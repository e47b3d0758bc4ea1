"""Batched-hypothesis RANSAC homography.

Port of `stitchingvideo_tpu/ops/ransac.py` (cv::findHomography(CV_RANSAC) +
inlier refit as BestOf2NearestMatcher drives it, reference
src/matchers.cpp:603-651): a fixed batch of 4-point hypotheses scored in
parallel, then two masked least-squares refits of the winner. Pairs are a
leading batch axis. The draws are an argument: `ransac_uniforms` makes them
from a seeded CPU generator, so the card and the CPU sample the same
hypotheses.
"""
from __future__ import annotations

import torch

from .homography import perspective_4pt, transfer_error2, weighted_refit_8pt


def ransac_uniforms(seed: int, n_pairs: int, iters: int,
                    device) -> torch.Tensor:
    """[n_pairs, iters, 4] uniforms in [0, 1) for `ransac_homography`, from
    a CPU `torch.Generator` seeded with `seed`, moved to `device`: the same
    values on every device."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return torch.rand((n_pairs, iters, 4), generator=gen,
                      dtype=torch.float32).to(device)


def ransac_homography(u: torch.Tensor, pts1: torch.Tensor,
                      pts2: torch.Tensor, valid: torch.Tensor,
                      thresh: float = 3.0):
    """RANSAC H: pts1 -> pts2, for [..., M, 2] points, [..., M] validity and
    [..., iters, 4] uniforms.

    Returns dict(H [..., 3, 3], inliers [..., M] bool, num_inliers [...]
    int32, ok [...] bool).
    """
    M = pts1.shape[-2]
    n_valid = valid.sum(-1)                                     # [...]
    # samples uniform over the valid correspondences: inverse CDF of the
    # validity count
    cdf = torch.cumsum(valid.to(torch.float32), -1).contiguous()
    targets = torch.floor(u * torch.clamp(n_valid.to(torch.float32),
                                          min=1.0)[..., None, None])
    flat = (targets + 0.5).reshape(*targets.shape[:-2], -1)
    samples = torch.clamp(torch.searchsorted(cdf, flat.contiguous()),
                          0, M - 1).reshape(targets.shape)      # [..., I, 4]
    distinct = (samples[..., :, None] == samples[..., None, :]) \
        .sum((-1, -2)) == 4
    sample_ok = distinct & (n_valid >= 4)[..., None]

    def pick(pts):                                      # -> [..., I, 4, 2]
        idx = samples.reshape(*samples.shape[:-2], -1)[..., None] \
            .expand(*samples.shape[:-2], samples.shape[-2] * 4, 2)
        return torch.gather(pts, -2, idx).reshape(*samples.shape, 2)

    Hs = perspective_4pt(pick(pts1), pick(pts2))                # [..., I, 3, 3]
    thresh2 = thresh * thresh
    inls = (transfer_error2(Hs, pts1[..., None, :, :], pts2[..., None, :, :])
            < thresh2) & valid[..., None, :]                    # [..., I, M]
    counts = torch.where(sample_ok, inls.sum(-1),
                         torch.full((), -1, device=inls.device))
    best = torch.argmax(counts, dim=-1)                         # first max
    best_inl = torch.gather(inls, -2, best[..., None, None]
                            .expand(*best.shape, 1, M))[..., 0, :]
    H = torch.gather(Hs, -3, best[..., None, None, None]
                     .expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    best_count = torch.gather(counts, -1, best[..., None])[..., 0]

    for _ in range(2):          # two masked least-squares refits
        H_ref = weighted_refit_8pt(pts1, pts2, best_inl.to(torch.float32))
        new_inl = (transfer_error2(H_ref, pts1, pts2) < thresh2) & valid
        better = new_inl.sum(-1) >= best_inl.sum(-1)
        H = torch.where(better[..., None, None], H_ref, H)
        best_inl = torch.where(better[..., None], new_inl, best_inl)

    num = best_inl.sum(-1).to(torch.int32)
    ok = (num >= 4) & (best_count > 0)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    return {"H": torch.where(ok[..., None, None], H, eye),
            "inliers": best_inl & ok[..., None],
            "num_inliers": torch.where(ok, num, torch.zeros_like(num)),
            "ok": ok}
