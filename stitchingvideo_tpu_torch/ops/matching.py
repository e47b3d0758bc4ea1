"""Pairwise descriptor matching as products, batched over pairs.

Port of `stitchingvideo_tpu/ops/matching.py` (CpuMatcher::match: 2-NN in
both directions + the Lowe ratio test `d0 < (1 - match_conf) * d1`,
reference src/matchers.cpp:147-202, fanned out over pairs, :66-109). The
Hamming distances of two binary descriptor sets are one product
(`|a| + |b| - 2 a.b^T`), so a pair's 2-NN search is one [K,256]x[256,K]
product and two reductions, and pairs are a batch axis. Every function
takes leading batch axes ([P, K, D] descriptors); the results are the
reference's bit for bit given the same descriptors.
"""
from __future__ import annotations

import numpy as np
import torch

_INF = float(np.float32(1e9))

# above this K1*K2 the 2-NN search streams the distance field in column
# chunks instead of materialising it (exact, the same results)
CHUNKED_ABOVE = 4096 * 4096
NN_CHUNK = 2048
# the exact brute-force envelope; beyond it match_pair refuses
MAX_KEYPOINTS = 65536


def _penalties(v1: torch.Tensor, v2: torch.Tensor):
    zero = torch.zeros((), dtype=torch.float32, device=v1.device)
    inf = torch.full((), _INF, dtype=torch.float32, device=v1.device)
    return torch.where(v1, zero, inf)[..., :, None], \
        torch.where(v2, zero, inf)[..., None, :]


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor,
                   v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """[..., K1, K2] Hamming distances of 0/1 descriptors [..., K, D];
    invalid rows and columns get +1e9. The 0/1 product is exact in float32
    (sums of at most D <= 2^24 ones; TF32 keeps 0 and 1 exact too)."""
    a = d1.to(torch.float32)
    b = d2.to(torch.float32)
    dot = a @ b.transpose(-1, -2)
    ham = a.sum(-1)[..., :, None] + b.sum(-1)[..., None, :] - 2.0 * dot
    p1, p2 = _penalties(v1, v2)
    return ham + p1 + p2


def l2_matrix(d1: torch.Tensor, d2: torch.Tensor,
              v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """[..., K1, K2] Euclidean distances of float descriptors (the
    SURF-class modality: true L2, the Lowe ratio's semantics)."""
    a = d1.to(torch.float32)
    b = d2.to(torch.float32)
    dot = (a.double() @ b.double().transpose(-1, -2)).float()
    sq = (a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :] \
        - 2.0 * dot
    p1, p2 = _penalties(v1, v2)
    return torch.sqrt(torch.clamp(sq, min=0.0)) + p1 + p2


def _two_nn(D: torch.Tensor):
    """Per-row two smallest distances and the argmin (first index on
    ties) of [..., K1, K2]."""
    d0, j0 = torch.min(D, dim=-1)
    cols = torch.arange(D.shape[-1], device=D.device)
    d1 = torch.where(cols == j0[..., None],
                     torch.full((), _INF, device=D.device), D).amin(dim=-1)
    return d0, d1, j0


def _metric_block(d1, d2, v1, v2):
    if d1.dtype.is_floating_point:
        return l2_matrix(d1, d2, v1, v2)
    return hamming_matrix(d1, d2, v1, v2)


def _two_nn_chunked(d1, v1, d2, v2, chunk: int = NN_CHUNK):
    """Exact per-row 2-NN of the distance matrix, streamed over column
    chunks of d2: O(K1 * chunk) live memory. Chunks scan left to right and
    a merge keeps the incumbent on equal distance, so ties go to the first
    index, as in _two_nn."""
    K1, K2 = d1.shape[-2], d2.shape[-2]
    lead = d1.shape[:-2]
    b0 = torch.full(lead + (K1,), _INF, device=d1.device)
    b1 = torch.full(lead + (K1,), _INF, device=d1.device)
    bj = torch.zeros(lead + (K1,), dtype=torch.int64, device=d1.device)
    for off in range(0, K2, chunk):
        dc, vc = d2[..., off:off + chunk, :], v2[..., off:off + chunk]
        c0, c1, cj = _two_nn(_metric_block(d1, dc, v1, vc))
        cj = cj + off
        take = c0 < b0
        n1 = torch.where(take, torch.minimum(b0, c1), torch.minimum(b1, c0))
        b0, bj, b1 = torch.where(take, c0, b0), torch.where(take, cj, bj), n1
    return b0, b1, bj


def _rank(d_eff: torch.Tensor, keep: torch.Tensor,
          chunk: int = 4 * NN_CHUNK) -> torch.Tensor:
    """rank[i] = the number of kept entries strictly better than i
    (distance, then index): the [M, M] comparison, in column chunks."""
    M = d_eff.shape[-1]
    idx = torch.arange(M, device=d_eff.device)
    rank = torch.zeros(d_eff.shape, dtype=torch.int64, device=d_eff.device)
    for off in range(0, M, chunk):
        dc, kc, ic = d_eff[..., None, off:off + chunk], \
            keep[..., None, off:off + chunk], idx[off:off + chunk]
        better = (dc < d_eff[..., :, None]) | \
            ((dc == d_eff[..., :, None]) & (ic[None, :] < idx[:, None]))
        rank += (better & kc).sum(-1)
    return rank


def match_pair(d1, v1, d2, v2, match_conf: float = 0.3,
               max_matches: int = 512):
    """Best-of-2-nearest matching of ordered pairs: descriptors
    [..., K, D] and validity [..., K] of each side.

    Returns (src_idx, dst_idx, dist, valid), each [..., max_matches]:
    forward (1->2) ratio survivors plus backward (2->1) survivors not found
    forward, best distance first, ties by index (BestOf2NearestMatcher::
    match, matchers.cpp:575-611). Integer descriptors match by Hamming
    distance, float ones by L2.
    """
    K1, K2 = d1.shape[-2], d2.shape[-2]
    if max(K1, K2) > MAX_KEYPOINTS:
        raise ValueError(
            f"match_pair: {max(K1, K2)} keypoints exceeds the exact "
            f"brute-force envelope (MAX_KEYPOINTS={MAX_KEYPOINTS}); "
            "reduce the detector budget (features.detect max_kp) — beyond "
            "this scale an ANN prefilter, not exact 2-NN, is the right tool")
    if K1 * K2 > CHUNKED_ABOVE:
        f0, f1, fj = _two_nn_chunked(d1, v1, d2, v2)
        b0, b1, bi = _two_nn_chunked(d2, v2, d1, v1)
    else:
        D = _metric_block(d1, d2, v1, v2)
        f0, f1, fj = _two_nn(D)
        b0, b1, bi = _two_nn(D.transpose(-1, -2))
    fwd_keep = (f0 < (1.0 - match_conf) * f1) & (f0 < _INF)
    bwd_keep = (b0 < (1.0 - match_conf) * b1) & (b0 < _INF)
    # a backward match (bi[j] -> j) is already there if forward row bi[j]
    # was kept and points to j
    ar1 = torch.arange(K1, device=d1.device).expand(fj.shape)
    ar2 = torch.arange(K2, device=d1.device).expand(bi.shape)
    already = torch.gather(fwd_keep, -1, bi) & (torch.gather(fj, -1, bi) == ar2)
    bwd_keep = bwd_keep & ~already

    src = torch.cat([ar1, bi], dim=-1)
    dst = torch.cat([fj, ar2], dim=-1)
    dist = torch.cat([f0, b0], dim=-1)
    keep = torch.cat([fwd_keep, bwd_keep], dim=-1)

    # best-distance-first truncation: each kept entry's slot is its rank;
    # everything else goes to the extra last slot, which is cut off
    d_eff = torch.where(keep, dist, torch.full((), float("inf"),
                                               device=dist.device))
    rank = _rank(d_eff, keep)
    slot = torch.where(keep & (rank < max_matches), rank,
                       torch.full((), max_matches, device=rank.device))

    def scatter(values, fill):
        out = torch.full(values.shape[:-1] + (max_matches + 1,), fill,
                         dtype=values.dtype, device=values.device)
        return out.scatter_(-1, slot, values)[..., :-1]

    return scatter(src, 0), scatter(dst, 0), scatter(dist, _INF), \
        scatter(keep, False)
