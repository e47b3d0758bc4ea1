"""Registration pipeline: images -> features -> match graph -> cameras.

Port of `stitchingvideo_tpu/register/pipeline.py` (the registration phase of
the reference drivers, CLI stitching_detailed.cpp:359-540, RT driver
GetPreStruct :348-694, and Stitcher::estimateTransform, src/stitcher.cpp:
91-112, :337-486): features -> pairwise match + RANSAC ->
leaveBiggestComponent -> HomographyBasedEstimator -> bundle adjustment ->
median focal -> waveCorrect.

The heavy stages run on the device with the camera and the pair as tensor
axes: one detector pass over the rig's stacked images, one matching and
RANSAC pass over all pairs. The graph, the rotation estimate and wave
correction are numpy on the host, as in the reference; each stage fetches
its inputs and outputs once. Every entry point runs on CUDA unless the
caller passes `device="cpu"`, and raises when there is no card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import StitchConfig
from ..device import resolve_device
from ..models.camera import Cameras
from ..ops import color
from ..ops import features as feat_ops
from ..ops.matching import match_pair
from ..ops.ransac import ransac_homography, ransac_uniforms
from . import estimator as est_mod
from . import graph as graph_mod
from .bundle import bundle_adjust
from .wave import wave_correct


@dataclasses.dataclass
class PairResult:
    """Host-side record for one ordered pair (i -> j)."""
    src: int
    dst: int
    H: Optional[np.ndarray]
    num_matches: int
    num_inliers: int
    confidence: float
    pts1: np.ndarray  # [M,2] centered, padded
    pts2: np.ndarray
    inlier_w: np.ndarray  # [M] 0/1


@dataclasses.dataclass
class RegistrationResult:
    cameras: Cameras
    indices: List[int]              # kept image indices (biggest component)
    warped_image_scale: float       # median focal (CLI :520-529)
    pair_stats: Dict[Tuple[int, int], Tuple[int, int, float]]
    features: List[dict]


SHAPE_BUCKET_Q = 32   # work/seam image shapes round up to this


def _pad_to_bucket(img: np.ndarray, q: int = SHAPE_BUCKET_Q) -> np.ndarray:
    """Reflect-101-pad H/W up to multiples of q (the reference's shape
    buckets): reads past the true edge see what reflect resampling of the
    unpadded image would, and the detector's extent masks the rest."""
    h, w = img.shape[:2]
    ph, pw = (-h) % q, (-w) % q
    if not (ph or pw):
        return img
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="reflect")


def _detector(cfg: StitchConfig):
    """(detector gate, descriptor family, threshold) of cfg.features.kind:
    'grad' is the float modality (Harris keypoints + gradient histograms
    matched by L2)."""
    fc = cfg.features
    det = "harris" if fc.kind in ("harris_brief", "grad") else "fast"
    desc_kind = "grad" if fc.kind == "grad" else "brief"
    return det, desc_kind, fc.fast_threshold if det == "fast" else 1.0


def compute_features(images: Sequence[np.ndarray], cfg: StitchConfig,
                     device=None) -> List[dict]:
    """Per-image feature dicts (gray conversion + detect_and_describe).

    Same-size images go through one batched detector pass; the small
    outputs (xy, valid, response, angle) come to the host in one fetch and
    the descriptors stay on the device as one batch, under '_dev', for
    match_all_pairs. Mixed sizes (and the pyramid) run one image at a time
    and come to the host whole. Images are bucket-padded; keypoint
    coordinates and img_wh stay in true image coordinates."""
    device = resolve_device(device, "compute_features")
    fc = cfg.features
    det, desc_kind, threshold = _detector(cfg)
    shapes = {im.shape for im in images}
    if len(shapes) == 1 and len(images) > 1 and fc.num_levels == 1:
        stack = np.stack(images)
        if stack.ndim == 4 and stack.dtype == np.uint8:
            # gray on the host, uploaded as uint8 (a third of the bytes)
            a = stack.astype(np.float32)
            gray_np = np.clip(np.round(
                a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114),
                0, 255).astype(np.uint8)
            batch = torch.from_numpy(np.stack([_pad_to_bucket(g)
                                               for g in gray_np])).to(device)
        else:
            dev = torch.from_numpy(np.stack([_pad_to_bucket(im)
                                             for im in stack])).to(device)
            batch = color.rgb_to_gray(dev) if dev.dim() == 4 else dev
        h_t, w_t = images[0].shape[:2]
        f = feat_ops.detect_and_describe(
            batch.to(torch.float32), threshold, fc.max_keypoints, fc.border,
            fc.grid, det, desc_kind, extent=(h_t, w_t))
        sm = torch.cat([f["xy"], f["valid"][..., None].to(torch.float32),
                        f["response"][..., None], f["angle"][..., None]],
                       dim=-1).cpu().numpy()
        dev_batch = {"desc": f["desc"], "valid": f["valid"], "xy": f["xy"]}
        wh = (w_t, h_t)   # true size: pp centring ignores the bucket pad
        return [{"xy": sm[i, :, 0:2], "valid": sm[i, :, 2] > 0.5,
                 "response": sm[i, :, 3], "angle": sm[i, :, 4],
                 "img_wh": wh, "_dev": (dev_batch, i)}
                for i in range(len(images))]
    out = []
    for img in images:
        h_t, w_t = img.shape[:2]
        # the pyramid detector has no extent masking: it takes the image
        # unpadded
        arr = torch.from_numpy(np.ascontiguousarray(
            img if fc.num_levels > 1 else _pad_to_bucket(np.asarray(img)))) \
            .to(device)
        gray = color.rgb_to_gray(arr) if arr.dim() == 3 \
            else arr.to(torch.float32)
        if fc.num_levels > 1:
            f = feat_ops.detect_and_describe_pyramid(
                gray, threshold=fc.fast_threshold, max_kp=fc.max_keypoints,
                border=fc.border, grid=fc.grid, levels=fc.num_levels,
                scale_factor=fc.scale_factor)
        else:
            f = feat_ops.detect_and_describe(
                gray, threshold, fc.max_keypoints, fc.border, fc.grid, det,
                desc_kind, extent=(h_t, w_t))
        f = {k: v.cpu().numpy() for k, v in f.items()}
        f["img_wh"] = (w_t, h_t)
        out.append(f)
    return out


def features_from_numpy(dicts: Sequence[dict], device=None) -> List[dict]:
    """The port's feature dicts from host arrays: each dict's xy, valid,
    response, angle, desc and img_wh (e.g. the JAX package's features,
    fetched with np.asarray). Same-shape descriptors become one batch on
    the device, as compute_features' batched pass leaves them."""
    device = resolve_device(device, "features_from_numpy")
    out = [{"xy": np.asarray(d["xy"], np.float32),
            "valid": np.asarray(d["valid"], bool),
            "response": np.asarray(d["response"], np.float32),
            "angle": np.asarray(d["angle"], np.float32),
            "desc": np.asarray(d["desc"]),
            "img_wh": tuple(int(x) for x in d["img_wh"])} for d in dicts]
    if len(out) > 1 and len({f["desc"].shape for f in out}) == 1:
        dev_batch = {k: torch.from_numpy(np.stack([f[k] for f in out]))
                     .to(device) for k in ("desc", "valid", "xy")}
        for i, f in enumerate(out):
            del f["desc"]
            f["_dev"] = (dev_batch, i)
    return out


def _match_pairs_device(u, desc, dvalid, xy, centers, pi, pj, match_conf,
                        max_matches, ransac_thresh):
    """All pairs at once: 2-NN matching + RANSAC with the pair as a batch
    axis. Returns points [P, M, 6] (p1, p2, valid, inlier) and scalars
    [P, 12] (H flat, matches, inliers, ok)."""
    src, dst, _d, valid = match_pair(desc[pi], dvalid[pi], desc[pj],
                                     dvalid[pj], match_conf=match_conf,
                                     max_matches=max_matches)

    def points(xy_b, idx, c):
        return torch.gather(xy_b, 1, idx[..., None].expand(*idx.shape, 2)) \
            - c[:, None, :]

    p1 = points(xy[pi], src, centers[pi])
    p2 = points(xy[pj], dst, centers[pj])
    r = ransac_homography(u, p1, p2, valid, thresh=ransac_thresh)
    pts = torch.cat([p1, p2, valid[..., None].to(torch.float32),
                     r["inliers"][..., None].to(torch.float32)], dim=-1)
    scal = torch.cat([r["H"].reshape(-1, 9).to(torch.float32),
                      torch.stack([valid.sum(-1).to(torch.float32),
                                   r["num_inliers"].to(torch.float32),
                                   r["ok"].to(torch.float32)], dim=-1)],
                     dim=-1)
    return pts, scal


def _confidence(ni: int, nm: int, mc) -> float:
    conf = ni / (8.0 + 0.3 * nm)          # matchers.cpp:622
    return 0.0 if conf > mc.near_dup_confidence else conf   # (:627)


def match_all_pairs(features: List[dict], cfg: StitchConfig,
                    seed: int = 0, device=None) -> List[PairResult]:
    """All unordered pairs matched + RANSAC'd (ordered i<j; H maps i->j).
    RANSAC's draws are `ransac_uniforms(seed, pairs, iters)`: row p serves
    the p-th pair of the batched pass, or the p-th pair that reaches
    RANSAC on the per-pair path."""
    device = resolve_device(device, "match_all_pairs")
    mc = cfg.match
    n = len(features)
    pairs_idx = [(i, j) for i in range(n) for j in range(i + 1, n)]
    dev0 = features[0].get("_dev") if features else None
    shared_dev = (dev0 is not None and
                  all(f.get("_dev") is not None
                      and f["_dev"][0] is dev0[0] and f["_dev"][1] == i
                      for i, f in enumerate(features)))
    same_shape = shared_dev or (
        all("desc" in f for f in features)
        and len({f["desc"].shape for f in features}) == 1)
    u = ransac_uniforms(seed, len(pairs_idx), mc.ransac_iters, device)

    results: List[PairResult] = []
    if same_shape and pairs_idx:
        if shared_dev:
            # the batched detector's outputs, still on the device
            desc, dvalid, xy = (dev0[0][k].to(device)
                                for k in ("desc", "valid", "xy"))
        else:
            # host features: one upload of each stack
            desc, dvalid, xy = (torch.from_numpy(np.stack(
                [np.asarray(f[k]) for f in features])).to(device)
                for k in ("desc", "valid", "xy"))
        centers = torch.tensor([[f["img_wh"][0] * 0.5, f["img_wh"][1] * 0.5]
                                for f in features], dtype=torch.float32,
                               device=device)
        pi = torch.tensor([p[0] for p in pairs_idx], device=device)
        pj = torch.tensor([p[1] for p in pairs_idx], device=device)
        pts_d, scal_d = _match_pairs_device(
            u, desc, dvalid, xy, centers, pi, pj, mc.match_conf,
            mc.max_matches, mc.ransac_thresh)
        pts = pts_d.cpu().numpy()          # [P, M, 6]
        scal = scal_d.cpu().numpy()        # [P, 12]
        Hs = scal[:, :9].reshape(-1, 3, 3)
        for p_idx, (i, j) in enumerate(pairs_idx):
            nm = int(round(float(scal[p_idx, 9])))
            ni = int(round(float(scal[p_idx, 10])))
            ok = scal[p_idx, 11] > 0.5 and nm >= mc.min_matches_for_h
            results.append(PairResult(
                i, j, Hs[p_idx] if ok else None, nm, ni if ok else 0,
                _confidence(ni, nm, mc) if ok else 0.0,
                pts[p_idx, :, 0:2], pts[p_idx, :, 2:4],
                pts[p_idx, :, 5].astype(np.float32) if ok
                else np.zeros(mc.max_matches, np.float32)))
        return results

    # per-pair path (mixed image sizes)
    def on_device(f, k):
        if "_dev" in f and k == "desc" and "desc" not in f:
            bd, i = f["_dev"]
            return bd["desc"][i].to(device)
        return torch.from_numpy(np.asarray(f[k])).to(device)

    drawn = 0
    for i, j in pairs_idx:
        fi, fj = features[i], features[j]
        src, dst, _dist, valid = match_pair(
            on_device(fi, "desc"), on_device(fi, "valid"),
            on_device(fj, "desc"), on_device(fj, "valid"),
            match_conf=mc.match_conf, max_matches=mc.max_matches)
        wi, hi = fi["img_wh"]
        wj, hj = fj["img_wh"]
        c1 = torch.tensor([wi * 0.5, hi * 0.5], device=device)
        c2 = torch.tensor([wj * 0.5, hj * 0.5], device=device)
        p1 = on_device(fi, "xy")[src] - c1
        p2 = on_device(fj, "xy")[dst] - c2
        nm = int(valid.sum())
        if nm < mc.min_matches_for_h:
            results.append(PairResult(i, j, None, nm, 0, 0.0,
                                      p1.cpu().numpy(), p2.cpu().numpy(),
                                      np.zeros(mc.max_matches, np.float32)))
            continue
        r = ransac_homography(u[drawn], p1, p2, valid,
                              thresh=mc.ransac_thresh)
        drawn += 1
        ni = int(r["num_inliers"])
        results.append(PairResult(
            i, j, r["H"].cpu().numpy() if bool(r["ok"]) else None,
            nm, ni, _confidence(ni, nm, mc), p1.cpu().numpy(),
            p2.cpu().numpy(), r["inliers"].cpu().numpy().astype(np.float32)))
    return results


def estimate_cameras(features: List[dict], pairs: List[PairResult],
                     cfg: StitchConfig, device=None) -> RegistrationResult:
    """Component selection + rotation estimation + BA + wave correction.
    The bundle adjustment runs on the device; the rest on the host."""
    device = resolve_device(device, "estimate_cameras")
    rc = cfg.register
    n = len(features)
    conf_map = {(p.src, p.dst): p.confidence for p in pairs}
    keep = graph_mod.biggest_component(n, conf_map, rc.conf_thresh)
    if len(keep) < 2:
        raise ValueError("Need more images: no connected component of size >= 2 "
                         "(reference 64-bit driver :472-476)")
    remap_idx = {g: k for k, g in enumerate(keep)}

    pair_info: Dict[Tuple[int, int], Tuple[np.ndarray, int]] = {}
    good_pairs: List[PairResult] = []
    for p in pairs:
        if p.src in remap_idx and p.dst in remap_idx and p.H is not None \
                and p.confidence > rc.conf_thresh:
            pair_info[(remap_idx[p.src], remap_idx[p.dst])] = (p.H, p.num_inliers)
            good_pairs.append(p)
    if not pair_info:
        raise ValueError("Need more images: no confident pairs")

    sizes = [features[g]["img_wh"] for g in keep]
    focals, Rs = est_mod.estimate_rotations(sizes, pair_info)

    ba_pairs = [p for p in good_pairs if p.num_inliers >= rc.ba_min_inliers]
    if rc.ba_kind in ("ray", "reproj") and ba_pairs:
        edge_i = np.array([remap_idx[p.src] for p in ba_pairs], np.int64)
        edge_j = np.array([remap_idx[p.dst] for p in ba_pairs], np.int64)
        pts1 = np.stack([p.pts1 for p in ba_pairs]).astype(np.float32)
        pts2 = np.stack([p.pts2 for p in ba_pairs]).astype(np.float32)
        w = np.stack([p.inlier_w for p in ba_pairs]).astype(np.float32)
        # the edge set padded to a multiple of 4 with zero-weight copies of
        # the first edge (the reference's compile bucket; the zero weights
        # leave the cost unchanged)
        E = len(ba_pairs)
        pad = -(-E // 4) * 4 - E
        if pad:
            edge_i = np.concatenate([edge_i, np.repeat(edge_i[:1], pad)])
            edge_j = np.concatenate([edge_j, np.repeat(edge_j[:1], pad)])
            pts1 = np.concatenate([pts1, np.zeros((pad,) + pts1.shape[1:],
                                                  np.float32)])
            pts2 = np.concatenate([pts2, np.zeros((pad,) + pts2.shape[1:],
                                                  np.float32)])
            w = np.concatenate([w, np.zeros((pad,) + w.shape[1:],
                                            np.float32)])
        # 5-char mask parity (CLI parseCmdArgs :259-272 -> refinement_mask_
        # cells; motion_estimators.cpp:389-438): fx, skew, ppx, aspect, ppy.
        # Skew is parsed but refines nothing, as in the reference.
        m = rc.ba_refine_mask
        if len(m) != 5 or any(c not in "x_" for c in m):
            raise ValueError(
                f"ba_refine_mask must be 5 chars of 'x'/'_', got {m!r}")

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        ba = bundle_adjust(
            dev(focals), dev(Rs), dev(edge_i), dev(edge_j), dev(pts1),
            dev(pts2), dev(w), kind=rc.ba_kind, iters=rc.ba_iters,
            refine_focal=m[0] == "x", refine_ppx=m[2] == "x",
            refine_aspect=m[3] == "x", refine_ppy=m[4] == "x")
        new_focals, new_Rs, new_ppa = (t.cpu().numpy() for t in ba[:3])
        # sanity gate: a poisoned edge can make LM diverge; fall back to the
        # homography-based initialisation (reference retry stance, 64-bit
        # driver :822-826)
        med = float(np.median(focals))
        sane = np.all(np.isfinite(new_focals)) and \
            np.all(new_focals > 0.2 * med) and np.all(new_focals < 5.0 * med)
        if sane:
            focals = new_focals
            Rs = new_Rs
            pp_off = new_ppa[:, :2]      # centred-coordinate pp offsets
            aspects = new_ppa[:, 2]
        else:
            pp_off = np.zeros((len(keep), 2), np.float32)
            aspects = np.ones(len(keep), np.float32)
        # gauge fix: normalise to the spanning tree's centre camera
        weight = {(i, j): float(ni) for (i, j), (_H, ni) in pair_info.items()}
        _tree, center = graph_mod.max_spanning_tree(len(keep), weight)
        Rs = np.einsum("ab,nbc->nac", np.linalg.inv(Rs[center]), Rs)

    if rc.wave_correct is not None:
        Rs = wave_correct(Rs, rc.wave_correct)

    warped_image_scale = float(np.median(focals))  # CLI :520-529
    if rc.ba_kind not in ("ray", "reproj") or not ba_pairs:
        pp_off = np.zeros((len(keep), 2), np.float32)
        aspects = np.ones(len(keep), np.float32)
    cams = Cameras.create(
        focal=np.asarray(focals, np.float32),
        ppx=np.array([s[0] * 0.5 for s in sizes], np.float32) + pp_off[:, 0],
        ppy=np.array([s[1] * 0.5 for s in sizes], np.float32) + pp_off[:, 1],
        aspect=np.asarray(aspects, np.float32),
        R=np.asarray(Rs, np.float32), device=device)
    stats = {(p.src, p.dst): (p.num_matches, p.num_inliers, p.confidence)
             for p in pairs}
    return RegistrationResult(cameras=cams, indices=keep,
                              warped_image_scale=warped_image_scale,
                              pair_stats=stats,
                              features=[features[g] for g in keep])


def register_images(images: Sequence[np.ndarray], cfg: StitchConfig,
                    seed: int = 0, device=None) -> RegistrationResult:
    """Frames -> cameras: compute_features, match_all_pairs,
    estimate_cameras, all on `device` (CUDA unless given)."""
    device = resolve_device(device, "register_images")
    feats = compute_features(images, cfg, device)
    pairs = match_all_pairs(feats, cfg, seed, device)
    return estimate_cameras(feats, pairs, cfg, device)
