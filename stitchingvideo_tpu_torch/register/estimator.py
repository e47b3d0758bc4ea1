"""Homography-based rotation estimation.

Parity target: HomographyBasedEstimator::estimate + CalcRotation (reference
src/motion_estimators.cpp:59-167): shared median focal from pairwise
homographies, then rotation propagation R_to = R_from @ K_from^-1 @ H^-1 @ K_to
over the max spanning tree, BFS from the graph center. Host-side numpy —
O(N) tiny matrix products.

Coordinates: homographies are estimated on *centered* keypoints (the matcher
shifts by half the image size, reference matchers.cpp:595-605), so principal
points here are 0 and get re-added at warp time.

A copy of `stitchingvideo_tpu/register/estimator.py`: numpy host code in both packages.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..geometry.autocalib import estimate_focal
from . import graph as graph_mod


def estimate_rotations(img_sizes: List[Tuple[int, int]],
                       pair_info: Dict[Tuple[int, int], Tuple[np.ndarray, int]],
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(focals [N], R [N,3,3]) for N cameras.

    pair_info: {(i, j): (H_ij mapping i->j in centered coords, num_inliers)}.
    """
    n = len(img_sizes)
    pair_list = [(i, j, H, ni) for (i, j), (H, ni) in pair_info.items()]
    focal = estimate_focal(img_sizes, pair_list)
    focals = np.full((n,), focal, np.float64)

    weight = {(i, j): float(ni) for (i, j), (_H, ni) in pair_info.items() if ni > 0}
    tree, center = graph_mod.max_spanning_tree(n, weight)
    order = graph_mod.bfs_order(n, tree, center)

    def K(i):
        return np.array([[focals[i], 0, 0], [0, focals[i], 0], [0, 0, 1]], np.float64)

    Rs = np.tile(np.eye(3, dtype=np.float64)[None], (n, 1, 1))
    for (frm, to) in order:
        if (frm, to) in pair_info:
            H, _ = pair_info[(frm, to)]
            Hf = np.asarray(H, np.float64)
        else:
            H, _ = pair_info[(to, frm)]
            Hf = np.linalg.inv(np.asarray(H, np.float64))
        R_rel = np.linalg.inv(K(frm)) @ np.linalg.inv(Hf) @ K(to)
        # project to nearest rotation (H is noisy): SVD orthogonalization
        u, _s, vt = np.linalg.svd(R_rel)
        R_rel = u @ vt
        if np.linalg.det(R_rel) < 0:
            R_rel = -R_rel
        Rs[to] = Rs[frm] @ R_rel
    return focals.astype(np.float32), Rs.astype(np.float32)
