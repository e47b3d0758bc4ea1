"""Camera match-graph utilities (host-side; N is tiny).

Parity targets: DisjointSets (reference src/util.cpp:50-92),
leaveBiggestComponent (src/motion_estimators.cpp:735-791),
findMaxSpanningTree (:794-862), matchesGraphAsString (:669-733).

A copy of `stitchingvideo_tpu/register/graph.py`: numpy host code in both packages.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class DisjointSets:
    def __init__(self, n: int):
        self.parent = list(range(n))
        self.size = [1] * n

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        return ra


def biggest_component(n_images: int,
                      pair_conf: Dict[Tuple[int, int], float],
                      conf_threshold: float) -> List[int]:
    """Indices of the largest camera component connected by pairs with
    confidence > threshold (leaveBiggestComponent semantics)."""
    ds = DisjointSets(n_images)
    for (i, j), c in pair_conf.items():
        if c > conf_threshold:
            ds.union(i, j)
    roots = [ds.find(i) for i in range(n_images)]
    best_root = max(set(roots), key=lambda r: ds.size[ds.find(r)])
    return [i for i in range(n_images) if ds.find(i) == best_root]


def max_spanning_tree(n_images: int,
                      pair_weight: Dict[Tuple[int, int], float]
                      ) -> Tuple[List[Tuple[int, int]], int]:
    """Maximum spanning tree (Kruskal over descending weights) + graph center.

    pair_weight: {(i, j): num_inliers}. Returns (tree edges, center node).
    Parity: findMaxSpanningTree (motion_estimators.cpp:794-862) which picks the
    node minimizing the maximum BFS distance as the propagation root.
    """
    edges = sorted(((w, i, j) for (i, j), w in pair_weight.items()),
                   key=lambda e: -e[0])
    ds = DisjointSets(n_images)
    tree: List[Tuple[int, int]] = []
    for w, i, j in edges:
        if ds.find(i) != ds.find(j):
            ds.union(i, j)
            tree.append((i, j))
    # adjacency + BFS eccentricity
    adj: List[List[int]] = [[] for _ in range(n_images)]
    for i, j in tree:
        adj[i].append(j)
        adj[j].append(i)

    def ecc(start: int) -> int:
        dist = {start: 0}
        frontier = [start]
        while frontier:
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if v not in dist:
                        dist[v] = dist[u] + 1
                        nxt.append(v)
            frontier = nxt
        return max(dist.values()) if dist else 0

    nodes_in_tree = {v for e in tree for v in e} or {0}
    center = min(nodes_in_tree, key=ecc)
    return tree, center


def bfs_order(n_images: int, tree: Sequence[Tuple[int, int]],
              root: int) -> List[Tuple[int, int]]:
    """Directed (from, to) edge visit order for rotation propagation."""
    adj: List[List[int]] = [[] for _ in range(n_images)]
    for i, j in tree:
        adj[i].append(j)
        adj[j].append(i)
    seen = {root}
    order: List[Tuple[int, int]] = []
    frontier = [root]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    order.append((u, v))
                    nxt.append(v)
        frontier = nxt
    return order


def matches_graph_dot(image_names: Sequence[str],
                      pair_stats: Dict[Tuple[int, int], Tuple[int, int, float]],
                      conf_threshold: float) -> str:
    """DOT-format match graph (--save_graph parity, motion_estimators.cpp:669-733).

    pair_stats: {(i, j): (num_matches, num_inliers, confidence)}.
    """
    lines = ["graph matches_graph{"]
    spanned = set()
    for (i, j), (nm, ni, conf) in sorted(pair_stats.items()):
        if conf > conf_threshold:
            a = image_names[i].replace(".", "_")
            b = image_names[j].replace(".", "_")
            lines.append(f'"{a}" -- "{b}"[label="Nm={nm}, Ni={ni}, C={conf:.5f}"];')
            spanned.add(i)
            spanned.add(j)
    for i, name in enumerate(image_names):
        if i not in spanned:
            lines.append(f'"{name.replace(".", "_")}";')
    lines.append("}")
    return "\n".join(lines)
