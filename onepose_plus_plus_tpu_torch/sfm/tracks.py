"""Feature-track building from pairwise index matches (host-side union-find).

COLMAP builds tracks inside ``point_triangulator``; here the correspondence
graph is explicit: nodes are (image_id, keypoint_idx) and every verified match
is an edge. A vectorized union-find with path halving merges connected
components into tracks. Conflicting tracks (two observations in the same
image) are split COLMAP-style by dropping the weaker observation.

Complexity is ~alpha(N) per edge. Port of
``onepose_plus_plus_tpu/sfm/tracks.py`` with its Python union-find only (the
JAX package's C++ builder, ``native/track_builder.cpp``, gives identical
tracks and is not carried over).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Pair = Tuple[int, int]


class UnionFind:
    """Array-based union-find with path halving + union by size."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return int(x)

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]


def _roots_python(
    total: int, edge_a: np.ndarray, edge_b: np.ndarray, confs: np.ndarray
):
    """Union-find over the edges: (roots [total], node_conf [total], component
    size per node)."""
    uf = UnionFind(total)
    node_conf = np.zeros(total)
    np.add.at(node_conf, edge_a, confs)
    np.add.at(node_conf, edge_b, confs)
    for aa, bb in zip(edge_a, edge_b):
        uf.union(int(aa), int(bb))
    roots = np.fromiter(
        (uf.find(x) for x in range(total)), dtype=np.int64, count=total
    )
    return roots, node_conf, uf.size[roots]  # component size per node


def build_tracks(
    keypoint_counts: Dict[int, int],
    match_indices: Dict[Pair, np.ndarray],
    match_confs: Dict[Pair, np.ndarray] = None,
    min_track_length: int = 2,
) -> List[Dict[int, int]]:
    """Union pairwise index matches into tracks.

    Args:
        keypoint_counts: img_id -> number of keypoints.
        match_indices: (i, j) -> [M, 2] (kpt_idx_i, kpt_idx_j).
        match_confs: optional per-match confidences; used to resolve
            in-image conflicts (keep the observation supported by higher
            total edge confidence).
        min_track_length: drop components smaller than this.
    Returns:
        list of tracks; each is {img_id: kpt_idx}.
    """
    img_ids = sorted(keypoint_counts)
    offsets = {}
    total = 0
    for i in img_ids:
        offsets[i] = total
        total += keypoint_counts[i]

    # flatten all edges
    ea_list, eb_list, ec_list = [], [], []
    for (i, j), m in match_indices.items():
        confs = (
            match_confs[(i, j)] if match_confs is not None else np.ones(len(m))
        )
        ea_list.append(offsets[i] + m[:, 0])
        eb_list.append(offsets[j] + m[:, 1])
        ec_list.append(confs)
    edge_a = np.concatenate(ea_list) if ea_list else np.zeros(0, np.int64)
    edge_b = np.concatenate(eb_list) if eb_list else np.zeros(0, np.int64)
    confs = np.concatenate(ec_list) if ec_list else np.zeros(0)

    roots, node_conf, root_size = _roots_python(total, edge_a, edge_b, confs)
    # node -> (img, kpt)
    node_img = np.empty(total, np.int64)
    node_kpt = np.empty(total, np.int64)
    for i in img_ids:
        o = offsets[i]
        n = keypoint_counts[i]
        node_img[o : o + n] = i
        node_kpt[o : o + n] = np.arange(n)

    comp: Dict[int, List[int]] = {}
    # only touch nodes that participate in a merged component
    active = np.flatnonzero(root_size >= min_track_length)
    for x in active:
        comp.setdefault(int(roots[x]), []).append(int(x))

    tracks: List[Dict[int, int]] = []
    for nodes in comp.values():
        if len(nodes) < min_track_length:
            continue
        obs: Dict[int, int] = {}
        for x in nodes:
            im = int(node_img[x])
            k = int(node_kpt[x])
            if im in obs:
                # conflict: same image twice in one track -> keep stronger node
                prev = offsets[im] + obs[im]
                if node_conf[x] > node_conf[prev]:
                    obs[im] = k
            else:
                obs[im] = k
        if len(obs) >= min_track_length:
            tracks.append(obs)
    return tracks


def tracks_to_arrays(
    tracks: Sequence[Dict[int, int]],
    keypoints: Dict[int, np.ndarray],
    Ks: Dict[int, np.ndarray],
    Ts: Dict[int, np.ndarray],
    max_track_length: int,
) -> dict:
    """Pack tracks into the fixed-capacity arrays the device triangulator eats.

    Tracks longer than ``max_track_length`` keep their first observations
    (sorted by image id); shorter ones are mask-padded.

    Returns dict(uv [T, V, 2] f32, K [T, V, 3, 3] f32, T_w2c [T, V, 4, 4] f32,
                 valid [T, V] bool, img_ids [T, V] int64 (-1 pad),
                 kpt_idx [T, V] int64 (-1 pad)).
    """
    t_n = len(tracks)
    v = max_track_length
    uv = np.zeros((t_n, v, 2), np.float32)
    Karr = np.tile(np.eye(3, dtype=np.float32), (t_n, v, 1, 1))
    Tarr = np.tile(np.eye(4, dtype=np.float32), (t_n, v, 1, 1))
    valid = np.zeros((t_n, v), bool)
    img_ids = np.full((t_n, v), -1, np.int64)
    kpt_idx = np.full((t_n, v), -1, np.int64)
    for ti, obs in enumerate(tracks):
        items = sorted(obs.items())[:v]
        for s, (im, k) in enumerate(items):
            uv[ti, s] = keypoints[im][k]
            Karr[ti, s] = Ks[im]
            Tarr[ti, s] = Ts[im]
            valid[ti, s] = True
            img_ids[ti, s] = im
            kpt_idx[ti, s] = k
    return {
        "uv": uv,
        "K": Karr,
        "T_w2c": Tarr,
        "valid": valid,
        "img_ids": img_ids,
        "kpt_idx": kpt_idx,
    }
