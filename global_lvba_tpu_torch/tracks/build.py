"""Match-graph connected components -> padded track arrays (port of
global_lvba_tpu.tracks.build, numpy).

The reference builds tracks by BFS over the keypoint match graph
(BuildTracksAndFuse3D): components with >= obser_thr observations over
>= obser_thr distinct images survive.  The labelling is a host union-find
(graph connectivity is sequential and irregular): the Python _UnionFind on
the CPU, the native library's (native/: union by size, the JAX package's
native roots, so its track order) for a stage on a CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from .. import native
from ..native import runtime


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


@dataclasses.dataclass
class TrackSet:
    """Padded per-track observation table."""

    obs_img: np.ndarray    # (T, Omax) int32, 0 where padded
    obs_kp: np.ndarray     # (T, Omax) int32
    obs_uv: np.ndarray     # (T, Omax, 2) float32
    obs_valid: np.ndarray  # (T, Omax) bool
    num_obs: np.ndarray    # (T,)
    stats: dict


def build_components(
    keypoints: Sequence[np.ndarray],
    matches: Dict[Tuple[int, int], np.ndarray],
    obser_thr: int = 3,
    max_obs: int = 64,
    device="cpu",
) -> TrackSet:
    """Union-find over keypoint matches.

    Args:
      keypoints: per image, (K_i, 2) pixel coords (x, y).
      matches: {(i, j): (m, 2) int array of (kp_i, kp_j)} with i < j.
      obser_thr: minimum observations AND distinct images per component.
      max_obs: observation capacity per track; overlong components keep
        their first max_obs observations (sorted by (image, kp)).
      device: the stage's device; a CUDA device labels the components
        through the native library (the same partition, other roots).
    """
    N = len(keypoints)
    offsets = np.zeros(N + 1, dtype=np.int64)
    for i in range(N):
        offsets[i + 1] = offsets[i] + len(keypoints[i])
    total = int(offsets[N])
    edge_list = []
    n_edges = 0
    for (i, j), m in matches.items():
        if m is None or len(m) == 0:
            continue
        ki = m[:, 0].astype(np.int64) + offsets[i]
        kj = m[:, 1].astype(np.int64) + offsets[j]
        edge_list.append(np.stack([ki, kj], axis=-1))
        n_edges += len(m)
    edges = (
        np.concatenate(edge_list) if edge_list else np.zeros((0, 2), np.int64)
    )
    if native.on_device(device):
        roots = runtime.union_find(total, edges)
    else:
        uf = _UnionFind(total)
        for a, b in edges:
            uf.union(int(a), int(b))
        roots = np.array([uf.find(x) for x in range(total)], dtype=np.int64)
    node_img = np.zeros(total, dtype=np.int32)
    for i in range(N):
        node_img[offsets[i]:offsets[i + 1]] = i

    # group nodes by root
    order = np.argsort(roots, kind="stable")
    sr = roots[order]
    firsts = np.concatenate([[True], sr[1:] != sr[:-1]])
    starts = np.flatnonzero(firsts)
    counts = np.diff(np.append(starts, total))

    comp_rows = []
    total_components = 0
    for s, c in zip(starts, counts):
        if c < obser_thr:
            continue
        nodes = order[s:s + c]
        total_components += 1
        imgs = node_img[nodes]
        if np.unique(imgs).shape[0] < obser_thr:
            continue
        kps = nodes - offsets[imgs]
        o2 = np.lexsort((kps, imgs))
        comp_rows.append((imgs[o2][:max_obs], kps[o2][:max_obs]))

    T = len(comp_rows)
    Omax = max((len(r[0]) for r in comp_rows), default=obser_thr)
    obs_img = np.zeros((T, Omax), dtype=np.int32)
    obs_kp = np.zeros((T, Omax), dtype=np.int32)
    obs_uv = np.zeros((T, Omax, 2), dtype=np.float32)
    obs_valid = np.zeros((T, Omax), dtype=bool)
    num_obs = np.zeros(T, dtype=np.int32)
    for t, (imgs, kps) in enumerate(comp_rows):
        k = len(imgs)
        obs_img[t, :k] = imgs
        obs_kp[t, :k] = kps
        for o in range(k):
            obs_uv[t, o] = keypoints[imgs[o]][kps[o]][:2]
        obs_valid[t, :k] = True
        num_obs[t] = k

    return TrackSet(
        obs_img=obs_img,
        obs_kp=obs_kp,
        obs_uv=obs_uv,
        obs_valid=obs_valid,
        num_obs=num_obs,
        stats={
            "total_components": total_components,
            "kept_components": T,
            "edges": n_edges,
            "max_obs": int(Omax),
        },
    )
