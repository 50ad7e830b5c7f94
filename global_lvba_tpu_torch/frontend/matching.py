"""Batched descriptor matching with SiftGPU's acceptance rules (port of
global_lvba_tpu.frontend.matching).

The reference calls SiftMatchGPU::GetSiftMatch(distmax=0.7, ratiomax=0.8,
mutual_best=1) per image pair.  On L2-normalized descriptors: the best
match's descriptor ANGLE acos(d·d') must be < distmax, the angle ratio
best/second < ratiomax, and the pair must be mutual nearest neighbours.

The similarity, its top-2 and both argmaxes come from
kernels.matcher.top2_similarity (kernel 6 on a CUDA tensor, its plain
version on a CPU tensor); the angle, ratio, validity and mutual tests run
on the same device, and the host receives one packed array per chunk of
pairs.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..kernels.matcher import top2_similarity


def accept_matches(vals, idx, colarg, v1, distmax: float = 0.7,
                   ratiomax: float = 0.8):
    """The acceptance tests on top2_similarity's outputs (any leading
    batch shape): returns (idx2 for each row, ok)."""
    ang1 = torch.arccos(vals[..., 0].clamp(-1.0, 1.0))
    ang2 = torch.arccos(vals[..., 1].clamp(-1.0, 1.0))
    ok = (ang1 < distmax) & (ang1 < ratiomax * ang2) & v1
    j = idx.long()
    rows = torch.arange(idx.shape[-1], device=idx.device)
    mutual = torch.gather(colarg.long(), -1, j) == rows
    return j, ok & mutual


def match_pair(d1, v1, d2, v2, distmax: float = 0.7, ratiomax: float = 0.8):
    """Match two descriptor sets d1 (K1, 128), d2 (K2, 128) (L2-normalized,
    float32, on one device) with validity masks v1, v2.  Returns
    (idx2 for each row of d1 (K1,), ok (K1,)) on that device."""
    vals, idx, colarg = top2_similarity(d1, d2, v1, v2)
    return accept_matches(vals, idx, colarg, v1, distmax, ratiomax)


def _pairs_of(j: np.ndarray, ok: np.ndarray) -> np.ndarray:
    i = np.flatnonzero(ok)
    return np.stack([i, j[i]], axis=-1).astype(np.int32)


def match_pair_arrays(
    d1: np.ndarray, d2: np.ndarray,
    v1: np.ndarray = None, v2: np.ndarray = None,
    distmax: float = 0.7, ratiomax: float = 0.8,
    device="cuda",
) -> np.ndarray:
    """Host wrapper: returns (m, 2) int32 match indices."""
    if d1.shape[0] == 0 or d2.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.int32)
    dev = resolve_device(device)
    v1 = np.ones(d1.shape[0], bool) if v1 is None else np.asarray(v1, bool)
    v2 = np.ones(d2.shape[0], bool) if v2 is None else np.asarray(v2, bool)

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev, dt)

    j, ok = match_pair(put(d1, torch.float32), put(v1, torch.bool),
                       put(d2, torch.float32), put(v2, torch.bool),
                       distmax, ratiomax)
    packed = torch.where(ok, j, torch.full_like(j, -1)).cpu().numpy()
    return _pairs_of(packed, packed >= 0)


def match_all_pairs(
    descs: Sequence,
    valids: Sequence,
    pairs: Sequence[Tuple[int, int]],
    distmax: float = 0.7,
    ratiomax: float = 0.8,
    min_matches: int = 0,
    chunk: int = 16,
    device="cuda",
) -> Dict[Tuple[int, int], np.ndarray]:
    """Match the given image pairs (the reference matches all O(N²)
    pairs).  descs / valids: per image (K, D) descriptors and (K,) masks,
    numpy or tensors (those of pipeline.sift_frontend.extract_images stay
    on the device).

    When every image has the same (K, D) slot shape (the built-in SIFT
    path), the descriptors are stacked once and each chunk of `chunk`
    pairs is one kernel call over the pair lists, with one copy to the
    host per chunk.  Mixed shapes go pair by pair."""
    dev = resolve_device(device)

    def put(x, dt):
        return torch.as_tensor(x).to(dev, dt).contiguous()

    out: Dict[Tuple[int, int], np.ndarray] = {}
    n = len(descs)
    bad = [(i, j) for (i, j) in pairs if not (0 <= i < n and 0 <= j < n)]
    if bad:
        raise ValueError(f"pairs {bad[:4]} name images outside [0, {n})")
    pairs = [(i, j) for (i, j) in pairs
             if descs[i].shape[0] > 0 and descs[j].shape[0] > 0]
    if not pairs:
        return out
    same_shape = len({tuple(d.shape) for d in descs}) == 1
    if same_shape and len(pairs) > 1:
        d_all = torch.stack([put(d, torch.float32) for d in descs])
        v_all = torch.stack([put(v, torch.bool) for v in valids])
        pidx = torch.as_tensor(np.asarray(pairs, np.int32).T.copy()).to(dev)
        for s in range(0, len(pairs), chunk):
            block = pairs[s:s + chunk]
            ia, ib = pidx[0, s:s + chunk], pidx[1, s:s + chunk]
            vals, idx, colarg = top2_similarity(d_all, d_all, v_all, v_all,
                                                ia, ib)
            j, ok = accept_matches(vals, idx, colarg, v_all[ia.long()],
                                   distmax, ratiomax)
            packed = torch.where(ok, j, torch.full_like(j, -1)).cpu().numpy()
            for bi, key in enumerate(block):
                m = _pairs_of(packed[bi], packed[bi] >= 0)
                if m.shape[0] > min_matches:
                    out[key] = m
        return out
    for (i, j) in pairs:
        jj, ok = match_pair(put(descs[i], torch.float32),
                            put(valids[i], torch.bool),
                            put(descs[j], torch.float32),
                            put(valids[j], torch.bool), distmax, ratiomax)
        packed = torch.where(ok, jj, torch.full_like(jj, -1)).cpu().numpy()
        m = _pairs_of(packed, packed >= 0)
        if m.shape[0] > min_matches:
            out[(i, j)] = m
    return out
