"""The work one factor evaluation needs, counted from the map, and its
least time on a card (the yardstick of eval_roofline).

An evaluation (cost, g and the Gauss-Newton-shaped H of every live voxel,
as the LM consumes them) needs, for a voxel seen by K frames, the Gram of
its three factor rows over its 6K pose columns: the upper triangle of a
(6K x 6K) product, 3 · 6K(6K + 1) flops (a multiply and an add each).
The per-entry aggregation and chain (a few hundred flops an entry) are not
counted, nor is padding, a band's zeros or the 3xTF32 split of a float32
Gram: so the count is a lower bound of the work, whatever route computes
it.  Bytes: each live (voxel, frame) entry's moments read once (n, μ, the
six of Pc), the pose table read once, g and the cost written once, and
H's nonzero upper triangle written once (21 values a frame's diagonal
block, 36 a pair of frames that some voxel sees together).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from scipy import sparse

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def eval_work(vox: np.ndarray, frame: np.ndarray, W: int,
              itemsize: int) -> dict:
    """{"flops", "bytes", "entries", "voxels", "pairs"} of one evaluation
    over the live entries (vox[i], frame[i]) of a W-frame map, each voxel
    observing a frame at most once, in floats of `itemsize` bytes."""
    vox = np.asarray(vox, np.int64)
    frame = np.asarray(frame, np.int64)
    _, K = np.unique(vox, return_counts=True)
    K = K.astype(np.float64)
    flops = float(np.sum(3.0 * 6.0 * K * (6.0 * K + 1.0)))
    # frames seen (the diagonal) and pairs (a < b) of frames that some
    # voxel sees together: the nonzeros of the co-visibility MᵀM of the
    # (voxel, frame) incidence matrix M
    M = sparse.csr_matrix((np.ones(vox.size), (vox, frame)),
                          shape=(int(vox.max(initial=-1)) + 1, W))
    C = (M.T @ M).tocoo()
    n_pairs = int(np.count_nonzero(C.row < C.col))
    n_diag = int(np.count_nonzero(C.row == C.col))
    values = (10 * vox.size + 12 * W + 6 * W + 1 + 21 * n_diag
              + 36 * n_pairs)
    return dict(flops=flops, bytes=float(values * itemsize),
                entries=int(vox.size), voxels=int(K.size), pairs=n_pairs)


def peaks(kind: str):
    """The card's published peaks (peaks.json) by its name, or None for a
    card the table does not hold."""
    table = json.loads(PEAKS.read_text())
    return table.get(kind)


def least_time_s(work: dict, peak: dict, dtype: str) -> tuple:
    """(the least time of the evaluation in seconds, what bounds it):
    operations at the dtype's tensor-core peak against bytes at the
    memory's peak."""
    tflops = peak["tf32_tflops"] if dtype == "float32" else peak[
        "fp64_tflops"]
    t_ops = work["flops"] / (tflops * 1e12)
    t_bytes = work["bytes"] / (peak["hbm_tb_s"] * 1e12)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
