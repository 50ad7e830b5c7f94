"""Segment reductions for irregular point -> voxel aggregation (port of
global_lvba_tpu.ops.segments).

The reference accumulates per-voxel statistics through hash maps and
octree nodes (bavoxel.hpp:799-836, 391-418).  Here the keys are sorted on
the host once, and the device sums go through an index table in a fixed
order (solver.dist_solve._segsum): no atomic scatter, so two runs are
bitwise equal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..solver.dist_solve import _segsum, index_table_np, to_device


def segment_sum(data: torch.Tensor, segment_ids,
                num_segments: int) -> torch.Tensor:
    """Rows of data (E, ...) summed by segment -> (num_segments, ...), each
    segment's rows added in their order; ids outside [0, num_segments) are
    dropped (as jax.ops.segment_sum drops them).  The ids are read to the
    host once for the segment table (index_table_np)."""
    ids = (segment_ids.cpu().numpy() if torch.is_tensor(segment_ids)
           else np.asarray(segment_ids))
    table = to_device([index_table_np(ids, num_segments)], data.device)[0]
    return _segsum(data, table)


def run_lengths(sorted_keys: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host run-length encoding of a sorted key array -> (unique_keys,
    start_offsets, counts); the segment id of each element is
    np.repeat(arange(len(unique)), counts)."""
    sorted_keys = np.asarray(sorted_keys)
    if sorted_keys.size == 0:
        return (sorted_keys[:0], np.zeros(0, dtype=np.int64),
                np.zeros(0, dtype=np.int64))
    change = np.empty(sorted_keys.shape[0], dtype=bool)
    change[0] = True
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    counts = np.diff(np.append(starts, sorted_keys.shape[0]))
    return sorted_keys[starts], starts.astype(np.int64), counts.astype(np.int64)


def ids_from_counts(counts: np.ndarray) -> np.ndarray:
    """Segment id per element from per-segment counts (host)."""
    return np.repeat(np.arange(counts.shape[0], dtype=np.int32), counts)
