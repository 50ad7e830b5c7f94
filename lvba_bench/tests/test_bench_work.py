"""work.py's counts against counts worked by hand on a tiny map."""

import numpy as np
import pytest

from lvba_bench import work


def test_tiny_map_by_hand():
    # voxel 0 sees frames 0, 1; voxel 1 sees frames 1, 2, 3; W = 4
    vox = np.array([0, 0, 1, 1, 1])
    frame = np.array([0, 1, 1, 2, 3])
    w = work.eval_work(vox, frame, W=4, itemsize=4)
    # Gram upper triangles: 3 rows x 6K(6K+1) flops, K = 2 and 3
    assert w["flops"] == 3 * 12 * 13 + 3 * 18 * 19 == 1494
    # frame pairs seen together: (0,1), (1,2), (1,3), (2,3)
    assert w["pairs"] == 4
    # values: 5 entries x 10 moments, 4 x 12 poses, 4 x 6 g, 1 cost,
    # 4 diagonal blocks x 21, 4 pairs x 36
    assert w["bytes"] == 4 * (50 + 48 + 24 + 1 + 84 + 144) == 1404
    assert w["entries"] == 5 and w["voxels"] == 2


def test_order_free_and_unseen_frames():
    vox = np.array([1, 0, 1, 0])
    frame = np.array([5, 2, 3, 0])
    w = work.eval_work(vox, frame, W=7, itemsize=8)
    assert w["flops"] == 2 * 3 * 12 * 13
    assert w["pairs"] == 2
    assert w["bytes"] == 8 * (40 + 7 * 18 + 1 + 4 * 21 + 2 * 36)


@pytest.mark.parametrize("dtype,bound", [("float32", "operations"),
                                         ("float64", "operations")])
def test_least_time(dtype, bound):
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    w = dict(flops=1e12, bytes=1e6)
    t, by = work.least_time_s(w, peak, dtype)
    tf = 495.0 if dtype == "float32" else 67.0
    assert by == bound and t == pytest.approx(1e12 / (tf * 1e12))
    t, by = work.least_time_s(dict(flops=1.0, bytes=3.35e12), peak, dtype)
    assert by == "bytes" and t == pytest.approx(1.0)
    assert work.peaks("some other card") is None
