"""The frozen scene generators reproduce the port's bit for bit."""

import numpy as np
import pytest

from global_lvba_tpu_torch.models import synthetic as port
from lvba_bench.scenes import synthetic as frozen


def _same(a, b):
    for f in ("points_body", "frame_ids", "R_true", "p_true", "planes_n",
              "planes_d", "times"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


@pytest.mark.parametrize("seed", [0, 5, 2 ** 33 + 7])
def test_plane_scene(seed):
    kw = dict(num_frames=9, points_per_frame=300, seed=seed)
    _same(frozen.make_plane_scene(**kw), port.make_plane_scene(**kw))
    kw = dict(num_frames=5, points_per_frame=120, num_planes=8, seed=seed)
    _same(frozen.make_plane_scene(**kw), port.make_plane_scene(**kw))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 1])
def test_corridor_scene(seed):
    kw = dict(num_frames=40, points_per_frame=200, seed=seed)
    _same(frozen.make_corridor_scene(**kw), port.make_corridor_scene(**kw))


@pytest.mark.parametrize("name", ["perturb_poses", "perturb_poses_drift"])
def test_perturbations(name):
    sc = frozen.make_plane_scene(num_frames=30, points_per_frame=60, seed=2)
    for seed in (1, 12345678901234):
        a = getattr(frozen, name)(sc.R_true, sc.p_true, 0.003, 0.01, seed)
        b = getattr(port, name)(sc.R_true, sc.p_true, 0.003, 0.01, seed)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
