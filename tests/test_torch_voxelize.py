"""The port's host voxelizer and anchor downsampling against the JAX
package's on a small scene: keys exact, moments to 1e-12 relative."""

import numpy as np
import pytest

from global_lvba_tpu.map.voxelize import build_voxel_map as jbuild
from global_lvba_tpu.models.synthetic import make_plane_scene as jscene
from global_lvba_tpu.models.synthetic import perturb_poses as jperturb
from global_lvba_tpu.pipeline.downsample import downsample_nearest_center as jds
from global_lvba_tpu_torch.map.voxelize import build_voxel_map
from global_lvba_tpu_torch.models.synthetic import (
    ate_rmse, make_plane_scene, perturb_poses)
from global_lvba_tpu_torch.pipeline.downsample import downsample_nearest_center


@pytest.fixture(scope="module")
def scene():
    return make_plane_scene(num_frames=6, points_per_frame=1500, seed=4)


def test_scene_and_perturbation_match_jax(scene):
    ref = jscene(num_frames=6, points_per_frame=1500, seed=4)
    np.testing.assert_array_equal(scene.points_body, ref.points_body)
    np.testing.assert_array_equal(scene.R_true, ref.R_true)
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.01, 0.02, seed=3)
    Rj, pj = jperturb(ref.R_true, ref.p_true, 0.01, 0.02, seed=3)
    np.testing.assert_array_equal(Rp, Rj)
    np.testing.assert_array_equal(pp, pj)
    assert ate_rmse(pp, scene.p_true) > 0


@pytest.mark.parametrize("voxel,ratios", [(1.0, (0.2,) * 4),
                                          (2.0, (0.1,) * 4)])
def test_voxel_map_matches_jax(scene, voxel, ratios):
    args = (scene.points_body, scene.frame_ids, scene.R_true, scene.p_true,
            voxel)
    vm = build_voxel_map(*args, eigen_ratios=ratios)
    ref = jbuild(*args, eigen_ratios=ratios)
    assert vm.num_planes == ref.num_planes > 0
    assert vm.stats == ref.stats
    for a, b in zip(vm.lookup.plane_keys + vm.lookup.subdiv_keys,
                    ref.lookup.plane_keys + ref.lookup.subdiv_keys):
        np.testing.assert_array_equal(a, b)
    assert len(vm.buckets) == len(ref.buckets)
    for b, r in zip(vm.buckets, ref.buckets):
        np.testing.assert_array_equal(b.n, r.n)
        np.testing.assert_array_equal(b.frame, r.frame)
        for x, y in ((b.mu, r.mu), (b.Pc, r.Pc)):
            assert np.max(np.abs(x - y)) <= 1e-12 * max(np.max(np.abs(y)), 1.0)
    q = scene.points_body[:500].astype(np.float64) + 0.1
    np.testing.assert_array_equal(vm.lookup.query(q), ref.lookup.query(q))


def test_downsample_matches_jax(scene):
    pts = scene.points_body[:4000]
    np.testing.assert_array_equal(downsample_nearest_center(pts, 0.1),
                                  jds(pts, 0.1))
