"""Morton-range spatial partitions and the distributed voxel moments of the
PyTorch port (CPU shards), after tests/test_spatial.py: the Morton codes
(host and device) against the JAX package's, partition contiguity and
balance, distributed moments == host moments == the JAX package's
host_voxel_moments, the capacity overflow, a voxel split over every shard,
and the LM on Morton-partitioned buckets == the local LM (float64)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.map.voxelize import build_voxel_map as jbuild
from global_lvba_tpu.models.synthetic import make_plane_scene, perturb_poses
from global_lvba_tpu.parallel import spatial as jsp
from global_lvba_tpu_torch.factors.plane_eigen import bucket_to_device
from global_lvba_tpu_torch.map.voxelize import build_voxel_map
from global_lvba_tpu_torch.parallel import spatial
from global_lvba_tpu_torch.parallel.mesh import make_mesh
from global_lvba_tpu_torch.parallel.shard import lm_damping_iter_sharded
from global_lvba_tpu_torch.solver.lm import lm_damping_iter

F64 = torch.float64


def _mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def test_morton_roundtrip_locality_and_device_codes():
    rng = np.random.default_rng(0)
    coords = rng.integers(-500, 500, size=(1000, 3))
    codes = spatial.morton3(coords)
    np.testing.assert_array_equal(codes, jsp.morton3(coords))
    assert codes.dtype == np.uint32
    assert np.unique(codes).shape[0] == np.unique(coords, axis=0).shape[0]
    dev = spatial.morton3_device(torch.as_tensor(coords, dtype=torch.int32))
    assert dev.dtype == torch.int64
    np.testing.assert_array_equal(dev.numpy(), codes.astype(np.int64))
    np.testing.assert_array_equal(
        dev.numpy(), np.asarray(jsp.morton3_device(
            jnp.asarray(coords, jnp.int32))).astype(np.int64))
    # neighbours along an axis share the high bits more often than not
    near = spatial.morton3(coords + np.array([1, 0, 0]))
    assert np.median(np.abs(near.astype(np.int64) - codes)) < 1 << 12
    with pytest.raises(ValueError, match="Morton range"):
        spatial.morton3(np.array([[600, 0, 0]]))


def test_spatial_partition_contiguity():
    rng = np.random.default_rng(1)
    centers = rng.uniform(-50, 50, size=(4096, 3))
    order, shard = spatial.spatial_partition(centers, 1.0, 8)
    jorder, jshard = jsp.spatial_partition(centers, 1.0, 8)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(shard, jshard)
    codes = spatial.morton3(np.floor(centers).astype(np.int64))
    for s in range(8):
        sel = shard == s
        lo, hi = codes[sel].min(), codes[sel].max()
        others = codes[~sel].astype(np.int64)
        assert not np.any((others >= lo) & (others <= hi))
    counts = np.bincount(shard, minlength=8)
    assert counts.max() - counts.min() <= 1


@pytest.mark.parametrize("n", [2, 3, 8])
def test_distributed_moments_match_host_and_jax(n):
    """Points sharded by arrival, binned per shard and passed around the
    ring: counts and keys exactly the host binning's (and the JAX
    package's host binning's), sums within float32 rounding; bitwise
    repeatable."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-20, 20, size=(20000, 3)).astype(np.float32)
    cap = 4096 if n == 8 else 12000
    kk, cc, ss, mm = spatial.distributed_voxel_moments(pts, 1.0, _mesh(n),
                                                       capacity=cap)
    hk, hc, hs, hm = spatial.host_voxel_moments(pts.astype(np.float64), 1.0)
    jk, jc, js_, jm = jsp.host_voxel_moments(pts.astype(np.float64), 1.0)
    for a, b in zip((hk, hc, hs, hm), (jk, jc, js_, jm)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(kk, hk)
    np.testing.assert_array_equal(cc, hc)
    np.testing.assert_allclose(ss, hs, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mm, hm, rtol=1e-4, atol=1e-2)
    again = spatial.distributed_voxel_moments(pts, 1.0, _mesh(n),
                                              capacity=cap)
    assert all(np.array_equal(a, b) for a, b in zip((kk, cc, ss, mm), again))


def test_capacity_overflow_raises():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-200, 200, size=(20000, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="capacity overflow"):
        spatial.distributed_voxel_moments(pts, 1.0, _mesh(8), capacity=64)


def test_boundary_voxel_merges():
    """One voxel's points spread over every shard (the pure-halo case): its
    owner receives every partial."""
    rng = np.random.default_rng(3)
    target = rng.uniform(0.1, 0.9, size=(64, 3)).astype(np.float32)
    filler = rng.uniform(5, 15, size=(960, 3)).astype(np.float32)
    pts = np.concatenate([target, filler])[rng.permutation(1024)]
    kk, cc, ss, _ = spatial.distributed_voxel_moments(pts, 1.0, _mesh(8),
                                                      capacity=1024)
    key0 = spatial.morton3(np.zeros((1, 3), np.int64))[0]
    row = np.searchsorted(kk, key0)
    assert kk[row] == key0 and cc[row] == 64
    np.testing.assert_allclose(ss[row], target.astype(np.float64).sum(0),
                               rtol=1e-5)


def test_lm_on_morton_partitioned_buckets():
    """Morton-reordered buckets give the local LM's poses, alone and through
    the sharded CG LM (tests/test_spatial.py:103), and their rows are the
    JAX package's partition.  (The local LM is held to the JAX package's
    in tests/test_torch_lm.py.)"""
    sc = make_plane_scene(num_frames=6, points_per_frame=1500, seed=0)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    jvm = jbuild(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                 voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.01, 0.02, seed=1)
    R0, p0 = torch.as_tensor(Rp), torch.as_tensor(pp)
    part = spatial.partition_buckets_morton(vm, 8)
    for a, b in zip(part, jsp.partition_buckets_morton(jvm, 8)):
        for x, y in zip((a.n, a.mu, a.Pc, a.frame), (b.n, b.mu, b.Pc,
                                                     b.frame)):
            np.testing.assert_array_equal(x, y)
    base = lm_damping_iter([bucket_to_device(b, F64, "cpu")
                            for b in vm.buckets], R0, p0, max_iters=5)
    dev = [bucket_to_device(b, F64, "cpu") for b in part]
    res = lm_damping_iter(dev, R0, p0, max_iters=5)
    np.testing.assert_allclose(res.p.numpy(), base.p.numpy(), rtol=0,
                               atol=1e-10)
    shd = lm_damping_iter_sharded(dev, R0, p0, _mesh(8), max_iters=5,
                                  reduced_solver="cg")
    np.testing.assert_allclose(shd.p.numpy(), base.p.numpy(), rtol=0,
                               atol=1e-8)
