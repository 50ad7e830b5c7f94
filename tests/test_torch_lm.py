"""Damped LM of the PyTorch port against the JAX package (float64, CPU):
poses at the 1e-8 of tests/test_aligned_layout.py on both reduced-solve
branches and on both layouts (aligned; bucketed on a box room and a
corridor), the zero-observation frame of tests/test_lm.py, the JAX
package's opt-in gather tables and aligned banded groups on a small
bucketed scene, and the inputs the port refuses."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.factors import padding as jpad
from global_lvba_tpu.map.voxelize import build_voxel_map
from global_lvba_tpu.models.synthetic import (
    ate_rmse, make_corridor_scene, make_plane_scene, perturb_poses)
from global_lvba_tpu.solver import dist_solve as jds, lm as jlm
from global_lvba_tpu_torch.factors.padding import from_jax_arrays
from global_lvba_tpu_torch.factors.plane_eigen import (
    PlaneFactorArrays, build_banded_groups)
from global_lvba_tpu_torch.solver import dist_solve, lm

F64 = torch.float64


def _problem(W, ppf, seed, extra_frame=False):
    scene = make_plane_scene(num_frames=W, points_per_frame=ppf, seed=seed)
    vm = build_voxel_map(
        scene.points_body, scene.frame_ids, scene.R_true, scene.p_true,
        voxel_size=1.0, eigen_ratios=(0.2,) * 4,
    )
    R0, p0 = scene.R_true, scene.p_true
    if extra_frame:     # a frame that observes nothing
        R0 = np.concatenate([R0, np.eye(3)[None]])
        p0 = np.concatenate([p0, np.array([[50.0, 50.0, 50.0]])])
    Wt = R0.shape[0]
    Rp, pp = perturb_poses(R0, p0, 0.004, 0.012, seed=seed + 1)
    ja = jpad.aligned_to_device(vm.buckets, Wt, dtype=jnp.float64)
    fa = from_jax_arrays(ja.n, ja.mu, ja.Pc, device="cpu", dtype=F64)
    return scene, ja, fa, Rp, pp


@pytest.fixture(scope="module")
def w64():
    return _problem(64, 400, 0)


@pytest.mark.parametrize("solver", ["auto", "cg"])
def test_lm_matches_jax(w64, solver):
    scene, ja, fa, Rp, pp = w64
    ref = jlm.lm_damping_iter([ja], jnp.asarray(Rp), jnp.asarray(pp),
                              max_iters=6, reduced_solver=solver)
    got = lm.lm_damping_iter([fa], torch.as_tensor(Rp), torch.as_tensor(pp),
                             max_iters=6, reduced_solver=solver)
    assert got.iters == int(ref.iters)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-8)
    assert np.isclose(float(got.residual), float(ref.residual), rtol=1e-8)
    assert ate_rmse(got.p.numpy(), scene.p_true) < 0.6 * ate_rmse(pp, scene.p_true)


@pytest.mark.parametrize("solver", ["lu", "cg"])
def test_unconstrained_frame_stays_fixed(solver):
    scene, ja, fa, Rp, pp = _problem(10, 1500, 2, extra_frame=True)
    got = lm.lm_damping_iter([fa], torch.as_tensor(Rp), torch.as_tensor(pp),
                             max_iters=8, reduced_solver=solver)
    p = got.p.numpy()
    assert np.isfinite(p).all()
    assert ate_rmse(p[:10], scene.p_true) < 0.5 * ate_rmse(pp[:10], scene.p_true)
    np.testing.assert_allclose(p[10], pp[10], rtol=0, atol=1e-9)
    ref = jlm.lm_damping_iter([ja], jnp.asarray(Rp), jnp.asarray(pp),
                              max_iters=8, reduced_solver=solver)
    np.testing.assert_allclose(p, np.asarray(ref.p), rtol=0, atol=1e-8)


def test_nielsen_update_matches_jax():
    for res1, res2, q1, u, v in [(1.0, 0.5, 0.6, 0.01, 2.0),
                                 (1.0, 1.2, 0.6, 0.01, 4.0),
                                 (2.0, 2.0, 0.0, 0.1, 2.0)]:
        args = [torch.tensor(x, dtype=F64) for x in (res1, res2, q1, u, v)]
        got = lm._nielsen_update(*args, 1e-6)
        ref = jlm._nielsen_update(*[jnp.asarray(x) for x in (res1, res2, q1, u, v)],
                                  1e-6)
        for a, b in zip(got, ref):
            assert float(a) == float(b)


def test_block_inverse_and_cg_match_jax():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(60, 60))
    H = X @ X.T + 60 * np.eye(60)
    g = rng.normal(size=60)
    D = H.reshape(10, 6, 10, 6)[np.arange(10), :, np.arange(10), :]
    np.testing.assert_allclose(dist_solve.inv_blocks_6x6(torch.as_tensor(D)).numpy(),
                               np.linalg.inv(D), rtol=1e-10, atol=1e-12)
    got = dist_solve.solve_damped_cg(torch.as_tensor(H), torch.as_tensor(g),
                                     torch.tensor(0.01, dtype=F64))
    ref = jds.solve_damped_cg(jnp.asarray(H), jnp.asarray(g), jnp.asarray(0.01))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("scene", ["plane", "corridor"])
def test_bucketed_lm_matches_jax(scene):
    if scene == "plane":
        W, sc = 24, make_plane_scene(num_frames=24, points_per_frame=600,
                                     seed=3)
    else:
        W, sc = 48, make_corridor_scene(num_frames=48, points_per_frame=2000,
                                        seed=0)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.004, 0.015, seed=1)
    ja = jpad.buckets_to_device(vm, dtype=jnp.float64, W=W)
    fas = [from_jax_arrays(b.n, b.mu, b.Pc, device="cpu", dtype=F64,
                           frame=b.frame) for b in ja]
    assert all(isinstance(fa, PlaneFactorArrays) for fa in fas)
    ref = jlm.lm_damping_iter(ja, jnp.asarray(Rp), jnp.asarray(pp),
                              max_iters=6)
    got = lm.lm_damping_iter(fas, torch.as_tensor(Rp), torch.as_tensor(pp),
                             max_iters=6)
    assert got.iters == int(ref.iters)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-8)
    assert np.isclose(float(got.residual), float(ref.residual), rtol=1e-8)
    assert ate_rmse(got.p.numpy(), sc.p_true) < 0.6 * ate_rmse(pp, sc.p_true)


def test_bucketed_input_raises(w64):
    """The JAX package's opt-in gather tables and aligned banded groups
    agree with the JAX package on a small bucketed plane scene: the
    gather LM's poses within 1e-8, the aligned groups array for array.
    cg_mf on aligned factor arrays raises ValueError as in the JAX
    package, and anything but factor arrays TypeError."""
    W = 8
    sc = make_plane_scene(num_frames=W, points_per_frame=400, seed=0)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    Rq, pq = perturb_poses(sc.R_true, sc.p_true, 0.004, 0.012, seed=2)
    ja = jpad.buckets_to_device(vm, dtype=jnp.float64, W=W,
                                layout="bucketed")
    fas = [from_jax_arrays(b.n, b.mu, b.Pc, device="cpu", dtype=F64,
                           frame=b.frame) for b in ja]
    got = lm.lm_damping_iter(fas, torch.as_tensor(Rq), torch.as_tensor(pq),
                             max_iters=4, gather_tables=True)
    ref = jlm.lm_damping_iter(ja, jnp.asarray(Rq), jnp.asarray(pq),
                              max_iters=4, gather_tables=True)
    assert got.route == "gather" and got.iters == int(ref.iters)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=0,
                               atol=1e-8)
    from global_lvba_tpu.factors.plane_eigen import (
        build_banded_groups as jbuild)
    jb, tg = jbuild(ja[0], W, aligned=True), build_banded_groups(
        fas[0], W, aligned=True)
    for a, b in zip(jb.fa, tg.fa):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jb.offset), tg.offset.numpy())
    _, _, fa_al, Rp, pp = w64
    with pytest.raises(ValueError, match="cg_mf"):
        lm.lm_damping_iter([fa_al], torch.as_tensor(Rp), torch.as_tensor(pp),
                           reduced_solver="cg_mf")
    with pytest.raises(TypeError):
        lm.lm_damping_iter([object()], torch.eye(3, dtype=F64)[None],
                           torch.zeros(1, 3, dtype=F64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cg_zero_gradient_stops_at_once(dtype):
    """A zero gradient stops the iterate at once: it converges on the
    first trip and the state freezes there, while the fixed-trip loop
    runs its 48 trips on the frozen direction with no read to the host
    (what stops is the iterate, no longer the loop)."""
    H = torch.eye(12, dtype=dtype) * 2.0
    trips = []

    def matvec(x):
        trips.append(x.clone())
        return H @ x

    x = dist_solve._pcg(matvec, lambda r: r, torch.zeros(12, dtype=dtype),
                        max_iters=48, tol=1e-10)
    assert len(trips) == 48 and torch.equal(x, torch.zeros(12, dtype=dtype))
    assert all(torch.equal(t, trips[0]) for t in trips)
    dx = dist_solve.solve_damped_cg(H, torch.zeros(12, dtype=dtype),
                                    torch.tensor(0.01, dtype=dtype),
                                    max_iters=48)
    assert torch.equal(dx, torch.zeros(12, dtype=dtype))
