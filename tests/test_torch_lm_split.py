"""The split LM and the routes of lm_damping_iter in the PyTorch port
(float64, CPU).

The parity cases mirror tests/test_lm_split.py:31,45,61 against the JAX
functions: lm_damping_iter_split on the dense and the banded (compact)
evaluation, and the routing of lm_damping_iter to the split at W >=
SPLIT_W (LVBA_SPLIT_W on the JAX side).  A spy on the port's CG functions
holds every route's solver and trip count against the JAX package's
constants (read from its source and signatures): 48 dense, 96 banded, 96
split dense (aligned and bucketed), 96 compact banded, 256 rows; an
aligned solve at W >= SPLIT_W takes the split's 96.  The new routes read
their ids to the host before the first evaluation and then one
`converged` an iteration."""

import inspect
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.factors import padding as jpad
from global_lvba_tpu.map.voxelize import build_voxel_map
from global_lvba_tpu.models.synthetic import (
    make_corridor_scene, make_plane_scene, perturb_poses)
from global_lvba_tpu.solver import dist_solve as jds, lm as jlm
from global_lvba_tpu_torch.factors.padding import (
    aligned_to_device, from_jax_arrays)
from global_lvba_tpu_torch.solver import lm

F64 = torch.float64
HOST_READS = ("__bool__", "item", "tolist", "cpu", "numpy", "__float__",
              "__int__")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the CG loops' thousands of
    small ops (and BLAS calls on small batches) stall on thread hand-offs
    when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(scene):
    """As tests/test_lm_split.py: the voxel map at the true poses, the JAX
    package's buckets and the port's of the same arrays, perturbed poses."""
    vm = build_voxel_map(
        scene.points_body, scene.frame_ids, scene.R_true, scene.p_true,
        voxel_size=1.0, eigen_ratios=(0.2, 0.2, 0.2, 0.2),
    )
    ja = jpad.buckets_to_device(vm, dtype=jnp.float64)
    tb = [from_jax_arrays(b.n, b.mu, b.Pc, device="cpu", dtype=F64,
                          frame=b.frame) for b in ja]
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.004, 0.015, seed=1)
    return vm, ja, tb, Rp, pp


@pytest.fixture(scope="module")
def plane24():
    return _setup(make_plane_scene(num_frames=24, points_per_frame=600,
                                   seed=3))


@pytest.fixture(scope="module")
def corridor96():
    return _setup(make_corridor_scene(num_frames=96, points_per_frame=400,
                                      seed=0))


def _close(got, ref, atol_p=1e-8, rtol_r=1e-8):
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=0,
                               atol=atol_p)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0,
                               atol=atol_p)
    assert np.isclose(float(got.residual), float(ref.residual), rtol=rtol_r)


def test_split_matches_jax_dense(plane24):
    """tests/test_lm_split.py:31: the split on the dense evaluation (LU at
    this W) against the JAX package's split and the port's fused loop."""
    _, ja, tb, Rp, pp = plane24
    R, p = torch.as_tensor(Rp), torch.as_tensor(pp)
    ref = jlm.lm_damping_iter_split(ja, jnp.asarray(Rp), jnp.asarray(pp),
                                    max_iters=6)
    got = lm.lm_damping_iter_split(tb, R, p, max_iters=6)
    fused = lm.lm_damping_iter(tb, R, p, max_iters=6)
    assert got.route == "split-dense" and fused.route == "dense"
    assert got.iters == int(ref.iters) == fused.iters
    _close(got, ref)
    np.testing.assert_allclose(got.p.numpy(), fused.p.numpy(), rtol=1e-8,
                               atol=1e-12)
    assert np.isclose(float(got.residual), float(fused.residual), rtol=1e-9)


def test_split_matches_jax_banded_cg(corridor96):
    """tests/test_lm_split.py:45: the corridor, forced banded Hessian and
    CG: the compact banded split against the JAX package's split and the
    port's banded loop on the dense H."""
    _, ja, tb, Rp, pp = corridor96
    R, p = torch.as_tensor(Rp), torch.as_tensor(pp)
    ref = jlm.lm_damping_iter_split(ja, jnp.asarray(Rp), jnp.asarray(pp),
                                    max_iters=5, hessian="banded",
                                    reduced_solver="cg")
    got = lm.lm_damping_iter_split(tb, R, p, max_iters=5, hessian="banded",
                                   reduced_solver="cg")
    fused = lm.lm_damping_iter(tb, R, p, max_iters=5, hessian="banded",
                               reduced_solver="cg")
    assert got.route == "split-banded" and fused.route == "banded"
    assert got.iters == int(ref.iters) == fused.iters
    _close(got, ref)
    np.testing.assert_allclose(got.p.numpy(), fused.p.numpy(), rtol=1e-8,
                               atol=1e-11)
    np.testing.assert_allclose(got.R.numpy(), fused.R.numpy(), rtol=1e-8,
                               atol=1e-11)


def test_large_w_routes_to_split(plane24, monkeypatch):
    """tests/test_lm_split.py:61: lm_damping_iter at W >= SPLIT_W takes the
    split route and gives the split's result, and the JAX package's
    routed result (LVBA_SPLIT_W there)."""
    _, ja, tb, Rp, pp = plane24
    R, p = torch.as_tensor(Rp), torch.as_tensor(pp)
    direct = lm.lm_damping_iter_split(tb, R, p, max_iters=4)
    monkeypatch.setenv("LVBA_SPLIT_W", "16")
    monkeypatch.setattr(lm, "SPLIT_W", 16)
    ref = jlm.lm_damping_iter(ja, jnp.asarray(Rp), jnp.asarray(pp),
                              max_iters=4)
    routed = lm.lm_damping_iter(tb, R, p, max_iters=4)
    assert routed.route == "split-dense"
    np.testing.assert_allclose(routed.p.numpy(), direct.p.numpy(),
                               rtol=1e-10, atol=1e-13)
    assert routed.iters == int(ref.iters)
    _close(routed, ref)


def _jax_trips():
    """The JAX package's CG trips per route, from its source and
    signatures (its environment switches at their defaults)."""
    def num(fn, pattern):
        return int(re.search(pattern, inspect.getsource(fn)).group(1))

    return {
        "dense": num(jlm._lm_jitted, r'LVBA_LIDAR_CG_ITERS", "(\d+)"'),
        "banded": num(jlm._lm_banded_jitted, r"max_iters=(\d+)"),
        "split-dense": num(jlm._solve_exec, r"max_iters=(\d+)"),
        "split-banded": inspect.signature(
            jds.solve_damped_cg_banded).parameters["max_iters"].default,
        "rows": inspect.signature(
            jds.solve_damped_cg_rows).parameters["max_iters"].default,
    }


# route -> (problem, lm_damping_iter keywords, SPLIT_W, the CG function
# the route must call)
ROUTES = {
    "dense": ("plane", dict(reduced_solver="cg"), None, "solve_damped_cg"),
    "banded": ("corridor", dict(reduced_solver="cg", hessian="banded"), None,
               "solve_damped_cg"),
    "split-dense aligned": ("aligned", dict(reduced_solver="cg"), 64,
                            "solve_damped_cg"),
    "split-dense": ("plane", dict(reduced_solver="cg", hessian="dense"), 16,
                    "solve_damped_cg"),
    "split-banded": ("corridor", dict(hessian="banded"), 16,
                     "solve_damped_cg_banded"),
    "rows": ("plane", dict(reduced_solver="cg_mf"), 16,
             "solve_damped_cg_rows"),
}


def _spy(monkeypatch):
    calls = []
    for name in ("solve_damped_cg", "solve_damped_cg_banded",
                 "solve_damped_cg_rows"):
        real = getattr(lm, name)

        def spy(*a, _name=name, _real=real, **k):
            calls.append((_name, k["max_iters"]))
            return _real(*a, **k)

        monkeypatch.setattr(lm, name, spy)
    return calls


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_solver_and_trips(plane24, corridor96, monkeypatch, case):
    problem, kw, split_w, fn = ROUTES[case]
    route = case.split()[0]
    if problem == "aligned":
        vm, _, _, Rp, pp = _setup(make_plane_scene(num_frames=64,
                                                   points_per_frame=400,
                                                   seed=0))
        bs = [aligned_to_device(vm.buckets, 64, dtype=F64, device="cpu")]
    else:
        _, _, bs, Rp, pp = plane24 if problem == "plane" else corridor96
    if split_w is not None:
        monkeypatch.setattr(lm, "SPLIT_W", split_w)
    calls = _spy(monkeypatch)
    res = lm.lm_damping_iter(bs, torch.as_tensor(Rp), torch.as_tensor(pp),
                             max_iters=2, **kw)
    assert res.route == route
    assert len(calls) == res.iters and res.iters >= 1
    assert set(calls) == {(fn, _jax_trips()[route])}
    assert _jax_trips() == {"dense": lm.LIDAR_CG_ITERS,
                            "banded": lm.BANDED_CG_ITERS,
                            "split-dense": lm.BANDED_CG_ITERS,
                            "split-banded": lm.BANDED_CG_ITERS,
                            "rows": lm.ROWS_CG_ITERS}


@pytest.mark.parametrize("case", ["split-banded", "rows"])
def test_new_routes_read_ids_first_then_converged(plane24, corridor96,
                                                  monkeypatch, case):
    """The compact banded and the rows routes read each bucket's ids and
    counts to the host once (cpu, numpy) before their first evaluation,
    then one `converged` an iteration and nothing else."""
    if case == "split-banded":
        _, _, bs, Rp, pp = corridor96
        kw = dict(hessian="banded")
    else:
        _, _, bs, Rp, pp = plane24
        kw = dict(reduced_solver="cg_mf")
    R0, p0 = torch.as_tensor(Rp), torch.as_tensor(pp)
    monkeypatch.setattr(lm, "SPLIT_W", 16)
    want = lm.lm_damping_iter(bs, R0, p0, max_iters=3, **kw)
    events = []

    def record(name, real):
        def f(self, *a, **k):
            events.append(name)
            return real(self, *a, **k)
        return f

    def refuse(name):
        def f(self, *a, **k):
            raise AssertionError(f"host read {name}")
        return f

    for name in HOST_READS:
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, record(name, real)
                            if name in ("__bool__", "cpu", "numpy")
                            else refuse(name))
    got = lm.lm_damping_iter(bs, R0, p0, max_iters=3, **kw)
    monkeypatch.undo()
    first = events.index("__bool__")
    assert events[:first] == ["cpu", "numpy"] * len(bs)
    assert events[first:] == ["__bool__"] * got.iters
    assert got.route == case and torch.equal(got.p, want.p)


def test_raises_name_a3b(plane24):
    """gather_tables=True (the JAX package's GatherPlan evaluation) takes
    the gather route on a bucketed solve and lands on the JAX package's
    poses within 1e-8; an unknown hessian
    raises ValueError, and so does cg_mf on the split LM."""
    _, ja, tb, Rp, pp = plane24
    R, p = torch.as_tensor(Rp), torch.as_tensor(pp)
    got = lm.lm_damping_iter(tb, R, p, max_iters=4, gather_tables=True)
    ref = jlm.lm_damping_iter(ja, jnp.asarray(Rp), jnp.asarray(pp),
                              max_iters=4, gather_tables=True)
    assert got.route == "gather" and got.iters == int(ref.iters)
    _close(got, ref)
    with pytest.raises(ValueError, match="hessian"):
        lm.lm_damping_iter(tb, R, p, hessian="sparse")
    with pytest.raises(ValueError, match="cg_mf"):
        lm.lm_damping_iter_split(tb, R, p, reduced_solver="cg_mf")
