"""The multi-device layer of the PyTorch port (float64, CPU shards): meshes
and the reduction, the factor-sharded evaluation and LM (a factors x
frames mesh too), the row-sharded CG, the sharded visual Schur solve and
its route, and the dry run, on meshes of n in {2, 3, 8} CPU shards (n = 3
pads), each held to the port's local result and to the JAX package's local
result at 1e-8 (the JAX package certifies its own sharded == local in
tests/test_parallel.py, MULTICHIP_r05.json).  Fixtures:
tests/test_parallel.py's make_plane_scene(6, 2000) and visual scene (M=6,
P=90).  The banded half is tests/test_torch_parallel_banded.py."""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.factors import plane_eigen as jpe
from global_lvba_tpu.map.voxelize import build_voxel_map
from global_lvba_tpu.models.synthetic import make_plane_scene, perturb_poses
from global_lvba_tpu.parallel import mesh as jmesh
from global_lvba_tpu.solver import dist_solve as jds, lm as jlm, schur as js
from global_lvba_tpu_torch.factors import plane_eigen as pe
from global_lvba_tpu_torch.parallel import mesh as pmesh, shard
from global_lvba_tpu_torch.parallel.dryrun import dryrun_multichip
from global_lvba_tpu_torch.solver import dist_solve, lm, schur

sys.path.insert(0, str(Path(__file__).parent))
from test_visual_ba import CAM as JCAM, make_visual_scene  # noqa: E402

F64 = torch.float64
TOL = 1e-8
NS = (2, 3, 8)
VISUAL_ITERS = 4   # the cost falls 4602 -> 3.6e-4 in 4 (1.7e-7 in 10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the CG loops' small ops stall on thread
    hand-offs when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n, names=("factors",), shape=None):
    return pmesh.make_mesh(n, names, shape, devices=["cpu"] * n)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _d(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _buckets(vm):
    return ([jpe.bucket_to_device(b, dtype=jnp.float64) for b in vm.buckets],
            [pe.bucket_to_device(b, dtype=F64, device="cpu")
             for b in vm.buckets])


@pytest.fixture(scope="module")
def memo():
    """A module-wide cache of local results: memo(key, fn) runs fn once."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    return get


@pytest.fixture(scope="module")
def plane():
    """tests/test_parallel.py's build(seed=1): W=6, 2,000 points a frame."""
    sc = make_plane_scene(num_frames=6, points_per_frame=2000, noise=0.003,
                          seed=1)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    jb, tb = _buckets(vm)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.01, 0.03, seed=3)
    return jb, tb, Rp, pp


@pytest.fixture(scope="module")
def jax_local(plane):
    """The JAX package's local LM of the plane scene, by solver, each
    computed once: its host-driven form (lm_damping_iter_split with the
    dense H: the same evaluation and Nielsen schedule, 4e-14 from its fused
    lm_damping_iter here), whose two solvers share their evaluation's
    executables (6 s of compiles against 16)."""
    cache = {}

    def get(solver):
        if solver not in cache:
            jb, _, Rp, pp = plane
            cache[solver] = jlm.lm_damping_iter_split(
                jb, jnp.asarray(Rp), jnp.asarray(pp), max_iters=6,
                reduced_solver=solver, hessian="dense")
        return cache[solver]

    return get


# ---------------------------------------------------------------------------
# Meshes and the reduction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,names,shape", [
    (8, ("factors",), None), (8, ("factors", "frames"), None),
    (6, ("factors", "frames"), None), (3, ("factors", "frames"), None),
    (8, ("factors", "frames"), (4, 2)), (8, ("a", "b", "c"), (2, 2, 2))])
def test_make_mesh_shape_rule_matches_jax(n, names, shape):
    m = _mesh(n, names, shape)
    jm = jmesh.make_mesh(n, names, shape)
    assert dict(m.shape) == dict(jm.shape)
    assert m.first == torch.device("cpu") and m.world == 1
    assert m.axis_devices(names[0]) == [torch.device("cpu")] * m.shape[
        names[0]]


def test_make_mesh_needs_cuda_devices_and_explicit_shapes():
    """Without devices= the mesh takes CUDA devices and raises when fewer
    exist (this machine has none); nothing falls back to the CPU.  Three
    axes need a shape, as in JAX."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count() + 1
    else:
        n = 1
    with pytest.raises(RuntimeError, match="CUDA device"):
        pmesh.make_mesh(n)
    with pytest.raises(ValueError, match="explicit shape"):
        _mesh(8, ("a", "b", "c"))
    with pytest.raises(ValueError):
        pmesh.make_mesh(4, devices=["cpu"] * 2)


def test_psum_sums_in_shard_order():
    rng = np.random.default_rng(0)
    parts = [_t(rng.normal(size=(5, 3)) * 10.0 ** k) for k in range(4)]
    got = pmesh.psum(parts, _mesh(4))
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(got, want)
    a, b = pmesh.psum([(p, p[0]) for p in parts], _mesh(4))
    assert torch.equal(a, want) and torch.equal(b, want[0])


# ---------------------------------------------------------------------------
# Factor sharding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
def test_shard_buckets_pads_and_splits(plane, n):
    from global_lvba_tpu.parallel.shard import _pad_rows_to as jpad

    jb, tb, _, _ = plane
    sb = shard.shard_buckets(tb, _mesh(n))
    for s, fa, jfa in zip(sb, tb, jb):
        Vp = -(-fa.n.shape[0] // n) * n
        assert s.rows == Vp and len(s.shards) == n
        want = jpad(jfa, n)
        for got, w in zip(zip(*s.shards), want):
            np.testing.assert_array_equal(torch.cat(got).numpy(),
                                          np.asarray(w))


@pytest.mark.parametrize("n", NS)
def test_sharded_cost_grad_hess_matches_local_and_jax(plane, n):
    """(r, g, H) of a sharded bucket == the port's local and the JAX
    package's evaluation, and two sharded runs are bitwise equal."""
    jb, tb, Rp, pp = plane
    W = 6
    mesh = _mesh(n)
    got = shard.sharded_cost_grad_hess(tb[0], _t(Rp), _t(pp), W, mesh)
    loc = pe.plane_cost_grad_hess(tb[0], _t(Rp), _t(pp), W)
    want = jax.jit(jpe.plane_cost_grad_hess, static_argnums=3)(
        jb[0], jnp.asarray(Rp), jnp.asarray(pp), W)
    for a, b, c in zip(got, loc, want):
        scale = max(float(b.abs().max()), 1.0)
        assert _d(a, b) <= TOL * scale and _d(a, c) <= TOL * scale
    again = shard.sharded_cost_grad_hess(tb[0], _t(Rp), _t(pp), W, mesh)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("solver", ["lu", "cg"])
@pytest.mark.parametrize("n", NS)
def test_lm_sharded_matches_local_and_jax(plane, jax_local, memo, n,
                                          solver):
    """The factor-sharded LM == the port's local LM and the JAX package's
    local LM; its averaged residual counts the padded rows, as the JAX
    package's sharded LM does."""
    jb, tb, Rp, pp = plane
    R0, p0 = _t(Rp), _t(pp)
    got = shard.lm_damping_iter_sharded(tb, R0, p0, _mesh(n), max_iters=6,
                                        reduced_solver=solver)
    loc = memo(("lm", solver), lambda: lm.lm_damping_iter(
        tb, R0, p0, max_iters=6, reduced_solver=solver))
    ref = jax_local(solver)
    assert got.route == "sharded-dense" and got.iters == loc.iters
    for a, b, c in ((got.R, loc.R, ref.R), (got.p, loc.p, ref.p)):
        assert _d(a, b) < TOL and _d(a, c) < TOL
    g_loc = sum(fa.n.shape[0] for fa in tb)
    g_pad = sum(-(-fa.n.shape[0] // n) * n for fa in tb)
    assert abs(float(got.residual) * g_pad - float(ref.residual) * g_loc) \
        <= TOL * float(ref.residual) * g_loc


def test_lm_sharded_cg_mf_runs_replicated(plane):
    """reduced_solver="cg_mf" on a mesh runs the matrix-free rows route
    replicated on the padded rows (as the JAX package's warns it does): the
    local rows LM's poses."""
    _, tb, Rp, pp = plane
    R0, p0 = _t(Rp), _t(pp)
    got = shard.lm_damping_iter_sharded(tb, R0, p0, _mesh(3), max_iters=3,
                                        reduced_solver="cg_mf")
    loc = lm.lm_damping_iter(tb, R0, p0, max_iters=3, reduced_solver="cg_mf")
    assert got.route == loc.route == "rows"
    assert _d(got.p, loc.p) < TOL and _d(got.R, loc.R) < TOL


@pytest.mark.parametrize("solver", ["lu", "cg"])
def test_factors_frames_mesh_matches_local(plane, jax_local, memo, solver):
    """A factors x frames mesh (4, 2): the LU on the first device, H
    row-sharded over frames for the CG matvec."""
    jb, tb, Rp, pp = plane
    R0, p0 = _t(Rp), _t(pp)
    got = shard.lm_damping_iter_sharded(
        tb, R0, p0, _mesh(8, ("factors", "frames"), (4, 2)), max_iters=6,
        reduced_solver=solver)
    loc = memo(("lm", solver), lambda: lm.lm_damping_iter(
        tb, R0, p0, max_iters=6, reduced_solver=solver))
    assert _d(got.p, loc.p) < TOL and _d(got.R, loc.R) < TOL
    assert _d(got.p, jax_local(solver).p) < TOL


@pytest.mark.parametrize("n", NS)
def test_row_sharded_cg_matches_local_and_jax(plane, n):
    """solve_damped_cg with H row-sharded over n devices == the unsharded
    solve and the JAX package's solve_damped_cg."""
    jb, tb, Rp, pp = plane
    W = 6
    _, g, H = lm._total_cgh(tb, None, _t(Rp), _t(pp), W)
    u = torch.tensor(0.01, dtype=F64)
    got = dist_solve.solve_damped_cg(H, g, u, max_iters=48,
                                     h_sharding=["cpu"] * n)
    loc = dist_solve.solve_damped_cg(H, g, u, max_iters=48)
    want = jax.jit(jds.solve_damped_cg, static_argnums=(3, 4))(
        jnp.asarray(H.numpy()), jnp.asarray(g.numpy()), jnp.asarray(0.01), 6,
        48)
    scale = float(loc.abs().max())
    assert _d(got, loc) <= 1e-10 * scale and _d(got, want) <= TOL * scale
    assert [b for b in dist_solve.row_blocks(36, 6, 8)] == [
        (0, 6), (6, 12), (12, 18), (18, 24), (24, 30), (30, 36), (36, 36),
        (36, 36)]


# ---------------------------------------------------------------------------
# The sharded visual solve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def visual():
    """tests/test_parallel.py:TestVisualBASharded's problem."""
    R, t, X, pn, pd, oc, op, uv = make_visual_scene(M=6, P=90, seed=11)
    rng = np.random.default_rng(12)
    t0 = t + rng.normal(scale=0.02, size=t.shape)
    t0[0] = t[0]
    X0 = X + rng.normal(scale=0.03, size=X.shape)
    arrays = dict(obs_cam=oc, obs_pt=op, obs_uv=uv, plane_n=pn, plane_d=pd,
                  num_cams=R.shape[0], num_pts=X.shape[0])
    from global_lvba_tpu_torch.geometry.camera import CameraModel

    return arrays, R, t0, X0, CameraModel(*JCAM), {}


@pytest.mark.parametrize("rs", ["auto", "cg", "cg_mf"])
@pytest.mark.parametrize("n", NS)
def test_visual_sharded_matches_local_and_jax(visual, memo, n, rs):
    """solve_visual_ba(mesh=) == the local solve (the port's and the JAX
    package's) at 1e-8; its route is the JAX package's mesh route."""
    arrays, R0, t0, X0, cam, jcache = visual
    prob = schur.VisualBAProblem(cam=cam, **arrays, reduced_solver=rs)
    got = schur.solve_visual_ba(prob, R0, t0, X0, max_iters=VISUAL_ITERS,
                                dtype=F64, mesh=_mesh(n))
    loc = memo(("visual", rs), lambda: schur.solve_visual_ba(
        prob, R0, t0, X0, max_iters=VISUAL_ITERS, dtype=F64, device="cpu"))
    if rs not in jcache:
        jcache[rs] = js.solve_visual_ba(
            js.VisualBAProblem(cam=JCAM, **arrays, reduced_solver=rs), R0,
            t0, X0, max_iters=VISUAL_ITERS)
    ref = jcache[rs]
    assert got.route == {"auto": "lu"}.get(rs, rs)
    assert got.iters == loc.iters == ref.iters
    for a, b, c in ((got.R, loc.R, ref.R), (got.t, loc.t, ref.t),
                    (got.X, loc.X, ref.X)):
        assert _d(a, b) < TOL and _d(a, c) < TOL
    # the noise-free scene's cost falls to ~1e-7: compare to cost0's scale
    assert abs(got.cost - ref.cost) <= 1e-10 * ref.cost0


@pytest.mark.parametrize("M", [6, 200])
def test_visual_mesh_route_matches_jax_auto_solver(M):
    """The mesh route of "auto" is _auto_solver(M, pairs_sharded=True, Q),
    the JAX package's; "cg_mf" on a mesh is the per-observation matvec."""
    rng = np.random.default_rng(M)
    O, P = 40 * M, 10 * M
    arrays = dict(obs_cam=rng.integers(0, M, O).astype(np.int32),
                  obs_pt=rng.integers(0, P, O).astype(np.int32),
                  obs_uv=np.zeros((O, 2)), plane_n=np.zeros((P, 3)),
                  plane_d=np.zeros(P), num_cams=M, num_pts=P)
    counts = np.bincount(arrays["obs_pt"], minlength=P)
    want = js._auto_solver(M, pairs_sharded=True, Q=int((counts ** 2).sum()))
    prob = schur.VisualBAProblem(cam=None, **arrays)
    assert schur._route(prob, F64, False, sharded=True)[0] == want
    assert want == ("cg" if M == 200 else "lu")
    prob.reduced_solver = "cg_mf"
    assert schur._route(prob, F64, False, sharded=True) == ("cg_mf", None)


def test_dryrun_multichip_on_cpu_shards():
    """dryrun_multichip(4, devices=["cpu"] * 4): every check of the JAX
    package's dry run, the gather-plan LM among them, sharded (or the
    gather route) == local within 1e-8."""
    out = dryrun_multichip(4, devices=["cpu"] * 4, verbose=False)
    assert set(out) == {"lu", "cg", "gather-plan", "banded-eval", "banded-lm",
                        "banded-compact-lm", "morton+cg", "spatial",
                        "visual-auto", "visual-cg", "visual-cg_mf"}
    assert all(v < TOL for k, v in out.items() if k != "spatial")
