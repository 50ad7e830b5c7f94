"""The visual BA solver of the PyTorch port against the JAX package
(float64, CPU): the reprojection and plane factors, the three
reduced-camera Schur CG solves, solve_visual_ba on every single-device
route, the route choice at its boundaries, and the numpy FD oracle.

The CG solves run the JAX package's trip counts (a spy on the port's
shared PCG loop, held against the JAX signatures), read nothing to the
host, and the LM reads one value an iteration (done, with the costs)."""

import inspect
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from global_lvba_tpu.eval import oracle as joracle
from global_lvba_tpu.factors import reprojection as jrep
from global_lvba_tpu.geometry.camera import CameraModel as JCameraModel
from global_lvba_tpu.solver import dist_solve as jds, schur as js
from global_lvba_tpu_torch.eval.metrics import mean_reprojection_error
from global_lvba_tpu_torch.factors import reprojection as rep
from global_lvba_tpu_torch.geometry.camera import CameraModel
from global_lvba_tpu_torch.models.synthetic import (
    make_joint_scene, perturb_poses)
from global_lvba_tpu_torch.pipeline.depth import camera_world_to_cam
from global_lvba_tpu_torch.solver import dist_solve, schur

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_visual_ba import CAM as JCAM, make_visual_scene  # noqa: E402

F64 = torch.float64
CAM = CameraModel(*JCAM)
HOST_READS = ("__bool__", "item", "tolist", "cpu", "numpy", "__float__",
              "__int__")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the CG loops' thousands of
    small ops stall on thread hand-offs when the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(),
                                                     1e-300)


# ---------------------------------------------------------------------------
# factors/reprojection
# ---------------------------------------------------------------------------


def _random_obs(N=500, seed=0):
    rng = np.random.default_rng(seed)
    R = Rotation.random(N, random_state=seed + 1).as_matrix()
    t = rng.normal(size=(N, 3))
    X = rng.normal(scale=3.0, size=(N, 3))
    uv = rng.uniform(0, 500, size=(N, 2))
    return R, t, X, uv


def test_reprojection_matches_jax():
    """Residuals and closed-form Jacobians against the JAX package's at
    1e-12 relative, with the Z gate exercised."""
    R, t, X, uv = _random_obs()
    got = rep.reproj_jacobians_expanded(CAM, _t(R), _t(t), _t(X), _t(uv), 0.5)
    ref = jrep.reproj_jacobians_expanded(JCAM, jnp.asarray(R), jnp.asarray(t),
                                         jnp.asarray(X), jnp.asarray(uv), 0.5)
    Z = (np.einsum("nij,nj->ni", R, X) + t)[:, 2]
    assert (Z <= 1e-8).sum() > 50
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), b) < 1e-12
    # the batched forms by index
    rng = np.random.default_rng(1)
    oc, op = rng.integers(0, 40, 300), rng.integers(0, 60, 300)
    args = (R[:40], t[:40], X[:60])
    got = rep.reproj_residuals_batch(CAM, *map(_t, args), torch.as_tensor(oc),
                                     torch.as_tensor(op), _t(uv[:300]), 0.5)
    ref = jrep.reproj_residuals_batch(JCAM, *map(jnp.asarray, args),
                                      jnp.asarray(oc), jnp.asarray(op),
                                      jnp.asarray(uv[:300]), 0.5)
    assert _rel(got.numpy(), ref) < 1e-12
    got = rep.reproj_jacobians_batch(CAM, *map(_t, args), torch.as_tensor(oc),
                                     torch.as_tensor(op), _t(uv[:300]), 0.5)
    ref = jrep.reproj_jacobians_batch(JCAM, *map(jnp.asarray, args),
                                      jnp.asarray(oc), jnp.asarray(op),
                                      jnp.asarray(uv[:300]), 0.5)
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), b) < 1e-12


def test_closed_form_matches_jacfwd():
    """The closed form against the port's torch.func.jacfwd oracle."""
    R, t, X, uv = _random_obs(seed=3)
    args = (CAM, _t(R), _t(t), _t(X), _t(uv), 0.5)
    for a, b in zip(rep.reproj_jacobians_expanded(*args),
                    rep._reproj_jacobians_jacfwd(*args)):
        assert _rel(a.numpy(), b.numpy()) < 1e-12


def test_gate_gives_exact_zeros():
    """A point behind the camera, on its plane, or a pad slot (R = 0,
    t = 0) gives exactly zero residual and Jacobians."""
    R = np.stack([np.eye(3), np.eye(3), np.zeros((3, 3))])
    t = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -5.0], [0.0, 0.0, 0.0]])
    X = np.array([[0.1, 0.2, -5.0], [0.3, 0.1, 5.0], [1.0, 2.0, 3.0]])
    uv = np.full((3, 2), 100.0)
    for out in rep.reproj_jacobians_expanded(CAM, _t(R), _t(t), _t(X),
                                             _t(uv), 0.5):
        assert torch.equal(out, torch.zeros_like(out))
    r = rep.reproj_residual(CAM, _t(R), _t(t), _t(X), _t(uv), 0.5)
    assert torch.equal(r, torch.zeros_like(r))


def test_plane_point_matches_jax():
    rng = np.random.default_rng(4)
    n = rng.normal(size=(50, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = rng.normal(size=50)
    X = rng.normal(scale=2.0, size=(50, 3))
    X[0] = -d[0] * n[0]                      # on the plane: e = 0
    got = rep.plane_point_batch(_t(n), _t(d), _t(X), 0.01)
    ref = jrep.plane_point_batch(jnp.asarray(n), jnp.asarray(d),
                                 jnp.asarray(X), 0.01)
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), b) < 1e-12
    one = rep.plane_point_residual(_t(n[1]), _t(d[1]), _t(X[1]), 0.01)
    assert abs(float(one) - float(ref[0][1])) < 1e-12 * abs(float(ref[0][1]))


# ---------------------------------------------------------------------------
# solver/dist_solve: the reduced-camera Schur CG solves
# ---------------------------------------------------------------------------


def _schur_system(seed=3, M=12, P=40, O=200):
    """As tests/test_visual_ba.py::test_point_major_matvec_matches_mf: SPD
    camera blocks, Y = W so that S is SPD, b with row 0 zeroed."""
    rng = np.random.default_rng(seed)
    obs_cam = rng.integers(0, M, size=O).astype(np.int32)
    obs_pt = rng.integers(0, P, size=O).astype(np.int32)
    dHcc = rng.normal(size=(M, 6, 6))
    dHcc = dHcc @ np.swapaxes(dHcc, -1, -2) + 8.0 * np.eye(6)
    W = rng.normal(size=(O, 6, 3)) * 0.2
    b = rng.normal(size=(M, 6))
    b[0] = 0.0
    return dict(M=M, P=P, obs_cam=obs_cam, obs_pt=obs_pt, dHcc=dHcc, W=W,
                Y=W.copy(), b=b)


def _tiers(s):
    """The port's tier layout of the system's observations (CPU)."""
    return dist_solve.pm_tiers(schur._tier_tables(s["obs_cam"], s["obs_pt"],
                                                  s["M"]), s["M"], "cpu")


def _schur_both(kind, s, fix_first=True, max_iters=None):
    """(port dc, JAX dc) of one Schur solve on the system s."""
    kw = dict(fix_first=fix_first)
    if max_iters is not None:
        kw["max_iters"] = max_iters
    j = [jnp.asarray(s[k]) for k in ("dHcc", "W", "Y")]
    t = [_t(s[k]) for k in ("dHcc", "W", "Y")]
    if kind == "mf":
        ref = jds.solve_schur_cg_mf(*j, jnp.asarray(s["obs_cam"]),
                                    jnp.asarray(s["obs_pt"]),
                                    jnp.asarray(s["b"]), s["P"], **kw)
        got = dist_solve.solve_schur_cg_mf(
            *t, torch.as_tensor(s["obs_cam"]), torch.as_tensor(s["obs_pt"]),
            _t(s["b"]), s["P"], **kw)
        return got, ref
    jt = js._point_major_tiers(s["obs_cam"], s["obs_pt"], s["P"], s["M"])
    tt = _tiers(s)
    if kind == "pm":
        ref = jds.solve_schur_cg_pm(*j, jt, jnp.asarray(s["b"]), **kw)
        got = dist_solve.solve_schur_cg_pm(*t, tt, _t(s["b"]), **kw)
        return got, ref
    zrow = np.zeros((1, 6, 3))
    Wp, Yp = (np.concatenate([s[k], zrow]) for k in ("W", "Y"))
    tdat = tuple((jnp.asarray(Wp[np.asarray(q.idx)]),
                  jnp.asarray(Yp[np.asarray(q.idx)]), q.cam) for q in jt)
    ref = jds.solve_schur_cg_pm_tiers(j[0], tdat, jnp.asarray(s["b"]), **kw)
    got = dist_solve.solve_schur_cg_pm_tiers(
        t[0], _t(Wp)[tt.idx], _t(Yp)[tt.idx], tt, _t(s["b"]), **kw)
    return got, ref


@pytest.mark.parametrize("kind", ["mf", "pm", "pm_tiers"])
@pytest.mark.parametrize("fix_first", [True, False])
def test_schur_solves_match_jax(kind, fix_first):
    """Each Schur solve against its JAX counterpart at its default trips
    and with 5 (not converged), within 1e-10 of max |dc|."""
    s = _schur_system()
    for trips in (None, 5):
        got, ref = _schur_both(kind, s, fix_first, trips)
        assert _rel(got.numpy(), ref) < 1e-10, (kind, trips)


def _no_host_reads(monkeypatch, allow=()):
    events = []

    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"host read: Tensor.{name}")
        return f

    def record(name, real):
        def f(self, *a, **k):
            events.append(name)
            return real(self, *a, **k)
        return f

    for name in HOST_READS:
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, record(name, real)
                            if name in allow else refuse(name))
    return events


def test_schur_solves_read_nothing_to_the_host(monkeypatch):
    """With their tables built beforehand (as solve_visual_ba builds
    them), the three solves run with every host read patched to raise."""
    s = _schur_system(seed=5)
    tt = _tiers(s)
    tables = dist_solve.to_device(
        [dist_solve.index_table_np(s["obs_cam"], s["M"]),
         dist_solve.index_table_np(s["obs_pt"], s["P"])], "cpu")
    dHcc, W, Y, b = (_t(s[k]) for k in ("dHcc", "W", "Y", "b"))
    oc, op = torch.as_tensor(s["obs_cam"]), torch.as_tensor(s["obs_pt"])
    Wt = torch.cat([W, W.new_zeros((1, 6, 3))])[tt.idx]
    runs = [
        lambda: dist_solve.solve_schur_cg_mf(dHcc, W, Y, oc, op, b, s["P"],
                                             tables=tables),
        lambda: dist_solve.solve_schur_cg_pm(dHcc, W, Y, tt, b),
        lambda: dist_solve.solve_schur_cg_pm_tiers(dHcc, Wt, Wt, tt, b),
    ]
    want = [run() for run in runs]
    _no_host_reads(monkeypatch)
    got = [run() for run in runs]
    monkeypatch.undo()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# solver/schur: solve_visual_ba on every route
# ---------------------------------------------------------------------------


def _problem(seed=1, M=8, P=120, extra_cams=0, plane_only=False):
    """make_visual_scene with 0.3 px noise (the final cost stays well
    above rounding), perturbed cameras but the first and points; with
    extra_cams, cameras no observation reaches; with plane_only, one point
    no camera observes (planes only)."""
    R, t, X, pn, pd, oc, op, uv = make_visual_scene(M=M, P=P, seed=seed)
    rng = np.random.default_rng(seed + 10)
    uv = uv + rng.normal(scale=0.3, size=uv.shape)
    R0 = R.copy()
    for m in range(1, M):
        R0[m] = R[m] @ Rotation.from_rotvec(
            rng.normal(scale=0.01, size=3)).as_matrix()
    t0 = t + rng.normal(scale=0.02, size=t.shape)
    t0[0] = t[0]
    X0 = X + rng.normal(scale=0.03, size=X.shape)
    if extra_cams:
        R0 = np.concatenate([R0, R[:extra_cams]])
        t0 = np.concatenate([t0, t[:extra_cams] + 5.0])
    if plane_only:
        X0 = np.concatenate([X0, X0[:1] + 0.1])
        pn = np.concatenate([pn, pn[:1]])
        pd = np.concatenate([pd, pd[:1]])
    num = dict(num_cams=R0.shape[0], num_pts=X0.shape[0])
    return (dict(obs_cam=oc, obs_pt=op, obs_uv=uv, plane_n=pn, plane_d=pd,
                 **num), R0, t0, X0)


# case -> (problem keywords, VisualBAProblem keywords, solve keywords,
# LVBA_VISUAL_TIER, LVBA_PM_ONEHOT_BUDGET or None, the port's route)
CASES = {
    "lu": ({}, {}, {}, "1", None, "lu"),
    "lu no plane": ({}, dict(use_plane=False), {}, "1", None, "lu"),
    "lu unobserved camera": (dict(extra_cams=2), {}, {}, "1", None, "lu"),
    "lu free first": ({}, dict(fix_first=False), {}, "1", None, "lu"),
    "cg": ({}, dict(reduced_solver="cg"), {}, "1", None, "cg"),
    "cg chunked": ({}, dict(reduced_solver="cg", pair_chunk=500), {}, "1",
                   None, "cg"),
    "cg_mf": ({}, dict(reduced_solver="cg_mf"), {}, "0", 10, "cg_mf"),
    "cg_pm": ({}, dict(reduced_solver="cg_mf"), {}, "0", None, "cg_pm"),
    "cg_pm plane-only point": (dict(plane_only=True),
                               dict(reduced_solver="cg_mf"), {}, "1", None,
                               "cg_pm"),
    "tier": ({}, dict(reduced_solver="cg_mf"), {}, "1", None, "tier"),
    "tier no plane": ({}, dict(reduced_solver="cg_mf", use_plane=False), {},
                      "1", None, "tier"),
    "tier unobserved camera": (dict(extra_cams=2),
                               dict(reduced_solver="cg_mf"), {}, "1", None,
                               "tier"),
    "host loop": ({}, dict(reduced_solver="cg_mf"), dict(device_loop=False),
                  "1", None, "cg_pm"),
}


def _set_switches(monkeypatch, tier, budget):
    monkeypatch.setenv("LVBA_VISUAL_TIER", tier)
    monkeypatch.setattr(schur, "VISUAL_TIER", tier == "1")
    if budget is None:
        monkeypatch.delenv("LVBA_PM_ONEHOT_BUDGET", raising=False)
    else:
        monkeypatch.setenv("LVBA_PM_ONEHOT_BUDGET", str(budget))
        monkeypatch.setattr(schur, "PM_ONEHOT_BUDGET", budget)


@pytest.mark.parametrize("case", list(CASES))
def test_solve_visual_ba_matches_jax(case, monkeypatch):
    """R, t and X within 1e-8, iters equal, cost0 and cost within 1e-10
    relative of the JAX package's solve on the same route; unobserved
    cameras stay exactly where they started."""
    pkw, bkw, skw, tier, budget, route = CASES[case]
    arrays, R0, t0, X0 = _problem(**pkw)
    _set_switches(monkeypatch, tier, budget)
    iters = 8
    ref = js.solve_visual_ba(js.VisualBAProblem(cam=JCAM, **arrays, **bkw),
                             R0, t0, X0, max_iters=iters, **skw)
    got = schur.solve_visual_ba(
        schur.VisualBAProblem(cam=CAM, **arrays, **bkw), R0, t0, X0,
        max_iters=iters, dtype=F64, device="cpu", **skw)
    assert got.route == route
    assert got.iters == ref.iters
    for a, b in ((got.R, ref.R), (got.t, ref.t), (got.X, ref.X)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)
    assert abs(got.cost0 - ref.cost0) <= 1e-10 * ref.cost0
    assert abs(got.cost - ref.cost) <= 1e-10 * ref.cost
    assert got.cost < 0.1 * got.cost0
    if pkw.get("extra_cams"):
        assert torch.equal(got.R[-2:], _t(R0[-2:]))
        assert torch.equal(got.t[-2:], _t(t0[-2:]))


def _pcg_spy(monkeypatch):
    trips = []
    real = dist_solve._pcg

    def spy(matvec, precond, b, max_iters, tol):
        trips.append(max_iters)
        return real(matvec, precond, b, max_iters, tol)

    monkeypatch.setattr(dist_solve, "_pcg", spy)
    return trips


def _jax_trips():
    """Each route's CG trips in the JAX package: the Schur solves' and
    solve_damped_cg's signature defaults (schur.py calls them without
    max_iters; LVBA_PM_CG_ITERS unset)."""
    def default(fn):
        return inspect.signature(fn).parameters["max_iters"].default

    return {"lu": None, "cg": default(jds.solve_damped_cg),
            "cg_mf": default(jds.solve_schur_cg_mf),
            "cg_pm": default(jds.solve_schur_cg_pm),
            "tier": default(jds.solve_schur_cg_pm_tiers)}


@pytest.mark.parametrize("route", ["lu", "cg", "cg_mf", "cg_pm", "tier"])
def test_route_trips_and_host_reads(route, monkeypatch):
    """Each route's CG runs the JAX package's trip count once an
    iteration; the device loop reads the host once an iteration (a
    tolist of done and the costs) and nothing else, after its set-up."""
    arrays, R0, t0, X0 = _problem(seed=2)
    solver = {"lu": "lu", "cg": "cg"}.get(route, "cg_mf")
    monkeypatch.setattr(schur, "VISUAL_TIER", route == "tier")
    if route == "cg_mf":
        monkeypatch.setattr(schur, "PM_ONEHOT_BUDGET", 10)
    prob = schur.VisualBAProblem(cam=CAM, **arrays, reduced_solver=solver)
    plan = schur.plan_visual(prob, R0, t0, X0, dtype=F64, device="cpu")
    assert plan.route == route
    want = schur.run_visual(plan, max_iters=6)
    trips = _pcg_spy(monkeypatch)
    events = _no_host_reads(monkeypatch, allow=("tolist",))
    got = schur.run_visual(plan, max_iters=6)
    monkeypatch.undo()
    assert got.iters == want.iters >= 3
    assert events == ["tolist"] * got.iters
    assert torch.equal(got.X, want.X) and torch.equal(got.R, want.R)
    n = _jax_trips()[route]
    assert trips == ([] if n is None else [n] * got.iters)
    assert dist_solve.PM_CG_ITERS == _jax_trips()["tier"]


def _route_problem(counts, M, P=None):
    """A problem whose point i has counts[i] observations spread over the
    cameras (points past len(counts) have none)."""
    P = P or len(counts)
    obs_pt = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    obs_cam = (np.arange(obs_pt.shape[0]) % M).astype(np.int32)
    arrays = dict(obs_cam=obs_cam, obs_pt=obs_pt,
                  obs_uv=np.zeros((obs_pt.shape[0], 2)),
                  plane_n=np.tile([[0.0, 0.0, 1.0]], (P, 1)),
                  plane_d=np.zeros(P), num_cams=M, num_pts=P)
    return arrays


class _Route(Exception):
    pass


def _jax_route(arrays, dtype, monkeypatch, device_loop=True):
    """The JAX package's route on a problem, read from what its solve
    hands its device loops, or its host loop's step (spies that stop it
    there)."""
    import functools

    def tiers(*a, **k):
        raise _Route("tier")

    def name(solver, tiers):
        if solver == "cg_mf":
            return "cg_pm" if tiers else "cg_mf"
        return solver

    def flat(pstat, consts, pa, pb, tiers, *a, **k):
        raise _Route(name(pstat.reduced_solver, tiers))

    def partial(fn, *a, **k):
        if fn is js._solve_cached:
            raise _Route(name(a[0].reduced_solver, k["tiers"]))
        return functools.partial(fn, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(js, "_lm_device_loop_tiers", tiers)
        m.setattr(js, "_lm_device_loop", flat)
        m.setattr(js, "partial", partial)
        R0 = np.tile(np.eye(3), (arrays["num_cams"], 1, 1))
        t0 = np.zeros((arrays["num_cams"], 3))
        X0 = np.zeros((arrays["num_pts"], 3))
        with pytest.raises(_Route) as e:
            js.solve_visual_ba(js.VisualBAProblem(cam=JCAM, **arrays), R0, t0,
                               X0, max_iters=1, dtype=dtype,
                               device_loop=device_loop)
    return e.value.args[0]


ROUTE_CASES = {
    "6M = 1020": (dict(counts=[3] * 20, M=170), {}),
    "6M = 1026": (dict(counts=[3] * 20, M=171), {}),
    "Q = 2^20": (dict(counts=[1024], M=4), {}),
    "Q = 2^20 + 1": (dict(counts=[1024, 1], M=4), {}),
    "plane-only point": (dict(counts=[3] * 20, M=171, P=21), {}),
    "over budget": (dict(counts=[3] * 20, M=171), dict(budget=10)),
    "host loop": (dict(counts=[3] * 20, M=171), dict(device_loop=False)),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_route_choice_matches_jax(case, dtype, monkeypatch):
    """The port's route equals the JAX package's on either side of each
    boundary: 6M = 1024, Q = 2^20, a point observed by no camera, the
    byte budget and the host loop.  The dtype sets the JAX package's
    budget itemsizes."""
    pkw, kw = ROUTE_CASES[case]
    arrays = _route_problem(**pkw)
    _set_switches(monkeypatch, "1", kw.get("budget"))
    ref = _jax_route(arrays, getattr(jnp, dtype), monkeypatch,
                     kw.get("device_loop", True))
    got = schur._route(schur.VisualBAProblem(cam=CAM, **arrays),
                       getattr(torch, dtype),
                       not kw.get("device_loop", True))[0]
    assert got == ref


def test_mesh_raises_naming_a7():
    """solve_visual_ba raises TypeError, naming Mesh, for a mesh that is no
    parallel.mesh.Mesh."""
    arrays, R0, t0, X0 = _problem()
    prob = schur.VisualBAProblem(cam=CAM, **arrays)
    with pytest.raises(TypeError, match="Mesh"):
        schur.solve_visual_ba(prob, R0, t0, X0, device="cpu", mesh=object())


def test_mesh_solve_equals_local():
    """solve_visual_ba(mesh=) on two CPU shards gives the local solve's
    route, iterations and result (1e-8)."""
    from global_lvba_tpu_torch.parallel.mesh import make_mesh

    arrays, R0, t0, X0 = _problem()
    prob = schur.VisualBAProblem(cam=CAM, **arrays)
    got = schur.solve_visual_ba(prob, R0, t0, X0, max_iters=5, dtype=F64,
                                mesh=make_mesh(2, devices=["cpu"] * 2))
    want = schur.solve_visual_ba(prob, R0, t0, X0, max_iters=5, dtype=F64,
                                 device="cpu")
    assert got.route == want.route == "lu" and got.iters == want.iters
    for a, b in ((got.R, want.R), (got.t, want.t), (got.X, want.X)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-8)


def test_unknown_solver_raises():
    arrays, R0, t0, X0 = _problem()
    with pytest.raises(ValueError):
        schur.solve_visual_ba(schur.VisualBAProblem(
            cam=CAM, **arrays, reduced_solver="qr"), R0, t0, X0, device="cpu")


# ---------------------------------------------------------------------------
# eval/oracle: the FD dense LM (BASELINE.md:54)
# ---------------------------------------------------------------------------


def test_matches_fd_oracle():
    """tests/test_parity_oracle.py:148's problem (6 cameras, 27 points,
    100 observations): the port's solve and the numpy FD-Jacobian oracle
    land on the same mean reprojection, 1.074 -> 0.2905 px, within 1e-6 px
    of each other."""
    js_ = make_joint_scene(num_frames=6, points_per_frame=1500, seed=0,
                           num_landmarks=120, pair_window=5)
    sc = js_.lidar
    lm_ids = sorted({int(l) for lm in js_.kp_landmark for l in lm})
    remap = {l: i for i, l in enumerate(lm_ids)}
    obs_cam = np.concatenate([np.full(k.shape[0], m) for m, k in
                              enumerate(js_.keypoints)]).astype(np.int32)
    obs_pt = np.array([remap[int(l)] for lm in js_.kp_landmark for l in lm],
                      np.int32)
    obs_uv = np.concatenate(js_.keypoints).astype(np.float64)
    X0 = js_.landmarks[lm_ids] + np.random.default_rng(1).normal(
        scale=0.02, size=(len(lm_ids), 3))
    k = np.asarray(lm_ids) % sc.planes_n.shape[0]
    pn, pd = sc.planes_n[k], sc.planes_d[k]
    Rcw0, tcw0 = camera_world_to_cam(js_.Rci, js_.tci,
                                     sc.R_true[js_.image_frame],
                                     sc.p_true[js_.image_frame])
    Rcw_p, tcw_p = perturb_poses(Rcw0, tcw0, 0.003, 0.01, seed=4)
    assert (Rcw0.shape[0], X0.shape[0], obs_cam.shape[0]) == (6, 27, 100)
    prob = schur.VisualBAProblem(cam=js_.cam, obs_cam=obs_cam, obs_pt=obs_pt,
                                 obs_uv=obs_uv, plane_n=pn, plane_d=pd,
                                 num_cams=6, num_pts=X0.shape[0])
    res = schur.solve_visual_ba(prob, Rcw_p, tcw_p, X0, max_iters=30,
                                dtype=F64, device="cpu")
    Ro, to, Xo, _ = joracle.oracle_visual_ba(
        JCameraModel(*js_.cam), obs_cam, obs_pt, obs_uv, pn, pd, Rcw_p,
        tcw_p, X0, max_iters=30)
    args = (obs_cam, obs_pt, obs_uv)
    pre = mean_reprojection_error(js_.cam, Rcw_p, tcw_p, X0, *args)
    post = mean_reprojection_error(js_.cam, res.R, res.t, res.X, *args)
    post_o = mean_reprojection_error(js_.cam, Ro, to, Xo, *args)
    assert abs(pre - 1.074) < 5e-4 and abs(post - 0.2905) < 5e-5
    assert abs(post - post_o) < 1e-6
