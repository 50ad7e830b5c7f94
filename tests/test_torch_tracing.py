"""The port's tracer (utils/profiling.py) inside the LM solve.

On the CPU: off, a solve records nothing and never opens a profiler
range; on, its results are bit for bit the untraced ones, its spans nest
as declared (one lm.plan_route and iters + 1 lm.eval, iters
lm.damped_solve a solve, each under its lm.solve and with its solve id;
self time is total less the children's cover), cg.live_trips is the trip
at which a plain PCG loop over the same operands first converges,
lm.rejects a host recount of the rejected steps, the map's spans are
taken, and each span's profiler range holds the tracer's own interval.

On a card (marked `cuda`; no JAX here):

    python -m pytest tests/test_torch_tracing.py -q -m cuda --noconftest

repeated solves capture no graph after their warm-up, tracing adds no
synchronizing call, and a captured CG graph replays the same kernels
whether it was captured with tracing on or off, as many as its trips run
eagerly.
"""

import time
import warnings

import pytest
import torch

from global_lvba_tpu_torch.factors.padding import buckets_to_device
from global_lvba_tpu_torch.map.voxelize import build_voxel_map
from global_lvba_tpu_torch.models.synthetic import (
    make_plane_scene, perturb_poses)
from global_lvba_tpu_torch.solver import dist_solve, lm
from global_lvba_tpu_torch.utils import profiling

F64 = torch.float64


@pytest.fixture(autouse=True)
def _tracer_off():
    """Each test starts and ends with the tracer off and empty; one torch
    thread (the CG trips are thousands of small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene12():
    """A bucketed W = 12 map and two starts: a mild one (every step
    accepted) and a rough one (rejects steps)."""
    scene = make_plane_scene(num_frames=12, points_per_frame=600, seed=2)
    profiling.reset()
    profiling.enable()
    vm = build_voxel_map(scene.points_body, scene.frame_ids, scene.R_true,
                         scene.p_true, 1.0, eigen_ratios=[0.2] * 4)
    bs = buckets_to_device(vm, W=12, dtype=F64, device="cpu")
    map_spans = profiling.snapshot()["spans"]
    profiling.disable()
    profiling.reset()
    starts = {}
    for name, rs, ts in (("mild", 0.004, 0.012), ("rough", 0.02, 0.05)):
        R, p = perturb_poses(scene.R_true, scene.p_true, rs, ts, seed=1)
        starts[name] = (torch.as_tensor(R), torch.as_tensor(p))
    return bs, starts, map_spans


def test_map_build_spans(scene12):
    spans = scene12[2]
    assert set(spans) == {"map.voxelize", "map.upload"}
    assert all(s["count"] == 1 and s["host_s"] > 0 and s["device_s"] is None
               for s in spans.values())


def test_off_records_nothing_and_opens_no_range(scene12, monkeypatch):
    bs, starts, _ = scene12

    def boom(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    res = lm.lm_damping_iter(bs, *starts["rough"], max_iters=4)
    assert res.iters == 4
    snap = profiling.snapshot(records=True)
    assert snap == dict(spans={}, counters={}, records=[])
    assert profiling.span("lm.solve") is profiling.span("lm.eval")
    profiling.enable()
    with pytest.raises(AssertionError, match="tracing off"):
        lm.lm_damping_iter(bs, *starts["rough"], max_iters=4)


@pytest.mark.parametrize("start", ["mild", "rough"])
def test_traced_solve_is_bitwise_untraced(scene12, start):
    bs, starts, _ = scene12
    off = lm.lm_damping_iter(bs, *starts[start], max_iters=6)
    profiling.enable()
    on = lm.lm_damping_iter(bs, *starts[start], max_iters=6)
    assert on.iters == off.iters and on.route == off.route
    for a, b in ((on.R, off.R), (on.p, off.p), (on.residual, off.residual)):
        assert torch.equal(a, b)


def test_span_counts_nesting_and_self_time(scene12):
    bs, starts, _ = scene12
    profiling.enable()
    iters = [lm.lm_damping_iter(bs, *starts[k], max_iters=6).iters
             for k in ("mild", "rough")]
    iters.append(lm.lm_damping_iter_split(bs, *starts["mild"],
                                          max_iters=3).iters)
    snap = profiling.snapshot(records=True)
    spans, recs = snap["spans"], snap["records"]
    n = sum(iters)
    assert {k: v["count"] for k, v in spans.items()} == {
        "lm.solve": 3, "lm.plan_route": 3, "lm.eval": n + 3,
        "lm.damped_solve": n}
    roots = [i for i, r in enumerate(recs) if r["name"] == "lm.solve"]
    assert [recs[i]["parent"] for i in roots] == [None] * 3
    ids = [recs[i]["solve"] for i in roots]
    assert len(set(ids)) == 3
    for j, root in enumerate(roots):
        kids = [r for r in recs if r["parent"] == root]
        assert all(r["solve"] == ids[j] for r in kids)
        assert [r["name"] for r in kids] == (
            ["lm.plan_route", "lm.eval"]
            + ["lm.damped_solve", "lm.eval"] * iters[j])
        top = recs[root]
        assert all(top["t0"] <= r["t0"] <= r["t1"] <= top["t1"]
                   for r in kids)
    for name, s in spans.items():
        kids = [r for r in recs if r["parent"] is not None
                and recs[r["parent"]]["name"] == name]
        cover = sum(r["t1"] - r["t0"] for r in kids)
        assert s["self_s"] == pytest.approx(s["host_s"] - cover, abs=1e-9)
        assert s["device_s"] is None
    assert spans["lm.eval"]["self_s"] == spans["lm.eval"]["host_s"]


def _plain_pcg_trip(H, g, u, tol, max_iters):
    """The first trip (1-based) at which a plain PCG loop on (H + u
    diag(H)) x = -g, block-Jacobi preconditioned as _damped_cg is, meets
    ||r||² / ||b||² < tol²; max_iters if none does."""
    d = torch.diagonal(H)
    damp = u * d + 1e-12 * (1.0 + torch.max(d.abs()))
    Minv = dist_solve._block_jacobi_inv_damped(H, damp, 6)

    def precond(r):
        return torch.bmm(Minv, r.reshape(-1, 6, 1)).reshape(-1)

    b = -g
    x, r = torch.zeros_like(b), b.clone()
    z = precond(r)
    p, rz = z.clone(), torch.dot(r, z)
    b2 = torch.dot(b, b)
    for k in range(1, max_iters + 1):
        Ap = H @ p + damp * p
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_n = torch.dot(r, z)
        p = z + rz_n / rz * p
        rz = rz_n
        if float(torch.dot(r, r) / b2) < tol * tol:
            return k
    return max_iters


@pytest.mark.parametrize("spread,max_iters", [(30.0, 96), (1e6, 12)])
def test_cg_live_trips_is_the_plain_loops_trip(spread, max_iters):
    gen = torch.Generator().manual_seed(5)
    n = 60
    Q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, dtype=F64))
    H = Q @ torch.diag(torch.logspace(0, torch.log10(torch.tensor(spread)),
                                      n, dtype=F64)) @ Q.T
    H = 0.5 * (H + H.T)
    g = torch.randn(n, generator=gen, dtype=F64)
    u = torch.tensor(0.01, dtype=F64)
    want = _plain_pcg_trip(H, g, u, 1e-10, max_iters)
    off = dist_solve.solve_damped_cg(H, g, u, max_iters=max_iters)
    profiling.enable()
    on = dist_solve.solve_damped_cg(H, g, u, max_iters=max_iters)
    assert torch.equal(on, off)
    got = profiling.snapshot()["counters"]["cg.live_trips"]
    assert got == want
    assert (want < max_iters) == (spread < 100)


def test_lm_rejects_is_a_host_recount(scene12, monkeypatch):
    bs, starts, _ = scene12
    seen = []
    real = lm._nielsen_update

    def recount(*a):
        out = real(*a)
        seen.append(bool(out[0]))
        return out

    monkeypatch.setattr(lm, "_nielsen_update", recount)
    profiling.enable()
    for k in ("mild", "rough"):
        lm.lm_damping_iter(bs, *starts[k], max_iters=10)
    rejects = seen.count(False)
    assert rejects >= 1
    snap = profiling.snapshot()
    assert snap["counters"]["lm.rejects"] == rejects
    assert "cg.live_trips" not in snap["counters"]    # LU at W = 12
    assert "cg.graph_captures" not in snap["counters"]


def test_spans_are_profiler_ranges_holding_their_intervals(scene12):
    bs, starts, _ = scene12
    from torch.profiler import ProfilerActivity, profile

    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        epoch = time.time_ns() * 1e-9 - time.perf_counter()
        lm.lm_damping_iter(bs, *starts["mild"], max_iters=3)
    recs = profiling.snapshot(records=True)["records"]
    base = prof.profiler.kineto_results.trace_start_ns() * 1e-9
    ranges = sorted((e.time_range.start * 1e-6 + base,
                     e.time_range.end * 1e-6 + base, e.name)
                    for e in prof.events() if profiling.is_declared(e.name))
    assert [n for _, _, n in ranges] == [
        r["name"] for r in sorted(recs, key=lambda r: r["t0"])]
    slack = 2e-4      # the two clocks' offset, read once
    for (s, e, _), r in zip(ranges, sorted(recs, key=lambda r: r["t0"])):
        assert e - s >= r["t1"] - r["t0"] - 1e-6
        assert s - slack <= r["t0"] + epoch
        assert r["t1"] + epoch <= e + slack


def test_device_trace_turns_the_spans_on_for_its_region(tmp_path, scene12):
    bs, starts, _ = scene12
    with profiling.device_trace(tmp_path / "trace", device="cpu"):
        assert profiling.enabled()
        lm.lm_damping_iter(bs, *starts["mild"], max_iters=2)
    assert not profiling.enabled()
    import json

    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace" / "trace.json").read_text())["traceEvents"]}
    assert {"lm.solve", "lm.plan_route", "lm.eval",
            "lm.damped_solve"} <= names


def test_stage_timer_stages_are_spans():
    from global_lvba_tpu_torch.utils.metrics import MetricsRegistry, StageTimer

    reg = MetricsRegistry()
    timer = StageTimer(reg, device="cpu")
    with timer.stage("off"):
        pass
    profiling.enable()
    with timer.stage("window"):
        with profiling.span("map.voxelize"):
            pass
    snap = profiling.snapshot(records=True)
    assert [r["name"] for r in snap["records"]] == ["map.voxelize",
                                                    "stage.window"]
    assert snap["records"][0]["parent"] == 1
    assert sorted(reg.values) == ["mem/off_rss_mb", "mem/window_rss_mb",
                                  "time/off_s", "time/window_s"]


def test_undeclared_names_raise():
    profiling.enable()
    with pytest.raises(KeyError):
        profiling.span("lm.nothing")
    with pytest.raises(KeyError):
        profiling.count("lm.nothing")
    with profiling.span("stage.anything"):
        pass
    assert profiling.snapshot()["spans"]["stage.anything"]["count"] == 1


# ------------------------------------------------------------- the card ---

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def plane_card(card):
    dev = card
    scene = make_plane_scene(num_frames=64, points_per_frame=1500, seed=3)
    vm = build_voxel_map(scene.points_body, scene.frame_ids, scene.R_true,
                         scene.p_true, 1.0, eigen_ratios=[0.2] * 4,
                         device=dev)
    bs = buckets_to_device(vm, W=64, dtype=torch.float32, device=dev)
    R, p = perturb_poses(scene.R_true, scene.p_true, 0.004, 0.012, seed=1)
    R0 = torch.as_tensor(R).to(dev, torch.float32)
    p0 = torch.as_tensor(p).to(dev, torch.float32)

    def solve():
        res = lm.lm_damping_iter(bs, R0, p0, max_iters=6,
                                 reduced_solver="cg")
        return res, res.p.cpu()

    return solve


def _syncs(run):
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(1 for w in caught if "synchronizing" in str(w.message)
               and "debug mode is a prototype" not in str(w.message))


@pytest.mark.cuda
def test_no_graph_capture_after_warm_up(plane_card):
    plane_card()
    plane_card()
    profiling.enable()
    iters = [plane_card()[0].iters for _ in range(3)]
    snap = profiling.snapshot()
    assert snap["counters"].get("cg.graph_captures", 0) == 0
    assert snap["spans"]["lm.damped_solve"]["count"] == sum(iters)
    assert 0 < snap["counters"]["cg.live_trips"] <= sum(iters) * \
        lm.LIDAR_CG_ITERS
    assert snap["spans"]["lm.eval"]["device_s"] > 0


@pytest.mark.cuda
def test_tracing_adds_no_sync(plane_card):
    plane_card()
    off = _syncs(plane_card)
    profiling.enable()
    on = _syncs(plane_card)
    assert on == off > 0


def _replay_kernels(graph) -> int:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.graph.replay()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if str(e.device_type).endswith("CUDA"))


@pytest.mark.cuda
def test_captured_graph_kernels_traced_or_not(card):
    dev = card
    gen = torch.Generator().manual_seed(9)
    A = torch.randn(96, 96, generator=gen, dtype=F64)
    H = (A @ A.T + 96 * torch.eye(96, dtype=F64)).to(dev)
    g = torch.randn(96, generator=gen, dtype=F64).to(dev)
    u = torch.tensor(0.01, dtype=F64, device=dev)
    counts = []
    for on in (True, False):
        dist_solve._GRAPHS.clear()
        (profiling.enable if on else profiling.disable)()
        graph = dist_solve.cg_graph(96, F64, dev, max_iters=16)
        graph(H, g, u)
        profiling.disable()
        counts.append(_replay_kernels(graph))
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dist_solve._damped_cg(H, g, u, 6, 16, 1e-10)
        torch.cuda.synchronize()
    eager = sum(1 for e in prof.events()
                if str(e.device_type).endswith("CUDA"))
    dist_solve._GRAPHS.clear()
    assert counts[0] == counts[1] > 16 * 10, (counts, eager)
