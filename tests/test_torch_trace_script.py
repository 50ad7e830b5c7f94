"""scripts/trace_solve.py, the operator's breakdown of a solve from the
program's spans and counters: its idle-gap attribution on a hand-made
trace, and a CPU rehearsal of a benchmark cell reporting its numbers."""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "trace_solve", ROOT / "scripts" / "trace_solve.py")
trace_solve = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_solve)

NINE = ("route_plan_ms", "eval_in_solve_ms", "cg_in_solve_ms",
        "cg_live_trips", "lm_rejects", "graph_captures", "map_voxelize_s",
        "map_upload_s", "plan_idle_share")


def test_idle_by_span_takes_the_innermost_program_span():
    dev = [(1.0, 2.0, "k1"), (1.5, 2.5, "k2"), (4.0, 4.5, "k1"),
           (6.0, 6.25, "k3"), (7.0, 7.5, "k1")]
    host = [(0.0, 8.0, "lm.solve"), (2.6, 3.9, "aten::nonzero"),
            (2.55, 4.0, "lm.plan_route"), (4.6, 5.9, "cudaGraphLaunch"),
            (6.3, 6.5, "lm.eval")]
    got = trace_solve.idle_by_span(dev, host,
                                   lambda n: n.startswith("lm."))
    # gaps (2.5, 4.0), (4.5, 6.0), (6.25, 7.0): middles 3.25, 5.25, 6.625;
    # lm.eval ends before 6.625, so lm.solve holds the last
    assert got == pytest.approx({"lm.plan_route": 1.5, "lm.solve": 2.25})
    none = trace_solve.idle_by_span(dev, host, lambda n: False)
    assert none == pytest.approx({trace_solve.NO_SPAN: 3.75})


def test_rehearsal_reports_the_numbers():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = trace_solve.run("plane_w512.f32", 2300000011, 0.0, True,
                              log=lambda m: None)
    finally:
        torch.set_num_threads(threads)
    m = out["metrics"]
    assert set(NINE) - set(m) == {"plan_idle_share"}    # no card
    assert out["device"] == {"kind": "cpu"} and out["trace"] is None
    assert out["cycles"] == 4 and len(out["tracing_cost"]["solve_ms_on"]) == 2
    n = out["spans"]["lm.solve"]["count"]
    assert n == 2 * 16
    assert out["spans"]["lm.eval"]["count"] == \
        out["spans"]["lm.damped_solve"]["count"] + n
    assert m["lm_rejects"] == out["counters"].get("lm.rejects", 0) / n
    assert m["graph_captures"] == 0 and m["map_voxelize_s"] > 0
    assert out["split_ms"]["accounted"] == pytest.approx(1.0, abs=1e-9)
    assert out["host_syncs"] == {"off": None, "on": None}
