"""`correct` fails where it must: the control in the program's place, and
the timed path broken underneath a whole run (the harness's look for a
card skipped: a rehearsal on the CPU), each judged by the cell's own
limits.  On a card, control.py runs the control at the cells' sizes."""

import math
import time

import numpy as np
import pytest

from lvba_bench import compare, control, harness

CELLS = ["plane_w512.f32", "corridor_w4096.f32", "plane_w512.f64"]


def _fails(numbers, limits):
    ok, rows = compare.judge(numbers, limits)
    return not ok, rows


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The reference in TF32 (float32 cells) or the program's float32 path
    (the float64 cell) in the program's place, at the rehearsal size."""
    rows = []
    control.readings(cell, seeds=[], control_seeds=[31], n_solves=2,
                     n_control=2, rehearse=True, emit=rows.append)
    import json

    row = json.loads(rows[0])
    limits = harness.load_cell(cell, False).limits
    failed, checks = _fails(row["control"], limits)
    assert failed, checks


def _run(cell_name, monkeypatch, patch):
    cell = harness.load_cell(cell_name, False)
    patch(monkeypatch)
    return harness.run(cell, 41, 0.3, False, time.perf_counter(),
                       rehearse=cell.config["rehearse"], log=lambda m: None)


def _over(out, name, factor=3.0):
    c = out["checks"][name]
    return not math.isfinite(c["value"]) or c["value"] > factor * c["limit"]


def _unchanged(monkeypatch):
    import global_lvba_tpu_torch.solver.lm as lm

    def stuck(buckets, R0, p0, max_iters=10, **kw):
        return lm.LMResult(R=R0.clone(), p=p0.clone(), iters=max_iters,
                           residual=R0.new_zeros(()), route="stuck")
    monkeypatch.setattr(lm, "lm_damping_iter", stuck)


def _half_left_out(monkeypatch):
    import global_lvba_tpu_torch.factors.padding as pad

    orig = pad.buckets_to_device

    def half(vm, *a, **kw):
        out = orig(vm, *a, **kw)
        for b in out:
            b.n[b.n.shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(pad, "buckets_to_device", half)


def _answer_altered(monkeypatch):
    import global_lvba_tpu_torch.solver.lm as lm

    orig = lm.lm_damping_iter

    def altered(*a, **kw):
        res = orig(*a, **kw)
        p = res.p.clone()
        p[p.shape[0] // 2] += 0.05
        return res._replace(p=p)
    monkeypatch.setattr(lm, "lm_damping_iter", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault,numbers", [
    (_unchanged, ["solve_cost_gap", "solve_rel_pose_gap"]),
    (_half_left_out, ["eval_cost_err", "eval_grad_err"]),
    (_answer_altered, ["solve_cost_gap", "solve_rel_pose_gap",
                       "solve_pose_gap"]),
], ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_fault_fails(cell, fault, numbers, monkeypatch):
    """A step that returns its state unchanged; half of the voxels left out
    of the evaluation (the mean over the rest); a solve's answer altered
    where it is produced.  (The exchange between cards has no fault here:
    every cell runs on one card.)"""
    out = _run(cell, monkeypatch, fault)
    assert out["correct"] is False
    assert any(_over(out, n) for n in numbers if n in out["checks"]), \
        out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell, cuda_device):
    """A short run of each cell on the card is correct."""
    c = harness.load_cell(cell, False)
    out = harness.run(c, 2 ** 31 + 11, 2.0, False, time.perf_counter(),
                      log=lambda m: None)
    assert out["correct"] is True, out["checks"]
    assert np.isfinite(out["metrics"]["solve_ms"]["value"])
