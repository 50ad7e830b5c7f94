"""The harness as a program: its imports, its refusals and its growth by
data files alone."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "global_lvba_tpu"}

_PROBE = """
import json, runpy, sys
sys.argv = [{script!r}] + {args!r}
rc = 0
try:
    runpy.run_path({script!r}, run_name="__main__")
except SystemExit as e:
    rc = e.code
print("MODULES " + json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})),
      file=sys.stderr)
sys.exit(rc)
"""


def _run(args, cwd=ROOT, env=None, script="lvba_bench/run.py"):
    code = _PROBE.format(script=script, args=list(args))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def _modules(stderr):
    line = [ln for ln in stderr.splitlines() if ln.startswith("MODULES ")]
    return set(json.loads(line[-1][8:]))


def _result(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["plane_w512.f32", "corridor_w4096.f32",
                                  "plane_w512.f64"])
def test_rehearsal_imports_no_jax(cell):
    p = _run(["--workload", cell, "--seed", "2200000001", "--seconds",
              "0.2", "--trace", "1", "--rehearse"])
    assert p.returncode == 0, p.stderr[-3000:]
    mods = _modules(p.stderr)
    assert not mods & FORBIDDEN, mods & FORBIDDEN
    assert "global_lvba_tpu_torch" in mods
    out = _result(p.stdout)
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"
    names = [ln.split()[1] for ln in p.stderr.splitlines()
             if ln.startswith("check ") and " limit " in ln]
    assert names == list(out["checks"])


def test_reference_reaches_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import lvba_bench.reference.voxel_map, "
            "lvba_bench.reference.plane_factor, lvba_bench.reference.lm, "
            "lvba_bench.compare, lvba_bench.work, lvba_bench.scenes.synthetic;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    mods = set(eval(p.stdout))
    assert not mods & (FORBIDDEN | {"global_lvba_tpu_torch"})


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(["--workload", "plane_w512.f32", "--seed", "1", "--seconds",
              "1", "--trace", "0"])
    assert p.returncode != 0 and p.stdout.strip() == ""


def _bare_copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "lvba_bench", tmp_path / "lvba_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_bare_checkout_no_result(tmp_path):
    root = _bare_copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for extra in ([], ["--rehearse"]):
        p = _run(["--workload", "plane_w512.f32", "--seed", "1",
                  "--seconds", "0.2", "--trace", "0"] + extra, cwd=root,
                 env=env)
        assert p.returncode != 0 and p.stdout.strip() == ""


def _digests(root):
    return {str(f.relative_to(root)): hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(root.rglob("*")) if f.is_file()
            and "__pycache__" not in f.parts}


def test_new_cell_by_data_files_alone(tmp_path):
    """A configuration, a traffic mix, a limits file and a per-layer
    metric added as new files (and entries in BENCHMARK.json): the harness
    lists the new cell and dry-runs it, and no file it had changes."""
    root = _bare_copy(tmp_path)
    before = _digests(root / "lvba_bench")
    b = root / "lvba_bench"
    cfg = json.loads((b / "configs" / "plane_w512.json").read_text())
    cfg["name"] = "room_w64"
    cfg["scene"].update(num_frames=64, points_per_frame=500, num_planes=8)
    cfg["rehearse"] = {"num_frames": 12, "points_per_frame": 400}
    (b / "configs" / "room_w64.json").write_text(json.dumps(cfg))
    trf = json.loads((b / "traffic" / "perturbed.f64.json").read_text())
    trf.update(name="drift.f64", perturbation="drift", rot_sigma=0.001,
               trans_sigma=0.003, pool=3)
    (b / "traffic" / "drift.f64.json").write_text(json.dumps(trf))
    (b / "limits" / "room_w64.drift.json").write_text(json.dumps(
        {"limits": {"map_err": 1e-5, "eval_cost_err": 1e-3}}))
    (b / "metrics" / "scene_s.py").write_text(
        "def read(rec):\n    return rec['spans'].get('scene_s')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="room_w64",
                                 file="lvba_bench/configs/room_w64.json"))
    bench["workloads"].append(dict(name="room_w64.drift", config="room_w64",
                                   traffic="drift.f64", chips=1, why="test"))
    bench["per_layer"].append(dict(
        name="scene_s", unit="s", better="lower", source="host_clock",
        layer="scene", moves="setup_s", workloads=["room_w64.drift"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    p = _run(["--list"], cwd=root, env=env)
    assert p.returncode == 0 and "room_w64.drift" in p.stdout.split()
    p = _run(["--workload", "room_w64.drift", "--seed", "4", "--seconds",
              "0.2", "--trace", "1", "--rehearse"], cwd=root, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    out = _result(p.stdout)
    # the per-layer metrics that list their cells report in those alone
    assert list(out["metrics"]) == ["scene_s"]
    assert list(out["checks"]) == ["map_err", "eval_cost_err"]
    assert out["correct"] is True
    after = _digests(root / "lvba_bench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_reduce_trace():
    from lvba_bench.harness import reduce_trace

    dev = [(1.0, 2.0, "k1"), (1.5, 2.5, "k2"), (4.0, 4.5, "k1"),
           (6.0, 6.25, "k3")]
    host = [(0.0, 7.0, "solve"), (2.6, 3.9, "aten::nonzero"),
            (3.0, 3.5, "cudaStreamSynchronize"), (4.6, 5.9, "plan_route")]
    tr = reduce_trace(dev, host, wall=8.0)
    assert tr["busy_s"] == pytest.approx(1.5 + 0.5 + 0.25)
    assert tr["window_s"] == 8.0
    assert tr["device_ops"][0] == ["k1", 1.5]
    # gaps (2.5, 4.0) and (4.5, 6.0): their middles 3.25 and 5.25
    assert dict(tr["idle_gaps"]) == pytest.approx(
        {"cudaStreamSynchronize": 1.5, "plan_route": 1.5})
