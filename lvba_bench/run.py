"""Runs one cell of the benchmark and prints its result as the last line.

    python3 lvba_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  With --trace 0 the result's metrics are the cell's end-to-end
metrics, with --trace 1 its per-layer ones (BENCHMARK.json).  The
numbers compared with the reference, each beside its limit, are the last
lines on standard error and the result's last key.  No card, too few
cards, a missing file or a module of JAX loaded: an exit code other than
0 and no result.

    python3 lvba_bench/run.py --list
lists the cells;
    python3 lvba_bench/run.py --workload <cell> --rehearse ...
runs the cell on the CPU at the configuration's rehearsal size (its
"rehearse" key), through the same code: a dry run, never a measurement.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)

    # the port never loads JAX; keep libraries that could from doing so
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from lvba_bench import harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        if args.list:
            for name in harness.list_cells():
                print(name)
            return 0
        if not args.workload:
            raise harness.RunError("--workload is required")
        cell = harness.load_cell(args.workload, bool(args.trace))
        shrink = cell.config.get("rehearse") if args.rehearse else None
        if args.rehearse and not shrink:
            raise harness.RunError("the configuration has no rehearse key")
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          T_START, rehearse=shrink, log=log)
    except harness.RunError as e:
        log(f"error: {e}")
        return 2
    rows = out.pop("_rows")
    log(f"correct {out['correct']}")
    for name, value, limit in rows:
        log(f"check {name} {value:.6g} limit {limit:.6g}")
    for c in out["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])     # strict JSON has no inf
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
