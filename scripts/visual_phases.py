"""Runs chip_smoke.py's visual and system phases (14-16: the JAX bench's
visual solver problems, every visual route at M=100, ladder 3 end to end;
17: ladder 3 through LvbaSystem and the CLI, held to phase 16's values;
20: the native host runtime and the card's z-buffer at ladder 3's and
path 2a's sizes, path 2a's run made first) alone on one CUDA card, and
writes their results to
chiprun_out/visual_phases.json.

    python3 scripts/visual_phases.py [14] [15] [16] [17] [20]

With no arguments it runs 14-16; 17 and 20 need 16 before them.  It fails, as chip_smoke.py does,
when a check misses its limit or no CUDA device is available."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from global_lvba_tpu_torch import resolve_device

    dev = resolve_device("cuda")
    print(cs._card_line(), flush=True)
    results, paths = {}, {}
    scene = []
    # the LiDAR stages' kernel checks (phases 16 and 17) record their max
    # abs errors
    kern = {k: dict(max_abs_err=0.0) for k in (
        "table_select", "soa_agg", "soa_chain_entries", "entry_reduce",
        "syrk")}
    t0 = time.time()
    for name in sys.argv[1:] or ["14", "15", "16"]:
        t1 = time.time()
        if name == "14":
            cs._visual_bench(torch, np, dev, results)
        elif name == "15":
            cs._visual_routes(torch, np, dev, results)
        elif name == "16":
            scene.extend(cs._visual_e2e(torch, np, dev, kern, results, paths))
            results["kernel_max_abs_err"] = kern
        elif name == "17" and scene:
            cs._system(torch, np, dev, kern, results, paths, *scene)
            results["launches_by_path"] = paths
        elif name == "20" and scene:
            cs._keep_2a(torch, np)
            cs._native(torch, np, dev, kern, results, *scene)
            results["zbuffer"] = kern["zbuffer"]
        else:
            raise SystemExit(f"unknown phase {name!r}: 14, 15, 16, 17 or "
                             "20 (17 and 20 after 16)")
        print(f"[phase {name}] {time.time() - t1:.1f} s", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "visual_phases.json").write_text(
        json.dumps(results, indent=1, default=float))
    print(f"all {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
