"""Runs chip_smoke.py's phase 21 ([images]: the box room as image files
with no COLMAP db, the system from them on the card, the undistort and
colorize kernels against their plain versions) alone on one CUDA card,
and writes its results to chiprun_out/images_phase.json.

    python3 scripts/images_phase.py

It builds the kernels first (as chip_smoke.py's set-up does) and fails,
as chip_smoke.py does, when a check misses its limit or no CUDA device is
available."""

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
    from global_lvba_tpu_torch.kernels import build
    from global_lvba_tpu_torch.native import runtime

    dev = resolve_device("cuda")
    print(cs._card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    for name in build.SIGNATURES:
        build.launcher(name)
    runtime.library()
    print(f"kernels and the host library built in {time.time() - t0:.1f} s",
          flush=True)
    results, paths, kern = {}, {}, {}
    t0 = time.time()
    cs._images(torch, np, dev, kern, results, paths)
    results["kernels"] = kern
    results["launches_by_path"] = paths
    print(f"[phase 21] {time.time() - t0:.1f} s", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "images_phase.json").write_text(
        json.dumps(results, indent=1, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
