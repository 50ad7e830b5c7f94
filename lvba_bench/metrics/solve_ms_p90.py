"""solve_ms_p90: the 90th percentile of the window's solves' wall times
(ms), linear between the order statistics."""

import numpy as np


def read(rec):
    ms = [s["ms"] for s in rec["solves"]]
    return float(np.percentile(ms, 90)) if ms else None
