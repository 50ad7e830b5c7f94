"""cg_ms: CUDA events around back-to-back calls of the planned route's
damped solve at u = 0.01, over the count (ms)."""


def read(rec):
    return rec["probes"].get("cg_ms")
