"""eval_ms: CUDA events around back-to-back calls of the planned route's
evaluation (plan_route(...).cgh) at a start, over the count (ms)."""


def read(rec):
    return rec["probes"].get("eval_ms")
