"""eval_roofline: the evaluation's least time on the card (work.py: the
Gram's operations at the dtype's tensor-core peak against the bytes at
the memory's peak) over eval_ms, in %.  Nothing for a card the peak table
does not hold."""

from lvba_bench.work import least_time_s


def read(rec):
    ms = rec["probes"].get("eval_ms")
    if not ms or rec.get("work") is None or rec.get("peak") is None:
        return None
    t, _ = least_time_s(rec["work"], rec["peak"], rec["dtype"])
    return 100.0 * t / (ms * 1e-3)
