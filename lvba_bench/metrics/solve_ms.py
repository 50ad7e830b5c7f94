"""solve_ms: the window's wall time over the solves completed in it (ms),
each solve's route set-up and read-back included."""


def read(rec):
    n = len(rec["solves"])
    return rec["window_s"] * 1e3 / n if n else None
