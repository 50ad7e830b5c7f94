"""lm_iters: LMResult.iters averaged over the window's solves."""


def read(rec):
    it = [s["iters"] for s in rec["solves"]]
    return sum(it) / len(it) if it else None
