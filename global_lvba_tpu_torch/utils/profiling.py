"""The port's tracer: named spans and counters inside the program, and
device_trace, which writes a Chrome trace of a region with the program's
spans beside the card's kernels.

Off by default.  Off, span() returns one shared null context and count()
returns at once: no record_function, no CUDA event, no allocation.  On
(enable()), each span records its name, its parent span and the id of the
LM solve it belongs to, its host start and end (time.perf_counter), opens
a torch.profiler.record_function range of its name (so that under a
profiler the span sits on the device trace's clock beside the kernels)
and, on a CUDA device, records a pair of timing events on the current
stream (not while that stream captures a graph).  A counter adds a host
number, or a device tensor into an accumulator on its device (no read).
snapshot() synchronizes once and resolves both.

Every name is declared in SPANS or COUNTERS below, with what it measures;
an undeclared one raises.  scripts/trace_solve.py reads them over a
benchmark cell's solves.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch

SPANS = {
    "lm.solve": "one LM solve (lm_damping_iter, lm_damping_iter_split, "
                "the sharded LMs): "
                "route set-up, the loop and its reads; each opens a new "
                "solve id",
    "lm.plan_route": "the solve's plan_route: the route's operands, a "
                     "bucketed route's host reads and frame tables, the "
                     "banded groups and their plan",
    "lm.eval": "one evaluation route.cgh in the LM loop (the start's, "
               "then one an iteration at the trial point)",
    "lm.damped_solve": "one damped solve route.solve in the LM loop (on a "
                       "card the CUDA graph's operand copies and replay)",
    "map.voxelize": "build_voxel_map: the adaptive voxel map on the host",
    "map.upload": "buckets_to_device: the factor buckets onto the device",
    "stage.<name>": "a system run's stage <name> (StageTimer.stage)",
}
COUNTERS = {
    "cg.live_trips": "CG trips run before the done flag froze the state "
                     "(trip k converges: k live), summed over CG solves",
    "lm.rejects": "LM iterations whose trial step was rejected (Nielsen "
                  "accept false), accumulated on the device",
    "cg.graph_captures": "CUDA graph captures of a damped solve (a miss "
                         "of dist_solve's graph cache)",
}

_NULL = nullcontext()
_on = False
_stack: list = []           # the open spans, innermost last
_records: list = []         # the closed spans since the last reset
_counts: dict = {}          # counter -> host number
_dev_counts: dict = {}      # (counter, device) -> int64 accumulator
_next_solve = 0


def enabled() -> bool:
    return _on


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def reset():
    """Drop the closed spans and the counters (open spans stay open)."""
    _records.clear()
    _counts.clear()
    _dev_counts.clear()


def is_declared(name: str) -> bool:
    """A span name of the table (stage.<name> for any stage)."""
    return name in SPANS or name.startswith("stage.")


class _Span:
    __slots__ = ("name", "device", "parent", "solve", "t0", "t1", "events",
                 "_range")

    def __init__(self, name: str, device):
        if not is_declared(name):
            raise KeyError(f"span {name!r} is not declared in SPANS")
        self.name = name
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        global _next_solve
        self.parent = _stack[-1] if _stack else None
        if self.name == "lm.solve":
            self.solve = _next_solve
            _next_solve += 1
        else:
            self.solve = self.parent.solve if self.parent else None
        _stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.events = None
        dev = self.device
        if (dev is not None and dev.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(dev))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self._range.__exit__(*exc)
        _stack.remove(self)
        _records.append(self)
        return False


def span(name: str, device=None):
    """A context manager around one region of the program named `name`
    (declared in SPANS); `device`: where its work runs (CUDA: timing
    events).  Off: one shared null context."""
    if not _on:
        return _NULL
    return _Span(name, device)


def traced(name: str):
    """Decorator: each call of the function inside span(name) (host clock
    only)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n=1):
    """Add n to the counter `name` (declared in COUNTERS): a number on the
    host, or a tensor added into an accumulator on its device with no read
    back.  Off: nothing."""
    if not _on:
        return
    if name not in COUNTERS:
        raise KeyError(f"counter {name!r} is not declared in COUNTERS")
    if isinstance(n, torch.Tensor):
        key = (name, n.device)
        acc = _dev_counts.get(key)
        if acc is None:
            acc = _dev_counts[key] = torch.zeros((), dtype=torch.int64,
                                                 device=n.device)
        acc.add_(n.to(torch.int64))
    else:
        _counts[name] = _counts.get(name, 0) + n


def _cover(parent, children) -> float:
    """Seconds of the parent's interval that its children cover."""
    total, end = 0.0, parent.t0
    for c in sorted(children, key=lambda c: c.t0):
        s, e = max(c.t0, end), min(c.t1, parent.t1)
        if e > s:
            total += e - s
            end = e
    return total


def snapshot(records: bool = False) -> dict:
    """The closed spans and the counters since the last reset:
    {"spans": {name: {count, host_s, self_s, device_s}}, "counters":
    {name: number}}.  host_s: the host clock's total; self_s: host_s less
    the seconds the span's children cover; device_s: the timing events'
    total (None where no record has events, as on the CPU).  records:
    also each span as {name, parent, solve, t0, t1} (parent an index into
    the list, None at the root).  Synchronizes once."""
    cuda = {r.device for r in _records if r.events is not None}
    cuda |= {k[1] for k in _dev_counts if k[1].type == "cuda"}
    for dev in cuda:
        torch.cuda.synchronize(dev)
    kids: dict = {}
    for r in _records:
        if r.parent is not None:
            kids.setdefault(id(r.parent), []).append(r)
    spans: dict = {}
    for r in _records:
        s = spans.setdefault(r.name, dict(count=0, host_s=0.0, self_s=0.0,
                                          device_s=None))
        s["count"] += 1
        s["host_s"] += r.t1 - r.t0
        s["self_s"] += r.t1 - r.t0 - _cover(r, kids.get(id(r), ()))
        if r.events is not None:
            dt = r.events[0].elapsed_time(r.events[1]) * 1e-3
            s["device_s"] = (s["device_s"] or 0.0) + dt
    counters = dict(_counts)
    for (name, _), acc in _dev_counts.items():
        counters[name] = counters.get(name, 0) + int(acc)
    out = dict(spans=spans, counters=counters)
    if records:
        index = {id(r): i for i, r in enumerate(_records)}
        out["records"] = [dict(name=r.name, solve=r.solve, t0=r.t0, t1=r.t1,
                               parent=None if r.parent is None
                               else index.get(id(r.parent)))
                          for r in _records]
    return out


@contextmanager
def device_trace(out_dir: str, device="cuda"):
    """Trace the enclosed region with torch.profiler (the host's ops, and
    the card's kernels on a CUDA `device`) with the program's spans on,
    and write it as a Chrome trace, <out_dir>/trace.json: the spans of
    SPANS sit on the kernels' clock there (on a card each also shows on
    the device's rows, over the kernels its region launched: leave those
    out when summing the device's busy time).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from .. import resolve_device

    dev = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    was = _on
    enable()
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        if not was:
            disable()
    prof.export_chrome_trace(str(Path(out_dir) / "trace.json"))
