"""Device profiling (the port's counterpart of
global_lvba_tpu.utils.profiling): any pipeline region can be traced with
torch.profiler and the trace opened in Perfetto or chrome://tracing."""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path


@contextmanager
def device_trace(out_dir: str, device="cuda"):
    """Trace the enclosed region with torch.profiler (the host's ops, and
    the card's kernels on a CUDA `device`) and write it as a Chrome trace,
    <out_dir>/trace.json.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from .. import resolve_device

    dev = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(out_dir) / "trace.json"))


def annotate(name: str):
    """Named trace region (shows up in the profiler timeline)."""
    import torch

    return torch.profiler.record_function(name)
