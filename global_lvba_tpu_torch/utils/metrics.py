"""Run metrics: per-stage wall timers and memory readings, and a registry
dumped as JSON; the port's own copy of global_lvba_tpu.utils.metrics.

Every pipeline stage records its wall time, the host's resident set after
it and, on a card, the caching allocator's peak (hbm_stats, under the JAX
package's names), and the registry serializes for the CLI and scripts."""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .profiling import span


class MetricsRegistry:
    def __init__(self):
        self.values: Dict[str, float] = {}

    def set(self, key: str, value):
        self.values[key] = value

    def add(self, key: str, value: float):
        self.values[key] = self.values.get(key, 0.0) + value

    def dump(self, path=None) -> str:
        s = json.dumps(self.values, indent=2, default=float)
        if path:
            Path(path).write_text(s)
        return s


class StageTimer:
    """Context-manager timer recording wall time plus memory observability
    per stage (the reference's check_mem, BALM/bavoxel.hpp:769-795): host
    VmRSS after the stage and, on a CUDA `device`, the allocator's
    cumulative peak.  Each stage is the tracer's span stage.<name>."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 device="cpu"):
        self.registry = registry or MetricsRegistry()
        self.device = torch.device(device)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(f"stage.{name}", self.device):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.registry.add(f"time/{name}_s", dt)
            rss = rss_mb()
            if rss >= 0:
                self.registry.set(f"mem/{name}_rss_mb", round(rss, 1))
            hbm = hbm_stats(self.device)
            if hbm:
                self.registry.set(
                    f"mem/{name}_hbm_peak_mb",
                    round(hbm.get("peak_bytes_in_use", 0) / 2**20, 1),
                )


def rss_mb() -> float:
    """Resident set size in MB (BALM2::check_mem analogue, bavoxel.hpp:769)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return -1.0


def hbm_stats(device) -> Dict[str, int]:
    """The card's allocator stats under the JAX package's names:
    bytes_in_use and peak_bytes_in_use (torch.cuda.memory_stats, the
    caching allocator's tensors) and bytes_limit (the card's total
    memory, torch.cuda.mem_get_info).  {} for a CPU device, as the JAX
    package gives on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.mem_get_info(device)[1]),
    }


def compute_mad(residuals) -> float:
    """Median absolute deviation x 1.4826 (computeMAD, utils.hpp:294-303),
    the JAX package's metrics copy: np.median, which averages the two
    middle values of an even-length input (utils.robust.compute_mad, which
    utils exports, takes the reference's nth_element element instead).
    Returns -1.0 for empty input."""
    r = np.asarray(residuals, dtype=np.float64)
    if r.size == 0:
        return -1.0
    med = np.median(r)
    return float(np.median(np.abs(r - med)) * 1.4826)
