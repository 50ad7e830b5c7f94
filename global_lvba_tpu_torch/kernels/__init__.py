"""CUDA kernels of the port, each beside its plain PyTorch version.

A wrapper takes the plain version only for CPU tensors; for a CUDA tensor
it launches its kernel or raises.  Each launch adds one to the wrapper's
count (launch_counts), so a run can show that its path went through the
kernels."""

from . import colorize, gram, matcher, selection, soa, undistort, zbuffer

_COUNTS = (soa.LAUNCHES, gram.LAUNCHES, selection.LAUNCHES,
           matcher.LAUNCHES, zbuffer.LAUNCHES, undistort.LAUNCHES,
           colorize.LAUNCHES)


def launch_counts() -> dict:
    return {k: v for d in _COUNTS for k, v in d.items()}


def reset_launch_counts():
    for d in _COUNTS:
        for k in d:
            d[k] = 0
