"""CUDA kernels of the port, each beside its plain PyTorch version.

A wrapper takes the plain version only for CPU tensors; for a CUDA tensor
it launches its kernel or raises.  Each launch adds one to the wrapper's
count (launch_counts), so a run can show that its path went through the
kernels."""

from . import gram, soa


def launch_counts() -> dict:
    return {**soa.LAUNCHES, **gram.LAUNCHES}


def reset_launch_counts():
    for d in (soa.LAUNCHES, gram.LAUNCHES):
        for k in d:
            d[k] = 0
