"""Device meshes for the multi-device layer (port of
global_lvba_tpu.parallel.mesh).

The parallel axes:
  * "factors": data parallelism over plane-factor voxels and
    reprojection observations; gradients and Hessians are reduced over
    it (the reference's 16-thread divide_thread reduction,
    bavoxel.hpp:597-639, on devices);
  * "frames": state parallelism over keyframe blocks of the (6W, 6W)
    reduced system (the row-sharded CG matvec).

A Mesh is a grid of torch devices with its axis names.  A device may be
listed more than once: eight shards on one card (or on the CPU, in the
tests) are the counterpart of the JAX package's virtual devices.  Shards
on a mesh are evaluated in shard order, and every reduction over the
factor axis is one function, `psum`: the partials are summed in shard
order on the mesh's first device, then all_reduce'd when the mesh was
made inside a torch.distributed process group (one process a host or a
card; each process then holds `world` times fewer of the global shards).
No sum uses atomics.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A grid of torch devices (`devices`, an object array) with one axis
    name a dimension; `shape` maps each axis to its size, as the JAX
    Mesh's does.  distributed, world, rank: whether a torch.distributed
    process group was up when the mesh was made, its size and this
    process's rank (False, 1, 0 without one)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid needs as many "
                             f"axis names, got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, devices.shape))
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        self.distributed = up
        self.world = dist.get_world_size() if up else 1
        self.rank = dist.get_rank() if up else 0

    @property
    def first(self) -> torch.device:
        """The device the reductions land on."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis` (index 0 on every other axis): shard i
        of that axis runs on the i-th."""
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[k] = slice(None)
        return list(self.devices[tuple(idx)])

    def n_shards(self, axis: str = "factors") -> int:
        """The global shard count of `axis`: its size in every process."""
        return self.shape[axis] * self.world

    def local_shards(self, axis: str = "factors") -> range:
        """The global shard ids this process holds, in order."""
        n = self.shape[axis]
        return range(self.rank * n, (self.rank + 1) * n)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("factors",),
              shape: Optional[Tuple[int, ...]] = None,
              devices=None) -> Mesh:
    """A mesh of n_devices devices (the JAX package's shape rule: one axis
    takes them all; two axes favour the factor axis, a frames axis of 2
    when n is even; more axes need an explicit `shape`).

    devices: the devices to take the first n of, e.g.
    [torch.device("cuda:0")] * 8 for eight shards on one card, or ["cpu"]
    * 4.  Without it, the first n CUDA devices (all of them when n is None);
    fewer than n raises, and nothing falls back to the CPU."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else n_devices
        if n < 1 or have < n:
            raise RuntimeError(
                f"make_mesh needs {n_devices or 1} CUDA device(s) and "
                f"{have} are available; pass devices= (e.g. "
                f"[torch.device('cuda:0')] * n, or ['cpu'] * n) to place "
                f"several shards on one device")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
        n = len(devs) if n_devices is None else n_devices
        if len(devs) < n:
            raise ValueError(f"{len(devs)} devices given, {n} asked for")
        devs = devs[:n]
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        elif len(axis_names) == 2:
            f, s = n, 1
            while f % 2 == 0 and s < 2:
                f //= 2
                s *= 2
            shape = (f, s)
        else:
            raise ValueError("provide an explicit shape for >2 axes")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    return Mesh(grid.reshape(shape), axis_names)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None):
    """Join a torch.distributed process group (the JAX package's
    jax.distributed.initialize): coordinator_address "host:port" (or an
    init_method URL), the world size and this process's rank, all given
    explicitly (nothing here reads a cluster's environment).  backend:
    NCCL where CUDA is available, gloo otherwise; gloo also runs several
    processes on one card, which NCCL refuses.  A mesh made afterwards
    reduces across the processes."""
    dist = torch.distributed
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    addr = coordinator_address or "localhost:29500"
    init = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes or 1,
                            rank=process_id or 0)


def _all_reduce_(flat: torch.Tensor) -> torch.Tensor:
    """Sum flat across the process group, in place; gloo reduces CUDA
    tensors through the host."""
    dist = torch.distributed
    if flat.is_cuda and dist.get_backend() == "gloo":
        host = flat.cpu()
        dist.all_reduce(host)
        flat.copy_(host)
    else:
        dist.all_reduce(flat)
    return flat


def psum(parts, mesh: Mesh):
    """The factor-axis reduction: parts, one a local shard in shard order,
    each a tensor or a tuple of tensors, summed in shard order on the
    mesh's first device; with a process group the sums are then
    all_reduce'd (one call, every tensor in one flat buffer).  Returns a
    tensor or a tuple, as parts hold."""
    dev = mesh.first
    single = torch.is_tensor(parts[0])
    rows = [(p,) if single else tuple(p) for p in parts]
    out = []
    for k in range(len(rows[0])):
        acc = rows[0][k].to(dev)
        for r in rows[1:]:
            acc = acc + r[k].to(dev)
        out.append(acc)
    if mesh.distributed:
        flat = torch.cat([t.reshape(-1) for t in out])
        _all_reduce_(flat)
        o = 0
        for i, t in enumerate(out):
            out[i] = flat[o:o + t.numel()].view(t.shape)
            o += t.numel()
    return out[0] if single else tuple(out)


def shard_bounds(length: int, n: int):
    """[(lo, hi), ...]: `length` rows in n equal contiguous shards (length
    a multiple of n)."""
    step = length // n
    return [(i * step, (i + 1) * step) for i in range(n)]


def gather_rows(parts, mesh: Mesh) -> torch.Tensor:
    """The rows of every shard, concatenated in global shard order on the
    mesh's first device (the all-gather of a sharded array): the local
    shards' parts (equal shapes), then, with a process group, every
    process's."""
    out = torch.cat([p.to(mesh.first) for p in parts])
    if mesh.world > 1:
        dist = torch.distributed
        gloo = out.is_cuda and dist.get_backend() == "gloo"
        src = out.cpu() if gloo else out
        got = [torch.empty_like(src) for _ in range(mesh.world)]
        dist.all_gather(got, src)
        out = torch.cat(got).to(mesh.first)
    return out
