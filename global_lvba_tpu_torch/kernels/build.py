"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each csrc/<name>.cu is compiled by its own `nvcc` process, all started
together, into a shared library with a plain C interface
(build/torch_ext/lib<name>-<digest>.so, next to the package; `.gitignore`
lists build/).  The digest covers the source, the shared header and the
flags, so an edited kernel is rebuilt and an unchanged one is reused.
A limit that the Python side shares with a kernel is passed as a -D flag
(_defines), so it is written down once.
Nothing here runs at import time: the first wrapper call on a CUDA tensor
builds.  A build that fails raises with the compiler's output; there is no
fallback.

A plain C interface keeps PyTorch's headers out of the build (a source
that includes them takes minutes to compile, this one seconds).  Each
launcher takes tensor pointers and the stream as integers and returns
cudaGetLastError() after the launch.  Its ctypes signature is bound once,
when the library loads; `launcher(name)` is a dictionary lookup after the
first call.  A source may hold several launchers (soa_chain.cu: the
aligned and the per-entry chain, and the aligned chain's occupancy query
that kernels/soa.py sizes its grid with; selection.cu: table_select and
entry_reduce; syrk.cu: the tf32 split and the Gram; colorize.cu: the
colorization and its occupancy query); matcher.cu's launcher runs its
two kernels (the work units and the reduction of their partials);
zbuffer.cu's fills the maps with a memset and rasterizes, colorize.cu's
launches one cooperative kernel.
The LiDAR kernels have a float64 instance each for float64 solves, bound
as `<name>_f64` (dtype_launcher picks it); the matcher, the tf32 split and
the z-buffer are float32 only, the undistortion integer only and the
colorization float64 only.

host_library builds the native host runtime (native/lvba_native.cpp) with
g++ the same way (a digest of the source, the flags and the machine, a
per-process temporary file renamed into place, so several test workers may
build it at once).  It needs no nvcc: the CPU tests build it too.  Its
flags: -ffp-contract=off keeps each product and sum separately rounded in
the order written (numpy's order is not FMA's), and no -march=native,
since a copy of the tree may carry build/ to another host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCES = ("soa_agg", "soa_chain", "syrk", "selection", "matcher", "zbuffer",
           "undistort", "colorize")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
HOST_SOURCE = Path(__file__).resolve().parent.parent / "native" / \
    "lvba_native.cpp"
HOST_CXX = "g++"
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
              "-ffp-contract=off")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# each launcher: its source, C name and argument types (it returns an int)
SIGNATURES = {
    "soa_agg": ("soa_agg", "lvba_soa_agg",
                [_I] + [_P] * 8 + [_I] + [_P] * 3),
    "soa_chain": ("soa_chain", "lvba_soa_chain",
                  [_P] * 5 + [_I] * 5 + [_P] * 4 + [_I] + [_P] * 3),
    "soa_chain_entries": ("soa_chain", "lvba_soa_chain_entries",
                          [_P] * 6 + [_I] * 4 + [_P] * 3),
    "syrk_split": ("syrk", "lvba_syrk_split", [_P] + [_I] * 4 + [_P] * 3),
    "syrk": ("syrk", "lvba_syrk", [_P] * 2 + [_I] * 5 + [_P] * 4),
    "table_select": ("selection", "lvba_table_select",
                     [_I] + [_P] * 4 + [_I] * 2 + [_P] * 2),
    "entry_reduce": ("selection", "lvba_entry_reduce",
                     [_P, _P, _L, _I, _I, _I, _P, _P]),
    "soa_agg_f64": ("soa_agg", "lvba_soa_agg_f64",
                    [_I] + [_P] * 8 + [_I] + [_P] * 3),
    "soa_chain_f64": ("soa_chain", "lvba_soa_chain_f64",
                      [_P] * 5 + [_I] * 5 + [_P] * 4 + [_I] + [_P] * 3),
    "soa_chain_entries_f64": ("soa_chain", "lvba_soa_chain_entries_f64",
                              [_P] * 6 + [_I] * 4 + [_P] * 3),
    "syrk_f64": ("syrk", "lvba_syrk_f64", [_P] + [_I] * 4 + [_P] * 4),
    "table_select_f64": ("selection", "lvba_table_select_f64",
                         [_I] + [_P] * 4 + [_I] * 2 + [_P] * 2),
    "entry_reduce_f64": ("selection", "lvba_entry_reduce_f64",
                         [_P, _P, _L, _I, _I, _I, _P, _P]),
    # not a launcher: the aligned chain's resident blocks a SM (float or
    # double instance), for kernels/soa.py chain_tile
    "soa_chain_occupancy": ("soa_chain", "lvba_soa_chain_occupancy",
                            [_I, _P]),
    "top2_similarity": ("matcher", "lvba_top2_similarity",
                        [_P, _P, _P, _I, _P, _P, _P, _I] + [_I] * 4
                        + [_P] * 8),
    "zbuffer": ("zbuffer", "lvba_zbuffer",
                [_P, _L, _P, _P, _P, _L, _I, _P, _P]
                + [ctypes.c_float] * 8 + [_I] * 2 + [_P] * 3),
    "undistort": ("undistort", "lvba_undistort",
                  [_P] * 5 + [_I] * 5 + [_P] * 2),
    "colorize": ("colorize", "lvba_colorize",
                 [_P, _L] + [_P] * 3 + [_I] + [ctypes.c_double] * 8
                 + [_I, _I, _L, _I] + [_P] * 4 + [_L] + [_P] * 2),
    # not a launcher: colorize_kernel's resident blocks a SM, for
    # kernels/colorize.py's cooperative grid
    "colorize_occupancy": ("colorize", "lvba_colorize_occupancy", [_P]),
}

_lock = threading.Lock()
_libs: dict = {}
_launchers: dict = {}
_logs: dict = {}


def dtype_launcher(name: str, dtype) -> str:
    """The launcher key of kernel `name` for operands of `dtype`: `name`
    for float32, `name_f64` for float64; any other dtype raises."""
    if dtype == torch.float32:
        return name
    if dtype == torch.float64:
        return f"{name}_f64"
    raise TypeError(f"{name}: the kernel takes float32 or float64, got "
                    f"{dtype}")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _defines(name: str) -> tuple:
    """The -D flags of csrc/<name>.cu: soa_chain.cu takes its per-entry
    block limits from kernels/soa.py, whose chain_entries_tile picks the
    voxels a block within them, and the aligned chain's warps a block per
    dtype, with which chain_tile sizes its grid; zbuffer.cu the points of
    a piece and the pairs of a block's chunk, with which kernels/zbuffer.py
    cuts the ranges and counts L2's bytes; undistort.cu the output tile and
    the box cap that kernels/undistort.py's tile plan
    is made for, and the byte permutes that its tests mirror; colorize.cu
    its block, whose pixels kernels/colorize.py's slabs count on, and the
    most images of a slab."""
    if name == "zbuffer":
        from . import zbuffer
        return (f"-DLVBA_ZBUF_PIECE={zbuffer.PIECE}",
                f"-DLVBA_ZBUF_CHUNK={zbuffer.CHUNK}")
    if name == "undistort":
        from . import undistort
        return (f"-DLVBA_UNDISTORT_TILE_W={undistort.TILE_W}",
                f"-DLVBA_UNDISTORT_TILE_H={undistort.TILE_H}",
                f"-DLVBA_UNDISTORT_MAX_PITCH={undistort.MAX_PITCH}",
                f"-DLVBA_UNDISTORT_MAX_ROWS={undistort.MAX_ROWS}",
                f"-DLVBA_UNDISTORT_SEL01={undistort.SEL01:#x}",
                f"-DLVBA_UNDISTORT_SEL2={undistort.SEL2:#x}")
    if name == "colorize":
        from . import colorize
        return (f"-DLVBA_COLORIZE_THREADS={colorize.THREADS}",
                f"-DLVBA_COLORIZE_STASH={colorize.STASH}",
                f"-DLVBA_COLORIZE_SLAB_IMAGES={colorize.SLAB_IMAGES}")
    if name != "soa_chain":
        return ()
    from . import soa
    return (f"-DLVBA_CHAIN_MAX_TILE={soa.CHAIN_MAX_TILE}",
            f"-DLVBA_CHAIN_MAX_ENTRIES={soa.CHAIN_MAX_ENTRIES}",
            f"-DLVBA_CHAIN_WARPS_F32={soa.CHAIN_WARPS[torch.float32]}",
            f"-DLVBA_CHAIN_WARPS_F64={soa.CHAIN_WARPS[torch.float64]}")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + _defines(name)).encode())
    return h.hexdigest()[:16]


def library(name: str) -> Path:
    """The shared library built from csrc/<name>.cu with NVCC_FLAGS and
    its _defines."""
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _build_all():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        out = library(name)
        if out.exists():
            _logs[name] = "(reused)"
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *_defines(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        _logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in SOURCES:
        lib = ctypes.CDLL(str(library(name)))
        lib.lvba_error_string.argtypes = [ctypes.c_int]
        lib.lvba_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    for name, (src, cname, argtypes) in SIGNATURES.items():
        fn = getattr(_libs[src], cname)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _launchers[name] = fn


def launcher(name: str):
    """The bound launcher `name` (a key of SIGNATURES), building every
    kernel on the first call."""
    fn = _launchers.get(name)
    if fn is None:
        with _lock:
            if not _libs:
                _build_all()
        fn = _launchers[name]
    return fn


def host_library() -> Path:
    """The native host library (HOST_SOURCE built by HOST_CXX with
    HOST_FLAGS), built on the first call of any process and reused after;
    RuntimeError with the compiler's output if the build fails."""
    h = hashlib.sha256(HOST_SOURCE.read_bytes())
    h.update(" ".join((HOST_CXX, *HOST_FLAGS, platform.machine())).encode())
    out = BUILD_DIR / f"liblvba_native-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which(HOST_CXX)
    if cxx is None:
        raise RuntimeError(f"{HOST_CXX} not found: the native host library "
                           f"cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(HOST_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{HOST_CXX} failed for {HOST_SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_logs() -> dict:
    """nvcc's output per source (ptxas register / spill report) of the
    build this process made, "(reused)" for a library found built."""
    with _lock:
        return dict(_logs)


def check(name: str, err: int):
    """Raise if the launcher `name` returned a CUDA error code (every
    library exports lvba_error_string, cudaGetErrorString behind a C
    name)."""
    if err != 0:
        msg = _libs[SIGNATURES[name][0]].lvba_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
