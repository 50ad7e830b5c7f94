"""ctypes bindings of the port's native host runtime (lvba_native.cpp).

The library is built with g++ at the first call (kernels/build.
host_library: build/torch_ext/liblvba_native-<digest>.so) and bound once.
It needs no nvcc, so the CPU tests build and run it.  A build that fails
raises with the compiler's output, and an input the C code rejects raises:
nothing here returns None for a caller to fall back on (the JAX package's
runtime does).  Each wrapper checks dtypes, shapes and bounds before it
hands pointers over.  n_threads = 0 takes every hardware thread.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_P, _L, _I, _D = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_double
# each entry point: its ctypes argument types and return type
SIGNATURES = {
    "lvba_lzf_decompress": ([ctypes.c_char_p, _L, _P, _L], _L),
    "lvba_voxel_keys64": ([_P, _L, _D, _I, _P], _I),
    "lvba_radix_argsort": ([_P, _L, _P], None),
    "lvba_union_find": ([_L, _P, _P, _L, _P], None),
    "lvba_transform_points": ([_P, _P, _L, _P, _P, _I, _P], None),
    "lvba_bin_moments": ([_P, _P, _L, _P, _L, _I, _P, _P], None),
    "lvba_png_unfilter": ([_P, _L, _L, _I, _P], _I),
    "lvba_jpeg_encode": ([_P, _I, _I, _I, _P, _L, _P], _I),
    "lvba_jpeg_info": ([_P, _L, _P, ctypes.c_char_p, _I], _I),
    "lvba_jpeg_decode": ([_P, _L, _I, _P, ctypes.c_char_p, _I], _I),
}

_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """The bound host library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            from ..kernels import build

            lib = ctypes.CDLL(str(build.host_library()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def lzf_decompress(data: bytes, expected: int) -> bytes:
    """LZF decompression of a PCL binary_compressed payload into at most
    `expected` bytes (the bytes written, as the Python decoder gives);
    ValueError on a malformed stream."""
    out = np.empty(expected, dtype=np.uint8)
    n = library().lvba_lzf_decompress(data, len(data), _ptr(out), expected)
    if n < 0:
        raise ValueError("malformed LZF stream")
    return out[:n].tobytes()


def voxel_keys64(pts: np.ndarray, voxel_size: float,
                 n_threads: int = 0) -> np.ndarray:
    """int64 voxel keys of float64 points (N, 3): pack_voxel_keys(
    voxel_coords(pts, voxel_size)), threaded; the same ValueError where a
    coordinate leaves the packable range."""
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {pts.shape}")
    out = np.empty(pts.shape[0], dtype=np.int64)
    rc = library().lvba_voxel_keys64(_ptr(pts), pts.shape[0],
                                     float(voxel_size), n_threads, _ptr(out))
    if rc != 0:
        raise ValueError("voxel coordinates out of packable range")
    return out


def radix_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of int64 keys (an 8-pass LSD radix sort): equal to
    np.argsort(keys, kind="stable")."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if keys.ndim != 1:
        raise ValueError(f"keys must be (N,), got {keys.shape}")
    out = np.empty(keys.shape[0], dtype=np.int64)
    library().lvba_radix_argsort(_ptr(keys), keys.shape[0], _ptr(out))
    return out


def union_find(n: int, edges: np.ndarray) -> np.ndarray:
    """Component root of each of n nodes over (m, 2) int64 edges (union by
    size, path halving: the JAX package's native roots)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size and (edges.min() < 0 or edges.max() >= n):
        raise ValueError(f"an edge names a node outside [0, {n})")
    a = np.ascontiguousarray(edges[:, 0])
    b = np.ascontiguousarray(edges[:, 1])
    out = np.empty(n, dtype=np.int64)
    library().lvba_union_find(n, _ptr(a), _ptr(b), a.shape[0], _ptr(out))
    return out


def transform_points(pts: np.ndarray, fid: np.ndarray, R: np.ndarray,
                     p: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """out_i = R[fid_i] @ pts_i + p[fid_i] in float64, threaded."""
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    fid = np.ascontiguousarray(fid, dtype=np.int32)
    R = np.ascontiguousarray(R, dtype=np.float64)
    p = np.ascontiguousarray(p, dtype=np.float64)
    n, W = pts.shape[0], R.shape[0]
    if pts.shape != (n, 3) or fid.shape != (n,) or R.shape != (W, 3, 3) \
            or p.shape != (W, 3):
        raise ValueError("transform_points takes pts (N, 3), fid (N,), "
                         "R (W, 3, 3) and p (W, 3)")
    if n and (fid.min() < 0 or fid.max() >= W):
        raise ValueError(f"a frame id lies outside [0, {W})")
    out = np.empty_like(pts)
    library().lvba_transform_points(_ptr(pts), _ptr(fid), n, _ptr(R),
                                    _ptr(p), n_threads, _ptr(out))
    return out


def bin_moments(pts: np.ndarray, sort_idx: np.ndarray, starts: np.ndarray,
                n_threads: int = 0):
    """Per-segment (sum xyz (S, 3), sum of xxᵀ's 6 unique entries (S, 6))
    in float64 over rows sort_idx[starts[i]:starts[i + 1]] of pts, each
    segment summed in order."""
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    sort_idx = np.ascontiguousarray(sort_idx, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n, S = sort_idx.shape[0], starts.shape[0]
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {pts.shape}")
    if n and (sort_idx.min() < 0 or sort_idx.max() >= pts.shape[0]):
        raise ValueError("a sort index lies outside the points")
    if S and (starts[0] != 0 or starts[-1] >= max(n, 1)
              or np.any(np.diff(starts) <= 0)):
        raise ValueError("starts must rise strictly from 0 below N")
    sums = np.empty((S, 3), dtype=np.float64)
    moms = np.empty((S, 6), dtype=np.float64)
    library().lvba_bin_moments(_ptr(pts), _ptr(sort_idx), n, _ptr(starts),
                               S, n_threads, _ptr(sums), _ptr(moms))
    return sums, moms
