"""PCD point-cloud reader (ascii / binary / binary_compressed) and a
minimal binary writer; the port's own copy of global_lvba_tpu.io.pcd.

Replaces the reference's PCL loadPCDFile dependency
(src/dataset_io.cpp:270).  Returns an (N, len(fields)) float32 array of
the requested fields (default x, y, z[, intensity]).  binary_compressed
uses PCL's LZF scheme (per-field column blocks), decoded by the native
host library (native/, the JAX package's C++ decoder, built with g++ at
first use) on any machine.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from ..native import runtime

_SIZES = {("F", 4): np.float32, ("F", 8): np.float64,
          ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
          ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32}


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """LZF decompression of a PCL binary_compressed payload, by the native
    library (native/runtime.lzf_decompress, the JAX package's C++
    decoder): a control byte below 32 starts a literal run of ctrl + 1
    bytes; any other is a back reference of (ctrl >> 5) + 2 bytes (7
    means a length byte follows), ((ctrl & 0x1F) << 8) + next byte + 1
    bytes back."""
    return runtime.lzf_decompress(data, expected)


def read_pcd(path, fields: Sequence[str] = ("x", "y", "z", "intensity")) -> np.ndarray:
    path = Path(path)
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        names = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        counts = list(map(int, header.get("COUNT", " ".join(["1"] * len(names))).split()))
        n_pts = int(header["POINTS"])
        mode = header["DATA"].split()[0]

        dtype_fields = []
        for nm, sz, tp, ct in zip(names, sizes, types, counts):
            base = _SIZES[(tp, sz)]
            if ct == 1:
                dtype_fields.append((nm, base))
            else:
                dtype_fields.append((nm, base, (ct,)))
        rec = np.dtype(dtype_fields)

        if mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, ndmin=2)
            cols = {}
            ci = 0
            for nm, ct in zip(names, counts):
                cols[nm] = raw[:, ci]
                ci += ct
            out = np.stack(
                [cols[nm] if nm in cols else np.zeros(raw.shape[0]) for nm in fields],
                axis=-1,
            ).astype(np.float32)
            return out
        elif mode == "binary":
            buf = f.read(rec.itemsize * n_pts)
            arr = np.frombuffer(buf, dtype=rec, count=n_pts)
        elif mode == "binary_compressed":
            comp_size, uncomp_size = np.frombuffer(f.read(8), dtype=np.uint32)
            payload = _lzf_decompress(f.read(int(comp_size)), int(uncomp_size))
            # column-major: each field's column stored contiguously
            arr = np.zeros(n_pts, dtype=rec)
            off = 0
            for nm, sz, ct in zip(names, sizes, counts):
                nbytes = sz * ct * n_pts
                col = np.frombuffer(payload[off : off + nbytes], dtype=rec[nm].base if ct > 1 else rec[nm])
                if ct > 1:
                    arr[nm] = col.reshape(n_pts, ct)
                else:
                    arr[nm] = col
                off += nbytes
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")

        out = np.zeros((n_pts, len(fields)), dtype=np.float32)
        for k, nm in enumerate(fields):
            if nm in arr.dtype.names:
                out[:, k] = arr[nm].astype(np.float32)
        return out


def write_pcd(path, pts: np.ndarray, fields: Sequence[str] = ("x", "y", "z")):
    """Minimal binary PCD writer (fixtures / exports)."""
    pts = np.asarray(pts, dtype=np.float32)
    n = pts.shape[0]
    hdr = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * len(fields))}\n"
        f"TYPE {' '.join(['F'] * len(fields))}\n"
        f"COUNT {' '.join(['1'] * len(fields))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(hdr.encode("ascii"))
        f.write(np.ascontiguousarray(pts[:, : len(fields)]).tobytes())
