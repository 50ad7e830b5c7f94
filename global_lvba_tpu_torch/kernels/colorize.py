"""The colored clouds' z-buffer over all images of a call in one launch
(csrc/colorize.cu), beside its plain torch version.

It replaces no Pallas kernel: the JAX package colorizes on the host in
numpy (global_lvba_tpu/pipeline/outputs.py:81 colorize_clouds).  For each
image k, the world points of its +-half_w LiDAR window (a contiguous run
[lo_k, hi_k) of the frames' concatenated world points, found on the host
by searchsorted as there) are projected in float64, operation by
operation as numpy rounds it:
  * Xc = p Rcwᵀ + t with R p formed as numpy's BLAS forms it, the chain
    fma(R2, p2, fma(R1, p1, R0 p0)), then + t;
  * Z > 1e-12, x = X / Z, y = Y / Z, r2 = x x + y y, radial = 1 + k1 r2 +
    k2 r2 r2, the tangential terms left to right, u = rint(clip(fx xd + cx,
    -1, W)), v likewise, a pixel when 0 <= u < W and 0 <= v < H;
and each pixel keeps its nearest point, the least point index among
equal depths: numpy's stable lexsort((Z, lin)) and its first row per
pixel.  The kernel projects each window point once and keeps the pair
(Z, index) of a pixel by a 16-byte compare-and-swap, in slabs of whole
images whose cells fit in L2 (slab_pixels), and compacts each slab's
picks on the card, image by image in ascending pixel order, the JAX
function's row order; its picks are bitwise repeatable and bitwise the
plain version's.  The same launch checks the windows; the wrapper reads
the pick count and that status back once a call.
The plain version emulates each FMA exactly (error-free product and sum,
the low parts added rounded to odd: Boldo and Melquiond's emulation),
since torch has no fused multiply-add.
Bound: operations (COLORIZE_OPS float64 operations a window point, none
fused but the chain's, each an FMA issue slot); the bytes are the points
and poses once and the picks once.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = {"colorize": 0}
# float64 operations a window point: R p + t (3 products, 6 FMAs, 3 sums),
# 2 quotients, r2 (3), radial (4), xd and yd (9 each), u and v (4)
COLORIZE_OPS = 43
NONE = 2 ** 31 - 1     # a pixel no point reached
# the kernel's block, the pixels a block compacts (a bitmap word a
# thread), the most images of a slab and the most cells of a slab (16
# bytes each: 32 MiB of the card's 50 MB L2); csrc/colorize.cu takes the
# first three as -D flags
THREADS = 256
STASH = 32 * THREADS
SLAB_IMAGES = 64
SLAB_CELLS = 1 << 21
_BLOCKS_ON: dict = {}
_SCRATCH_ON: dict = {}


def _intrinsics(cam):
    return [float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy, cam.k1,
                               cam.k2, cam.p1, cam.p2)]


def _cams(Rcw, tcw, dev):
    """The poses (M, 12) float64 on `dev`; host poses go to the card from
    pinned memory without a wait, so a call's one synchronization stays
    its read back."""
    M = Rcw.shape[0]
    c = torch.cat([torch.as_tensor(Rcw).reshape(M, 9),
                   torch.as_tensor(tcw).reshape(M, 3)], dim=1).to(
        dtype=torch.float64)
    if dev.type == "cuda" and c.device.type == "cpu":
        return c.contiguous().pin_memory().to(dev, non_blocking=True)
    return c.to(dev).contiguous()


def _picks(idx: torch.Tensor, W: int):
    """(image, pixel row v, pixel column u, point) int64 of the pixels of
    the (M, H * W) pick map that a point reached, image by image in
    ascending pixel order."""
    m, lin = torch.nonzero(idx != NONE, as_tuple=True)
    return m, lin // W, lin % W, idx[m, lin].long()


def _check_windows(lo, hi, n):
    """The windows are runs of the points: 0 <= lo <= hi <= n (the plain
    version's check; the kernel makes the same one)."""
    if bool(((lo < 0) | (lo > hi) | (hi > n)).any()):
        raise ValueError(f"colorize: each window [lo, hi) must lie in "
                         f"[0, {n}] with lo <= hi")


def slab_pixels(HW: int, blocks: int) -> int:
    """Pixels a slab of the kernel walks for images of HW pixels and a
    grid of `blocks` blocks: whole images (at most SLAB_IMAGES) whose
    cells fit in SLAB_CELLS and the blocks' STASH pixels each; an image
    larger than that is cut into slabs of that many pixels."""
    cap = min(SLAB_CELLS, blocks * STASH)
    if HW <= cap:
        return min(SLAB_IMAGES, cap // HW) * HW
    return cap


def slabs(M: int, HW: int, S: int):
    """The kernel's slabs over the call's M * HW pixels, image-major:
    [(first pixel, end), ...] of S pixels each, the last shorter."""
    return [(g, min(g + S, M * HW)) for g in range(0, M * HW, S)]


def compact_plain(idx: torch.Tensor, S: int, blocks: int) -> torch.Tensor:
    """The kernel's compaction of the (M, H * W) pick map, in its order:
    slab by slab, block by block (STASH pixels each), word by word, bit by
    bit; each pick packed as (image * H * W + pixel) << 32 | point."""
    flat = idx.reshape(-1).long()
    out = []
    for g0, g1 in slabs(idx.shape[0], idx.shape[1], S):
        for b in range(blocks):
            a = g0 + b * STASH
            if a >= g1:
                break
            part = flat[a:min(a + STASH, g1)]
            at = torch.nonzero(part != NONE).squeeze(1)
            out.append(((at + a) << 32) | part[at])
    return torch.cat(out) if out else flat.new_zeros(0)


def unpack_picks(packed: torch.Tensor, H: int, W: int):
    """(image, v, u, point) int64 of the kernel's packed picks."""
    g = packed >> 32
    HW = H * W
    m = g // HW
    lin = g - m * HW
    v = lin // W
    return m, v, lin - v * W, packed & 0xFFFFFFFF


def _blocks(dev) -> int:
    """The cooperative grid on `dev`: the kernel's resident blocks an SM
    times the SMs."""
    n = _BLOCKS_ON.get(dev)
    if n is None:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = build.launcher("colorize_occupancy")(ctypes.byref(per_sm))
        build.check("colorize_occupancy", err)
        if per_sm.value < 1:
            raise RuntimeError("colorize_kernel does not fit on an SM")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n = _BLOCKS_ON[dev] = sms * per_sm.value
    return n


def _scratch(dev, S: int, blocks: int):
    """The kernel's empty cells (S, 16 bytes of 0xff), its bitmap (0) and
    its blocks' counts on `dev`: made once; each launch leaves the cells
    and the bitmap empty."""
    buf = _SCRATCH_ON.get(dev)
    if buf is None or buf[0].shape[0] < S or buf[2].shape[0] < blocks:
        buf = _SCRATCH_ON[dev] = (
            torch.full((S, 2), -1, dtype=torch.int64, device=dev),
            torch.zeros(((S + 31) // 32,), dtype=torch.int32, device=dev),
            torch.empty((blocks,), dtype=torch.int64, device=dev))
    return buf


def colorize(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
             Rcw, tcw, cam):
    """Each image's nearest window point per pixel: (image, v, u, point)
    int64 tensors, image by image in ascending pixel order.

    points (N, 3) float64 world points; image k projects points[lo[k] :
    hi[k]] (lo, hi int64 (M,)) through Rcw[k] (3, 3), tcw[k] (3,) and the
    camera `cam`.  CPU tensors take colorize_plain; on a CUDA tensor the
    kernel runs or this raises.  A window outside the points raises.  On
    the card the call reads the pick count and the kernel's status back
    once, so it synchronizes once."""
    dev = points.device
    if dev.type == "cpu":
        _check_windows(lo, hi, points.shape[0])
        return colorize_plain(points, lo, hi, Rcw, tcw, cam)
    if dev.type != "cuda":
        raise ValueError(f"colorize: unsupported device {dev}")
    if points.dim() != 2 or points.shape[1] != 3 \
            or points.dtype != torch.float64 or not points.is_contiguous():
        raise ValueError("points must be a contiguous (N, 3) float64 tensor")
    N = points.shape[0]
    if N >= NONE:
        raise ValueError("colorize takes fewer than 2^31 - 1 points")
    M = lo.shape[0]
    for t, what in ((lo, "lo"), (hi, "hi")):
        if t.shape != (M,) or t.dtype != torch.int64 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous (M,) int64 tensor "
                             f"on the points' device")
    H, W = int(cam.height), int(cam.width)
    if M * H * W >= 2 ** 32:
        raise ValueError("colorize takes fewer than 2^32 pixels a call")
    cams = _cams(Rcw, tcw, dev)
    if cams.shape != (M, 12):
        raise ValueError(f"Rcw must be ({M}, 3, 3) and tcw ({M}, 3)")
    blocks = _blocks(dev) if M else 1
    S = slab_pixels(H * W, blocks) if H * W else STASH
    cells, words, counts = _scratch(dev, S, blocks)
    # at most one pick a pixel and a window point
    cap = max(1, M * min(H * W, N))
    packed = torch.empty((cap,), dtype=torch.int64, device=dev)
    meta = torch.empty((2,), dtype=torch.int64, device=dev)
    launch = build.launcher("colorize")
    with torch.cuda.device(dev):
        err = launch(ctypes.c_void_p(points.data_ptr()), N,
                     ctypes.c_void_p(lo.data_ptr()),
                     ctypes.c_void_p(hi.data_ptr()),
                     ctypes.c_void_p(cams.data_ptr()), M,
                     *_intrinsics(cam), W, H, S, blocks,
                     ctypes.c_void_p(cells.data_ptr()),
                     ctypes.c_void_p(words.data_ptr()),
                     ctypes.c_void_p(counts.data_ptr()),
                     ctypes.c_void_p(packed.data_ptr()), cap,
                     ctypes.c_void_p(meta.data_ptr()),
                     ctypes.c_void_p(torch.cuda.current_stream(dev)
                                     .cuda_stream))
    build.check("colorize", err)
    LAUNCHES["colorize"] += 1
    n, status = meta.tolist()      # the call's one read back
    if status & 1:
        raise ValueError(f"colorize: each window [lo, hi) must lie in "
                         f"[0, {N}] with lo <= hi")
    if status:
        raise RuntimeError(f"colorize: kernel status {status}")
    return unpack_picks(packed[:n], H, W)


# ---------------------------------------------------------------------------
# exact float64 fused multiply-add from separately rounded torch ops

_SPLIT = 134217729.0   # 2^27 + 1, Veltkamp's splitter for float64


def _two_prod(a, b):
    p = a * b
    t = a * _SPLIT
    ah = t - (t - a)
    al = a - ah
    t = b * _SPLIT
    bh = t - (t - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _add_odd(a, b):
    """a + b rounded to odd: the nearest sum, moved one ulp toward the
    exact sum where it is inexact and its last bit is even."""
    s, e = _two_sum(a, b)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where((e != 0) & even, torch.nextafter(s, toward), s)


def fma64(a, b, c):
    """a * b + c rounded once (float64): RN(th + RO(tl + pl)) with a b = ph
    + pl and c + ph = th + tl exactly (Boldo and Melquiond)."""
    ph, pl = _two_prod(a, b)
    th, tl = _two_sum(c, ph)
    return th + _add_odd(tl, pl)


def _project(P, cam_row, k, W: int, H: int):
    """Float64 (ok, u, v, Z) of the points P (n, 3) through one image's
    pose row (12,), the 8 intrinsics k and the image size, as
    colorize_clouds computes them (ok: in front and finite; u, v clipped
    and rounded, not yet checked against the image)."""
    fx, fy, cx, cy, k1, k2, p1, p2 = k
    px, py, pz = P.unbind(1)
    R = cam_row.unbind()

    def row(i):
        return fma64(R[3 * i + 2], pz, fma64(R[3 * i + 1], py,
                                             R[3 * i] * px)) + R[9 + i]

    X, Y, Z = row(0), row(1), row(2)
    ok = Z > 1e-12
    z = torch.where(ok, Z, torch.ones_like(Z))
    x, y = X / z, Y / z
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    ok &= torch.isfinite(xd) & torch.isfinite(yd)
    u = torch.round(torch.clamp(fx * torch.nan_to_num(xd) + cx, -1, W))
    v = torch.round(torch.clamp(fy * torch.nan_to_num(yd) + cy, -1, H))
    return ok, u.long(), v.long(), Z


def colorize_plain(points, lo, hi, Rcw, tcw, cam):
    """Plain torch version of colorize, an image at a time: the projection
    in separately rounded float64 ops (R p's FMAs emulated exactly), the
    least Z per pixel by scatter_reduce_("amin"), then the least index
    among the points at it."""
    dev = points.device
    H, W = int(cam.height), int(cam.width)
    k = _intrinsics(cam)
    cams = _cams(Rcw, tcw, dev)
    M = cams.shape[0]
    idx = torch.full((M, H * W), NONE, dtype=torch.int32, device=dev)
    los, his = lo.tolist(), hi.tolist()
    for m in range(M):
        if his[m] <= los[m]:
            continue
        P = points[los[m]:his[m]]
        ok, u, v, Z = _project(P, cams[m], k, W, H)
        ok &= (u >= 0) & (u < W) & (v >= 0) & (v < H)
        lin = (v * W + u)[ok]
        Zk = Z[ok]
        ids = torch.nonzero(ok).squeeze(1) + los[m]
        zmin = torch.full((H * W,), float("inf"), dtype=torch.float64,
                          device=dev).scatter_reduce_(0, lin, Zk, "amin")
        at = Zk == zmin[lin]
        best = torch.full((H * W,), NONE, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, lin[at], ids[at], "amin")
        idx[m] = best.to(torch.int32)
    return _picks(idx, W)
