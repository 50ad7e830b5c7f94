"""SIFT feature extraction on the device (port of
global_lvba_tpu.frontend.sift, plain torch, batched over images).

The pipeline of SiftGPU with `-fo -1 -t 0.01 -e 12`:
  * Gaussian scale space (first octave -1 = 2x upsample), 3 intervals per
    octave, sigma0 = 1.6.  Every level blurs straight from the octave base
    as T_v(sigma) @ img @ T_h(sigma), two batched matmuls per octave in
    full float32 (resolve_device sets TF32 off); the first octave folds the
    2x bilinear upsample into the operands.  The operands are built once
    per (shape, sigmas, device, dtype) and cached, so no call copies a
    constant from the host;
  * DoG extrema over the 3x3x3 neighbourhood (max_pool3d, -inf padding),
    contrast threshold 0.01 and edge rejection r = 12;
  * per-octave candidate selection by an exact top-k of the strongest
    scale per pixel, one Newton step of sub-pixel refinement;
  * a 36-bin weighted orientation histogram per keypoint, built from 36
    masked sums (no atomics: the secondary-peak test is repeatable), with
    keypoints duplicated at secondary peaks >= 0.8 * max;
  * 4x4x8 = 128-d descriptors: every pixel of the keypoint's 64x64
    gradient patch is rotated into the keypoint frame and trilinearly
    binned; normalize -> clip 0.2 -> renormalize.

Each image yields exactly `max_kp` slots ranked by |DoG| response, with a
validity mask.  Ties in the ranking take the lower slot first (a stable
sort), as lax.top_k does.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device


class SiftParams(NamedTuple):
    n_octaves: int = 5
    n_scales: int = 3            # intervals per octave
    sigma0: float = 1.6
    first_octave: int = -1       # -1: upsample x2 (SiftGPU -fo -1)
    contrast_thr: float = 0.01   # SiftGPU -t
    edge_thr: float = 12.0       # SiftGPU -e
    max_kp: int = 2048
    ori_bins: int = 36
    patch: int = 16              # descriptor sample grid
    n_orientations: int = 2      # keypoint copies at 0.8-peak orientations


class SiftFeatures(NamedTuple):
    """Per image (or with a leading batch axis B): K = max_kp slots."""

    xy: torch.Tensor           # (K, 2) pixel coords in the original image
    sigma: torch.Tensor        # (K,)
    response: torch.Tensor     # (K,) |DoG| value
    orientation: torch.Tensor  # (K,) radians
    desc: torch.Tensor         # (K, 128) L2-normalized
    valid: torch.Tensor        # (K,) bool


_PSZ = 64   # gradient patch per keypoint: covers the descriptor span
_OSZ = 24   # orientation window inside the patch (±3·sigma_max, margin)


def _toeplitz_gauss_np(n: int, sigma: float) -> np.ndarray:
    """(n, n) banded Toeplitz matrix of a truncated, globally normalized
    1-D Gaussian: zero-padding 'SAME' convolution as a matmul operand."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    d = np.arange(n)[:, None] - np.arange(n)[None, :]
    k = np.exp(-0.5 * (d.astype(np.float64) / sigma) ** 2)
    k[np.abs(d) > radius] = 0.0
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k /= np.exp(-0.5 * (t / sigma) ** 2).sum()
    return k.astype(np.float32)


def _upsample2_matrix_np(n: int) -> np.ndarray:
    """(2n, n) centered bilinear 2x-upsample operator (half-pixel centers,
    edge clamp)."""
    i = np.arange(2 * n)
    src = (i + 0.5) / 2.0 - 0.5
    i0 = np.floor(src).astype(np.int64)
    w1 = src - i0
    U = np.zeros((2 * n, n), dtype=np.float32)
    c0 = np.clip(i0, 0, n - 1)
    c1 = np.clip(i0 + 1, 0, n - 1)
    U[i, c0] += (1.0 - w1).astype(np.float32)
    U[i, c1] += w1.astype(np.float32)
    return U


@functools.lru_cache(maxsize=64)
def _blur_operands(H: int, W: int, sigmas: tuple, upsample2: bool,
                   device: torch.device, dtype: torch.dtype):
    """(Tv (L, H', H), Th (L, W, W')) on `device`, built once.  The values
    are the JAX package's float32 constants, cast to `dtype`."""
    if upsample2:
        Uv = _upsample2_matrix_np(H)
        Uh = _upsample2_matrix_np(W)
        Tv = np.stack([_toeplitz_gauss_np(2 * H, s) @ Uv for s in sigmas])
        Th = np.stack([(_toeplitz_gauss_np(2 * W, s) @ Uh).T for s in sigmas])
    else:
        Tv = np.stack([_toeplitz_gauss_np(H, s) for s in sigmas])
        Th = np.stack([_toeplitz_gauss_np(W, s) for s in sigmas])
    return (torch.as_tensor(Tv).to(device, dtype),
            torch.as_tensor(Th).to(device, dtype))


def _gauss_levels(base: torch.Tensor, sigmas, upsample2: bool) -> torch.Tensor:
    """Blur base (B, H, W) by each sigma: (B, L, H', W')."""
    _, H, W = base.shape
    Tv, Th = _blur_operands(H, W, tuple(sigmas), upsample2, base.device,
                            base.dtype)
    t = torch.matmul(Tv[None], base[:, None])        # (B, L, H', W)
    return torch.matmul(t, Th[None])                 # (B, L, H', W')


def _local_extrema(dog: torch.Tensor) -> torch.Tensor:
    """(B, S, H, W) -> bool mask of 26-neighbourhood extrema (the window
    is padded with -inf / +inf, as reduce_window SAME)."""
    x = dog[:, None]
    mx = F.max_pool3d(x, 3, stride=1, padding=1)[:, 0]
    mn = -F.max_pool3d(-x, 3, stride=1, padding=1)[:, 0]
    return (dog >= mx) | (dog <= mn)


def _extract_octave(gauss: torch.Tensor, params: SiftParams, k: int):
    """Detect and refine keypoints in one octave of gauss (B, S+3, H, W).

    Returns (xy (B, k, 2) octave coords, scale index (B, k), sigma in
    octave units (B, k), DoG value (B, k), valid (B, k))."""
    S = params.n_scales
    dog = gauss[:, 1:] - gauss[:, :-1]               # (B, S+2, H, W)
    B, L, Hh, Ww = dog.shape
    dev = dog.device
    cand = _local_extrema(dog) & (dog.abs() > 0.8 * params.contrast_thr)
    smask = torch.zeros(L, dtype=torch.bool, device=dev)
    smask[1:S + 1] = True
    border = 5
    bm = torch.zeros((Hh, Ww), dtype=torch.bool, device=dev)
    bm[border:-border, border:-border] = True
    cand = cand & smask[None, :, None, None] & bm[None, None]
    score = torch.where(cand, dog.abs(), torch.zeros_like(dog))
    # the strongest scale per pixel (first on ties, as argmax), then an
    # exact top-k over the pixels
    px_max, px_arg = score.max(dim=1)                # (B, H, W)
    top_val, top_idx = torch.topk(px_max.reshape(B, -1), k, dim=1)
    yy = torch.div(top_idx, Ww, rounding_mode="floor")
    xx = top_idx - yy * Ww
    s_idx = torch.gather(px_arg.reshape(B, -1), 1, top_idx)
    valid = top_val > 0

    # the 3x3x3 neighbourhood of each candidate (indices clamped: only
    # invalid slots can reach the border)
    r = torch.arange(-1, 2, device=dev)
    ss = (s_idx[..., None] + r).clamp(0, L - 1)
    ys = (yy[..., None] + r).clamp(0, Hh - 1)
    xs = (xx[..., None] + r).clamp(0, Ww - 1)
    flat = ((ss[..., :, None, None] * Hh + ys[..., None, :, None]) * Ww
            + xs[..., None, None, :]).reshape(B, -1)
    nb = torch.gather(dog.reshape(B, -1), 1, flat).reshape(B, k, 3, 3, 3)

    def d(ds, dy, dx):
        return nb[..., ds + 1, dy + 1, dx + 1]

    g0 = 0.5 * (d(0, 0, 1) - d(0, 0, -1))
    g1 = 0.5 * (d(0, 1, 0) - d(0, -1, 0))
    g2 = 0.5 * (d(1, 0, 0) - d(-1, 0, 0))
    dxx = d(0, 0, 1) + d(0, 0, -1) - 2 * d(0, 0, 0)
    dyy = d(0, 1, 0) + d(0, -1, 0) - 2 * d(0, 0, 0)
    dss = d(1, 0, 0) + d(-1, 0, 0) - 2 * d(0, 0, 0)
    dxy = 0.25 * (d(0, 1, 1) - d(0, 1, -1) - d(0, -1, 1) + d(0, -1, -1))
    dxs = 0.25 * (d(1, 0, 1) - d(1, 0, -1) - d(-1, 0, 1) + d(-1, 0, -1))
    dys = 0.25 * (d(1, 1, 0) - d(1, -1, 0) - d(-1, 1, 0) + d(-1, -1, 0))
    # Cramer's-rule 3x3 solve of the Newton step
    a11, a12, a13 = dxx + 1e-9, dxy, dxs
    a22, a23, a33 = dyy + 1e-9, dys, dss + 1e-9
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    det = a11 * c11 + a12 * c12 + a13 * c13
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    off = -torch.stack([
        c11 * g0 + c12 * g1 + c13 * g2,
        c12 * g0 + c22 * g1 + c23 * g2,
        c13 * g0 + c23 * g1 + c33 * g2,
    ], dim=-1) / det[..., None]
    off = off.clamp(-0.5, 0.5)
    val = d(0, 0, 0) + 0.5 * (g0 * off[..., 0] + g1 * off[..., 1]
                              + g2 * off[..., 2])
    # edge rejection on the 2x2 spatial Hessian
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    rr = params.edge_thr
    edge_ok = (det2 > 0) & (tr * tr * rr < (rr + 1) ** 2 * det2)
    valid = valid & edge_ok & (val.abs() > params.contrast_thr)
    fdt = dog.dtype
    x_ref = xx.to(torch.float32).to(fdt) + off[..., 0]
    y_ref = yy.to(torch.float32).to(fdt) + off[..., 1]
    s_ref = s_idx.to(torch.float32).to(fdt) + off[..., 2]
    sigma_o = params.sigma0 * (2.0 ** (s_ref / S))
    return torch.stack([x_ref, y_ref], dim=-1), s_idx, sigma_o, val, valid


def _patch_gather(img: torch.Tensor, rows: torch.Tensor, y0: torch.Tensor,
                  x0: torch.Tensor, size: int) -> torch.Tensor:
    """(N, size, size) crops of img (R, H, W) at row rows[n], top-left
    (y0[n], x0[n]); the crops must lie inside img."""
    _, H, W = img.shape
    a = torch.arange(size, device=img.device)
    idx = ((rows[:, None, None] * H + y0[:, None, None] + a[None, :, None])
           * W + x0[:, None, None] + a[None, None, :])
    return img.reshape(-1)[idx.reshape(-1)].reshape(-1, size, size)


def _extract_patches(gauss_int: torch.Tensor, xy: torch.Tensor,
                     scale_idx: torch.Tensor):
    """Per-keypoint (PSZ, PSZ) central-difference gradient patches of
    gauss_int (B, S, H, W) at xy (B, K, 2), scale scale_idx (B, K).

    Returns (dx (B, K, PSZ, PSZ), dy, origin (B, K, 2) patch -> octave)."""
    B, S, H, W = gauss_int.shape
    K = xy.shape[1]
    P2 = _PSZ + 2
    if H < P2 or W < P2:
        # tiny octaves: edge-pad so the fixed-size crop always fits
        gauss_int = F.pad(gauss_int, (0, max(0, P2 - W), 0, max(0, P2 - H)),
                          mode="replicate")
        H, W = max(H, P2), max(W, P2)
    # .to(int32) truncates toward zero, as astype(int32)
    x0 = (xy[..., 0].to(torch.int32) - _PSZ // 2 - 1).clamp(0, max(W - P2, 0))
    y0 = (xy[..., 1].to(torch.int32) - _PSZ // 2 - 1).clamp(0, max(H - P2, 0))
    b = torch.arange(B, device=xy.device)[:, None]
    rows = (b * S + scale_idx).reshape(-1).long()
    patch = _patch_gather(gauss_int.reshape(B * S, H, W), rows,
                          y0.reshape(-1).long(), x0.reshape(-1).long(), P2)
    patch = patch.reshape(B, K, P2, P2)
    dx = 0.5 * (patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2])
    dy = 0.5 * (patch[..., 2:, 1:-1] - patch[..., :-2, 1:-1])
    return dx, dy, torch.stack([x0 + 1, y0 + 1], dim=-1)


def _crop_ori_window(mpx, apx, xy_loc):
    """(OSZ, OSZ) crops of the gradient patches (N, P, P) centred on the
    keypoint (clamped at the patch border).  Returns (m, a, xy local)."""
    N, P, _ = mpx.shape
    x0 = (xy_loc[:, 0].to(torch.int32) - _OSZ // 2).clamp(0, P - _OSZ).long()
    y0 = (xy_loc[:, 1].to(torch.int32) - _OSZ // 2).clamp(0, P - _OSZ).long()
    rows = torch.arange(N, device=mpx.device)
    mo = _patch_gather(mpx, rows, y0, x0, _OSZ)
    ao = _patch_gather(apx, rows, y0, x0, _OSZ)
    org = torch.stack([x0, y0], dim=-1).to(xy_loc.dtype)
    return mo, ao, xy_loc - org


def _orientations(mpx, apx, xy_loc, sigma, params: SiftParams):
    """Dominant and secondary orientation per keypoint from its gradient
    window (N, P, P), every pixel voting into a 36-bin histogram with
    Gaussian weight exp(-r^2 / 2(1.5s)^2), truncated at |r| <= 3s.

    Returns (theta1 (N,), theta2 (N,), has2 (N,)): theta2 is the largest
    strict local peak >= 0.8 * max outside the dominant bin."""
    NB = params.ori_bins
    N, P, _ = mpx.shape
    ar = torch.arange(P, dtype=mpx.dtype, device=mpx.device)
    rx = ar[None, None, :] - xy_loc[:, 0, None, None]    # (N, 1, P)
    ry = ar[None, :, None] - xy_loc[:, 1, None, None]    # (N, P, 1)
    sw = torch.clamp(1.5 * sigma, min=1e-3)[:, None, None]
    span = torch.clamp(3.0 * sigma, min=1e-3)[:, None, None]
    w = torch.exp(-(rx * rx + ry * ry) / (2.0 * sw * sw))
    w = torch.where((rx.abs() <= span) & (ry.abs() <= span), w,
                    torch.zeros_like(w))
    bins = torch.remainder(
        torch.floor((apx + math.pi) / (2 * math.pi) * NB).to(torch.int32), NB)
    mw = (mpx * w).reshape(N, -1)
    binsf = bins.reshape(N, -1)
    zero = torch.zeros((), dtype=mw.dtype, device=mw.device)
    # 36 masked sums: a fixed reduction order, no atomics
    hist = torch.stack(
        [torch.where(binsf == b, mw, zero).sum(dim=-1) for b in range(NB)],
        dim=-1)                                          # (N, NB)
    for _ in range(2):                                   # circular smooth x2
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0

    def at(ob):
        return torch.gather(hist, 1, ob[:, None])[:, 0]

    def peak_theta(ob):
        left = at(torch.remainder(ob - 1, NB))
        c = at(ob)
        right = at(torch.remainder(ob + 1, NB))
        denom = left - 2 * c + right
        delta = torch.where(denom.abs() > 1e-12, 0.5 * (left - right) / denom,
                            torch.zeros_like(denom))
        return (ob + delta + 0.5) / NB * 2 * math.pi - math.pi

    ob = torch.argmax(hist, dim=-1)
    theta1 = peak_theta(ob)
    left = torch.roll(hist, 1, -1)
    right = torch.roll(hist, -1, -1)
    is_peak = (hist > left) & (hist >= right)
    idxs = torch.arange(NB, device=hist.device)[None, :]
    cand = is_peak & (idxs != ob[:, None]) & (hist >= 0.8 * at(ob)[:, None])
    v2 = torch.where(cand, hist, torch.full_like(hist, -1.0))
    ob2 = torch.argmax(v2, dim=-1)
    has2 = torch.gather(v2, 1, ob2[:, None])[:, 0] > 0
    return theta1, peak_theta(ob2), has2


def _descriptors(mpx, apx, xy_loc, sigma, theta, chunk: int = 256):
    """128-d descriptor per row of the gradient patches (N, P, P): each
    pixel rotated into the keypoint frame, hat-weighted over the (4, 4, 8)
    bin grid (bin width 3·sigma) and contracted as one batched matmul per
    chunk of `chunk` rows (the (C, P·P, 16) weight tensor is 67 MB at
    C = 256 in float32)."""
    N, P, _ = mpx.shape
    S = P * P
    dt, dev = mpx.dtype, mpx.device
    ar = torch.arange(P, dtype=dt, device=dev)
    c4 = torch.arange(4, dtype=dt, device=dev)
    c8 = torch.arange(8, dtype=dt, device=dev)
    out = []
    for lo in range(0, N, chunk):
        mc, ac = mpx[lo:lo + chunk], apx[lo:lo + chunk]
        xyc, sgc, thc = xy_loc[lo:lo + chunk], sigma[lo:lo + chunk], \
            theta[lo:lo + chunk]
        C = mc.shape[0]
        rx = ar[None, None, :] - xyc[:, 0, None, None]   # (C, 1, P)
        ry = ar[None, :, None] - xyc[:, 1, None, None]   # (C, P, 1)
        hw = torch.clamp(3.0 * sgc, min=1e-3)[:, None, None]
        ct = torch.cos(thc)[:, None, None]
        st = torch.sin(thc)[:, None, None]
        gv = (rx * ct + ry * st) / hw
        gu = (-rx * st + ry * ct) / hw
        wgt = torch.exp(-(gu * gu + gv * gv) / (2.0 * 2.0 ** 2))
        contrib = (mc * wgt).reshape(C, S)
        bu = (gu + 2.0 - 0.5).reshape(C, S)
        bv = (gv + 2.0 - 0.5).reshape(C, S)
        ob8 = (torch.remainder(ac - thc[:, None, None], 2 * math.pi)
               / (2 * math.pi) * 8.0).reshape(C, S)
        Au = torch.clamp(1.0 - (bu[..., None] - c4).abs(), min=0.0)
        Av = torch.clamp(1.0 - (bv[..., None] - c4).abs(), min=0.0)
        do_ = (ob8[..., None] - c8).abs()
        do_ = torch.minimum(do_, 8.0 - do_)                # circular
        Ao = torch.clamp(1.0 - do_, min=0.0)               # (C, S, 8)
        T = (contrib[..., None] * Au)[..., :, None] * Av[..., None, :]
        d = torch.bmm(T.reshape(C, S, 16).transpose(1, 2), Ao).reshape(C, 128)
        d = torch.clamp(d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True)
                             + 1e-12), max=0.2)
        out.append(d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True)
                        + 1e-12))
    return torch.cat(out) if out else mpx.new_zeros((0, 128))


def _as_batch(images, device) -> torch.Tensor:
    """(B, H, W) tensor on `device`: float64 stays float64, anything else
    becomes float32."""
    x = torch.as_tensor(images)
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.to(device=device, dtype=dt)


def extract_sift_batch(images, params: SiftParams = SiftParams(),
                       device="cuda") -> SiftFeatures:
    """SIFT features of a batch of grayscale images (B, H, W) in [0, 1];
    every leaf has a leading axis B.  Runs without a host sync."""
    dev = resolve_device(device)
    img = _as_batch(images, dev)
    B = img.shape[0]
    S = params.n_scales
    upsample_first = params.first_octave == -1
    first_scale = 0.5 if upsample_first else 1.0
    base_sigma = 0.5 / first_scale      # assumed camera blur, at octave 0
    octave_img = img
    all_xy, all_sigma, all_resp, all_theta, all_desc, all_valid = \
        [], [], [], [], [], []
    for o in range(params.n_octaves):
        kp_per_octave = max(64, params.max_kp // 2 >> o)
        if octave_img.shape[1] < 16 or octave_img.shape[2] < 16:
            break
        scale = first_scale * (2 ** o)
        lvl0_from_base = base_sigma < params.sigma0 - 1e-6
        incs = []
        for s in range(0 if lvl0_from_base else 1, S + 3):
            sig_abs = params.sigma0 * 2 ** (s / S)
            incs.append(math.sqrt(max(sig_abs ** 2 - base_sigma ** 2, 0.01)))
        levels = _gauss_levels(octave_img, incs,
                               upsample2=(o == 0 and upsample_first))
        gauss = levels if lvl0_from_base else torch.cat(
            [octave_img[:, None], levels], dim=1)
        xy, s_idx, sigma_o, resp, valid = _extract_octave(
            gauss, params, kp_per_octave)
        K = xy.shape[1]
        sclamp = (s_idx - 1).clamp(0, S - 1)
        dxp, dyp, origin = _extract_patches(gauss[:, 1:S + 1], xy, sclamp)
        xy_loc = (xy - origin.to(xy.dtype)).reshape(B * K, 2)
        mpx = torch.sqrt(dxp * dxp + dyp * dyp).reshape(B * K, _PSZ, _PSZ)
        apx = torch.atan2(dyp, dxp).reshape(B * K, _PSZ, _PSZ)
        sig_f = sigma_o.reshape(-1)
        mo, ao, xy_o = _crop_ori_window(mpx, apx, xy_loc)
        theta1, theta2, has2 = _orientations(mo, ao, xy_o, sig_f, params)
        theta1, theta2, has2 = (t.reshape(B, K) for t in (theta1, theta2, has2))
        if params.n_orientations >= 2:
            # keypoints duplicated at secondary orientation peaks; one
            # descriptor pass over both orientations, rows (b, copy, k)
            th_d = torch.cat([theta1, theta2], dim=1)
            th2 = torch.stack([theta1, theta2], dim=1).reshape(-1)
            rep = lambda t: t.reshape(B, 1, K, *t.shape[1:]).expand(
                B, 2, K, *t.shape[1:]).reshape(B * 2 * K, *t.shape[1:])
            desc_d = _descriptors(rep(mpx), rep(apx), rep(xy_loc), rep(sig_f),
                                  th2).reshape(B, 2 * K, 128)
            xy_d = torch.cat([xy, xy], dim=1)
            sig_d = torch.cat([sigma_o, sigma_o], dim=1)
            valid_d = torch.cat([valid, valid & has2], dim=1)
            resp_d = torch.cat([resp, resp], dim=1)
        else:
            th_d = theta1
            desc_d = _descriptors(mpx, apx, xy_loc, sig_f,
                                  theta1.reshape(-1)).reshape(B, K, 128)
            xy_d, sig_d, valid_d, resp_d = xy, sigma_o, valid, resp
        all_xy.append((xy_d + 0.5) * scale - 0.5)
        all_sigma.append(sig_d * scale)
        all_resp.append(resp_d.abs())
        all_theta.append(th_d)
        all_desc.append(desc_d)
        all_valid.append(valid_d)
        octave_img = gauss[:, S, ::2, ::2]
        base_sigma = params.sigma0

    xy = torch.cat(all_xy, dim=1)
    resp = torch.cat(all_resp, dim=1)
    valid = torch.cat(all_valid, dim=1)
    # global top max_kp by response; a stable sort puts the lower slot
    # first on ties (a keypoint before its second-orientation copy)
    score = torch.where(valid, resp, torch.full_like(resp, -1.0))
    k = min(params.max_kp, score.shape[1])
    top_val, order = torch.sort(score, dim=1, descending=True, stable=True)
    top_val, top = top_val[:, :k], order[:, :k]

    def pick(t):
        return torch.gather(t, 1, top.reshape(B, k, *([1] * (t.dim() - 2)))
                            .expand(B, k, *t.shape[2:]))

    return SiftFeatures(
        xy=pick(xy), sigma=pick(torch.cat(all_sigma, dim=1)),
        response=pick(resp), orientation=pick(torch.cat(all_theta, dim=1)),
        desc=pick(torch.cat(all_desc, dim=1)), valid=top_val > 0)


def extract_sift(image, params: SiftParams = SiftParams(),
                 device="cuda") -> SiftFeatures:
    """SIFT features of one grayscale image (H, W) in [0, 1]: a batch of
    one."""
    f = extract_sift_batch(torch.as_tensor(image)[None], params, device)
    return SiftFeatures(*(x[0] for x in f))


def from_jax_features(xy, sigma, response, orientation, desc, valid,
                      device="cuda", dtype=torch.float32) -> SiftFeatures:
    """Carries the JAX package's SiftFeatures, handed over as numpy
    (np.asarray of each leaf), into the port's SiftFeatures on `device`."""
    dev = resolve_device(device)

    def put(x):
        return torch.as_tensor(np.array(x)).to(dev, dtype)

    return SiftFeatures(xy=put(xy), sigma=put(sigma), response=put(response),
                        orientation=put(orientation), desc=put(desc),
                        valid=torch.as_tensor(np.array(valid, bool)).to(dev))
