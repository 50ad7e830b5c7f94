"""A JPEG writer for test data: the frames that cv2 and the port's encoder do
not write.  numpy and plain Python only, so that the tests,
scripts/make_image_fixtures.py and chip_smoke.py, on a machine without cv2,
share this one writer.

  * lossy(): sequential and progressive frames of 1 to 4 components under
    any sampling, Huffman-coded (sequential only, each scan's tables built
    from its own symbol counts, jcHuff's gen_optimal_table) or
    arithmetic-coded (jcarith.c's QM coder with jaricom.c's Qe table;
    sequential SOF9 and progressive SOF10, with a DAC segment and restart
    intervals on request).  Four components are CMYK, or YCCK under Adobe
    APP14 transform 2 (cmyk_from_bgr, ycck_from_cmyk; ycc_from_bgr for
    three).  Other SOF markers,
    precisions and component counts are written on request, for the
    frames that libjpeg refuses (SOF5, 12 bits, two components).
  * lossless(): SOF3 frames of 1, 3 or 4 components, precision 2-16,
    predictors 1-7, a point transform, interleaved or one scan a
    component, restart intervals of whole MCU rows.

The forward DCT and the quantisation match no encoder: the reference for
every file is cv2's decode of it, never the array it was made from."""

import heapq
import struct

import numpy as np

# the zigzag order: ZIGZAG[k] is the natural (row-major) index of the k-th
# coefficient
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
                   28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
                   44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47,
                   55, 62, 63])

# Annex K's quantisation tables (natural order)
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# jaricom.c: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) of each state
_QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1),
    (0x5a1d, 113, 113, 0)]  # state 113: the fixed probability 0.5
_ARITAB = [(qe << 16) | (nm << 8) | (sw << 7) | nl for qe, nl, nm, sw in _QE]

# 8-point DCT-II with JPEG's scaling: F = C @ block @ C.T
_C = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2
                * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
               for u in range(8)])


def segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def quant_table(base, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling of a base table, 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((np.asarray(base) * scale + 50) // 100, 1, 255)


# ---------------------------------------------------------------------------
# colour


def cmyk_from_bgr(bgr: np.ndarray) -> list:
    """Four planes (C, M, Y, K) whose CMYK JPEG cv2 reads back close to bgr:
    K the brightest channel, each of C, M, Y the inverse of cv2's
    x' = K - (((255 - x) K) >> 8) for R, G, B."""
    b = bgr.astype(np.float64)
    k = np.maximum(b.max(axis=2), 1.0)
    out = [np.clip(np.rint(255 - (k - b[:, :, i]) * 256 / k), 0, 255)
           .astype(np.uint8) for i in (2, 1, 0)]
    return out + [k.astype(np.uint8)]


def ycc_from_bgr(bgr: np.ndarray) -> list:
    """Y, Cb, Cr planes of a BGR image (JFIF's weights, rounded)."""
    b, g, r = (bgr[:, :, i].astype(np.float64) for i in range(3))
    planes = (0.299 * r + 0.587 * g + 0.114 * b,
              128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
              128 + 0.5 * r - 0.418688 * g - 0.081312 * b)
    return [np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in planes]


def ycck_from_cmyk(planes) -> list:
    """(Y, Cb, Cr, K) planes that libjpeg's ycck_cmyk_convert turns back
    into C, M, Y, K: the YCbCr of (255 - C, 255 - M, 255 - Y)."""
    inverse = np.stack([255 - p.astype(np.int64) for p in planes[2::-1]],
                       -1)
    return ycc_from_bgr(inverse) + [planes[3]]


# ---------------------------------------------------------------------------
# Huffman coding


def optimal_table(freq) -> tuple:
    """(bits (16,), symbols) of a Huffman code for symbol counts freq (a
    mapping symbol -> count), no code longer than 16 bits and none all
    ones: jcHuff's gen_optimal_table with a reserved symbol."""
    heap = [(int(c), s, (s,)) for s, c in freq.items() if c > 0]
    heap.append((1, 256, (256,)))
    heapq.heapify(heap)
    size = {s: 0 for _, s, _ in heap}
    while len(heap) > 1:
        c1, s1, m1 = heapq.heappop(heap)
        c2, s2, m2 = heapq.heappop(heap)
        for s in m1 + m2:
            size[s] += 1
        heapq.heappush(heap, (c1 + c2, min(s1, s2), m1 + m2))
    bits = [0] * 64
    for s in size:
        bits[size[s]] += 1
    for i in range(63, 16, -1):  # jcHuff's length limit
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved symbol's code, the longest
    # the symbols in order of their lengths fill the lengths after the
    # limit; the reserved symbol takes the last (all ones) code and drops out
    order = sorted(size, key=lambda s: (s == 256, size[s], s))
    return bits[1:17], order[:-1]


def _codes(bits, syms):
    """{symbol: (code, length)} of a canonical table (jdhuff's order)."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[syms[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def dht(tc: int, th: int, bits, syms) -> bytes:
    return segment(0xC4, bytes([(tc << 4) | th]) + bytes(bits) + bytes(syms))


def _bit_size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (0 for 0)."""
    a = np.abs(v).astype(np.int64)
    out = np.zeros(a.shape, np.int64)
    while np.any(a):
        nz = a > 0
        out += nz
        a >>= 1
    return out


def _extra(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The s extra bits of v: v if positive, else v - 1 in s bits."""
    return np.where(v >= 0, v, v + (1 << s) - 1).astype(np.int64)


def pack(values, lengths, groups) -> list:
    """The bytes of each group of (value, length) codes, the codes in
    order and the groups rising: each group padded with one bits to a
    byte and 0xFF-stuffed."""
    values = np.asarray(values, np.int64)
    lengths = np.asarray(lengths, np.int64)
    groups = np.asarray(groups, np.int64)
    n_groups = int(groups.max()) + 1
    per = np.bincount(groups, weights=lengths, minlength=n_groups).astype(
        np.int64)
    pad = (-per) % 8
    # a padding code after each group's last code
    key = np.concatenate([groups * 2, np.arange(n_groups) * 2 + 1])
    order = np.argsort(key, kind="stable")
    values = np.concatenate([values, (1 << pad) - 1])[order]
    lengths = np.concatenate([lengths, pad])[order]
    # each code (<= 32 bits) lies in the 5 bytes from its first one
    off = np.cumsum(lengths) - lengths
    first, sh = off >> 3, off & 7
    w = values << (40 - lengths - sh)
    nbytes = int(off[-1] + lengths[-1]) // 8
    idx = np.concatenate([first + j for j in range(5)])
    byt = np.concatenate([(w >> (32 - 8 * j)) & 0xFF for j in range(5)])
    data = np.bincount(idx, weights=byt, minlength=nbytes + 5)[
        :nbytes].astype(np.uint8)
    out, at = [], 0
    for n in (per + pad) // 8:
        chunk = data[at:at + n]
        at += n
        ff = np.nonzero(chunk == 0xFF)[0]
        out.append(np.insert(chunk, ff + 1, 0).tobytes())
    return out


def _join_intervals(chunks) -> bytes:
    """Restart intervals' bytes joined by RST0..RST7 markers."""
    out = bytearray(chunks[0])
    for i, c in enumerate(chunks[1:]):
        out += bytes([0xFF, 0xD0 + (i & 7)]) + c
    return bytes(out)


# ---------------------------------------------------------------------------
# frames


class _Comp:
    pass


def _layout(planes, sampling, block):
    """Components (id-less) with their sampling, downsampled planes and
    block grids for planes of one size; the frame's MCU grid."""
    H, W = planes[0].shape
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    mcux = -(-W // (block * max_h))
    mcuy = -(-H // (block * max_v))
    comps = []
    for plane, (h, v) in zip(planes, sampling):
        c = _Comp()
        c.h, c.v = h, v
        fx, fy = max_h // h, max_v // v
        c.dw, c.dh = -(-W * h // max_h), -(-H * v // max_v)
        c.wib, c.hib = -(-c.dw // block), -(-c.dh // block)
        c.bw, c.bh = mcux * h, mcuy * v
        p = np.pad(plane.astype(np.float64),
                   ((0, c.dh * fy - H), (0, c.dw * fx - W)), mode="edge")
        c.plane = p.reshape(c.dh, fy, c.dw, fx).mean(axis=(1, 3))
        comps.append(c)
    return comps, max_h, max_v, mcux, mcuy


def _blocks(c, center: float, q: np.ndarray) -> np.ndarray:
    """(bh, bw, 64) quantised coefficients of a component in zigzag order,
    the plane padded by its edge to the MCU grid."""
    p = np.pad(c.plane, ((0, c.bh * 8 - c.dh), (0, c.bw * 8 - c.dw)),
               mode="edge") - center
    b = p.reshape(c.bh, 8, c.bw, 8).transpose(0, 2, 1, 3)
    F = (_C @ b @ _C.T).reshape(c.bh, c.bw, 64)
    z = np.rint(F / q[None, None, :]).astype(np.int64)[:, :, ZIGZAG]
    lim = 1 << (int(np.log2(center)) + 4)  # 2047 at 8 bits
    z[:, :, 0] = np.clip(z[:, :, 0], -lim + 1, lim - 1)
    z[:, :, 1:] = np.clip(z[:, :, 1:], -(lim // 2) + 1, lim // 2 - 1)
    return z


def _scan_order(comps, cis, mcux, mcuy):
    """(component, block row, block column, MCU index) arrays of a scan's
    blocks in coding order: the component's own blocks in a scan of one,
    else the MCUs with each component's h x v blocks."""
    if len(cis) == 1:
        c = comps[cis[0]]
        by, bx = np.divmod(np.arange(c.wib * c.hib), c.wib)
        n = by.size
        return np.full(n, cis[0]), by, bx, np.arange(n)
    my, mx = np.divmod(np.arange(mcux * mcuy), mcux)
    ci, oy, ox = [], [], []
    for k in cis:
        for y in range(comps[k].v):
            for x in range(comps[k].h):
                ci.append(k)
                oy.append(y)
                ox.append(x)
    ci, oy, ox = (np.array(a) for a in (ci, oy, ox))
    v = np.array([comps[k].v for k in ci])
    h = np.array([comps[k].h for k in ci])
    by = my[:, None] * v[None] + oy[None]
    bx = mx[:, None] * h[None] + ox[None]
    mcu = np.repeat(np.arange(my.size), ci.size)
    return (np.tile(ci, my.size), by.ravel(), bx.ravel(), mcu)


def _huffman_scan(coef, comps, cis, mcux, mcuy, restart, tables):
    """DHT segments and the entropy-coded data of a sequential Huffman
    scan (DC of each block against its component's last, reset at each
    restart; AC as run/size symbols with ZRL and EOB).  tables[i] is the
    (DC, AC) table slot of the scan's i-th component."""
    ci, by, bx, mcu = _scan_order(comps, cis, mcux, mcuy)
    z = np.empty((ci.size, 64), np.int64)
    for c in cis:
        sel = ci == c
        z[sel] = coef[c][by[sel], bx[sel]]
    group = mcu // restart if restart else np.zeros_like(mcu)
    n = z.shape[0]
    # DC differences against the last block of the component, 0 at an
    # interval's start
    diff = np.zeros(n, np.int64)
    for c in cis:
        sel = np.nonzero(ci == c)[0]
        dc = z[sel, 0]
        prev = np.concatenate([[0], dc[:-1]])
        first = np.concatenate([[True], group[sel][1:] != group[sel][:-1]])
        prev[first] = 0
        diff[sel] = dc - prev
    slot = {c: tables[i] for i, c in enumerate(cis)}
    dslot = np.array([slot[c][0] for c in ci])
    aslot = np.array([slot[c][1] for c in ci])
    s_dc = _bit_size(diff)
    # AC symbols: each nonzero with the zeros before it
    b, k = np.nonzero(z[:, 1:])
    k = k + 1
    prevk = np.zeros_like(k)
    same = b[1:] == b[:-1]
    prevk[1:][same] = k[:-1][same]
    run = k - prevk - 1
    v = z[b, k]
    s_ac = _bit_size(v)
    sym = ((run & 15) << 4) | s_ac
    nzrl = run >> 4
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = last < 63
    # counts and tables
    segs = b""
    dcodes, acodes = {}, {}
    for t in sorted(set(dslot.tolist())):
        f = np.bincount(s_dc[dslot == t], minlength=17)
        bits, syms = optimal_table({s: f[s] for s in range(17)})
        dcodes[t] = _codes(bits, syms)
        segs += dht(0, t, bits, syms)
    for t in sorted(set(aslot.tolist())):
        f = np.bincount(sym[aslot[b] == t], minlength=256).astype(np.int64)
        f[0xF0] += int(nzrl[aslot[b] == t].sum())
        f[0x00] += int(eob[aslot == t].sum())
        bits, syms = optimal_table({s: f[s] for s in range(256)})
        acodes[t] = _codes(bits, syms)
        segs += dht(1, t, bits, syms)

    def lookup(codes, slots, symbols):
        cl = np.zeros((2, symbols.size), np.int64)
        for t in np.unique(slots):
            sel = slots == t
            tab = np.zeros((2, 257), np.int64)
            for s, (c, ln) in codes[t].items():
                tab[:, s] = (c, ln)
            cl[:, sel] = tab[:, symbols[sel]]
        return cl

    dc_code = lookup(dcodes, dslot, s_dc)
    ac_code = lookup(acodes, aslot[b], sym)
    zrl_code = lookup(acodes, aslot[b], np.full(b.size, 0xF0))
    eob_code = lookup(acodes, aslot, np.zeros(n, np.int64))
    vals, lens, keys = [], [], []
    vals.append((dc_code[0] << s_dc) | np.where(s_dc > 0, _extra(diff, s_dc),
                                                0))
    lens.append(dc_code[1] + s_dc)
    keys.append(np.arange(n) * 1024)
    for j in range(3):
        sel = nzrl > j
        vals.append(zrl_code[0][sel])
        lens.append(zrl_code[1][sel])
        keys.append(b[sel] * 1024 + k[sel] * 8 + j)
    vals.append((ac_code[0] << s_ac) | _extra(v, s_ac))
    lens.append(ac_code[1] + s_ac)
    keys.append(b * 1024 + k * 8 + 3)
    vals.append(eob_code[0][eob])
    lens.append(eob_code[1][eob])
    keys.append(np.nonzero(eob)[0] * 1024 + 1000)
    keys = np.concatenate(keys)
    order = np.argsort(keys, kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    grp = group[keys[order] // 1024]
    return segs, _join_intervals(pack(vals, lens, grp))


class _QM:
    """jcarith.c's QM encoder: arith_encode, finish_pass and the restart."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit_zeros(self):
        if self.zc:
            self.out += bytes(self.zc)
            self.zc = 0

    def enc(self, st, i, val):
        sv = st[i]
        q = _ARITAB[sv & 0x7F]
        qe = q >> 16
        a = self.a - qe
        if val != (sv >> 7):
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ (q & 0xFF)
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ ((q >> 8) & 0xFF)
        c, ct = self.c, self.ct
        while True:
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                temp = c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._emit_zeros()
                        self.out.append(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self.out.append(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._emit_zeros()
                        self.out.append(self.buffer)
                    if self.sc:
                        self._emit_zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        c = temp + 0x8000 if temp < self.c else temp
        c <<= self.ct
        if c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._emit_zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if c & 0x7FFF800:
            self._emit_zeros()
            b1 = (c >> 19) & 0xFF
            self.out.append(b1)
            if b1 == 0xFF:
                self.out.append(0)
            if c & 0x7F800:
                b2 = (c >> 11) & 0xFF
                self.out.append(b2)
                if b2 == 0xFF:
                    self.out.append(0)


def _arith_scan(coef, comps, cis, mcux, mcuy, restart, scan, tables,
                dac_l, dac_u, dac_k, progressive):
    """The entropy-coded data of one arithmetic-coded scan (jcarith.c's
    encode_mcu, encode_mcu_DC_first / AC_first / DC_refine / AC_refine)."""
    ss, se, ah, al = scan
    qm = _QM()
    enc = qm.enc
    fixed = bytearray([113])
    dc_stats = {t: bytearray(64) for t in range(4)}
    ac_stats = {t: bytearray(256) for t in range(4)}
    dc_pass = not progressive or (ss == 0 and ah == 0)
    ac_pass = not progressive or ss > 0
    ci, by, bx, mcu = _scan_order(comps, cis, mcux, mcuy)
    blocks = [coef[c][y, x].tolist() for c, y, x in zip(ci, by, bx)]
    pos = {c: i for i, c in enumerate(cis)}
    last_dc = [0] * len(cis)
    ctx = [0] * len(cis)

    def mag_dc(st, i, v, t):
        # Figures F.8 / F.9 for DC; returns the conditioning m
        m = 0
        v -= 1
        if v:
            enc(st, i, 1)
            m = 1
            i = 20
            v2 = v >> 1
            while v2:
                enc(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        enc(st, i, 0)
        i += 14
        mm = m >> 1
        while mm:
            enc(st, i, 1 if mm & v else 0)
            mm >>= 1
        return m

    def code_dc(st, s0, v, p, t):
        if v == 0:
            enc(st, s0, 0)
            ctx[p] = 0
            return
        enc(st, s0, 1)
        if v > 0:
            enc(st, s0 + 1, 0)
            i, c = s0 + 2, 4
        else:
            v = -v
            enc(st, s0 + 1, 1)
            i, c = s0 + 3, 8
        m = mag_dc(st, i, v, t)
        if m < (1 << dac_l[t]) >> 1:
            c = 0
        elif m > (1 << dac_u[t]) >> 1:
            c += 8
        ctx[p] = c

    def mag_ac(st, i, v, k, t):
        m = 0
        v -= 1
        if v:
            enc(st, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                enc(st, i, 1)
                m <<= 1
                i = 189 if k <= dac_k[t] else 217
                v2 >>= 1
                while v2:
                    enc(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        enc(st, i, 0)
        i += 14
        m >>= 1
        while m:
            enc(st, i, 1 if m & v else 0)
            m >>= 1

    def code_ac(st, blk, lo, hi, t):
        # Figure F.5 over the band lo..hi of values already shifted
        ke = hi
        while ke >= lo and blk[ke] == 0:
            ke -= 1
        k = lo
        while k <= ke:
            i = 3 * (k - 1)
            enc(st, i, 0)
            while blk[k] == 0:
                enc(st, i + 1, 0)
                i += 3
                k += 1
            enc(st, i + 1, 1)
            v = blk[k]
            if v > 0:
                enc(fixed, 0, 0)
            else:
                v = -v
                enc(fixed, 0, 1)
            mag_ac(st, i + 2, v, k, t)
            k += 1
        if k <= hi:
            enc(st, 3 * (k - 1), 1)

    def shifted(blk, lo, hi, sh):
        out = [0] * 64
        for k in range(lo, hi + 1):
            v = blk[k]
            out[k] = (v >> sh) if v >= 0 else -((-v) >> sh)
        return out

    def reset_stats():
        for c in cis:
            t = tables[pos[c]]
            if dc_pass:
                dc_stats[t[0]][:] = bytes(64)
            if ac_pass:
                ac_stats[t[1]][:] = bytes(256)
        for p in range(len(cis)):
            last_dc[p] = 0
            ctx[p] = 0

    reset_stats()
    rst = 0
    prev_mcu = -1
    for blk, c, m in zip(blocks, ci, mcu):
        if m != prev_mcu:
            if restart and m and m % restart == 0:
                qm.finish()
                qm.out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                qm.reset()
                reset_stats()
            prev_mcu = m
        p = pos[c]
        td, ta = tables[p]
        if not progressive:
            code_dc(dc_stats[td], ctx[p], blk[0] - last_dc[p], p, td)
            last_dc[p] = blk[0]
            code_ac(ac_stats[ta], blk, 1, 63, ta)
        elif ss == 0 and ah == 0:
            d = blk[0] >> al
            code_dc(dc_stats[td], ctx[p], d - last_dc[p], p, td)
            last_dc[p] = d
        elif ss == 0:
            enc(fixed, 0, (blk[0] >> al) & 1)
        elif ah == 0:
            code_ac(ac_stats[ta], shifted(blk, ss, se, al), ss, se, ta)
        else:
            st = ac_stats[ta]
            cur = shifted(blk, ss, se, al)
            ke = se
            while ke > 0 and cur[ke] == 0:
                ke -= 1
            kex = ke
            while kex > 0 and not (abs(blk[kex]) >> ah):
                kex -= 1
            k = ss
            while k <= ke:
                i = 3 * (k - 1)
                if k > kex:
                    enc(st, i, 0)
                while True:
                    v = cur[k]
                    if v:
                        a = abs(v)
                        if a >> 1:
                            enc(st, i + 2, a & 1)
                        else:
                            enc(st, i + 1, 1)
                            enc(fixed, 0, 1 if v < 0 else 0)
                        break
                    enc(st, i + 1, 0)
                    i += 3
                    k += 1
                k += 1
            if k <= se:
                enc(st, 3 * (k - 1), 1)
    qm.finish()
    return bytes(qm.out)


def simple_script(n: int) -> list:
    """A progressive scan script over n components: libjpeg's
    jpeg_simple_progression for three (YCbCr), else DC first and
    refined, then each component's AC in two bands and a refinement."""
    if n == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    cs = tuple(range(n))
    out = [(cs, 0, 0, 0, 1)]
    out += [((c,), 1, 5, 0, 1) for c in cs]
    out += [((c,), 6, 63, 0, 1) for c in cs]
    out += [(cs, 0, 0, 1, 0)]
    out += [((c,), 1, 63, 1, 0) for c in cs]
    return out


def lossy(planes, *, sampling=None, quality=90, coding="huffman",
          progressive=False, restart=0, dac=None, adobe=None, precision=8,
          sof=None, exif=None) -> bytes:
    """A DCT-based JPEG of planes (H, W) uint8 (each at full size; a
    component's sampling (h, v) box-averages it), components 1, 2, ...,
    a JFIF APP0 for one or three without Adobe: coding "huffman"
    (sequential) or "arith"; progressive (arith only) under
    simple_script; restart an interval in MCUs; dac {"dc": {table: (L,
    U)}, "ac": {table: K}} written as a DAC segment; adobe the APP14
    transform (0 CMYK or RGB, 1 YCbCr, 2 YCCK) or None; sof the marker
    (SOF0 / SOF1 / SOF2 / SOF9 / SOF10 by default); exif a TIFF block
    for an APP1."""
    planes = [np.asarray(p) for p in planes]
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    ids = list(range(1, n + 1))
    jfif = n in (1, 3) and adobe is None
    arith = coding == "arith"
    if progressive and not arith:
        raise ValueError("progressive Huffman files come from cv2")
    comps, max_h, max_v, mcux, mcuy = _layout(planes, sampling, 8)
    center = float(1 << (precision - 1))
    # component 0 (and K) on the luma table, the others on chroma
    tq = [0 if (c == 0 or (n == 4 and c == 3)) else 1 for c in range(n)]
    qt = [quant_table(LUMA_Q, quality), quant_table(CHROMA_Q, quality)]
    coef = [_blocks(c, center, qt[tq[i]])
            for i, c in enumerate(comps)]
    out = b"\xff\xd8"
    if jfif:
        out += segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if exif is not None:
        out += segment(0xE1, b"Exif\0\0" + exif)
    if adobe is not None:
        out += segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe]))
    for t in sorted(set(tq)):
        out += segment(0xDB, bytes([t]) + bytes(
            qt[t][ZIGZAG].astype(np.uint8).tolist()))
    if sof is None:
        sof = (0xCA if progressive else 0xC9) if arith else (
            0xC0 if precision == 8 else 0xC1)
    body = struct.pack(">BHHB", precision, planes[0].shape[0],
                       planes[0].shape[1], n)
    for i, (h, v) in enumerate(sampling):
        body += bytes([ids[i], (h << 4) | v, tq[i]])
    out += segment(sof, body)
    tables = [(min(i, 1), min(i, 1)) for i in range(n)] if not arith else \
        [(i, i) for i in range(n)]
    dac_l, dac_u, dac_k = [0] * 4, [1] * 4, [5] * 4
    if dac:
        db = b""
        for t, (lo, up) in sorted(dac.get("dc", {}).items()):
            dac_l[t], dac_u[t] = lo, up
            db += bytes([t, (up << 4) | lo])
        for t, k in sorted(dac.get("ac", {}).items()):
            dac_k[t] = k
            db += bytes([0x10 | t, k])
        out += segment(0xCC, db)
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    scans = simple_script(n) if progressive else \
        [(tuple(range(n)), 0, 63, 0, 0)]
    for cis, ss, se, ah, al in scans:
        cis = tuple(cis)
        sel = [tables[c] for c in cis]
        if arith:
            data = _arith_scan(coef, comps, cis, mcux, mcuy, restart,
                               (ss, se, ah, al), sel, dac_l, dac_u, dac_k,
                               progressive)
        else:
            segs, data = _huffman_scan(coef, comps, cis, mcux, mcuy,
                                       restart, sel)
            out += segs
        sos = bytes([len(cis)])
        for c, (td, ta) in zip(cis, sel):
            sos += bytes([ids[c], (td << 4) | ta])
        out += segment(0xDA, sos + bytes([ss, se, (ah << 4) | al])) + data
    return out + b"\xff\xd9"


# ---------------------------------------------------------------------------
# lossless


_PREDICT = {
    1: lambda a, b, c: a,
    2: lambda a, b, c: b,
    3: lambda a, b, c: c,
    4: lambda a, b, c: a + b - c,
    5: lambda a, b, c: a + ((b - c) >> 1),
    6: lambda a, b, c: b + ((a - c) >> 1),
    7: lambda a, b, c: (a + b) >> 1,
}


def _lossless_diffs(x, predictor, precision, pt, first_rows):
    """(rows, cols) differences of a plane x (values >> pt) under the
    predictor; rows in first_rows restart the prediction (2^(P - Pt - 1)
    at their first column, the left neighbour after it)."""
    x = x.astype(np.int64)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = _PREDICT[predictor](a, b, c)
    pred[:, 0] = b[:, 0]
    first = np.zeros(x.shape[0], bool)
    first[list(first_rows)] = True
    pred[first, 1:] = a[first, 1:]
    pred[first, 0] = 1 << (precision - pt - 1)
    d = (x - pred) & 0xFFFF
    return np.where(d >= 32768, d - 65536, d)


def lossless(planes, *, precision=8, predictor=1, pt=0, restart_rows=0,
             interleave=True, sampling=None, adobe=None, jfif=False, ids=None,
             sof=0xC3, exif=None) -> bytes:
    """A lossless (SOF3, Huffman-coded) JPEG of planes (H, W) of samples
    below 2^precision: predictor 1-7, point transform pt, one scan
    (interleave) or one a component, restart_rows MCU rows an interval
    (one scan, or one component); sampling, adobe and exif as lossy()'s;
    jfif a JFIF APP0; ids the component ids (1, 2, ... by default); sof
    the marker (SOF11 for a frame that libjpeg refuses: the data stays
    Huffman-coded)."""
    planes = [np.asarray(p) for p in planes]
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    comps, max_h, max_v, mcux, mcuy = _layout(planes, sampling, 1)
    samples = [np.rint(c.plane).astype(np.int64) >> pt for c in comps]
    out = b"\xff\xd8"
    if jfif:
        out += segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if exif is not None:
        out += segment(0xE1, b"Exif\0\0" + exif)
    if adobe is not None:
        out += segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe]))
    body = struct.pack(">BHHB", precision, planes[0].shape[0],
                       planes[0].shape[1], n)
    for i, (h, v) in enumerate(sampling):
        body += bytes([ids[i], (h << 4) | v, 0])
    out += segment(sof, body)
    groups = [tuple(range(n))] if interleave else [(c,) for c in range(n)]
    if restart_rows:
        if len(groups) > 1 and n > 1:
            raise ValueError("restarts need one scan or one component")
        per_row = mcux if len(groups[0]) > 1 else comps[0].dw
        out += segment(0xDD, struct.pack(">H", restart_rows * per_row))
    for cis in groups:
        one = len(cis) == 1
        diffs = {}
        for c in cis:
            k = comps[c]
            rows_a_mcu_row = 1 if one else k.v
            step = restart_rows * rows_a_mcu_row if restart_rows else 0
            first = range(0, k.dh, step) if step else [0]
            d = _lossless_diffs(samples[c], predictor, precision, pt, first)
            # dummy samples past the plane: difference 0
            pw = k.dw if one else mcux * k.h
            ph = k.dh if one else mcuy * k.v
            full = np.zeros((ph, pw), np.int64)
            full[:k.dh, :k.dw] = d
            diffs[c] = full
        if one:
            c = cis[0]
            seq = diffs[c].ravel()
            row = np.repeat(np.arange(diffs[c].shape[0]), diffs[c].shape[1])
        else:
            parts, rows = [], []
            for c in cis:
                k = comps[c]
                d = diffs[c].reshape(mcuy, k.v, mcux, k.h).transpose(
                    0, 2, 1, 3).reshape(mcuy, mcux, -1)
                parts.append(d)
            seq = np.concatenate(parts, axis=2)
            row = np.repeat(np.arange(mcuy), seq.shape[1] * seq.shape[2])
            seq = seq.ravel()
        group = row // restart_rows if restart_rows else np.zeros_like(row)
        s = _bit_size(seq)
        s[seq == -32768] = 16
        bits, syms = optimal_table(dict(enumerate(np.bincount(
            s, minlength=17).tolist())))
        codes = _codes(bits, syms)
        tab = np.zeros((2, 17), np.int64)
        for sym, (cd, ln) in codes.items():
            tab[:, sym] = (cd, ln)
        extra_n = np.where(s == 16, 0, s)
        vals = (tab[0][s] << extra_n) | np.where(
            extra_n > 0, _extra(seq, extra_n), 0)
        out += dht(0, 0, bits, syms)
        sos = bytes([len(cis)])
        for c in cis:
            sos += bytes([ids[c], 0x00])
        out += segment(0xDA, sos + bytes([predictor, 0, pt]))
        out += _join_intervals(pack(vals, tab[1][s] + extra_n, group))
    return out + b"\xff\xd9"
