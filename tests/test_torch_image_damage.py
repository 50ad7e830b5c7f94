"""Damaged and unusual image files through the port's readers (io/image.py
and the native library's JPEG decoder) against cv2.imread 5.0 on the CPU:
the same image bit for bit (tolerance 0), or both refuse (cv2 None, the
port a ValueError naming the format), colour and gray.

  * JPEG: libjpeg-turbo's recovery as cv2.imread (its stdio source) meets
    it: files cut anywhere (the fake EOI), a missing EOI, restart markers
    removed or renumbered (jpeg_resync_to_restart), bytes of the scans
    changed (markers, bad Huffman and arithmetic codes, and coefficients
    far past an encoder's range, which libjpeg-turbo's SIMD IDCT
    saturates and wraps in 16-bit lanes); a seeded sweep of cuts, byte
    changes and RST edits on baseline 4:2:0 and 4:4:4, restarts,
    progressive (with restarts), arithmetic-coded sequential and
    progressive, lossless and CMYK sources, from cv2 and
    tests/jpeg_writer.py.
  * PNG: cv2 5.0's chunk rules (io/image.py _read_png) on a sweep of bad
    CRCs on each chunk type, inserted unknown, repeated and misplaced
    chunks, a missing IEND, data after IEND and cuts at every chunk
    boundary; read_png and imread_unchanged, the depth maps' reader,
    against IMREAD_UNCHANGED on the same files.
Each source is one test case (seeded with its name), so that a failure
names its file and mutation.  The whole file runs in ~6 s on one
worker."""

import struct

import cv2
import numpy as np
import pytest
import torch

import jpeg_writer as jw
from global_lvba_tpu_torch.io import image as gi
from png_writer import chunk as png_chunk, png
from test_torch_image_decode import _image


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _enc(img, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _same_or_both_refuse(path, what):
    """imread_color / imread_gray of path equal cv2.imread's bit for bit,
    or raise ValueError where cv2 returns None."""
    for flag, read in ((cv2.IMREAD_COLOR, gi.imread_color),
                       (cv2.IMREAD_GRAYSCALE, gi.imread_gray)):
        want = cv2.imread(str(path), flag)
        if want is None:
            with pytest.raises(ValueError):
                read(path)
            continue
        got = read(path)
        assert got.shape == want.shape and np.array_equal(got, want), (
            what, flag)


# ---------------------------------------------------------------------------
# JPEG


A = _image(64, 80, 1)
S420 = [(2, 2), (1, 1), (1, 1)]
JPEG_SOURCES = {
    "baseline420": lambda: _enc(A),
    "baseline444": lambda: _enc(A, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
    "restart2": lambda: _enc(A, cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
    "progressive": lambda: _enc(A, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
    "progressive_restart": lambda: _enc(A, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                        cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
    "arith": lambda: jw.lossy(jw.ycc_from_bgr(A), sampling=S420,
                              coding="arith", restart=4),
    "arith_progressive": lambda: jw.lossy(jw.ycc_from_bgr(A), sampling=S420,
                                          coding="arith", progressive=True),
    "lossless": lambda: jw.lossless([A[:, :, 1]], predictor=4,
                                    restart_rows=8),
    "lossless_rgb": lambda: jw.lossless([A[:, :, 2], A[:, :, 1], A[:, :, 0]],
                                        predictor=6),
    "cmyk": lambda: jw.lossy(jw.cmyk_from_bgr(A), adobe=0, restart=5),
}


def _scan_data(data: bytes):
    """(start, end) of each scan's entropy-coded bytes (RSTn inside)."""
    out, k = [], 2
    while k < len(data) - 1:
        if data[k] == 0xFF and data[k + 1] == 0xDA:
            st = k + 2 + struct.unpack(">H", data[k + 2:k + 4])[0]
            e = st
            while e < len(data) - 1 and not (
                    data[e] == 0xFF and data[e + 1] not in (0, 0xFF)
                    and not 0xD0 <= data[e + 1] <= 0xD7):
                e += 1
            out.append((st, e))
            k = e
        else:
            k += 1
    return out


def _jpeg_mutations(data: bytes, seed: int):
    """Cuts (inside the scans, with and without an EOI appended, and in
    the header), changed bytes inside the scans (a new value or one bit
    flipped), and the first restart markers removed or renumbered."""
    rng = np.random.default_rng(seed)
    scans = _scan_data(data)
    lo, n = scans[0][0], len(data)
    yield "no EOI", data[:-2]
    for frac in np.linspace(0.04, 0.96, 12):
        k = lo + int((n - lo) * frac)
        yield f"cut at {k}", data[:k]
        yield f"cut at {k} + EOI", data[:k] + b"\xff\xd9"
    for k in (3, lo // 3, lo - 1):
        yield f"header cut at {k}", data[:k]
    for t in range(20):
        st, e = scans[int(rng.integers(len(scans)))]
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            j = int(rng.integers(st, max(st + 1, e)))
            b[j] = (int(rng.integers(0, 256)) if rng.random() < 0.6
                    else b[j] ^ (1 << int(rng.integers(8))))
        yield f"bytes changed ({t})", bytes(b)
    rst = [k for k in range(lo, n - 1)
           if data[k] == 0xFF and 0xD0 <= data[k + 1] <= 0xD7]
    for j, k in enumerate(rst[:2]):
        yield f"RST {j} removed", data[:k] + data[k + 2:]
        for d in (1, 2, 3, 5, 6, 7):
            b = bytearray(data)
            b[k + 1] = 0xD0 + ((data[k + 1] - 0xD0 + d) & 7)
            yield f"RST {j} renumbered +{d}", bytes(b)


@pytest.mark.parametrize("source", list(JPEG_SOURCES))
def test_jpeg_mutation_sweep_matches_cv2(tmp_path, source):
    data = JPEG_SOURCES[source]()
    p = tmp_path / "m.jpg"
    p.write_bytes(data)
    _same_or_both_refuse(p, "source")
    cases = 0
    for what, mutated in _jpeg_mutations(data, sum(source.encode())):
        p.write_bytes(mutated)
        _same_or_both_refuse(p, what)
        cases += 1
    assert cases >= 48


def _rst_file():
    return _enc(A, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)


def _first_rst(jpg):
    return jpg.index(b"\xff\xd0")


MOTIVATION = {
    "baseline cut at 60%, no EOI":
        lambda: _enc(A)[:len(_enc(A)) * 6 // 10],
    "baseline cut at 60%, an EOI appended":
        lambda: _enc(A)[:len(_enc(A)) * 6 // 10] + b"\xff\xd9",
    "baseline without its EOI": lambda: _enc(A)[:-2],
    "first RST removed":
        lambda: (lambda j, k: j[:k] + j[k + 2:])(_rst_file(),
                                                  _first_rst(_rst_file())),
    "first RST renumbered D0 -> D5":
        lambda: (lambda j, k: j[:k + 1] + b"\xd5" + j[k + 2:])(
            _rst_file(), _first_rst(_rst_file())),
    "progressive cut at 70%":
        lambda: (lambda j: j[:len(j) * 7 // 10])(
            _enc(A, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
}


@pytest.mark.parametrize("case", list(MOTIVATION))
def test_damaged_jpeg_reads_as_cv2(tmp_path, case):
    """Where cv2 returns an image from a damaged JPEG, the port returns the
    same image."""
    p = tmp_path / "d.jpg"
    p.write_bytes(MOTIVATION[case]())
    assert cv2.imread(str(p), cv2.IMREAD_COLOR) is not None
    _same_or_both_refuse(p, case)


def test_cut_jpeg_keeps_the_data_before_the_cut(tmp_path):
    """A baseline file cut at 80% (a killed recorder's file): the rows
    whose data was kept decode as the whole file's do, and the rest is
    libjpeg's uniform gray (zero coefficients) below the last MCU that
    started inside the data."""
    img = _image(96, 128, 3)
    jpg = _enc(img)
    whole = tmp_path / "w.jpg"
    whole.write_bytes(jpg)
    cut = tmp_path / "c.jpg"
    cut.write_bytes(jpg[:len(jpg) * 8 // 10])
    a, b = gi.imread_color(whole), gi.imread_color(cut)
    assert np.array_equal(b, cv2.imread(str(cut), cv2.IMREAD_COLOR))
    assert np.array_equal(a[:48], b[:48])
    assert np.all(b[-16:, -16:] == 128)


def test_arith_bad_code_ends_its_interval(tmp_path):
    """JWRN_ARITH_BAD_CODE: an arithmetic-coded file whose data reads as a
    magnitude past 2^15 stops that MCU and the rest of its restart
    interval, and decodes on from the next restart, as cv2's does."""
    data = JPEG_SOURCES["arith"]()
    st, e = _scan_data(data)[0]
    p = tmp_path / "a.jpg"
    rng = np.random.default_rng(11)
    for t in range(12):
        b = bytearray(data)
        j = int(rng.integers(st, e - 8))
        b[j:j + 6] = bytes([0x7F] * 6)
        p.write_bytes(bytes(b))
        _same_or_both_refuse(p, f"bytes at {j}")


def test_jpeg_markers_libjpeg_refuses(tmp_path):
    """After the first scan of a progressive file, a second SOI, a
    reserved marker, a JPGn marker or a second SOF stops libjpeg: cv2 and
    the port read nothing.  In a file of one scan the same markers come
    after the image, which libjpeg reads in jpeg_finish_decompress, after
    cv2 has its image: both read it."""
    for source in ("progressive", "baseline420"):
        data = JPEG_SOURCES[source]()
        end = _scan_data(data)[0][1]
        p = tmp_path / f"{source}.jpg"
        for marker in (b"\xff\xd8", b"\xff\x05", b"\xff\xf3\x00\x04ab",
                       b"\xff\xc8\x00\x04ab"):
            p.write_bytes(data[:end] + marker + data[end:])
            want = cv2.imread(str(p), cv2.IMREAD_COLOR)
            assert (want is None) == (source == "progressive")
            _same_or_both_refuse(p, (source, marker))


# ---------------------------------------------------------------------------
# PNG


def _chunks(data: bytes):
    out, pos = [], 8
    while pos + 8 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        out.append(data[pos:pos + 12 + n])
        pos += 12 + n
    return out


def _join(chunks) -> bytes:
    return gi._PNG_SIGNATURE + b"".join(chunks)


def _bad_crc(c: bytes) -> bytes:
    return c[:-1] + bytes([c[-1] ^ 0x5A])


def _png_sources():
    rng = np.random.default_rng(12)
    rgb = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    return {
        "cv2 colour": cv2.imencode(".png", rgb)[1].tobytes(),
        "cv2 gray": cv2.imencode(".png", rgb[:, :, 0])[1].tobytes(),
        "palette, two IDATs": png(rng.integers(0, 16, (9, 11, 1)), 3, 4,
                                  plte=rng.integers(0, 256, (16, 3))),
        "RGBA 16 bits, eXIf, two IDATs": png(
            rng.integers(0, 65536, (9, 11, 4)), 6, 16,
            exif=b"MM\0*\0\0\0\x08\0\x01\x01\x12\0\x03\0\0\0\x01\0\x06"
                 + bytes(6)),
    }


TEXT = png_chunk(b"tEXt", b"Comment\0hello")
EXIF6 = png_chunk(b"eXIf", b"MM\0*\0\0\0\x08\0\x01\x01\x12\0\x03\0\0\0\x01"
                           b"\0\x06" + bytes(6))
PRIVATE = png_chunk(b"prVt", b"abc")
CRITICAL = png_chunk(b"ABCD", b"xyz")


def _png_mutations(data: bytes):
    cs = _chunks(data)
    tags = [c[4:8] for c in cs]
    first_idat = tags.index(b"IDAT")
    last_idat = len(tags) - 1 - tags[::-1].index(b"IDAT")
    for i, c in enumerate(cs):
        yield f"bad CRC on {tags[i]!r}", _join(cs[:i] + [_bad_crc(c)]
                                               + cs[i + 1:])
    places = {"before the IDATs": first_idat, "after the IDATs":
              last_idat + 1, "after IEND": len(cs)}
    if last_idat > first_idat:
        places["between the IDATs"] = last_idat
    for extra in (TEXT, EXIF6, PRIVATE, CRITICAL):
        for where, at in places.items():
            for c in (extra, _bad_crc(extra)):
                yield (f"{extra[4:8]!r} {where}"
                       + (" (bad CRC)" if c is not extra else ""),
                       _join(cs[:at] + [c] + cs[at:]))
    yield "a second IHDR", _join(cs[:1] + cs[:1] + cs[1:])
    yield "a second IHDR after the IDATs", _join(
        cs[:last_idat + 1] + cs[:1] + cs[last_idat + 1:])
    if b"PLTE" in tags:
        k = tags.index(b"PLTE")
        yield "a second PLTE", _join(cs[:k + 1] + [cs[k]] + cs[k + 1:])
    yield "no IEND", _join(cs[:-1])
    yield "junk after IEND", data + b"junk"
    yield "IEND with data", _join(cs[:-1] + [png_chunk(b"IEND", b"xy")])
    yield "chunk type not letters", _join(
        cs[:1] + [png_chunk(b"a1c!", b"")] + cs[1:])
    pos = 8
    for c in cs:
        for k in (pos, pos + 4, pos + len(c) // 2, pos + len(c) - 2):
            yield f"cut at {k}", data[:k]
        pos += len(c)


@pytest.mark.parametrize("source", list(_png_sources()))
def test_png_chunk_sweep_matches_cv2(tmp_path, source):
    """Every mutation reads as cv2.imread reads it, colour and gray, and
    read_png refuses exactly where IMREAD_UNCHANGED returns None and gives
    its samples elsewhere, which imread_unchanged (the depth maps'
    reader) gives bit for bit."""
    data = _png_sources()[source]
    p = tmp_path / "m.png"
    cases = 0
    for what, mutated in _png_mutations(data):
        p.write_bytes(mutated)
        _same_or_both_refuse(p, what)
        want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        if want is None:
            with pytest.raises(ValueError):
                gi.read_png(mutated)
            with pytest.raises(ValueError):
                gi.imread_unchanged(p)
        else:
            px = gi.read_png(mutated)[0]
            assert px.shape[:2] == want.shape[:2], what
            got = gi.imread_unchanged(p)
            assert got.dtype == want.dtype and np.array_equal(got, want), what
        cases += 1
    assert cases >= 45


PNG_TABLE = {
    "tEXt with a bad CRC before the IDAT": ("before", _bad_crc(TEXT), True),
    "tEXt with a bad CRC after the IDAT": ("after", _bad_crc(TEXT), True),
    "IEND with a bad CRC": ("iend", None, True),
    "no IEND chunk": ("no iend", None, False),
    "unknown critical chunk ABCD before the IDAT": ("before", CRITICAL,
                                                     False),
    "a second IHDR": ("ihdr", None, False),
}


@pytest.mark.parametrize("case", list(PNG_TABLE))
@pytest.mark.parametrize("gray", [False, True])
def test_png_chunk_rules(tmp_path, case, gray):
    """The cases where the port and cv2 5.0 used to differ, on cv2's own
    colour and gray PNGs: cv2 reads the first three and refuses the rest,
    and so does the port."""
    rgb = _image(9, 11, 4)
    cs = _chunks(cv2.imencode(".png", rgb[:, :, 0] if gray else rgb)[1]
                 .tobytes())
    where, extra, reads = PNG_TABLE[case]
    if where == "before":
        cs = cs[:1] + [extra] + cs[1:]
    elif where == "after":
        cs = cs[:-1] + [extra] + cs[-1:]
    elif where == "iend":
        cs[-1] = _bad_crc(cs[-1])
    elif where == "no iend":
        cs = cs[:-1]
    else:
        cs = cs[:1] + cs
    p = tmp_path / "t.png"
    p.write_bytes(_join(cs))
    assert (cv2.imread(str(p), cv2.IMREAD_COLOR) is not None) == reads
    _same_or_both_refuse(p, case)


def test_png_bad_crc_exif_is_dropped(tmp_path):
    """An eXIf chunk with a bad CRC is dropped with the other ancillary
    chunks: its orientation is not applied (cv2 returns the image as
    stored)."""
    cs = _chunks(cv2.imencode(".png", _image(9, 11, 5))[1].tobytes())
    p = tmp_path / "e.png"
    for c, shape in ((EXIF6, (11, 9, 3)), (_bad_crc(EXIF6), (9, 11, 3))):
        p.write_bytes(_join(cs[:1] + [c] + cs[1:]))
        assert gi.imread_color(p).shape == shape
        _same_or_both_refuse(p, shape)


def test_png_cut_image_data_raises_value_error(tmp_path):
    """A zlib stream cut short, or one that does not inflate, is the
    format's ValueError (not zlib's error), as cv2 reads nothing."""
    data = cv2.imencode(".png", _image(9, 11, 6))[1].tobytes()
    cs = _chunks(data)
    body = cs[1][8:-4]
    p = tmp_path / "z.png"
    for idat in (body[:-3], b"\x78\x9c\xff\xff" + body[4:]):
        p.write_bytes(_join([cs[0], png_chunk(b"IDAT", idat), cs[-1]]))
        assert cv2.imread(str(p), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="PNG"):
            gi.imread_color(p)


def test_imread_color_or_none(tmp_path):
    """None exactly where cv2.imread(IMREAD_COLOR) returns None: a missing
    file, and a file the readers refuse (here one cv2 reads only in gray);
    the image elsewhere."""
    lossless = tmp_path / "l.jpg"
    lossless.write_bytes(jw.lossless([A[:, :, 0]], predictor=1))
    assert cv2.imread(str(lossless), cv2.IMREAD_COLOR) is None
    assert cv2.imread(str(lossless), cv2.IMREAD_GRAYSCALE) is not None
    assert gi.imread_color_or_none(lossless) is None
    assert gi.imread_color_or_none(tmp_path / "missing.png") is None
    ok = tmp_path / "ok.png"
    ok.write_bytes(cv2.imencode(".png", A)[1].tobytes())
    assert np.array_equal(gi.imread_color_or_none(ok), A)
    with pytest.raises(TypeError):
        gi.imread_color_or_none(None)
