"""Writes global_lvba_tpu_torch/pipeline/draw_data.py, the data with which
pipeline/draw.py draws cv2's markers and text without cv2.

Run where cv2 is installed (it is the reference here, never a dependency
of the port):

    python scripts/make_draw_data.py

It records, from cv2's own renders, FONT_HERSHEY_SIMPLEX's glyphs of
printable ASCII at the scales and thicknesses the exports use (cv2 renders
them anti-aliased, a glyph after another at whole-pixel advances, each
blended as v = (v (255 - a) + c a + 127) // 255): each glyph's coverage
stamp, its offset from the origin and its advance.  Every string below is
checked against cv2 before the file is written, on uniform backgrounds of
random values and colours; a failed check raises.
"""

import base64
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "global_lvba_tpu_torch" / "pipeline" / "draw_data.py"
FONT = cv2.FONT_HERSHEY_SIMPLEX
TEXT_STYLES = ((0.5, 1), (0.6, 1), (0.6, 2), (0.5, 2))
CHARS = [chr(c) for c in range(32, 127)]


def _render(text, scale, thick, org=(50, 80), size=(160, 1400)):
    im = np.zeros(size, np.uint8)
    cv2.putText(im, text, org, FONT, scale, 255, thick, cv2.LINE_AA)
    return im


def glyphs(scale, thick):
    """{char: (dx, dy, advance, alpha (h, w) uint8)} at origin offsets."""
    ox, oy = 50, 80
    stamps = {}
    for ch in CHARS:
        im = _render(ch, scale, thick)
        ys, xs = np.nonzero(im)
        if ys.size:
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
            stamps[ch] = (x0 - ox, y0 - oy, im[y0:y1, x0:x1].copy())
        else:
            stamps[ch] = (0, 0, np.zeros((0, 0), np.uint8))
    out = {}
    for ch in CHARS:
        ref = "H"
        pair = _render(ch + ref, scale, thick)
        for adv in range(0, 60):
            if np.array_equal(compose(stamps, {ch: adv}, ch + ref,
                                      pair.shape, (ox, oy)), pair):
                break
        else:
            raise RuntimeError(f"no whole-pixel advance for {ch!r}")
        out[ch] = stamps[ch] + (adv,)
    return {ch: (dx, dy, adv, a) for ch, (dx, dy, a, adv) in out.items()}


def compose(stamps, adv, text, shape, org, bg=0, col=255):
    """The glyphs blended one after another at whole advances (the last
    glyph's advance unused): v = (v (255 - a) + c a + 127) // 255."""
    im = np.full(shape, bg, np.int64)
    x = org[0]
    for ch in text:
        dx, dy, a = stamps[ch][:3]
        if a.size:
            y0, x0 = org[1] + dy, x + dx
            sub = im[y0:y0 + a.shape[0], x0:x0 + a.shape[1]]
            a = a.astype(np.int64)
            sub[:] = (sub * (255 - a) + col * a + 127) // 255
        x += adv.get(ch, 0)
    return im


def check_strings(table, scale, thick):
    rng = np.random.default_rng(int(scale * 10) + thick)
    tests = ["img=17 N=342 mean_pre=1.234 mean_post=0.567",
             "sift=2048 track=731", "img=0 N=0 mean_pre=-1.000 mean_post=-1.000",
             "".join(CHARS)]
    tests += ["".join(rng.choice(CHARS, size=40)) for _ in range(30)]
    stamps = {ch: (v[0], v[1], v[3]) for ch, v in table.items()}
    adv = {ch: v[2] for ch, v in table.items()}
    for k, t in enumerate(tests):
        bg, col = (0, 255) if k % 2 else (int(rng.integers(0, 256)),
                                          int(rng.integers(0, 256)))
        want = np.full((160, 1400), bg, np.uint8)
        cv2.putText(want, t, (50, 80), FONT, scale, col, thick, cv2.LINE_AA)
        got = compose(stamps, adv, t, want.shape, (50, 80), bg, col)
        if not np.array_equal(want, got):
            raise RuntimeError(f"text {t!r} at {scale}, {thick}: "
                               f"{int((want != got).sum())} pixels differ")


def pack_glyphs():
    recs, blob = [], bytearray()
    for scale, thick in TEXT_STYLES:
        table = glyphs(scale, thick)
        check_strings(table, scale, thick)
        for ch in CHARS:
            dx, dy, adv, a = table[ch]
            recs.append((scale, thick, ord(ch), int(dx), int(dy), int(adv), a.shape[0],
                         a.shape[1], len(blob)))
            blob += a.tobytes()
    return recs, base64.b64encode(zlib.compress(bytes(blob), 9)).decode()


def main():
    recs, blob = pack_glyphs()
    lines = [
        '"""Data of pipeline/draw.py, written by scripts/make_draw_data.py '
        'from cv2\'s',
        "renders (see there): FONT_HERSHEY_SIMPLEX's anti-aliased glyph "
        "coverage.",
        'Do not edit."""',
        "",
    ]
    lines.append("# (scale, thickness, code, dx, dy, advance, h, w, offset "
                 "into GLYPH_BYTES)")
    lines.append("GLYPHS = [")
    for r in recs:
        lines.append(f"    {r!r},")
    lines.append("]")
    lines.append("")
    lines.append("# the glyphs' coverage bytes, zlib-compressed, base64")
    lines.append("GLYPH_BLOB = (")
    for k in range(0, len(blob), 76):
        lines.append(f'    "{blob[k:k + 76]}"')
    lines.append(")")
    OUT.write_text("\n".join(lines) + "\n")
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    sys.exit(main())
