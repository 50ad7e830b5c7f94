"""Terminal progress bar (the reference's printProgressBar)."""

from __future__ import annotations

import sys


def progress_bar(current: int, total: int, width: int = 50, stream=None):
    stream = sys.stdout if stream is None else stream
    if total <= 0:
        return
    frac = current / total
    pos = int(width * frac)
    bar = "=" * pos + (">" if pos < width else "") + " " * max(0, width - pos - 1)
    stream.write(f"[{bar}] {int(frac * 100):3d}% ({current}/{total})\r")
    stream.flush()
    if current >= total:
        stream.write("\n")
