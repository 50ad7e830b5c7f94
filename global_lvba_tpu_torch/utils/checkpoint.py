"""Stage-granular checkpoint/resume; the port's own copy of
global_lvba_tpu.utils.checkpoint.

Every pipeline stage saves its arrays as an .npz under
<out_dir>/checkpoints and is skipped on resume: deterministic restart at
stage granularity.  The file format is the JAX package's, key for key
(arrays by name, scalars in a JSON `__meta__` entry, a ragged list as
`<name>__<i>` entries counted by `__list__<name>`), so a checkpoint
written by either package loads unchanged in the other: no converter
is needed.  A checkpoint is published atomically: it is written to
<stage>.tmp.npz and renamed over <stage>.npz, so a run killed mid-write
leaves only the .tmp file, which has() does not see.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

import numpy as np


class StageCheckpoint:
    def __init__(self, out_dir, enable: bool = True):
        self.dir = Path(out_dir) / "checkpoints"
        self.enable = enable
        if enable:
            self.dir.mkdir(parents=True, exist_ok=True)

    def path(self, stage: str) -> Path:
        return self.dir / f"{stage}.npz"

    def has(self, stage: str) -> bool:
        return self.enable and self.path(stage).exists()

    def save(self, stage: str, **arrays):
        if not self.enable:
            return
        meta = {}
        np_arrays = {}
        for k, v in arrays.items():
            if isinstance(v, (int, float, str, bool)):
                meta[k] = v
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], np.ndarray):
                # ragged list of arrays -> indexed entries
                meta[f"__list__{k}"] = len(v)
                for i, a in enumerate(v):
                    np_arrays[f"{k}__{i}"] = np.asarray(a)
            else:
                np_arrays[k] = np.asarray(v)
        np_arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        # the name keeps the .npz suffix (savez appends it otherwise)
        tmp = self.dir / f"{stage}.tmp.npz"
        np.savez_compressed(tmp, **np_arrays)
        os.replace(tmp, self.path(stage))

    def load(self, stage: str) -> Dict:
        data = np.load(self.path(stage), allow_pickle=False)
        meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
        out: Dict = {}
        lists = {
            k[len("__list__"):]: int(v) for k, v in meta.items() if k.startswith("__list__")
        }
        list_entry_keys = set()
        for k, n in lists.items():
            out[k] = [data[f"{k}__{i}"] for i in range(n)]
            list_entry_keys.update(f"{k}__{i}" for i in range(n))
        for k, v in meta.items():
            if not k.startswith("__list__"):
                out[k] = v
        for k in data.files:
            if k == "__meta__" or k in list_entry_keys:
                continue
            out[k] = data[k]
        return out
