"""COLMAP sqlite database ingestion — the preferred feature frontend; the
port's own copy of global_lvba_tpu.frontend.colmap_db (stdlib sqlite3,
host numpy).

Replicates loadFromColmapDB (src/lvba_system.cpp:510-685):

  * images table maps file name (full and basename) -> image_id; the load
    aborts (returns None) when the db image count differs from the dataset
    image count (:546-553);
  * keypoints blobs are row-major float32 with 4 or 6 columns
    (x, y, sigma, extremum[, ...]) (:574-609);
  * two_view_geometries holds INLIER matches per pair_id
    = min_id * (2^31 - 1) + max_id, rows x 2 uint32, with index swap
    correction when the query order differs from id order (:611-680).
"""

from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_COLMAP_MAX_IMAGES = (1 << 31) - 1


def _pair_id(id1: int, id2: int) -> int:
    if id1 > id2:
        id1, id2 = id2, id1
    return id1 * _COLMAP_MAX_IMAGES + id2


def load_colmap_db(
    db_path,
    image_names: Sequence[str],
):
    """Load keypoints + inlier matches for the given ordered image names.

    Returns (keypoints, matches) or None when the database does not cover
    the dataset (reference behavior: fall back to the SIFT frontend).

    keypoints: list of (K_i, 4) float32 arrays (x, y, sigma, extremum).
    matches: {(i, j): (m, 2) int32} for i < j in dataset order.
    """
    db_path = Path(db_path)
    if not db_path.exists():
        return None
    try:
        return _load_colmap_db_inner(db_path, image_names)
    except sqlite3.Error:
        # unusable/corrupt database -> caller falls back to the SIFT
        # frontend, mirroring the reference's rebuild path
        # (lvba_system.cpp:546-553)
        return None


def _load_colmap_db_inner(db_path, image_names):
    con = sqlite3.connect(str(db_path))
    try:
        cur = con.cursor()
        name2id: Dict[str, int] = {}
        count = 0
        for image_id, name in cur.execute("SELECT image_id, name FROM images;"):
            name2id[name] = int(image_id)
            name2id[Path(name).name] = int(image_id)
            count += 1
        if count != len(image_names):
            return None

        ids = []
        for n in image_names:
            iid = name2id.get(n, name2id.get(Path(n).name, -1))
            ids.append(iid)

        keypoints: List[np.ndarray] = []
        for iid in ids:
            if iid < 0:
                keypoints.append(np.zeros((0, 4), dtype=np.float32))
                continue
            row = cur.execute(
                "SELECT rows, cols, data FROM keypoints WHERE image_id=?;", (iid,)
            ).fetchone()
            if row is None or row[2] is None:
                keypoints.append(np.zeros((0, 4), dtype=np.float32))
                continue
            rows, cols, blob = int(row[0]), int(row[1]), row[2]
            if rows * cols * 4 != len(blob):
                keypoints.append(np.zeros((0, 4), dtype=np.float32))
                continue
            arr = np.frombuffer(blob, dtype=np.float32).reshape(rows, cols)
            out = np.zeros((rows, 4), dtype=np.float32)
            out[:, : min(cols, 4)] = arr[:, : min(cols, 4)]
            keypoints.append(out)

        matches: Dict[Tuple[int, int], np.ndarray] = {}
        N = len(ids)
        for i in range(N):
            for j in range(i + 1, N):
                id1, id2 = ids[i], ids[j]
                if id1 < 0 or id2 < 0:
                    continue
                if keypoints[i].shape[0] == 0 or keypoints[j].shape[0] == 0:
                    continue
                swapped = id1 > id2
                pid = _pair_id(id1, id2)
                row = cur.execute(
                    "SELECT rows, cols, data FROM two_view_geometries WHERE pair_id=?;",
                    (pid,),
                ).fetchone()
                if row is None or row[2] is None:
                    continue
                rows, cols, blob = int(row[0]), int(row[1]), row[2]
                if cols != 2 or rows <= 0 or len(blob) != rows * 8:
                    continue
                m = np.frombuffer(blob, dtype=np.uint32).reshape(rows, 2).astype(np.int64)
                if swapped:
                    m = m[:, ::-1]
                ok = (
                    (m[:, 0] >= 0)
                    & (m[:, 0] < keypoints[i].shape[0])
                    & (m[:, 1] >= 0)
                    & (m[:, 1] < keypoints[j].shape[0])
                )
                m = m[ok]
                if m.shape[0]:
                    matches[(i, j)] = m.astype(np.int32)
        return keypoints, matches
    finally:
        con.close()


def write_colmap_db(
    db_path,
    image_names: Sequence[str],
    keypoints: Sequence[np.ndarray],
    matches: Dict[Tuple[int, int], np.ndarray],
):
    """Create a COLMAP-schema database from in-memory features/matches.

    Used by tests (round-trip fixture) and by the built-in SIFT frontend to
    cache its output the way the reference caches via match.db."""
    db_path = Path(db_path)
    con = sqlite3.connect(str(db_path))
    try:
        cur = con.cursor()
        cur.execute(
            "CREATE TABLE IF NOT EXISTS images (image_id INTEGER PRIMARY KEY, name TEXT);"
        )
        cur.execute(
            "CREATE TABLE IF NOT EXISTS keypoints (image_id INTEGER PRIMARY KEY,"
            " rows INTEGER, cols INTEGER, data BLOB);"
        )
        cur.execute(
            "CREATE TABLE IF NOT EXISTS two_view_geometries (pair_id INTEGER PRIMARY KEY,"
            " rows INTEGER, cols INTEGER, data BLOB);"
        )
        for i, name in enumerate(image_names):
            iid = i + 1
            cur.execute("INSERT OR REPLACE INTO images VALUES (?, ?);", (iid, name))
            kp = np.asarray(keypoints[i], dtype=np.float32)
            cur.execute(
                "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?);",
                (iid, kp.shape[0], kp.shape[1], kp.tobytes()),
            )
        for (i, j), m in matches.items():
            id1, id2 = i + 1, j + 1
            arr = np.asarray(m, dtype=np.uint32)
            if id1 > id2:
                arr = arr[:, ::-1]
            pid = _pair_id(id1, id2)
            cur.execute(
                "INSERT OR REPLACE INTO two_view_geometries VALUES (?, ?, ?, ?);",
                (pid, arr.shape[0], 2, np.ascontiguousarray(arr).tobytes()),
            )
        con.commit()
    finally:
        con.close()
