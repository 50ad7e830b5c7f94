"""SIFT frontend stage: image loading, batched extraction, all-pairs
matching (port of global_lvba_tpu.pipeline.sift_frontend).

The fallback path of the reference's extractAndMatchFeaturesGPU when no
COLMAP db is usable: extract per image, match every image pair with
SiftGPU's default acceptance (distmax 0.7, ratio 0.8, mutual best), and
compact the keypoints and matches to the valid slots.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import LvbaConfig
from ..frontend.matching import match_all_pairs
from ..frontend.sift import SiftParams, extract_sift_batch
from ..io.image import imread_color_or_none, imread_gray, resize_linear
from ..utils.progress import progress_bar

log = logging.getLogger("global_lvba_tpu_torch.frontend")


def load_gray_image(path, width: int, height: int) -> np.ndarray:
    """The image file as gray float32 in [0, 1] at width x height: cv2's
    IMREAD_GRAYSCALE (the EXIF orientation applied first) and
    INTER_LINEAR resize, bit for bit (io/image.py)."""
    img = imread_gray(path)
    if img.shape[1] != width or img.shape[0] != height:
        img = resize_linear(img, width, height)
    return img.astype(np.float32) / 255.0


def _upload(stack: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host image stack on `dev` as float32; from pinned memory on a
    card, so the copy does not wait for the work queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(stack, np.float32))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def extract_images(
    images: Sequence[np.ndarray],
    params: Optional[SiftParams] = None,
    batch: int = 4,
    device="cuda",
):
    """SIFT on the images, same-shape images in batches of `batch`;
    returns (kps, descs, valids).  The keypoints (K, 2) come to the host
    as numpy; the descriptors (K, 128) and masks (K,) stay on the device
    for the matcher."""
    dev = resolve_device(device)
    params = params or SiftParams()
    n = len(images)
    kps: List[np.ndarray] = [None] * n
    descs: List = [None] * n
    valids: List = [None] * n
    i = 0
    while i < n:
        shape = images[i].shape
        j = i
        while j < n and j - i < batch and images[j].shape == shape:
            j += 1
        feats = extract_sift_batch(_upload(np.stack(images[i:j]), dev),
                                   params, dev)
        xy = feats.xy.float().cpu().numpy()
        for k in range(i, j):
            kps[k] = xy[k - i]
            descs[k] = feats.desc[k - i]
            valids[k] = feats.valid[k - i]
        progress_bar(j, n)
        i = j
    return kps, descs, valids


def extract_images_pipelined(
    paths: Sequence,
    width: int,
    height: int,
    params: Optional[SiftParams] = None,
    batch: int = 4,
    decode_workers: int = 4,
    device="cuda",
):
    """Frontend extraction with the image decode on host threads,
    overlapped with the device's extraction of the batch before: every
    batch is queued before anything is read back.  Returns (kps, descs,
    valids) as extract_images."""
    from concurrent.futures import ThreadPoolExecutor

    dev = resolve_device(device)
    params = params or SiftParams()
    n = len(paths)
    feats_batches = []
    with ThreadPoolExecutor(max_workers=decode_workers) as ex:
        futs = [ex.submit(load_gray_image, p, width, height) for p in paths]
        for i in range(0, n, batch):
            j = min(i + batch, n)
            stack = np.stack([futs[k].result() for k in range(i, j)])
            feats_batches.append(
                (i, j, extract_sift_batch(_upload(stack, dev), params, dev)))
            progress_bar(j, n)
    kps: List[np.ndarray] = [None] * n
    descs: List = [None] * n
    valids: List = [None] * n
    for (i, j, feats) in feats_batches:
        xy = feats.xy.float().cpu().numpy()
        for k in range(i, j):
            kps[k] = xy[k - i]
            descs[k] = feats.desc[k - i]
            valids[k] = feats.valid[k - i]
    return kps, descs, valids


def match_and_compact(
    kps: Sequence[np.ndarray],
    descs: Sequence,
    valids: Sequence,
    chunk: int = 16,
    device="cuda",
) -> Tuple[List[np.ndarray], Dict[Tuple[int, int], np.ndarray]]:
    """Match all pairs i < j and compact to the valid keypoints: returns
    (keypoints (K_i, 2) of the valid slots per image, matches {(i, j):
    (m, 2) int32} in those compacted indices)."""
    M = len(kps)
    pairs = [(i, j) for i in range(M) for j in range(i + 1, M)]
    matches = match_all_pairs(descs, valids, pairs, chunk=chunk,
                              device=device)
    if M and len({tuple(v.shape) for v in valids}) == 1:   # one copy
        vmask = list(torch.stack([torch.as_tensor(v) for v in valids])
                     .cpu().numpy())
    else:
        vmask = [torch.as_tensor(v).cpu().numpy() for v in valids]
    kps_out: List[np.ndarray] = []
    remaps: List[np.ndarray] = []
    for k in range(M):
        v = vmask[k]
        remap = np.full(v.shape[0], -1, np.int64)
        remap[v] = np.arange(v.sum())
        remaps.append(remap)
        kps_out.append(kps[k][v])
    matches_out: Dict[Tuple[int, int], np.ndarray] = {}
    for (i, j), m in matches.items():
        mi = remaps[i][m[:, 0]]
        mj = remaps[j][m[:, 1]]
        ok = (mi >= 0) & (mj >= 0)
        if np.any(ok):
            matches_out[(i, j)] = np.stack([mi[ok], mj[ok]],
                                           axis=-1).astype(np.int32)
    return kps_out, matches_out


def extract_and_match_sift(
    ds,                      # a dataset: .image_paths, .cam (width, height)
    cfg: LvbaConfig,
    params: Optional[SiftParams] = None,
    result_dir=None,
    device="cuda",
) -> Tuple[List[np.ndarray], Dict[Tuple[int, int], np.ndarray]]:
    """Full frontend from a dataset: load, extract, match all pairs.

    Returns (keypoints (K, 2) per image restricted to valid slots,
    matches).  With cfg.solver.save_match_images and a result_dir, each
    matched pair is drawn into result_dir/matches_<i>_<j>.jpg
    (outputs.draw_matches)."""
    kps, descs, valids = extract_images_pipelined(
        ds.image_paths, ds.cam.width, ds.cam.height, params, device=device)
    kps_out, matches_out = match_and_compact(kps, descs, valids,
                                             device=device)
    if cfg.solver.save_match_images and result_dir is not None:
        # per-pair match visualizations, the reference's
        # drawAndSaveMatchesGPU into result/ (lvba_system.cpp:823)
        from .outputs import draw_matches

        rdir = Path(result_dir)
        rdir.mkdir(parents=True, exist_ok=True)
        for (i, j), m in matches_out.items():
            # a pair is skipped where cv2.imread(IMREAD_COLOR) would
            # return None, as the reference's is
            img1 = imread_color_or_none(ds.image_paths[i])
            img2 = imread_color_or_none(ds.image_paths[j])
            if img1 is None or img2 is None:
                continue
            draw_matches(
                img1, img2, kps_out[i], kps_out[j], m,
                path=rdir / f"matches_{i:04d}_{j:04d}.jpg",
            )
    log.info(
        "[sift] %d images, %d pairs matched, mean kp %.0f",
        len(kps_out), len(matches_out),
        np.mean([k.shape[0] for k in kps_out]) if kps_out else 0.0,
    )
    return kps_out, matches_out
