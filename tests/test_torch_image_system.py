"""The system from image files with no COLMAP db, both packages on the CPU:
models/synthetic.write_room_dataset's box room (8 views at 160 x 128 from
320 x 256 files at scale 0.5: PNG (one of them Adam7-interlaced), two
BMPs, a baseline JPEG of the port's encoder and a progressive one of
cv2's; 12 LiDAR frames) through
the port's LvbaSystem.run_full_pipeline(images=...) and the JAX package's.
The SIFT fallback reads the files (the port's decoders, cv2 in the JAX
package); both run SiftParams(max_kp=256, n_octaves=3) for time, the solve
in float64.  Keypoint counts per image, tracks and observations within
1%, the post-BA reprojection within 2%; then the port's visual result
exported through both packages' export_outputs (the same poses, points
and observations): points3D.txt and the colored PCDs byte for byte, the
undistorted JPEGs byte for byte, the overlays and track images pixel for
pixel."""

import dataclasses
import functools

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from global_lvba_tpu.config import LvbaConfig as JConfig
from global_lvba_tpu.frontend import sift as jsift
from global_lvba_tpu.native import runtime as jnative
from global_lvba_tpu.pipeline import (
    sift_frontend as jsf, system as jsystem, visual_ba as jvba)
from global_lvba_tpu.tracks import fuse as jfuse
from global_lvba_tpu_torch.config import LvbaConfig
from global_lvba_tpu_torch.frontend import sift as psift
from global_lvba_tpu_torch.geometry.camera import CameraModel
from global_lvba_tpu_torch.io.image import (
    imread_color, jpeg_info, read_png, resize_linear)
from global_lvba_tpu_torch.models.synthetic import write_room_dataset
from global_lvba_tpu_torch.pipeline import sift_frontend as psf, visual_ba
from global_lvba_tpu_torch.pipeline.system import LvbaSystem
from global_lvba_tpu_torch.tracks import fuse
from png_writer import png as _png

CAM = CameraModel(fx=1293.56944 / 4, fy=1293.3155 / 4, cx=626.91359 / 4,
                  cy=522.799224 / 4, k1=-0.07616, k2=0.123001, p1=-0.00113,
                  p2=0.000251, width=320, height=256)
SETTINGS = {
    "window_ba": dict(size=6, anchor_leaf_size=0.02, use_window_ba_rel=True),
    "BALM_stage1": dict(root_voxel_size=1.0, eigen_ratio_array=[0.2] * 4),
    "BALM_stage2": dict(root_voxel_size=0.5, eigen_ratio_array=[0.08] * 4),
    "solver": dict(dtype="float64"),
    "colmap_output": dict(enable=True, filter_size_points3D=0.05),
}


@pytest.fixture(autouse=True, scope="module")
def _patched():
    """One intra-op thread; small SIFT in both packages; fusion in float64
    in both, the JAX package's native library off."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(psf, "SiftParams", functools.partial(
            psift.SiftParams, max_kp=256, n_octaves=3))
        mp.setattr(jsf, "SiftParams", functools.partial(
            jsift.SiftParams, max_kp=256, n_octaves=3))
        mp.setattr(jnative, "get_lib", lambda: None)
        mp.setattr(jvba, "fuse_tracks", functools.partial(
            jfuse.fuse_tracks, dtype=jnp.float64))
        mp.setattr(visual_ba, "fuse_tracks", functools.partial(
            fuse.fuse_tracks, dtype=torch.float64))
        mp.setenv("LVBA_COMPILE_CACHE", "0")
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("image_system")
    cfg_path, bgr, _, _ = write_room_dataset(
        root / "data", CAM, 0.5, num_views=8, num_frames=12,
        points_per_frame=5000, seed=3, bmp_every=4, settings=SETTINGS,
        step=0.3, jpeg_every=3)
    psys = LvbaSystem(LvbaConfig.from_yaml(cfg_path), out_dir=root / "port",
                      device="cpu")
    paths = psys.ds.image_paths
    # view 5 (a baseline JPEG of the port's encoder) again as cv2's
    # progressive JPEG, view 0 (a PNG) as an Adam7 PNG
    assert paths[5].suffix == ".jpg" and paths[0].suffix == ".png"
    cv2.imwrite(str(paths[5]), bgr[5], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    paths[0].write_bytes(_png(bgr[0][:, :, ::-1], 2, 8, (0, 1, 2, 3, 4),
                              interlace=1))
    images = [resize_linear(imread_color(p), 160, 128) for p in paths]
    pres = psys.run_full_pipeline(images=images)
    jsys = jsystem.LvbaSystem(JConfig.from_yaml(cfg_path),
                              out_dir=root / "jax")
    jres = jsys.run_full_pipeline(images=images)
    return dict(root=root, bgr=bgr, paths=paths, images=images,
                port=(psys, pres), jax=(jsys, jres))


def test_dataset_files_decode_as_written(runs):
    """PNG (one of them Adam7) and BMP views decode to the arrays written,
    JPEG views (the port's baseline, cv2's progressive) to cv2.imread's
    pixels bit for bit and within the codec's loss of the arrays."""
    paths = runs["paths"]
    suffixes = [p.suffix for p in paths]
    assert (suffixes.count(".bmp"), suffixes.count(".jpg")) == (2, 2)
    assert jpeg_info(paths[2].read_bytes())["format"] == "baseline"
    assert jpeg_info(paths[5].read_bytes())["format"] == "progressive"
    assert read_png(paths[0].read_bytes())[0].shape == (256, 320, 3)
    assert paths[0].read_bytes()[28] == 1       # IHDR's interlace byte
    for k, p in enumerate(paths):
        got = imread_color(p)
        assert np.array_equal(got, cv2.imread(str(p), cv2.IMREAD_COLOR))
        if p.suffix == ".jpg":
            err = got.astype(np.float64) - runs["bgr"][k]
            assert 10 * np.log10(255.0 ** 2 / np.mean(err ** 2)) >= 35.0
        else:
            assert np.array_equal(got, runs["bgr"][k])
        assert np.array_equal(runs["images"][k], cv2.resize(
            got, (160, 128), interpolation=cv2.INTER_LINEAR))


def test_frontend_and_solve_match_jax(runs):
    (psys, pres), (jsys, jres) = runs["port"], runs["jax"]
    pv, jv = psys.visual_result, jsys.visual_result
    for a, b in zip(pv.keypoints, jv.keypoints):
        assert abs(len(a) - len(b)) <= 0.01 * len(b)
    for k in ("tracks_fused", "tracks_with_plane", "observations"):
        assert abs(pv.stats[k] - jv.stats[k]) <= 0.01 * jv.stats[k], k
    assert pv.stats["tracks_fused"] > 100
    assert abs(pres["mean_reproj_post"] - jres["mean_reproj_post"]) <= \
        0.02 * jres["mean_reproj_post"]
    assert pres["mean_reproj_post"] < pres["mean_reproj_pre"]
    assert pres["mean_reproj_post"] < 1.0


def _port_result_in_jax(psys, jsys):
    """The JAX system holding the port's poses and visual result."""
    jsys.R_opt, jsys.p_opt = psys.R_opt.copy(), psys.p_opt.copy()
    fields = {f.name: getattr(psys.visual_result, f.name)
              for f in dataclasses.fields(jvba.VisualBAResultFull)}
    jsys.visual_result = jvba.VisualBAResultFull(**fields)


def test_exports_of_the_same_result_match_jax(runs):
    (psys, _), (jsys, _) = runs["port"], runs["jax"]
    root, images = runs["root"], runs["images"]
    _port_result_in_jax(psys, jsys)
    psys.out_dir, jsys.out_dir = root / "ex_port", root / "ex_jax"
    psys.export_outputs(images)
    jsys.export_outputs(images)
    a, b = psys.out_dir, jsys.out_dir
    tree = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert tree == sorted(str(p.relative_to(b)) for p in b.rglob("*")
                          if p.is_file())
    assert len(list((a / "Colmap" / "images").glob("*.jpg"))) == 8
    for name in ("Colmap/sparse/points3D.txt", "Colmap/sparse/images.txt",
                 "Colmap/colored_merged_after.pcd",
                 "Colmap/colored_merged_before.pcd"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    for p in sorted((a / "Colmap" / "images").glob("*.jpg")):
        assert p.read_bytes() == (b / "Colmap" / "images" / p.name) \
            .read_bytes()
    pngs = sorted((a / "reproj").glob("*.png")) + sorted(
        (a / "track_features").glob("*.png"))
    assert len(pngs) >= 8
    for p in pngs:
        q = b / p.relative_to(a)
        assert np.array_equal(cv2.imread(str(p)), cv2.imread(str(q))), p
    n_pts = len((a / "Colmap" / "sparse" / "points3D.txt").read_text()
                .splitlines())
    assert n_pts > 100
    assert set(psys.export_times) >= {"undistort_s", "jpeg_s", "colorize_s",
                                      "overlays_s", "track_images_s"}
