"""The SIFT frontend of the PyTorch port end to end against the JAX
package on the CPU: PNGs through extract_and_match_sift (float32, as both
load them), and the match-graph track components."""

from types import SimpleNamespace

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from global_lvba_tpu.config import LvbaConfig as JConfig
from global_lvba_tpu.pipeline import sift_frontend as jsf
from global_lvba_tpu.tracks import build as jtb
from global_lvba_tpu_torch.config import LvbaConfig
from global_lvba_tpu_torch.frontend.sift import SiftParams
from global_lvba_tpu_torch.geometry.camera import CameraModel
from global_lvba_tpu_torch.models.synthetic import (
    make_plane_scene, render_textured_views)
from global_lvba_tpu_torch.pipeline import sift_frontend as psf
from global_lvba_tpu_torch.tracks import build as ptb

PARAMS = dict(max_kp=256, n_octaves=3)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Five renders of the box room at 160 x 128 along a short yaw sweep,
    written as PNGs with cv2."""
    import cv2

    cam = CameraModel(fx=161.7, fy=161.7, cx=78.4, cy=65.3, k1=-0.076,
                      k2=0.123, p1=-0.00113, p2=0.000251, width=160,
                      height=128)
    scene = make_plane_scene(num_frames=2, points_per_frame=60, seed=9)
    R0 = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    Rcw, tcw = [], []
    for k in range(5):
        R = R0 @ Rotation.from_rotvec([0.0, 0.0, 0.06 * k]).as_matrix().T
        Rcw.append(R)
        tcw.append(-R @ np.array([-0.5, 0.05 * k, 0.0]))
    imgs = render_textured_views(scene, cam, np.stack(Rcw), np.stack(tcw))
    d = tmp_path_factory.mktemp("frontend")
    paths = []
    for i, im in enumerate(imgs):
        p = d / f"{i}.png"
        cv2.imwrite(str(p), (im * 255).round().astype(np.uint8))
        paths.append(p)
    return SimpleNamespace(image_paths=paths, cam=cam)


@pytest.fixture(scope="module")
def frontends(dataset):
    got = psf.extract_and_match_sift(dataset, LvbaConfig(),
                                     params=SiftParams(**PARAMS),
                                     device="cpu")
    from global_lvba_tpu.frontend.sift import SiftParams as JParams

    want = jsf.extract_and_match_sift(dataset, JConfig(),
                                      params=JParams(**PARAMS))
    return got, want


def test_extract_and_match_sift_matches_jax(frontends):
    (kps, matches), (jkps, jmatches) = frontends
    assert len(kps) == len(jkps) == 5
    for a, b in zip(kps, jkps):
        assert a.shape == b.shape and a.shape[0] > 50
        # float32 blurs in another summation order: the same keypoints;
        # one Newton step on a nearly singular DoG Hessian amplifies the
        # rounding, so positions agree within 1e-2 px (median 1e-4)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2)
        assert np.median(np.abs(a - b).max(1)) < 1e-4
    assert set(matches) == set(jmatches)
    assert len(matches) >= 8
    for key in matches:
        np.testing.assert_array_equal(matches[key], jmatches[key])


def test_build_components_matches_jax(frontends):
    (kps, matches), _ = frontends
    got = ptb.build_components(kps, matches, obser_thr=3)
    want = jtb.build_components(kps, matches, obser_thr=3)
    assert got.stats == want.stats and got.obs_img.shape[0] > 20

    def tracks(ts):   # order-free: the JAX side may use its native labels
        return sorted(tuple(zip(ts.obs_img[t, :n], ts.obs_kp[t, :n]))
                      for t, n in enumerate(ts.num_obs))

    assert tracks(got) == tracks(want)
    order = np.lexsort((got.obs_kp[:, 0], got.obs_img[:, 0]))
    jorder = np.lexsort((want.obs_kp[:, 0], want.obs_img[:, 0]))
    np.testing.assert_array_equal(got.obs_uv[order], want.obs_uv[jorder])
    np.testing.assert_array_equal(got.obs_valid[order], want.obs_valid[jorder])


@pytest.mark.parametrize("case", ["chain", "below_threshold",
                                  "distinct_images"])
def test_build_components_small_graphs(case):
    if case == "chain":
        kps = [np.array([[10.0, 10.0]]), np.array([[20.0, 20.0]]),
               np.array([[30.0, 30.0]])]
        matches = {(0, 1): np.array([[0, 0]]), (1, 2): np.array([[0, 0]])}
    elif case == "below_threshold":
        kps = [np.array([[1.0, 1.0]]), np.array([[2.0, 2.0]])]
        matches = {(0, 1): np.array([[0, 0]])}
    else:
        kps = [np.array([[1.0, 1.0], [1.5, 1.5]]), np.array([[2.0, 2.0]])]
        matches = {(0, 1): np.array([[0, 0], [1, 0]])}
    got = ptb.build_components(kps, matches, obser_thr=3)
    want = jtb.build_components(kps, matches, obser_thr=3)
    assert got.stats == want.stats
    for name in ("obs_img", "obs_kp", "obs_uv", "obs_valid", "num_obs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_save_match_images_match_jax_draw_matches(dataset, tmp_path):
    """With solver.save_match_images every matched pair is drawn into
    result_dir, byte for byte as the JAX package's draw_matches writes
    the same pair."""
    import cv2

    from global_lvba_tpu.pipeline.outputs import draw_matches

    cfg = LvbaConfig()
    cfg.solver.save_match_images = True
    kps, matches = psf.extract_and_match_sift(
        dataset, cfg, params=SiftParams(**PARAMS),
        result_dir=tmp_path / "result", device="cpu")
    names = sorted(f"matches_{i:04d}_{j:04d}.jpg" for i, j in matches)
    assert matches and sorted(
        p.name for p in (tmp_path / "result").iterdir()) == names
    for (i, j), m in matches.items():
        imgs = [cv2.imread(str(dataset.image_paths[k]), cv2.IMREAD_COLOR)
                for k in (i, j)]
        draw_matches(*imgs, kps[i], kps[j], m, path=tmp_path / "want.jpg")
        got = tmp_path / "result" / f"matches_{i:04d}_{j:04d}.jpg"
        assert got.read_bytes() == (tmp_path / "want.jpg").read_bytes()


def test_save_match_images_skip_a_view_cv2_reads_only_in_gray(dataset,
                                                                tmp_path):
    """A dataset whose view 2 is a one-component lossless JPEG (cv2 reads
    it in gray for SIFT, and returns None in colour): with
    solver.save_match_images both packages match every pair, skip the
    drawings of the pairs with view 2, write the others, and finish; the
    same set of matches_*.jpg files."""
    import cv2

    import jpeg_writer as jw
    from global_lvba_tpu.frontend.sift import SiftParams as JParams

    paths = list(dataset.image_paths)
    gray = cv2.imread(str(paths[2]), cv2.IMREAD_GRAYSCALE)
    paths[2] = tmp_path / "2.jpg"
    paths[2].write_bytes(jw.lossless([gray], predictor=1))
    assert cv2.imread(str(paths[2]), cv2.IMREAD_COLOR) is None
    ds = SimpleNamespace(image_paths=paths, cam=dataset.cam)
    names = {}
    for pkg in ("port", "jax"):
        cfg = LvbaConfig() if pkg == "port" else JConfig()
        cfg.solver.save_match_images = True
        out = tmp_path / pkg
        if pkg == "port":
            _, matches = psf.extract_and_match_sift(
                ds, cfg, params=SiftParams(**PARAMS), result_dir=out,
                device="cpu")
        else:
            _, matches = jsf.extract_and_match_sift(
                ds, cfg, params=JParams(**PARAMS), result_dir=out)
        assert any(2 in pair for pair in matches)
        names[pkg] = sorted(p.name for p in out.iterdir())
        assert names[pkg] == sorted(
            f"matches_{i:04d}_{j:04d}.jpg" for i, j in matches
            if 2 not in (i, j))
    assert names["port"] == names["jax"] and names["port"]


def test_save_match_images_stop_at_an_image_past_cv2s_size_limit(dataset,
                                                                 tmp_path):
    """View 2 swapped, after the gray reads of the SIFT stage, for the
    header of a 40000 x 40000 PNG: with solver.save_match_images both
    packages stop in the export (cv2.error from cv2.imread, the port's
    ImageSizeError, which imread_color_or_none lets through), having drawn
    the same pairs before it."""
    import struct
    import zlib

    import cv2

    from global_lvba_tpu.frontend.sift import SiftParams as JParams
    from global_lvba_tpu_torch.io.image import ImageSizeError
    from png_writer import chunk

    paths = list(dataset.image_paths)
    big = tmp_path / "big.png"
    big.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 40000, 40000, 8, 0, 0, 0, 0)) + chunk(
        b"IDAT", zlib.compress(bytes(16))) + chunk(b"IEND", b""))
    ds = SimpleNamespace(image_paths=paths[:2] + [big] + paths[3:],
                         cam=dataset.cam)
    drawn = {}
    for pkg, mod, error in (("port", psf, ImageSizeError),
                            ("jax", jsf, cv2.error)):
        load = mod.load_gray_image

        def gray_of_view_2(path, *a, load=load):
            return load(paths[2] if path == big else path, *a)

        cfg = LvbaConfig() if pkg == "port" else JConfig()
        cfg.solver.save_match_images = True
        out = tmp_path / pkg
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "load_gray_image", gray_of_view_2)
            with pytest.raises(error):
                if pkg == "port":
                    mod.extract_and_match_sift(
                        ds, cfg, params=SiftParams(**PARAMS),
                        result_dir=out, device="cpu")
                else:
                    mod.extract_and_match_sift(
                        ds, cfg, params=JParams(**PARAMS), result_dir=out)
        drawn[pkg] = sorted(p.name for p in out.iterdir())
    assert drawn["port"] == drawn["jax"] and drawn["port"]
