"""The port's exports against the JAX package on the CPU: the eleven cases
of tests/test_outputs.py, each run through both packages (files byte-equal
or images equal pixel for pixel, numbers within 1e-9), and the depth PNGs:
the port writes and reads them with zlib (no cv2) and must agree with
cv2's files both ways, under every PNG row filter."""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from global_lvba_tpu.__main__ import main as jmain
from global_lvba_tpu.geometry import camera as jcamera
from global_lvba_tpu.io.pcd import read_pcd
from global_lvba_tpu.pipeline import outputs as jout, viz as jviz
from global_lvba_tpu.utils.checkpoint import StageCheckpoint as JCheckpoint
from global_lvba_tpu_torch.__main__ import main
from global_lvba_tpu_torch.geometry.camera import CameraModel
from global_lvba_tpu_torch.io.pcd import write_pcd
from global_lvba_tpu_torch.pipeline import outputs, viz
from global_lvba_tpu_torch.utils.checkpoint import StageCheckpoint

CAM = CameraModel(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128, height=96)
JCAM = jcamera.CameraModel(*CAM)
DIST = CAM._replace(k1=-0.08, k2=0.12, p1=-0.001, p2=0.0005)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_files(a, b):
    assert a.read_bytes() == b.read_bytes(), (a, b)


def _same_image(a, b):
    ia = cv2.imread(str(a), cv2.IMREAD_UNCHANGED)
    ib = cv2.imread(str(b), cv2.IMREAD_UNCHANGED)
    assert ia is not None and ia.shape == ib.shape and np.array_equal(ia, ib)


def _same_dirs(a, b, compare=_same_files):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and names
    for n in names:
        compare(a / n, b / n)


# ---------------------------------------------------------- depth PNG ----

def _depth(seed=0):
    """Smooth ramps, a random patch, zeros and out-of-range values: rows
    for which libpng picks different filters."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:96, 0:128]
    d = (2.0 + 0.05 * x + 0.02 * y).astype(np.float32)
    d[10:30, 20:60] = rng.uniform(0, 20, (20, 40))
    d[40:50] = 0.0
    d[60, :10] = 40.0                     # clipped at 65535
    d[61, :10] = -1.0                     # clipped at 0
    return d


def _encode_png16(img: np.ndarray, filters) -> bytes:
    """A 16-bit grayscale PNG whose row y is stored under filter
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    H, W = img.shape
    raw = img.astype(">u2").view(np.uint8).reshape(H, 2 * W).astype(np.int64)
    out = bytearray()
    prior = np.zeros(2 * W, np.int64)
    for y in range(H):
        cur = raw[y]
        a = np.concatenate([[0, 0], cur[:-2]])
        c = np.concatenate([[0, 0], prior[:-2]])
        b = prior
        ft = filters[y % len(filters)]
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) // 2
        else:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out.append(ft)
        out.extend(((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 16, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


def _cv2_bytes(ext, img):
    ok, buf = cv2.imencode(ext, img)
    assert ok
    return buf.tobytes()


def _palette_trns_png():
    from png_writer import png

    rng = np.random.default_rng(4)
    return png(rng.integers(0, 16, (12, 10, 1)), 3, 4,
               plte=rng.integers(0, 256, (16, 3)), trns=bytes([0, 90, 200]))


_OTHER_FORMATS = {
    "gray8_png": lambda: _cv2_bytes(".png", (_depth(2) * 12).astype(
        np.uint8)),
    "rgb16_png": lambda: _cv2_bytes(".png", np.stack(
        [np.clip(_depth(k) * 2000, 0, 65535) for k in (3, 4, 5)],
        -1).astype(np.uint16)),
    "palette_trns_png": _palette_trns_png,
    "gray_bmp": lambda: _cv2_bytes(".bmp", (_depth(6) * 12).astype(
        np.uint8)),
    "color_jpg": lambda: _cv2_bytes(".jpg", np.stack(
        [(_depth(k) * 12).astype(np.uint8) for k in (7, 8, 9)], -1)),
}


class TestDepthPng:
    def test_roundtrip(self, tmp_path):
        depth = np.random.default_rng(0).uniform(0, 20, (96, 128)).astype(
            np.float32)
        p, q = tmp_path / "d.png", tmp_path / "j.png"
        outputs.save_depth_png(p, depth)
        jout.save_depth_png(q, depth)
        back = outputs.load_depth_png(p)
        assert np.abs(back - depth).max() < 1e-3
        want = jout.load_depth_png(p)
        assert back.dtype == want.dtype and np.array_equal(back, want)
        assert np.array_equal(back, jout.load_depth_png(q))

    def test_files_decode_to_cv2_pixels(self, tmp_path):
        """The port's file and the JAX package's (cv2's) decode to equal
        pixels through cv2; the port's reader gives JAX's array from
        cv2's file."""
        depth = _depth()
        p, q = tmp_path / "port.png", tmp_path / "jax.png"
        outputs.save_depth_png(p, depth)
        jout.save_depth_png(q, depth)
        a = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(q), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype == np.uint16 and np.array_equal(a, b)
        assert np.array_equal(outputs.load_depth_png(q),
                              jout.load_depth_png(q))

    @pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                         (0, 1, 2, 3, 4)])
    def test_every_row_filter(self, tmp_path, filters):
        img = np.clip(_depth(1) * 2000, 0, 65535).astype(np.uint16)
        p = tmp_path / "f.png"
        p.write_bytes(_encode_png16(img, filters))
        assert np.array_equal(cv2.imread(str(p), cv2.IMREAD_UNCHANGED), img)
        got = outputs.load_depth_png(p)
        assert np.array_equal(got, img.astype(np.float32) / 2000.0)
        assert np.array_equal(got, jout.load_depth_png(p))

    @pytest.mark.parametrize("kind", list(_OTHER_FORMATS) + [
        "not_an_image", "bare_signature", "missing"])
    def test_other_formats(self, tmp_path, kind):
        """Files other than a 16-bit gray PNG read as the reference reads
        them (cv2's IMREAD_UNCHANGED in float32 over scale, the default and
        1000), and a file that is no image raises ValueError (a missing
        one FileNotFoundError), where the reference fails on cv2's None."""
        p = tmp_path / f"d.{kind.rsplit('_', 1)[-1]}"
        if kind in _OTHER_FORMATS:
            p.write_bytes(_OTHER_FORMATS[kind]())
            for kw in ({}, {"scale": 1000.0}):
                got = outputs.load_depth_png(p, **kw)
                want = jout.load_depth_png(p, **kw)
                assert got.dtype == want.dtype == np.float32
                assert got.shape == want.shape and np.array_equal(got, want)
            return
        if kind == "not_an_image":
            p.write_bytes(b"GIF89a")
            with pytest.raises(ValueError, match="unknown image format"):
                outputs.load_depth_png(p)
        elif kind == "bare_signature":
            p.write_bytes(outputs._PNG_SIGNATURE)
            with pytest.raises(ValueError, match="no IHDR"):
                outputs.load_depth_png(p)
        else:
            with pytest.raises(FileNotFoundError):
                outputs.load_depth_png(p)


# ------------------------------------------------------- COLMAP export ----

class TestColmapExport:
    def test_images_and_points(self, tmp_path):
        from scipy.spatial.transform import Rotation

        rng = np.random.default_rng(1)
        Rcw = Rotation.random(3, random_state=0).as_matrix()
        tcw = rng.normal(size=(3, 3))
        pts = rng.normal(size=(10, 3))
        rgb = rng.integers(0, 256, (10, 3)).astype(np.float32)
        outputs.write_colmap_sparse(tmp_path / "p", Rcw, tcw, pts)
        jout.write_colmap_sparse(tmp_path / "j", Rcw, tcw, pts)
        _same_dirs(tmp_path / "p" / "sparse", tmp_path / "j" / "sparse")
        names = ["a.jpg", "b.jpg", "c.jpg"]
        outputs.write_colmap_sparse(tmp_path / "p2", Rcw, tcw, pts, rgb, names)
        jout.write_colmap_sparse(tmp_path / "j2", Rcw, tcw, pts, rgb, names)
        _same_dirs(tmp_path / "p2" / "sparse", tmp_path / "j2" / "sparse")
        img_lines = (tmp_path / "p" / "sparse" / "images.txt").read_text() \
            .splitlines()
        assert len(img_lines) == 6
        assert len((tmp_path / "p" / "sparse" / "points3D.txt").read_text()
                   .splitlines()) == 10
        q = np.array(list(map(float, img_lines[0].split()[1:5])))
        Rrt = Rotation.from_quat([q[1], q[2], q[3], q[0]]).as_matrix()
        np.testing.assert_allclose(Rrt, Rcw[0], atol=1e-5)


class TestColorize:
    def test_colored_cloud(self, tmp_path):
        clouds = [np.array([[0.0, 0.0, 5.0], [0.1, 0.0, 4.0]], np.float32)]
        img = np.zeros((96, 128, 3), dtype=np.uint8)
        img[:, :] = (255, 128, 64)  # BGR
        args = (clouds, np.array([0.0]), np.eye(3)[None], np.zeros((1, 3)),
                np.array([0.0]), [img], np.eye(3)[None], np.zeros((1, 3)))
        out = outputs.colorize_clouds(CAM, *args, device="cpu")
        ref = jout.colorize_clouds(JCAM, *args)
        assert out.dtype == ref.dtype and np.array_equal(out, ref)
        assert out.shape[0] == 2
        np.testing.assert_array_equal(out[0, 3:6], [64, 128, 255])
        outputs.write_colored_pcd(tmp_path / "c.pcd", out)
        jout.write_colored_pcd(tmp_path / "j.pcd", ref)
        _same_files(tmp_path / "c.pcd", tmp_path / "j.pcd")
        back = read_pcd(tmp_path / "c.pcd", fields=("x", "y", "z"))
        np.testing.assert_allclose(back, out[:, :3], atol=1e-6)

    def test_many_frames_distorted(self):
        """Several frames and images, a distorted camera, points behind
        and beside it, and a ±0.5 s window that leaves one image empty."""
        rng = np.random.default_rng(3)
        cam = DIST
        clouds = [rng.uniform([-3, -3, -2], [3, 3, 8], (400, 3)).astype(
            np.float32) for _ in range(5)]
        lt = np.array([0.0, 0.4, 0.8, 1.2, 5.0])
        Rb = np.tile(np.eye(3), (5, 1, 1))
        pb = rng.normal(scale=0.1, size=(5, 3))
        it = np.array([0.1, 0.9, 3.0])
        imgs = [rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
                for _ in it]
        Rcw = np.tile(np.eye(3), (3, 1, 1))
        tcw = rng.normal(scale=0.05, size=(3, 3))
        args = (clouds, lt, Rb, pb, it, imgs, Rcw, tcw)
        out = outputs.colorize_clouds(cam, *args, device="cpu")
        ref = jout.colorize_clouds(jcamera.CameraModel(*cam), *args)
        assert out.shape[0] > 100 and np.array_equal(out, ref)


# ---------------------------------------------------------- overlays ----

def _overlay_problem(seed=2, M=2, P=5):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1, 1, P), rng.uniform(-1, 1, P),
                  rng.uniform(4, 6, P)], -1)
    Rcw = np.tile(np.eye(3), (M, 1, 1))
    tcw = np.zeros((M, 3))
    obs_cam = np.repeat(np.arange(M), P).astype(np.int32)
    obs_pt = np.tile(np.arange(P), M).astype(np.int32)
    uv = (X[obs_pt, :2] / X[obs_pt, 2:3]) * 100 + [64, 48]
    return X, Rcw, tcw, obs_cam, obs_pt, uv


class TestOverlays:
    def test_reprojection_overlays(self, tmp_path):
        X, Rcw, tcw, obs_cam, obs_pt, uv = _overlay_problem()
        args = ([None, None], obs_cam, obs_pt, uv, X + 0.05, X, Rcw, tcw,
                Rcw, tcw)
        pre, post = outputs.save_reprojection_overlays(tmp_path / "p", CAM,
                                                       *args)
        jpre, jpost = jout.save_reprojection_overlays(tmp_path / "j", JCAM,
                                                      *args)
        assert abs(pre - jpre) <= 1e-9 and abs(post - jpost) <= 1e-9
        assert post < pre and post < 0.2
        assert len(list((tmp_path / "p").iterdir())) == 2
        _same_dirs(tmp_path / "p", tmp_path / "j", _same_image)

    def test_projections_and_images_on_a_distorted_camera(self, tmp_path):
        """Rotated cameras, a distorted model, real images and names: the
        projected coordinates within 1e-9 of the JAX package's, the images
        equal pixel for pixel."""
        import jax.numpy as jnp
        from scipy.spatial.transform import Rotation

        rng = np.random.default_rng(4)
        X, _, _, obs_cam, obs_pt, _ = _overlay_problem(4, M=3, P=40)
        Rcw = Rotation.from_rotvec(rng.normal(scale=0.05, size=(3, 3))) \
            .as_matrix()
        tcw = rng.normal(scale=0.1, size=(3, 3))
        uv, ok = outputs.project_observations(DIST, Rcw, tcw, X, obs_cam,
                                              obs_pt)
        juv, _, jok = jcamera.project_world_to_pixel(
            jcamera.CameraModel(*DIST), jnp.asarray(Rcw)[obs_cam],
            jnp.asarray(tcw)[obs_cam], jnp.asarray(X)[obs_pt])
        assert ok.all() and np.array_equal(ok, np.asarray(jok))
        np.testing.assert_allclose(uv, np.asarray(juv), rtol=0, atol=1e-9)
        imgs = [rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
                for _ in range(3)]
        names = ["a.png", "b.png", "c.png"]
        meas = uv + rng.normal(scale=0.5, size=uv.shape)
        args = (imgs, obs_cam, obs_pt, meas, X + 0.02, X, Rcw, tcw, Rcw, tcw,
                names)
        got = outputs.save_reprojection_overlays(tmp_path / "p", DIST, *args)
        want = jout.save_reprojection_overlays(
            tmp_path / "j", jcamera.CameraModel(*DIST), *args)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        _same_dirs(tmp_path / "p", tmp_path / "j", _same_image)

    def test_track_features(self, tmp_path):
        kps = [np.array([[10.0, 10.0], [50.0, 30.0]], dtype=np.float32)]
        used = [np.array([True, False])]
        outputs.save_track_feature_images(tmp_path / "p", CAM, [None], kps,
                                          used)
        jout.save_track_feature_images(tmp_path / "j", JCAM, [None], kps,
                                       used)
        assert len(list((tmp_path / "p").iterdir())) == 1
        _same_dirs(tmp_path / "p", tmp_path / "j", _same_image)
        img = np.random.default_rng(5).integers(0, 256, (96, 128, 3)) \
            .astype(np.uint8)
        outputs.save_track_feature_images(tmp_path / "p2", CAM, [img], kps,
                                          used, image_names=["x.png"])
        jout.save_track_feature_images(tmp_path / "j2", JCAM, [img], kps,
                                       used, image_names=["x.png"])
        _same_dirs(tmp_path / "p2", tmp_path / "j2", _same_image)


def test_undistort_image_matches_jax():
    img = np.random.default_rng(6).integers(0, 256, (96, 128, 3)).astype(
        np.uint8)
    got = outputs.undistort_image(DIST, img, device="cpu")
    want = jout.undistort_image(jcamera.CameraModel(*DIST), img)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_draw_matches_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    img1 = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    img2 = rng.integers(0, 256, (80, 100, 3)).astype(np.uint8)
    k1 = rng.uniform(0, 90, (30, 2)).astype(np.float32)
    k2 = rng.uniform(0, 75, (25, 2)).astype(np.float32)
    m = np.stack([rng.permutation(30)[:12], rng.permutation(25)[:12]], -1)
    got = outputs.draw_matches(img1, img2, k1, k2, m, path=tmp_path / "p.jpg")
    want = jout.draw_matches(img1, img2, k1, k2, m, path=tmp_path / "j.jpg")
    assert got.shape == (96, 228, 3) and np.array_equal(got, want)
    _same_files(tmp_path / "p.jpg", tmp_path / "j.jpg")


# -------------------------------------------------------- checkpoints ----

class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        ck = StageCheckpoint(tmp_path)
        R = np.random.default_rng(0).normal(size=(4, 3, 3))
        clouds = [np.random.default_rng(i).normal(size=(10 + i, 3))
                  for i in range(3)]
        ck.save("stage1", R_opt=R, note="hello", count=3, clouds=clouds)
        assert ck.has("stage1")
        for out in (ck.load("stage1"), JCheckpoint(tmp_path).load("stage1")):
            np.testing.assert_array_equal(out["R_opt"], R)
            assert out["note"] == "hello"
            assert out["count"] == 3
            assert len(out["clouds"]) == 3
            np.testing.assert_array_equal(out["clouds"][2], clouds[2])

    def test_missing(self, tmp_path):
        assert not StageCheckpoint(tmp_path).has("nope")
        assert not JCheckpoint(tmp_path).has("nope")


# --------------------------------------------------------------- viz ----

class TestVizExports:
    def test_trajectory_cloud(self, tmp_path):
        rng = np.random.default_rng(0)
        clouds = [rng.uniform(-2, 2, (500, 3)).astype(np.float32)
                  for _ in range(3)]
        R = np.tile(np.eye(3), (3, 1, 1))
        p = np.array([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0]])
        n = viz.export_trajectory_cloud(tmp_path / "p", clouds, R, p)
        assert n == jviz.export_trajectory_cloud(tmp_path / "j", clouds, R, p)
        assert n > 0
        cloud = read_pcd(tmp_path / "p" / "map_cloud.pcd",
                         fields=("x", "y", "z"))
        assert cloud.shape[0] == n
        path = read_pcd(tmp_path / "p" / "map_path.pcd",
                        fields=("x", "y", "z"))
        assert path.shape[0] == 3
        np.testing.assert_allclose(path[0], 0, atol=1e-6)
        from scipy.spatial.transform import Rotation

        R2 = Rotation.random(3, random_state=1).as_matrix()
        viz.export_trajectory_cloud(tmp_path / "p", clouds, R2, p,
                                    leaf=0.2, prefix="b")
        jviz.export_trajectory_cloud(tmp_path / "j", clouds, R2, p,
                                     leaf=0.2, prefix="b")
        viz.export_track_compare(tmp_path / "p", np.zeros((5, 3)),
                                 np.ones((5, 3)))
        jviz.export_track_compare(tmp_path / "j", np.zeros((5, 3)),
                                  np.ones((5, 3)))
        assert (tmp_path / "p" / "tracks_before.pcd").exists()
        _same_dirs(tmp_path / "p", tmp_path / "j")


class TestViewerHook:
    def test_no_pcds_returns_false(self, tmp_path):
        assert viz.launch_viewer(tmp_path) is False
        assert jviz.launch_viewer(tmp_path) is False

    def test_without_open3d_hints_and_returns_false(self, tmp_path, capsys):
        write_pcd(tmp_path / "cloud.pcd", np.zeros((4, 3), np.float32))
        try:
            import open3d  # noqa: F401
            pytest.skip("open3d installed; interactive path needs a display")
        except ImportError:
            pass
        assert viz.launch_viewer(tmp_path, block=False) is False
        hint = capsys.readouterr().out
        assert jviz.launch_viewer(tmp_path, block=False) is False
        assert "open3d not installed" in hint
        assert hint == capsys.readouterr().out

    def test_cli_view_exit_code(self, tmp_path):
        assert main(["view", "--out", str(tmp_path)]) == 1
        assert jmain(["view", "--out", str(tmp_path)]) == 1
