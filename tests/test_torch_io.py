"""The port's IO and utility modules against the JAX package on the CPU:
PCD reading (ascii, binary, binary_compressed through the pure-Python LZF
decoder) and writing, TUM poses, load_dataset, the COLMAP db, stage
checkpoints (each package loads the other's), the run metrics, the
robust-statistics utilities and the host downsamplers.  The JAX package's
native library is switched off where it would take over (its LZF)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from global_lvba_tpu.config import LvbaConfig as JConfig
from global_lvba_tpu.frontend import colmap_db as jdb
from global_lvba_tpu.io import dataset as jds, pcd as jpcd, tum as jtum
from global_lvba_tpu.native import runtime as jnative
from global_lvba_tpu.pipeline import downsample as jdown
from global_lvba_tpu.utils import checkpoint as jck, metrics as jmet
from global_lvba_tpu.utils import robust as jrob
from global_lvba_tpu_torch import utils
from global_lvba_tpu_torch.config import LvbaConfig
from global_lvba_tpu_torch.frontend import colmap_db
from global_lvba_tpu_torch.io import dataset, pcd, tum
from global_lvba_tpu_torch.pipeline import downsample
from global_lvba_tpu_torch.utils import checkpoint, metrics, profiling, robust


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (the suite's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_jax_native(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


# ---------------------------------------------------------------- PCD ----

def _lzf_compress(data: bytes) -> bytes:
    """A brute-force LZF encoder: the longest earlier match of at least 3
    bytes within 8,192 back (at most 264 long) becomes a back reference,
    anything else a literal run of at most 32 bytes."""
    out = bytearray()
    lit = bytearray()

    def flush():
        while lit:
            run = lit[:32]
            out.append(len(run) - 1)
            out.extend(run)
            del lit[:32]

    i, n = 0, len(data)
    while i < n:
        best, best_off = 0, 0
        for j in range(max(0, i - 8192), i):
            k = 0
            while i + k < n and k < 264 and data[j + k] == data[i + k]:
                k += 1
            if k > best:
                best, best_off = k, i - j - 1
        if best >= 3:
            flush()
            ln = best - 2
            if ln < 7:
                out.append((ln << 5) | (best_off >> 8))
            else:
                out.append((7 << 5) | (best_off >> 8))
                out.append(ln - 7)
            out.append(best_off & 0xFF)
            i += best
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def _records(n=40, seed=0):
    """x, y (random), z (constant: long matches), intensity (a short
    repeating pattern), ring (uint16), t (float64)."""
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("intensity", "<f4"), ("ring", "<u2"),
                             ("t", "<f8")])
    rec["x"] = rng.normal(size=n)
    rec["y"] = rng.normal(size=n)
    rec["z"] = 1.5
    rec["intensity"] = np.tile([3.0, 7.0, 9.0, 7.0], n // 4 + 1)[:n]
    rec["ring"] = np.arange(n) % 5
    rec["t"] = rng.uniform(0, 1, n)
    return rec


_HEADER = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z intensity ring t\n"
           "SIZE 4 4 4 4 2 8\nTYPE F F F F U F\nCOUNT 1 1 1 1 1 1\n"
           "WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
           "DATA {mode}\n")


def _write_pcd_file(path, mode, rec):
    n = rec.shape[0]
    head = _HEADER.format(n=n, mode=mode).encode("ascii")
    if mode == "ascii":
        body = "".join(" ".join(repr(v) for v in row) + "\n"
                       for row in rec.tolist()).encode("ascii")
    elif mode == "binary":
        body = rec.tobytes()
    else:
        payload = b"".join(np.ascontiguousarray(rec[nm]).tobytes()
                           for nm in rec.dtype.names)
        comp = _lzf_compress(payload)
        body = np.array([len(comp), len(payload)], "<u4").tobytes() + comp
    Path(path).write_bytes(head + body)


def test_lzf_stream_holds_literals_and_both_reference_forms():
    rec = _records()
    payload = b"".join(np.ascontiguousarray(rec[nm]).tobytes()
                       for nm in rec.dtype.names)
    comp = _lzf_compress(payload)
    i, kinds = 0, set()
    while i < len(comp):
        ctrl = comp[i]
        if ctrl < 32:
            kinds.add("literal")
            i += ctrl + 2
        elif ctrl >> 5 == 7:
            kinds.add("long reference")
            i += 3
        else:
            kinds.add("short reference")
            i += 2
    assert kinds == {"literal", "long reference", "short reference"}
    got = pcd._lzf_decompress(comp, len(payload))
    assert got == payload
    assert got == jpcd._lzf_decompress(comp, len(payload))


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
@pytest.mark.parametrize("fields", [("x", "y", "z", "intensity"),
                                    ("x", "y", "z"), ("t", "ring", "none")])
def test_read_pcd_matches_jax(tmp_path, mode, fields):
    rec = _records()
    path = tmp_path / f"c_{mode}.pcd"
    _write_pcd_file(path, mode, rec)
    got = pcd.read_pcd(path, fields=fields)
    want = jpcd.read_pcd(path, fields=fields)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], rec[fields[0]].astype(np.float32))


def test_write_pcd_byte_equal(tmp_path):
    pts = np.random.default_rng(1).normal(size=(57, 4))
    for fields in (("x", "y", "z"), ("x", "y", "z", "intensity")):
        pcd.write_pcd(tmp_path / "a.pcd", pts, fields=fields)
        jpcd.write_pcd(tmp_path / "b.pcd", pts, fields=fields)
        assert (tmp_path / "a.pcd").read_bytes() == \
            (tmp_path / "b.pcd").read_bytes()
        np.testing.assert_array_equal(
            pcd.read_pcd(tmp_path / "a.pcd", fields=fields),
            pts[:, :len(fields)].astype(np.float32))


# ---------------------------------------------------------------- TUM ----

def test_tum_write_byte_equal_and_read_matches_jax(tmp_path):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(2)
    R = Rotation.random(9, random_state=3).as_matrix()
    p = rng.normal(size=(9, 3))
    t = np.cumsum(rng.uniform(0.05, 0.15, 9)) + 1.6e9
    tum.write_tum_poses(tmp_path / "a.txt", t, R, p)
    jtum.write_tum_poses(tmp_path / "b.txt", t, R, p)
    text = (tmp_path / "a.txt").read_text()
    assert text == (tmp_path / "b.txt").read_text()
    # comments, blank and short lines are skipped; a bad number drops a line
    (tmp_path / "c.txt").write_text(
        "# t x y z qx qy qz qw\n\n1 2 3\n1 a 0 0 0 0 0 1\n" + text)
    for stride in (1, 2, 4):
        got = tum.read_tum_poses(tmp_path / "c.txt", stride=stride)
        want = jtum.read_tum_poses(tmp_path / "c.txt", stride=stride)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[1], R[::4], atol=1e-8)
    with pytest.raises(ValueError, match="stride"):
        tum.read_tum_poses(tmp_path / "c.txt", stride=0)
    (tmp_path / "d.txt").write_text("# nothing\n")
    with pytest.raises(ValueError, match="no poses"):
        tum.read_tum_poses(tmp_path / "d.txt")


# ------------------------------------------------------------ dataset ----

def _configs(root, step=2):
    cfgs = JConfig(), LvbaConfig()
    for c in cfgs:
        c.data_config.data_path = str(root)
        c.data_config.image_sample_step = step
        c.data_config.colmap_db_path = "match.db"
        c.cam_model.cam_width, c.cam_model.cam_height = 320, 256
        c.cam_model.scale = 0.5
        c.extrin_calib.extrinsic_T = [0.04, 0.02, -0.03]
        c.extrin_calib.extrinsic_R = [0.0, -1.0, 0.0, 1.0, 0.0, 0.0,
                                      0.0, 0.0, 1.0]
        c.extrin_calib.Pcl = [0.02, 0.1, -0.025]
    return cfgs


@pytest.fixture(scope="module")
def disk_dataset(tmp_path_factory):
    """7 images with 8 poses (stride 2 keeps 4 of each; stride 1 leaves
    the counts unequal), 6 PCDs with 5 LiDAR poses (the loader keeps 5),
    stray files the loader must skip."""
    from scipy.spatial.transform import Rotation

    root = tmp_path_factory.mktemp("io_dataset")
    img, lid = root / "all_image", root / "all_pcd_body"
    img.mkdir()
    lid.mkdir()
    rng = np.random.default_rng(4)
    t_img = 100.0 + 0.1 * np.arange(7)
    for t in t_img[::-1]:
        (img / f"{t:.6f}.png").write_bytes(b"")
    (img / "notes.txt").write_text("x")
    (img / "frame.jpg").write_bytes(b"")      # no timestamp: skipped
    R = Rotation.random(8, random_state=5).as_matrix()
    tum.write_tum_poses(img / "image_poses.txt", 100.0 + 0.1 * np.arange(8),
                        R, rng.normal(size=(8, 3)))
    t_lid = 100.0 + 0.05 * np.arange(6)
    for i, t in enumerate(t_lid):
        pcd.write_pcd(lid / f"{t:.6f}.pcd", rng.normal(size=(20 + i, 3)))
    tum.write_tum_poses(lid / "lidar_poses.txt", t_lid[:5], R[:5],
                        rng.normal(size=(5, 3)))
    return root


def test_load_dataset_matches_jax(disk_dataset):
    jcfg, tcfg = _configs(disk_dataset)
    want = jds.load_dataset(jcfg)
    got = dataset.load_dataset(tcfg)
    assert len(got.image_paths) == 4 and len(got.clouds) == 5
    for f in ("root", "image_paths", "colmap_db_path"):
        assert getattr(got, f) == getattr(want, f), f
    assert tuple(got.cam) == tuple(want.cam)
    for f in ("image_times", "cam_R", "cam_p", "lidar_times", "lidar_R",
              "lidar_p", "Rcl", "tcl", "Rci", "tci"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert all(np.array_equal(a, b) for a, b in zip(got.clouds, want.clouds))
    lazy = dataset.load_dataset(tcfg, root=disk_dataset, load_clouds=False)
    assert lazy.clouds == [] and np.array_equal(lazy.lidar_R, got.lidar_R)


def test_load_dataset_pose_count_check(disk_dataset):
    jcfg, tcfg = _configs(disk_dataset, step=1)
    for load, cfg in ((jds.load_dataset, jcfg), (dataset.load_dataset, tcfg)):
        with pytest.raises(ValueError, match="camera pose count"):
            load(cfg)
    assert dataset.parse_timestamp("img_12.5.png") == \
        jds.parse_timestamp("img_12.5.png") == 12.5
    assert dataset.parse_timestamp("none.png") is None


# ---------------------------------------------------------- COLMAP db ----

def _features(seed=6, M=4):
    rng = np.random.default_rng(seed)
    names = [f"{i}.png" for i in range(M)]
    kps = [rng.uniform(0, 100, (10 + 3 * i, 6)).astype(np.float32)
           for i in range(M)]
    matches = {}
    for i in range(M):
        for j in range(i + 1, M):
            m = np.stack([rng.permutation(kps[i].shape[0])[:5],
                          rng.permutation(kps[j].shape[0])[:5]], -1)
            matches[(i, j)] = m.astype(np.int32)
    return names, kps, matches


def test_colmap_db_roundtrip_matches_jax(tmp_path):
    names, kps, matches = _features()
    colmap_db.write_colmap_db(tmp_path / "a.db", names, kps, matches)
    jdb.write_colmap_db(tmp_path / "b.db", names, kps, matches)
    # the query order reversed: the swap correction
    order = names[::-1]
    for path in (tmp_path / "a.db", tmp_path / "b.db"):
        for q in (names, order):
            got = colmap_db.load_colmap_db(path, q)
            want = jdb.load_colmap_db(path, q)
            assert len(got[0]) == len(q)
            for a, b in zip(got[0], want[0]):
                assert np.array_equal(a, b)
            assert got[1].keys() == want[1].keys()
            for k in got[1]:
                assert np.array_equal(got[1][k], want[1][k])
    kp, mt = colmap_db.load_colmap_db(tmp_path / "a.db", names)
    np.testing.assert_array_equal(kp[2], kps[2][:, :4])
    for k, m in matches.items():
        np.testing.assert_array_equal(mt[k], m)
    kp_r, mt_r = colmap_db.load_colmap_db(tmp_path / "a.db", order)
    np.testing.assert_array_equal(mt_r[(0, 3)], matches[(0, 3)][:, ::-1])


def test_colmap_db_unusable_returns_none(tmp_path):
    names, kps, matches = _features()
    colmap_db.write_colmap_db(tmp_path / "a.db", names, kps, matches)
    assert colmap_db.load_colmap_db(tmp_path / "a.db", names[:-1]) is None
    assert jdb.load_colmap_db(tmp_path / "a.db", names[:-1]) is None
    assert colmap_db.load_colmap_db(tmp_path / "missing.db", names) is None
    (tmp_path / "bad.db").write_bytes(b"not a database" * 100)
    assert colmap_db.load_colmap_db(tmp_path / "bad.db", names) is None
    assert jdb.load_colmap_db(tmp_path / "bad.db", names) is None


# -------------------------------------------------------- checkpoints ----

def _stage_arrays(seed=7):
    rng = np.random.default_rng(seed)
    return dict(R_opt=rng.normal(size=(4, 3, 3)), note="hello", count=3,
                ratio=0.25, flag=True,
                clouds=[rng.normal(size=(10 + i, 3)) for i in range(3)],
                ids=np.arange(5, dtype=np.int32))


def _same_stage(out, arrays):
    assert set(out) == set(arrays)
    for k, v in arrays.items():
        if isinstance(v, list):
            assert len(out[k]) == len(v)
            assert all(np.array_equal(a, b) and a.dtype == b.dtype
                       for a, b in zip(out[k], v))
        elif isinstance(v, np.ndarray):
            assert np.array_equal(out[k], v) and out[k].dtype == v.dtype
        else:
            assert out[k] == v and type(out[k]) is type(v)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    """A checkpoint written by either package loads unchanged in both."""
    arrays = _stage_arrays()
    W = (checkpoint.StageCheckpoint if writer == "port"
         else jck.StageCheckpoint)(tmp_path)
    W.save("stage1", **arrays)
    for cls in (checkpoint.StageCheckpoint, jck.StageCheckpoint):
        ck = cls(tmp_path)
        assert ck.has("stage1") and not ck.has("stage2")
        _same_stage(ck.load("stage1"), arrays)


def test_checkpoint_atomic_publish_ignores_stale_tmp(tmp_path):
    ck = checkpoint.StageCheckpoint(tmp_path)
    (ck.dir / "stage1.tmp.npz").write_bytes(b"PK\x03\x04 truncated")
    assert not ck.has("stage1")
    ck.save("stage1", x=np.ones(3))
    assert ck.has("stage1") and not (ck.dir / "stage1.tmp.npz").exists()
    assert sorted(p.name for p in ck.dir.iterdir()) == ["stage1.npz"]
    off = checkpoint.StageCheckpoint(tmp_path / "off", enable=False)
    off.save("stage1", x=np.ones(3))
    assert not off.has("stage1") and not (tmp_path / "off").exists()


# ------------------------------------------------------------ metrics ----

def test_metrics_registry_dump_matches_jax(tmp_path):
    regs = metrics.MetricsRegistry(), jmet.MetricsRegistry()
    for r in regs:
        r.set("a", 1)
        r.add("t", 0.5)
        r.add("t", 0.25)
        r.set("x", np.float32(2.5))
    s = regs[0].dump(tmp_path / "m.json")
    assert s == regs[1].dump()
    assert json.loads((tmp_path / "m.json").read_text()) == {
        "a": 1, "t": 0.75, "x": 2.5}


def test_stage_timer_and_host_memory():
    reg = metrics.MetricsRegistry()
    timer = metrics.StageTimer(reg, device="cpu")
    for _ in range(2):
        with timer.stage("s"):
            pass
    with pytest.raises(RuntimeError):
        with timer.stage("boom"):
            raise RuntimeError("x")
    jreg = jmet.MetricsRegistry()
    jtimer = jmet.StageTimer(jreg)
    for _ in range(2):
        with jtimer.stage("s"):
            pass
    assert sorted(reg.values) == ["mem/boom_rss_mb", "mem/s_rss_mb",
                                  "time/boom_s", "time/s_s"]
    assert set(jreg.values) <= set(reg.values)
    assert reg.values["time/s_s"] >= 0 and reg.values["mem/s_rss_mb"] > 0
    assert metrics.hbm_stats("cpu") == {} == jmet.hbm_stats()
    assert metrics.rss_mb() > 0


def test_metrics_compute_mad_matches_jax():
    # metrics keeps the JAX metrics copy's np.median MAD (the two middle
    # values averaged on even lengths); robust keeps the reference's
    # nth_element one, which utils exports, as the JAX package's utils
    # does
    assert metrics.compute_mad is not robust.compute_mad
    assert utils.compute_mad is robust.compute_mad
    r = np.random.default_rng(8).normal(size=1001)
    assert metrics.compute_mad(r) == jmet.compute_mad(r) == jrob.compute_mad(r)
    assert metrics.compute_mad(r[:1000]) == jmet.compute_mad(r[:1000])
    assert robust.compute_mad(r[:1000]) == jrob.compute_mad(r[:1000])
    assert metrics.compute_mad(r[:1000]) != robust.compute_mad(r[:1000])
    assert metrics.compute_mad([1.0, 2.0, 4.0, 8.0]) == jmet.compute_mad(
        [1.0, 2.0, 4.0, 8.0])
    assert metrics.compute_mad([]) == jmet.compute_mad([]) == -1.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(tmp_path / "trace", device="cpu"):
        with profiling.span("stage.region"):
            torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "stage.region" for e in trace["traceEvents"])
    assert not profiling.enabled()
    profiling.reset()


# ------------------------------------------------------------- robust ----

def _same(fn, *args, **kw):
    got = getattr(robust, fn)(*args, **kw)
    want = getattr(jrob, fn)(*args, **kw)
    if isinstance(got, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want
    return got


class TestComputeMAD:
    def test_empty_returns_minus_one(self):
        assert _same("compute_mad", []) == -1.0

    def test_matches_definition(self):
        r = np.random.default_rng(0).normal(size=1001)
        med = np.sort(r)[r.size // 2]
        mad = np.sort(np.abs(r - med))[r.size // 2] * 1.4826
        assert _same("compute_mad", r) == pytest.approx(mad)

    def test_normal_consistency(self):
        r = np.random.default_rng(1).normal(scale=2.5, size=200000)
        assert _same("compute_mad", r) == pytest.approx(2.5, rel=0.02)


class TestPickLargestCluster:
    def test_all_within_returns_all(self):
        pts = np.zeros((5, 3)) + np.linspace(0, 0.05, 5)[:, None]
        out = _same("pick_largest_cluster_as_inliers", pts, [0, 1, 2, 3, 4])
        assert sorted(out.tolist()) == [0, 1, 2, 3, 4]

    def test_single_candidate(self):
        out = _same("pick_largest_cluster_as_inliers", np.zeros((3, 3)), [2])
        assert out.tolist() == [2]

    def test_bigger_cluster_wins(self):
        pts = np.concatenate([
            np.random.default_rng(2).normal(scale=0.01, size=(8, 3)),
            np.array([[5.0, 5.0, 5.0], [5.01, 5.0, 5.0]]),
        ])
        out = _same("pick_largest_cluster_as_inliers", pts, list(range(10)))
        assert sorted(out.tolist()) == list(range(8))

    def test_smaller_cluster_when_bigger_inconsistent(self):
        rng = np.random.default_rng(3)
        big = rng.uniform(-1, 1, size=(7, 3)) * 2.0
        small = np.array([[10.0, 0, 0], [10.02, 0, 0]])
        out = _same("pick_largest_cluster_as_inliers",
                    np.concatenate([big, small]), list(range(9)))
        assert sorted(out.tolist()) == [7, 8]

    def test_no_cluster_consistent_returns_empty(self):
        pts = np.array([[0.0, 0, 0], [0.5, 0, 0], [10.0, 0, 0],
                        [10.5, 0, 0]])
        out = _same("pick_largest_cluster_as_inliers", pts, list(range(4)))
        assert out.size == 0


class TestPreprocessLowTexture:
    def test_shape_and_upsample(self):
        pytest.importorskip("cv2")
        rng = np.random.default_rng(4)
        img = rng.uniform(100, 140, size=(64, 48, 3)).astype(np.uint8)
        out = _same("preprocess_low_texture_bgr", img)
        assert out.shape == img.shape and out.dtype == np.uint8
        out2 = _same("preprocess_low_texture_bgr", img,
                     enable_x2_upsample=True)
        assert out2.shape == (128, 96, 3)

    def test_contrast_increases_on_low_contrast_input(self):
        pytest.importorskip("cv2")
        rng = np.random.default_rng(5)
        img = (120 + 6 * rng.standard_normal((64, 64, 3))).clip(0, 255)
        img = img.astype(np.uint8)
        out = _same("preprocess_low_texture_bgr", img)
        assert float(out.std()) > float(img.std())


# --------------------------------------------------------- downsample ----

@pytest.mark.parametrize("voxel", [0.0005, 0.05, 0.3])
def test_downsample_mean_matches_jax(voxel):
    pts = np.random.default_rng(9).uniform(-2, 2, (3000, 3)).astype(
        np.float32)
    got = downsample.downsample_mean(pts, voxel)
    want = jdown.downsample_mean(pts, voxel)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    empty = np.zeros((0, 3), np.float32)
    assert downsample.downsample_mean(empty, voxel).shape == (0, 3)


@pytest.mark.parametrize("num", [-1, 0, 1, 3, 7])
def test_downsample_stride_matches_jax(num):
    pts = np.arange(60.0).reshape(20, 3)
    assert np.array_equal(downsample.downsample_stride(pts, num),
                          jdown.downsample_stride(pts, num))
