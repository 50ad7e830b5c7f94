"""The port's LvbaSystem and CLI against the JAX package's on one disk
dataset (tests/test_system.py's: 12 frames of 15,000 points, seed 13, a
COLMAP db), on the CPU in float64 (solver.dtype, and both packages'
fuse_tracks patched to float64; the JAX package's native library off, as
in tests/test_torch_visual_pipeline.py): poses, points and mean
reprojections within 1e-8, the same export file set, resume and failure
injection bitwise against the port's uninterrupted run, a checkpoint of
the JAX system resumed by the port, and the run / info / view
commands."""

import dataclasses
import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from global_lvba_tpu.__main__ import main as jmain
from global_lvba_tpu.config import LvbaConfig as JConfig
from global_lvba_tpu.native import runtime as jnative
from global_lvba_tpu.pipeline import system as jsystem, visual_ba as jvba
from global_lvba_tpu.tracks import fuse as jfuse
from global_lvba_tpu_torch.__main__ import main
from global_lvba_tpu_torch.config import LvbaConfig
from global_lvba_tpu_torch.frontend.colmap_db import write_colmap_db
from global_lvba_tpu_torch.io.dataset import load_dataset
from global_lvba_tpu_torch.io.pcd import write_pcd
from global_lvba_tpu_torch.io.tum import write_tum_poses
from global_lvba_tpu_torch.models.synthetic import (
    ate_rmse, make_joint_scene, perturb_poses)
from global_lvba_tpu_torch.pipeline import outputs, visual_ba
from global_lvba_tpu_torch.pipeline.system import LvbaSystem
from global_lvba_tpu_torch.tracks import fuse

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (the suite's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _float64_fusion():
    """Track fusion in float64 in both packages, the JAX package's native
    library off and its compile cache unused."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "get_lib", lambda: None)
        mp.setattr(jvba, "fuse_tracks", functools.partial(
            jfuse.fuse_tracks, dtype=jnp.float64))
        mp.setattr(visual_ba, "fuse_tracks", functools.partial(
            fuse.fuse_tracks, dtype=torch.float64))
        mp.setenv("LVBA_COMPILE_CACHE", "0")
        yield


def _settings(root, js):
    """tests/test_system.py's configuration, in float64, the COLMAP
    export on at 0.05 m."""
    cam = js.cam
    return {
        "data_config": dict(data_path=str(root), colmap_db_path="match.db",
                            image_sample_step=1),
        "cam_model": dict(cam_width=cam.width, cam_height=cam.height,
                          scale=1.0, cam_fx=cam.fx, cam_fy=cam.fy,
                          cam_cx=cam.cx, cam_cy=cam.cy, cam_d0=cam.k1,
                          cam_d1=cam.k2, cam_d2=cam.p1, cam_d3=cam.p2),
        "extrin_calib": dict(Rcl=[float(v) for v in js.Rci.reshape(-1)],
                             Pcl=[float(v) for v in js.tci]),
        "window_ba": dict(size=6, anchor_leaf_size=0.02,
                          use_window_ba_rel=True),
        "BALM_stage1": dict(root_voxel_size=1.0, eigen_ratio_array=[0.2] * 4),
        "BALM_stage2": dict(root_voxel_size=0.5,
                            eigen_ratio_array=[0.08] * 4),
        "solver": dict(dtype="float64"),
        "colmap_output": dict(enable=True, filter_size_points3D=0.05),
    }


def _config(cls, settings):
    cfg = cls()
    for group, vals in settings.items():
        for k, v in vals.items():
            setattr(getattr(cfg, group), k, v)
    return cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_system.py's reference-layout dataset, written once with
    the port's writers; its YAML config beside it."""
    root = tmp_path_factory.mktemp("system_dataset")
    js = make_joint_scene(num_frames=12, points_per_frame=15000, seed=13,
                          px_noise=0.3)
    sc = js.lidar
    R_odom, p_odom = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.008,
                                   seed=21)
    img_dir, pcd_dir = root / "all_image", root / "all_pcd_body"
    img_dir.mkdir()
    pcd_dir.mkdir()
    names = []
    for t in js.image_times:
        names.append(f"{t:.6f}.png")
        cv2.imwrite(str(img_dir / names[-1]), np.zeros((4, 4, 3), np.uint8))
    write_tum_poses(img_dir / "image_poses.txt", js.image_times,
                    R_odom[js.image_frame], p_odom[js.image_frame])
    for i, t in enumerate(sc.times):
        write_pcd(pcd_dir / f"{t:.6f}.pcd", sc.points_body[sc.frame_ids == i])
    write_tum_poses(pcd_dir / "lidar_poses.txt", sc.times, R_odom, p_odom)
    kps4 = [np.concatenate([k, np.ones((k.shape[0], 2), np.float32)], axis=1)
            for k in js.keypoints]
    write_colmap_db(root / "match.db", names, kps4, js.matches)
    settings = _settings(root, js)
    (root / "cfg.yaml").write_text(yaml.safe_dump(settings))
    # camera-sized imagery with spatial color structure (the export tree)
    H, W = js.cam.height, js.cam.width
    rng = np.random.default_rng(5)
    images = []
    for _ in js.image_times:
        img = np.zeros((H, W, 3), np.uint8)
        img[..., 0] = np.linspace(0, 255, W, dtype=np.uint8)[None, :]
        img[..., 1] = np.linspace(0, 255, H, dtype=np.uint8)[:, None]
        img[..., 2] = rng.integers(0, 255)
        images.append(img)
    return dict(root=root, settings=settings, js=js, sc=sc,
                odom=(R_odom, p_odom), images=images)


def _port(data, **kw):
    return LvbaSystem(_config(LvbaConfig, data["settings"]), device="cpu",
                      **kw)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """One uninterrupted run of each system, with the images."""
    out = tmp_path_factory.mktemp("system_runs")
    jsys = jsystem.LvbaSystem(_config(JConfig, data["settings"]),
                              out_dir=out / "jax", resume=True)
    jres = jsys.run_full_pipeline(images=data["images"])
    psys = _port(data, out_dir=out / "port", resume=True)
    pres = psys.run_full_pipeline(images=data["images"])
    return dict(jax=(jsys, jres), port=(psys, pres), out=out)


def _close(a, b, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol, err_msg=what)


def test_system_matches_jax(runs):
    (jsys, jres), (psys, pres) = runs["jax"], runs["port"]
    _close(psys.R_opt, jsys.R_opt, what="R_opt")
    _close(psys.p_opt, jsys.p_opt, what="p_opt")
    for f in ("Rcw", "tcw", "points", "points_pre", "Rcw_pre", "tcw_pre"):
        _close(getattr(psys.visual_result, f),
               getattr(jsys.visual_result, f), what=f)
    for k in ("mean_reproj_pre", "mean_reproj_post"):
        assert abs(pres[k] - jres[k]) < TOL, k
    for a, b in zip(psys.visual_result.track_obs,
                    jsys.visual_result.track_obs):
        assert np.array_equal(a, np.asarray(b))
    assert sorted(pres["metrics"]) == sorted(jres["metrics"])
    assert pres["metrics"]["lidar_ba/windows"] == \
        jres["metrics"]["lidar_ba/windows"]


def _tree(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_export_tree_matches_jax(runs):
    out = runs["out"]
    assert _tree(out / "port") == _tree(out / "jax")
    for name in ("images.txt", "points3D.txt"):
        a = (out / "port" / "Colmap" / "sparse" / name).read_text() \
            .splitlines()
        b = (out / "jax" / "Colmap" / "sparse" / name).read_text() \
            .splitlines()
        assert len(a) == len(b) > 0
        for la, lb in zip(a, b):
            ta, tb = la.split(), lb.split()
            assert len(ta) == len(tb)
            for u, v in zip(ta, tb):
                try:
                    assert abs(float(u) - float(v)) <= 1e-6, (la, lb)
                except ValueError:
                    assert u == v
    # the depth PNGs: the port's (zlib) and the JAX package's (cv2) files
    # decode to the same pixels
    for p in sorted((out / "port" / "depth").glob("*.png")):
        a = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(out / "jax" / "depth" / p.name),
                       cv2.IMREAD_UNCHANGED)
        assert a.dtype == np.uint16 and np.array_equal(a, b)


class TestFullPipeline:
    def test_run_and_resume(self, data, runs, tmp_path):
        psys, result = runs["port"]
        assert result["mean_reproj_post"] < result["mean_reproj_pre"]
        assert result["mean_reproj_post"] < 1.5
        R_odom, p_odom = data["odom"]
        p_true = data["sc"].p_true
        assert ate_rmse(psys.p_opt, p_true) < ate_rmse(p_odom, p_true)
        # resume path: a second run (in a copy of the run's tree) loads
        # both checkpoints
        shutil.copytree(runs["out"] / "port", tmp_path / "out")
        sys2 = _port(data, out_dir=tmp_path / "out", resume=True)
        result2 = sys2.run_full_pipeline()
        np.testing.assert_array_equal(sys2.p_opt, psys.p_opt)
        assert result2["mean_reproj_post"] == result["mean_reproj_post"]
        assert sys2.visual_result.stats == {"resumed": True}

    def test_output_tree_matches_reference_layout(self, data, runs):
        """The reference's file set (lvba_system.cpp:1945-2137):
        Colmap/sparse/{images.txt, points3D.txt}, Colmap/images/<k>.jpg,
        Colmap/colored_merged_{before,after}.pcd, depth/<ts>.png, with
        points3D.txt from the downsampled colored merged cloud."""
        out = runs["out"] / "port"
        M = len(data["js"].image_times)
        assert (out / "Colmap" / "sparse" / "images.txt").exists()
        assert (out / "Colmap" / "sparse" / "points3D.txt").exists()
        assert (out / "Colmap" / "colored_merged_after.pcd").exists()
        assert (out / "Colmap" / "colored_merged_before.pcd").exists()
        for k in range(M):
            assert (out / "Colmap" / "images" / f"{k}.jpg").exists()
        depth_files = sorted((out / "depth").glob("*.png"))
        assert [p.name for p in depth_files] == \
            [f"{t:.6f}.png" for t in data["js"].image_times]
        d0 = outputs.load_depth_png(depth_files[0])
        assert d0.shape == (data["js"].cam.height, data["js"].cam.width)
        assert d0.max() > 0
        assert len(list((out / "reproj").glob("*.png"))) > 0
        assert len(list((out / "track_features").glob("*.png"))) == M
        assert (out / "viz" / "tracks_before.pcd").exists()
        assert (out / "viz" / "tracks_after.pcd").exists()
        assert json.loads((out / "metrics.json").read_text())
        lines = (out / "Colmap" / "sparse" / "points3D.txt").read_text() \
            .strip().splitlines()
        hdr = (out / "Colmap" / "colored_merged_after.pcd").read_bytes()[:200]
        n_pcd = int([ln for ln in hdr.decode("ascii", "ignore").splitlines()
                     if ln.startswith("POINTS")][0].split()[1])
        assert len(lines) == n_pcd > 0
        assert len(lines[0].split()) == 8
        rgb = np.array([ln.split()[4:7] for ln in lines], dtype=int)
        assert rgb.min() >= 0 and rgb.max() <= 255 and rgb.max() > 0
        ilines = (out / "Colmap" / "sparse" / "images.txt").read_text() \
            .strip().splitlines()
        assert len(ilines) == 2 * M


class TestFailureInjection:
    """A run killed mid-way and resumed reproduces the uninterrupted run
    exactly: (1) death right after the lidar_ba checkpoint lands, (2) a
    kill mid-write of the next checkpoint (only a stale .tmp.npz exists;
    it must be ignored), (3) death after the visual checkpoint, before
    the exports."""

    def test_crash_resume_matches_uninterrupted(self, data, runs,
                                                tmp_path):
        sysA, resA = runs["port"]
        outB = tmp_path / "outB"
        sysB = _port(data, out_dir=outB, resume=True)
        sysB.run_lidar_ba()
        del sysB
        (outB / "checkpoints" / "visual_ba.tmp.npz").write_bytes(
            b"PK\x03\x04 truncated by SIGKILL")
        sysB2 = _port(data, out_dir=outB, resume=True)
        resB = sysB2.run_full_pipeline(images=data["images"])
        np.testing.assert_array_equal(sysB2.p_opt, sysA.p_opt)
        np.testing.assert_array_equal(sysB2.R_opt, sysA.R_opt)
        for f in ("points", "tcw", "Rcw"):
            np.testing.assert_array_equal(getattr(sysB2.visual_result, f),
                                          getattr(sysA.visual_result, f))
        assert resB["mean_reproj_post"] == resA["mean_reproj_post"]
        assert (outB / "checkpoints" / "visual_ba.npz").exists()
        assert not (outB / "checkpoints" / "visual_ba.tmp.npz").exists()
        for name in ("lidar_ba.npz", "visual_ba.npz"):
            a = np.load(outB / "checkpoints" / name)
            b = np.load(runs["out"] / "port" / "checkpoints" / name)
            assert a.files == b.files
            assert all(np.array_equal(a[k], b[k]) for k in a.files)
        sysB3 = _port(data, out_dir=outB, resume=True)
        resB3 = sysB3.run_full_pipeline()
        assert resB3["mean_reproj_post"] == resA["mean_reproj_post"]
        np.testing.assert_array_equal(sysB3.visual_result.points,
                                      sysA.visual_result.points)


def test_port_resumes_from_jax_checkpoint(data, runs, tmp_path):
    """The JAX system's lidar_ba.npz, loaded unchanged by the port: its
    visual stage lands within 1e-8 of the port's own full run."""
    ck = tmp_path / "out" / "checkpoints"
    ck.mkdir(parents=True)
    shutil.copy(runs["out"] / "jax" / "checkpoints" / "lidar_ba.npz", ck)
    psys = _port(data, out_dir=tmp_path / "out", resume=True)
    res = psys.run_full_pipeline()
    ref, ref_res = runs["port"]
    _close(psys.p_opt, ref.p_opt, what="p_opt")
    for f in ("Rcw", "tcw", "points"):
        _close(getattr(psys.visual_result, f),
               getattr(ref.visual_result, f), what=f)
    for k in ("mean_reproj_pre", "mean_reproj_post"):
        assert abs(res[k] - ref_res[k]) < TOL


class TestCli:
    def test_info_prints_jax_json(self, capsys):
        cfg = str(ROOT / "configs" / "example.yaml")
        assert main(["info", "--config", cfg]) == 0
        got = capsys.readouterr().out
        assert jmain(["info", "--config", cfg]) == 0
        assert got == capsys.readouterr().out
        assert json.loads(got) == dataclasses.asdict(
            LvbaConfig.from_yaml(cfg))

    def test_run_on_cpu_prints_jax_values(self, data, tmp_path, capsys):
        cfg = str(data["root"] / "cfg.yaml")
        assert main(["run", "--config", cfg, "--out", str(tmp_path / "p"),
                     "--device", "cpu", "--no-resume"]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert jmain(["run", "--config", cfg, "--out",
                      str(tmp_path / "j"), "--no-resume"]) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert sorted(got) == sorted(want) == ["mean_reproj_post",
                                                "mean_reproj_pre"]
        assert all(abs(got[k] - want[k]) < TOL for k in got)
        assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
        # --data overrides the config's dataset root; the checkpoints resume
        assert main(["run", "--config", cfg, "--data", str(data["root"]),
                     "--out", str(tmp_path / "p"), "--device", "cpu"]) == 0
        again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert again == got

    def test_view_exits_1_without_open3d(self, runs):
        out = str(runs["out"] / "port")
        assert main(["view", "--out", out]) == 1
        assert jmain(["view", "--out", out]) == 1


def test_run_without_device_needs_a_card(data):
    """`run` defaults to the card: with no CUDA device it raises, naming
    device='cpu', before it reads the dataset."""
    proc = subprocess.run(
        [sys.executable, "-m", "global_lvba_tpu_torch", "run", "--config",
         str(data["root"] / "cfg.yaml"), "--out", str(data["root"] / "x")],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert not (data["root"] / "x").exists()


def test_load_dataset_matches_written_scene(data):
    ds = load_dataset(_config(LvbaConfig, data["settings"]))
    js, sc = data["js"], data["sc"]
    assert len(ds.image_paths) == len(js.image_times)
    assert len(ds.clouds) == len(sc.times)
    np.testing.assert_allclose(ds.lidar_times, sc.times, atol=1e-6)
    np.testing.assert_allclose(ds.Rci, js.Rci, atol=1e-9)
    assert ds.colmap_db_path == data["root"] / "match.db"
