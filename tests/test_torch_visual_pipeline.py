"""The visual pipeline of the PyTorch port against the JAX package
(float64 where it computes, CPU): the joint scene and the JAX bench's
visual problems, the grid map, covisibility and host z-buffer, the LiDAR
pose propagation, track fusion, the mean reprojection metric and
run_visual_ba, at tests/test_visual_pipeline.py's size."""

import ast
import functools
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.config import LvbaConfig as JLvbaConfig
from global_lvba_tpu.eval import metrics as jmetrics
from global_lvba_tpu.models import synthetic as jsyn
from global_lvba_tpu.native import runtime as jnative
from global_lvba_tpu.pipeline import depth as jdepth, visual_ba as jvba
from global_lvba_tpu.solver import schur as js
from global_lvba_tpu.tracks import build as jbuild, fuse as jfuse
from global_lvba_tpu_torch.config import LvbaConfig
from global_lvba_tpu_torch.eval.metrics import mean_reprojection_error
from global_lvba_tpu_torch.models import synthetic as syn
from global_lvba_tpu_torch.pipeline import depth, visual_ba
from global_lvba_tpu_torch.tracks import build, fuse

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (the suite's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """tests/test_visual_pipeline.py's scene through both packages, the
    odometry poses perturbed from the truth."""
    kw = dict(num_frames=12, points_per_frame=20000, seed=3, px_noise=0.3)
    jsc, tsc = jsyn.make_joint_scene(**kw), syn.make_joint_scene(**kw)
    sc = jsc.lidar
    R_odom, p_odom = jsyn.perturb_poses(sc.R_true, sc.p_true, 0.004, 0.01,
                                        seed=9)
    clouds = [sc.points_body[sc.frame_ids == i] for i in range(12)]
    return jsc, tsc, clouds, R_odom, p_odom


def test_joint_scene_matches_jax(scene):
    jsc, tsc, _, _, _ = scene
    for a, b in zip((jsc.lidar, jsc), (tsc.lidar, tsc)):
        for f in ("points_body", "frame_ids", "R_true", "p_true", "times",
                  "image_times", "image_frame", "landmarks", "Rci", "tci"):
            if hasattr(a, f):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert tuple(jsc.cam) == tuple(tsc.cam)
    for a, b in zip(jsc.keypoints + jsc.kp_landmark,
                    tsc.keypoints + tsc.kp_landmark):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(jsc.matches) == list(tsc.matches)
    assert all(np.array_equal(jsc.matches[k], tsc.matches[k])
               for k in jsc.matches)


def test_perturb_poses_drift_matches_jax(scene):
    sc = scene[0].lidar
    for a, b in zip(jsyn.perturb_poses_drift(sc.R_true, sc.p_true, 0.0008,
                                             0.002, seed=21),
                    syn.perturb_poses_drift(sc.R_true, sc.p_true, 0.0008,
                                            0.002, seed=21)):
        assert np.array_equal(a, b)


class _Captured(Exception):
    pass


@pytest.mark.parametrize("kind", ["m200", "m1000"])
def test_bench_problems_match_jax(kind, monkeypatch):
    """make_visual_bench_problem against bench.py's bench_visual_<kind>:
    the function's own code (taken from bench.py's source, so importing
    the script runs nothing) up to its first solve, which a spy stops."""
    src = (ROOT / "bench.py").read_text()
    fn = next(n for n in ast.parse(src).body if isinstance(n, ast.FunctionDef)
              and n.name == f"bench_visual_{kind}")
    ns = {"np": np, "time": None}
    exec(compile(ast.Module([fn], []), "bench.py", "exec"), ns)

    def spy(prob, Rp, tp, X, max_iters):
        raise _Captured(prob, Rp, tp, X)

    monkeypatch.setattr(js, "solve_visual_ba", spy)
    with pytest.raises(_Captured) as e:
        ns[f"bench_visual_{kind}"]()
    prob, Rp, tp, X = e.value.args
    got = syn.make_visual_bench_problem(kind)
    assert tuple(prob.cam) == tuple(got.cam)
    for f in ("obs_cam", "obs_pt", "obs_uv", "plane_n", "plane_d"):
        a, b = getattr(prob, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (prob.num_cams, prob.num_pts) == (got.R0.shape[0], got.X0.shape[0])
    for a, b in ((Rp, got.R0), (tp, got.t0), (X, got.X0)):
        assert np.array_equal(a, b)


def test_grid_map_and_depth_match_jax(scene):
    """The grid map and covisible voxel sets equal the JAX package's, and
    the depth maps equal its host z-buffer (_zbuffer_host) bit for bit."""
    jsc, tsc, clouds, R_odom, p_odom = scene
    sc = jsc.lidar
    gj = jdepth.build_grid_map(clouds, sc.R_true, sc.p_true)
    gt = depth.build_grid_map(clouds, sc.R_true, sc.p_true)
    for f in ("keys", "starts", "counts", "points"):
        assert np.array_equal(getattr(gj, f), getattr(gt, f)), f
    assert all(np.array_equal(a, b) for a, b in
               zip(gj.frame_voxel_keys, gt.frame_voxel_keys))
    Rcw, tcw = depth.camera_world_to_cam(jsc.Rci, jsc.tci,
                                         sc.R_true[jsc.image_frame],
                                         sc.p_true[jsc.image_frame])
    Rj, tj = jdepth.camera_world_to_cam(jsc.Rci, jsc.tci,
                                        sc.R_true[jsc.image_frame],
                                        sc.p_true[jsc.image_frame])
    assert np.array_equal(Rcw, Rj) and np.array_equal(tcw, tj)
    maps = depth.render_depth_maps(tsc.cam, gt, sc.times, jsc.image_times,
                                   Rcw, tcw, device="cpu")
    for i, t_img in enumerate(jsc.image_times):
        vj = jdepth.covisible_voxels(gj, sc.times, float(t_img))
        assert np.array_equal(vj, depth.covisible_voxels(gt, sc.times,
                                                         float(t_img)))
        pts = jdepth.gather_voxel_points(gj, vj)
        assert np.array_equal(pts, depth.gather_voxel_points(gt, vj))
        ref = jdepth._zbuffer_host(jsc.cam, Rcw[i], tcw[i], pts)
        assert np.array_equal(maps[i], ref), i
        assert (ref > 0).sum() > 1000
    starts, counts = depth.gather_voxel_ranges(gt, vj)
    assert np.array_equal(starts, jdepth.gather_voxel_ranges(gj, vj)[0])
    assert np.array_equal(counts, jdepth.gather_voxel_ranges(gj, vj)[1])


def test_update_camera_poses_matches_jax(scene):
    jsc, _, _, R_odom, p_odom = scene
    sc = jsc.lidar
    args = (sc.times, sc.R_true, sc.p_true, R_odom, p_odom,
            jsc.image_times + 0.03, R_odom[jsc.image_frame],
            p_odom[jsc.image_frame])
    for a, b in zip(jdepth.update_camera_poses_from_lidar(*args),
                    depth.update_camera_poses_from_lidar(*args)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


def _fuse_inputs(scene):
    jsc, tsc, clouds, R_odom, p_odom = scene
    sc = jsc.lidar
    ts = build.build_components(tsc.keypoints, tsc.matches, obser_thr=3)
    Rcw, tcw = depth.camera_world_to_cam(jsc.Rci, jsc.tci,
                                         R_odom[jsc.image_frame],
                                         p_odom[jsc.image_frame])
    gm = depth.build_grid_map(clouds, sc.R_true, sc.p_true)
    maps = depth.render_depth_maps(tsc.cam, gm, sc.times, jsc.image_times,
                                   Rcw, tcw, device="cpu")
    return jsc, tsc, ts, maps, Rcw, tcw


def test_fuse_tracks_matches_jax(scene):
    """float64: ok, kept_obs and the chosen candidate equal, Xw and the
    mean reprojection within 1e-10 on the kept tracks, the DLT counts
    equal; the bilinear taps equal."""
    jsc, tsc, ts, maps, Rcw, tcw = _fuse_inputs(scene)
    jts = jbuild.build_components(jsc.keypoints, jsc.matches, obser_thr=3)
    assert np.array_equal(ts.obs_uv, jts.obs_uv)
    ref = jfuse.fuse_tracks(jsc.cam, jts, maps, Rcw, tcw, dtype=jnp.float64)
    got = fuse.fuse_tracks(tsc.cam, ts, maps, Rcw, tcw, dtype=F64,
                           device="cpu")
    ok = np.asarray(ref.ok)
    assert ok.sum() > 100 and np.asarray(ref.from_tri).sum() > 10
    assert np.array_equal(got.ok.numpy(), ok)
    assert np.array_equal(got.kept_obs.numpy(), np.asarray(ref.kept_obs))
    assert np.array_equal(got.from_tri.numpy(), np.asarray(ref.from_tri))
    assert int(got.tri_candidates) == int(ref.tri_candidates)
    assert int(got.tri_valid) == int(ref.tri_valid)
    np.testing.assert_allclose(got.Xw.numpy()[ok], np.asarray(ref.Xw)[ok],
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.mean_reproj.numpy()[ok],
                               np.asarray(ref.mean_reproj)[ok], rtol=0,
                               atol=1e-10)
    for a, b in zip(fuse._bilinear_depth_host(maps, ts.obs_img, ts.obs_uv,
                                              ts.obs_valid),
                    jfuse._bilinear_depth_host(maps, ts.obs_img, ts.obs_uv,
                                               ts.obs_valid)):
        assert np.array_equal(a, b)


def test_mean_reprojection_error_matches_jax(scene):
    jsc, tsc, ts, maps, Rcw, tcw = _fuse_inputs(scene)
    rng = np.random.default_rng(0)
    O = 400
    oc = rng.integers(0, Rcw.shape[0], O).astype(np.int32)
    op = rng.integers(0, 50, O).astype(np.int32)
    X = jsc.landmarks[:50]
    uv = rng.uniform(0, 200, (O, 2))
    ref = jmetrics.mean_reprojection_error(jsc.cam, Rcw, tcw, X, oc, op, uv)
    got = mean_reprojection_error(tsc.cam, Rcw, tcw, X, oc, op, uv)
    assert abs(got - ref) < 1e-12 * ref


def _configs():
    out = []
    for C in (JLvbaConfig, LvbaConfig):
        cfg = C()
        cfg.window_ba.size = 6
        cfg.window_ba.anchor_leaf_size = 0.02
        cfg.BALM_stage2.root_voxel_size = 0.5
        cfg.BALM_stage2.eigen_ratio_array = [0.08] * 4
        cfg.track_fusion.obser_thr = 3
        out.append(cfg)
    out[1].solver.dtype = "float64"
    return out


COUNTS = ("tracks_fused", "tri_selected", "depth_selected",
          "tracks_with_plane", "observations", "solve_iters",
          "total_components", "kept_components", "edges", "max_obs")


@pytest.mark.parametrize("fuse_dtype", ["float32", "float64"])
def test_run_visual_ba_matches_jax(scene, fuse_dtype, monkeypatch):
    """tests/test_visual_pipeline.py's run (the LiDAR result = the truth,
    odometry = perturbed) through both packages, the solve in float64:
    every count in stats equal, poses, points and the post-BA
    reprojection within 1e-8, the final cost within 1e-10 relative.  The
    JAX package runs its numpy host paths (its native library off), as
    the port does.  Track fusion runs in float32 by default in both
    packages (their float32 DLT eigensolves differ in the last bits, so
    the fused start points and cost0 differ at ~1e-5 relative); with both
    packages' fuse_tracks patched to float64, cost0 and the pre-BA
    reprojection match within 1e-10 too."""
    jsc, tsc, clouds, R_odom, p_odom = scene
    sc = jsc.lidar
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    if fuse_dtype == "float64":
        for mod, f, dt in ((jvba, jfuse.fuse_tracks, jnp.float64),
                           (visual_ba, fuse.fuse_tracks, F64)):
            monkeypatch.setattr(mod, "fuse_tracks", functools.partial(
                f, dtype=dt))
    kw = dict(clouds=clouds, lidar_times=sc.times, R_opt=sc.R_true,
              p_opt=sc.p_true, R_orig=R_odom, p_orig=p_odom,
              image_times=jsc.image_times, cam_R=R_odom[jsc.image_frame],
              cam_p=p_odom[jsc.image_frame], Rci=jsc.Rci, tci=jsc.tci,
              keypoints=jsc.keypoints, matches=jsc.matches)
    jcfg, tcfg = _configs()
    ref = jvba.run_visual_ba(cam=jsc.cam, cfg=jcfg, **kw)
    got = visual_ba.run_visual_ba(cam=tsc.cam, cfg=tcfg, device="cpu", **kw)
    assert {k: got.stats[k] for k in COUNTS} == {k: ref.stats[k]
                                                 for k in COUNTS}
    assert got.stats["solve_route"] == "lu"
    for f in ("Rcw", "tcw", "points"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=0,
                                   atol=1e-8, err_msg=f)
    assert abs(got.mean_reproj_post - ref.mean_reproj_post) < 1e-8
    assert abs(got.stats["cost"] - ref.stats["cost"]) <= 1e-10 * ref.stats[
        "cost"]
    assert got.mean_reproj_post < 1.0 and got.mean_reproj_post < \
        got.mean_reproj_pre
    for a, b in zip(got.track_obs, ref.track_obs):
        assert np.array_equal(a, b)
    assert all(np.array_equal(a, b) for a, b in
               zip(got.used_kp_mask, ref.used_kp_mask))
    tol = 1e-10 if fuse_dtype == "float64" else 1e-4
    assert abs(got.stats["cost0"] - ref.stats["cost0"]) <= tol * ref.stats[
        "cost0"]
    assert abs(got.mean_reproj_pre - ref.mean_reproj_pre) <= tol


def test_depth_out_dir_pngs_decode_to_depth_maps(scene, tmp_path,
                                                 monkeypatch):
    """run_visual_ba(depth_out_dir=) writes <ts>.png per image: each
    decodes (the port's reader, and cv2) to the map render_depth_maps
    returned, within the 1/2000 m quantization."""
    import cv2

    from global_lvba_tpu_torch.pipeline.outputs import load_depth_png

    jsc, tsc, clouds, R_odom, p_odom = scene
    sc = jsc.lidar
    maps = []
    render = visual_ba.render_depth_maps
    monkeypatch.setattr(visual_ba, "render_depth_maps",
                        lambda *a, **k: maps.append(render(*a, **k))
                        or maps[-1])
    cfg = LvbaConfig()
    cfg.solver.dtype = "float64"
    visual_ba.run_visual_ba(
        tsc.cam, clouds, sc.times, sc.R_true, sc.p_true, R_odom, p_odom,
        jsc.image_times, R_odom[jsc.image_frame], p_odom[jsc.image_frame],
        jsc.Rci, jsc.tci, jsc.keypoints, jsc.matches, cfg,
        depth_out_dir=tmp_path / "depth", device="cpu")
    names = sorted(p.name for p in (tmp_path / "depth").iterdir())
    assert names == sorted(f"{t:.6f}.png" for t in jsc.image_times)
    assert len(maps) == 1 and len(maps[0]) == len(names)
    for t, d in zip(jsc.image_times, maps[0]):
        path = tmp_path / "depth" / f"{t:.6f}.png"
        got = load_depth_png(path)
        want = np.clip(d, 0, 65535 / 2000.0)
        assert got.shape == d.shape and (d > 0).any()
        assert np.abs(got - want).max() <= 1 / 2000
        assert np.array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED),
                              np.clip(d * 2000, 0, 65535).astype(np.uint16))
