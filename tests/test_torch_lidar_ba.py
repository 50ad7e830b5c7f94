"""run_lidar_ba of the PyTorch port against the JAX package (float64, CPU):
at F=64 with the window stage off, voxel 1.0, eigen ratio 0.2, the density
gate picks the aligned layout; with the window stage on (24 frames,
windows of 6, the setting of tests/test_parity_oracle.py) every solve is
bucketed.  The poses agree at 1e-8 on both."""

import json

import numpy as np
import pytest
import torch

from global_lvba_tpu.config import LvbaConfig as JaxConfig
from global_lvba_tpu.pipeline.lidar_ba import run_lidar_ba as jax_run_lidar_ba
from global_lvba_tpu_torch.__main__ import main, slice_config
from global_lvba_tpu_torch.config import LvbaConfig
from global_lvba_tpu_torch.factors.padding import (
    aligned_to_device, buckets_to_device, picks_aligned)
from global_lvba_tpu_torch.map.voxelize import build_voxel_map
from global_lvba_tpu_torch.models.synthetic import (
    ate_rmse, make_plane_scene, perturb_poses)
from global_lvba_tpu_torch.pipeline.lidar_ba import run_lidar_ba

F = 64


@pytest.fixture(scope="module")
def scene():
    sc = make_plane_scene(num_frames=F, points_per_frame=1000, seed=0)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=1)
    clouds = [sc.points_body[sc.frame_ids == i] for i in range(F)]
    return sc, Rp, pp, clouds


def _jax_cfg():
    cfg = JaxConfig()
    cfg.window_ba.enable = False
    cfg.solver.dtype = "float64"
    for st in (cfg.BALM_stage1, cfg.BALM_stage2):
        st.root_voxel_size = 1.0
        st.eigen_ratio_array = [0.2] * 4
    return cfg


def test_gate_picks_aligned(scene):
    sc, Rp, pp, _ = scene
    vm = build_voxel_map(sc.points_body, sc.frame_ids, Rp, pp, 1.0,
                         eigen_ratios=[0.2] * 4)
    assert picks_aligned(vm, F)
    got = buckets_to_device(vm, W=F, dtype=torch.float64, device="cpu")
    want = aligned_to_device(vm.buckets, F, dtype=torch.float64, device="cpu")
    assert len(got) == 1
    for x, y in zip(got[0], want):
        assert torch.equal(x, y)


def test_run_lidar_ba_matches_jax(scene):
    sc, Rp, pp, clouds = scene
    got = run_lidar_ba(clouds, Rp, pp, slice_config("float64"), device="cpu")
    ref = jax_run_lidar_ba(clouds, Rp, pp, _jax_cfg())
    np.testing.assert_allclose(got.p_opt, ref.p_opt, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.R_opt, ref.R_opt, rtol=0, atol=1e-8)
    assert [s["planes"] for s in got.stats["global"]] == \
        [s["planes"] for s in ref.stats["global"]]
    assert all(s["lm_iters"] > 0 for s in got.stats["global"])
    assert ate_rmse(got.p_opt, sc.p_true) < 0.5 * ate_rmse(pp, sc.p_true)


def _window_cfg(cfg):
    cfg.window_ba.size = 6
    cfg.window_ba.enable = True
    cfg.window_ba.use_window_ba_rel = True
    cfg.window_ba.anchor_leaf_size = 0.05
    cfg.BALM_stage1.root_voxel_size = 1.0
    cfg.BALM_stage2.root_voxel_size = 1.0
    cfg.solver.dtype = "float64"
    return cfg


def test_default_windows_raise():
    """The window stage (bucketed, one merged bucket per window) and the
    bucketed anchor stages match the JAX pipeline.  (Before the bucketed
    layout was ported, this stage raised.)"""
    sc = make_plane_scene(num_frames=24, points_per_frame=3000, seed=7)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.004, 0.015, seed=8)
    clouds = [sc.points_body[sc.frame_ids == i] for i in range(24)]
    got = run_lidar_ba(clouds, Rp, pp, _window_cfg(LvbaConfig()), device="cpu")
    ref = jax_run_lidar_ba(clouds, Rp, pp, _window_cfg(JaxConfig()))
    np.testing.assert_allclose(got.p_opt, ref.p_opt, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.R_opt, ref.R_opt, rtol=0, atol=1e-8)
    for key in ("windows", "skipped"):
        assert got.stats["window"][key] == ref.stats["window"][key]
    assert got.stats["window"]["windows"] == 4
    assert got.stats["window"]["lm_iters"] > 0
    assert [s["planes"] for s in got.stats["global"]] == \
        [s["planes"] for s in ref.stats["global"]]
    np.testing.assert_array_equal(got.anchor_index, ref.anchor_index)
    assert ate_rmse(got.p_opt, sc.p_true) < 0.5 * ate_rmse(pp, sc.p_true)


def test_cli_lidar_on_cpu(capsys):
    assert main(["lidar", "--frames", "64", "--ppf", "600",
                 "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["ate_m"] < out["ate0_m"]
