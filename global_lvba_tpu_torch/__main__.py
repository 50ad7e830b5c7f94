"""Command-line entry point of the port.

  python -m global_lvba_tpu_torch run --config cfg.yaml [--data PATH]
      [--out OUT_DIR] [--no-resume] [--view] [--device cuda|cpu]
  python -m global_lvba_tpu_torch info --config cfg.yaml
  python -m global_lvba_tpu_torch view --out OUT_DIR
  python -m global_lvba_tpu_torch lidar --frames F --ppf P [--config cfg.yaml]
      [--device cuda|cpu] [--seed S]

`run`, `info` and `view` are the JAX package's commands (its __main__,
the reference's roslaunch node): `run` takes a dataset in the reference's
layout through LvbaSystem (LiDAR BA, visual BA, exports, a checkpoint
after each stage, resumed unless --no-resume) on --device (default the
card) and prints the mean reprojection before and after as one JSON
line; `info` prints the parsed configuration; `view` opens the exported
clouds in open3d when it is installed (exit 1 with a hint otherwise).

`lidar` runs run_lidar_ba on a synthetic plane scene with perturbed poses
and prints one JSON line with the ATE before and after.  Without --config
the configuration is the aligned global BA of the port's first slice:
window stage off (the frames are the anchors), both global stages at
voxel size 1.0 with eigen ratio 0.2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def slice_config(dtype: str = "float32"):
    """The aligned global-BA configuration (see the module docstring)."""
    from .config import LvbaConfig

    cfg = LvbaConfig()
    cfg.window_ba.enable = False
    for st in (cfg.BALM_stage1, cfg.BALM_stage2):
        st.root_voxel_size = 1.0
        st.eigen_ratio_array = [0.2] * 4
    cfg.solver.dtype = dtype
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(prog="global_lvba_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="run the full LVBA refinement pipeline")
    run_p.add_argument("--config", required=True, help="YAML config (reference schema)")
    run_p.add_argument("--data", default=None, help="dataset root (overrides config)")
    run_p.add_argument("--out", default=None, help="output directory")
    run_p.add_argument("--no-resume", action="store_true")
    run_p.add_argument(
        "--view", action="store_true",
        help="open the exported clouds in an interactive viewer after the "
             "run (needs open3d + a display; degrades to a hint otherwise)",
    )
    run_p.add_argument("--device", default="cuda")

    info_p = sub.add_parser("info", help="print the parsed configuration")
    info_p.add_argument("--config", required=True)

    view_p = sub.add_parser(
        "view", help="open previously exported PCDs in an interactive "
        "viewer (rviz-session analogue; needs open3d + a display)")
    view_p.add_argument("--out", required=True, help="pipeline output dir")

    lp = sub.add_parser("lidar", help="LiDAR BA on a synthetic plane scene")
    lp.add_argument("--frames", type=int, default=512)
    lp.add_argument("--ppf", type=int, default=2000, help="points per frame")
    lp.add_argument("--config", default=None, help="YAML config (reference schema)")
    lp.add_argument("--device", default="cuda")
    lp.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cmd == "lidar":
        return _lidar(args)

    if args.cmd == "view":
        from .pipeline.viz import launch_viewer

        return 0 if launch_viewer(args.out) else 1

    from .config import LvbaConfig

    cfg = LvbaConfig.from_yaml(args.config)

    if args.cmd == "info":
        import dataclasses

        print(json.dumps(dataclasses.asdict(cfg), indent=2))
        return 0

    if args.data:
        cfg.data_config.data_path = args.data

    from .pipeline.system import LvbaSystem

    system = LvbaSystem(cfg, out_dir=args.out, resume=not args.no_resume,
                        device=args.device)
    result = system.run_full_pipeline()
    print(json.dumps({k: v for k, v in result.items() if k != "metrics"},
                     default=float))
    if args.view:
        from .pipeline.viz import launch_viewer

        launch_viewer(system.out_dir, block=False)
    return 0


def _lidar(args):
    import numpy as np

    from .config import LvbaConfig
    from .models.synthetic import ate_rmse, make_plane_scene, perturb_poses
    from .pipeline.lidar_ba import run_lidar_ba

    if args.config:
        cfg = LvbaConfig.from_yaml(args.config)
    else:
        cfg = slice_config("float32" if args.device != "cpu" else "float64")
    scene = make_plane_scene(num_frames=args.frames,
                             points_per_frame=args.ppf, seed=args.seed)
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.003, 0.01,
                           seed=args.seed + 1)
    clouds = [scene.points_body[scene.frame_ids == i]
              for i in range(args.frames)]
    t0 = time.time()
    res = run_lidar_ba(clouds, Rp, pp, cfg, device=args.device)
    wall = time.time() - t0
    print(json.dumps({
        "frames": args.frames,
        "points": int(scene.points_body.shape[0]),
        "device": args.device,
        "ate0_m": ate_rmse(pp, scene.p_true),
        "ate_m": ate_rmse(np.asarray(res.p_opt), scene.p_true),
        "wall_s": wall,
        "stages": res.stats["global"],
    }, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
