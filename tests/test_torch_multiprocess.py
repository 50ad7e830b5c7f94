"""Two torch.distributed processes (gloo, CPU) after
tests/test_multiprocess.py: a cross-process reduction (mesh.psum), one
factor-sharded LM step across both processes == the local step, the
compact-banded LM whose CG reduces across them every trip, and the
distributed voxel moments with the ring passing tables between the
processes (send/recv), each == its single-process result."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

# slow tier, as tests/test_multiprocess.py (pyproject [tool.pytest.ini_options])
pytestmark = pytest.mark.slow

_WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch

    torch.set_num_threads(1)
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from global_lvba_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh, psum)

    initialize_distributed(f"127.0.0.1:{port}", nproc, pid, backend="gloo")
    mesh = make_mesh(2, devices=["cpu"] * 2)     # 2 shards a process
    assert mesh.world == nproc and mesh.n_shards() == 2 * nproc

    n_dev, rows = mesh.n_shards(), 4
    data = np.arange(n_dev * rows, dtype=np.float64).reshape(n_dev, rows)
    total = float(psum([torch.as_tensor(data[g])
                        for g in mesh.local_shards()], mesh).sum())
    assert abs(total - data.sum()) < 1e-9, total

    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import (
        make_corridor_scene, make_plane_scene, perturb_poses)
    from global_lvba_tpu_torch.parallel.shard import (
        lm_damping_iter_banded_compact_sharded, lm_damping_iter_sharded)
    from global_lvba_tpu_torch.parallel.spatial import (
        distributed_voxel_moments, host_voxel_moments)
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter

    F64 = torch.float64
    sc = make_plane_scene(num_frames=4, points_per_frame=800, seed=0)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    bk = buckets_to_device(vm, 4, dtype=F64, device="cpu")
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.01, 0.02, seed=1)
    R0, p0 = torch.as_tensor(Rp), torch.as_tensor(pp)
    loc = lm_damping_iter(bk, R0, p0, max_iters=1)
    mp = lm_damping_iter_sharded(bk, R0, p0, mesh, max_iters=1)
    dp = float((mp.p - loc.p).abs().max())
    assert dp < 1e-9, dp

    cor = make_corridor_scene(num_frames=48, points_per_frame=800, seed=4)
    vmc = build_voxel_map(cor.points_body, cor.frame_ids, cor.R_true,
                          cor.p_true, voxel_size=1.0,
                          eigen_ratios=(0.2,) * 4)
    cbk = buckets_to_device(vmc, 48, dtype=F64, device="cpu")
    Rc, pc = perturb_poses(cor.R_true, cor.p_true, 0.01, 0.02, seed=2)
    Rc, pc = torch.as_tensor(Rc), torch.as_tensor(pc)
    a = lm_damping_iter(cbk, Rc, pc, max_iters=3, hessian="banded",
                        reduced_solver="cg")
    b = lm_damping_iter_banded_compact_sharded(cbk, Rc, pc, mesh,
                                               max_iters=3, block=8)
    dc = float((a.p - b.p).abs().max())
    assert dc < 1e-8, dc

    pts = np.random.default_rng(0).uniform(-15, 15, size=(8000, 3)).astype(
        np.float32)
    kk, cc, ss, mm = distributed_voxel_moments(pts, 1.0, mesh, capacity=4096)
    hk, hc, hs, hm = host_voxel_moments(pts.astype(np.float64), 1.0)
    assert np.array_equal(kk, hk) and np.array_equal(cc, hc)
    assert np.allclose(ss, hs, rtol=1e-5, atol=1e-3)
    if pid == 0:
        print(f"MP_OK sum={total} procs={nproc} shards={n_dev} "
              f"lm_dp={dp:.3g} compact_dp={dc:.3g}", flush=True)
    """
)


def test_two_process_distributed_reduction_and_lm():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd()
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(pid), "2",
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err.decode()[-2000:]
        assert any(b"MP_OK" in out for out, _ in outs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
