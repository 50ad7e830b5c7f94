"""The port's native host runtime (global_lvba_tpu_torch/native), built here
by g++ without nvcc, against the port's numpy paths and the JAX package's
native functions on the same seeded inputs (after tests/test_native.py):
keys, argsort and union-find partitions exactly, the transform and the
segment moments within float64 rounding, LZF bytes exactly; the pipeline
helpers that a CUDA device routes through it (build_voxel_map,
build_grid_map, build_components, read_pcd) against the JAX package's
native path; and the failures that must raise (an out-of-range key, a
missing compiler) rather than fall back.

A host function given device="cuda" takes the native path without
touching a card, so these run on the CPU.

Tolerances: transform_points 1e-14 absolute on unit-scale points (the
JAX test's 1e-13, tighter: the C++ rounds each product and sum once, in
the order R0 x0 + R1 x1 + R2 x2 + p; numpy's einsum sums the three
products in another order, the JAX build with FMAs, so ~1 ulp apart);
bin_moments 1e-12 absolute (the JAX test's 1e-10, tighter: numpy's
reduceat sums a segment pairwise, the C++ in order); the sums equal the
JAX library's exactly (the same adds), the moments within 1e-12 (its
FMAs)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from global_lvba_tpu.map import voxelize as jvox
from global_lvba_tpu.native import runtime as jnat
from global_lvba_tpu.pipeline import depth as jdepth
from global_lvba_tpu.tracks import build as jbuild
from global_lvba_tpu_torch import native
from global_lvba_tpu_torch.io import pcd
from global_lvba_tpu_torch.kernels import build
from global_lvba_tpu_torch.map import voxelize
from global_lvba_tpu_torch.models.synthetic import (
    make_joint_scene, make_plane_scene, perturb_poses)
from global_lvba_tpu_torch.native import runtime
from global_lvba_tpu_torch.pipeline import depth
from global_lvba_tpu_torch.tracks import build as tbuild

ROOT = Path(__file__).resolve().parents[1]
CARD = "cuda"   # a host helper on this device takes the native path


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (the suite's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jlib():
    lib = jnat.get_lib()
    if lib is None:
        pytest.skip("the JAX package's native library does not build here")
    return lib


def test_library_builds_without_nvcc():
    """g++ builds it into build/torch_ext/ with the flags kernels/build
    states; the six entry points are bound; no CUDA kernel is built."""
    path = build.host_library()
    assert path.parent == build.BUILD_DIR and path.exists()
    assert "-ffp-contract=off" in build.HOST_FLAGS
    lib = runtime.library()
    for name in runtime.SIGNATURES:
        assert getattr(lib, name).restype == runtime.SIGNATURES[name][1]
    assert not build._libs
    assert native.on_device(CARD) and not native.on_device("cpu")


def test_voxel_keys64_match_numpy_and_jax(jlib):
    rng = np.random.default_rng(5)
    pts = rng.uniform(-300, 300, size=(50000, 3))
    got = runtime.voxel_keys64(pts, 0.7)
    np.testing.assert_array_equal(
        got, voxelize.pack_voxel_keys(voxelize.voxel_coords(pts, 0.7)))
    np.testing.assert_array_equal(got, jnat.voxel_keys64(pts, 0.7))
    # points on voxel boundaries and negative integers
    edge = np.array([[0.0, -0.7, 0.7], [-1e-300, 1.4, -2.1]])
    np.testing.assert_array_equal(
        runtime.voxel_keys64(edge, 0.7),
        voxelize.pack_voxel_keys(voxelize.voxel_coords(edge, 0.7)))


@pytest.mark.parametrize("bad", [1e9, -1e9, np.nan, np.inf])
def test_out_of_range_key_raises(bad):
    """The numpy path's ValueError, where the JAX runtime returns None."""
    pts = np.zeros((70000, 3))
    pts[123, 1] = bad
    with pytest.raises(ValueError, match="out of packable range"):
        runtime.voxel_keys64(pts, 1.0)
    with pytest.raises(ValueError, match="out of packable range"):
        voxelize.build_voxel_map(pts, np.zeros(70000, np.int32),
                                 np.eye(3)[None], np.zeros((1, 3)), 1.0,
                                 device=CARD)


def test_radix_argsort_is_the_stable_argsort(jlib):
    rng = np.random.default_rng(1)
    for keys in (rng.integers(-(2**62), 2**62, size=100000),
                 rng.integers(-3, 4, size=100000),        # many ties
                 np.zeros(0, np.int64), np.array([5])):
        got = runtime.radix_argsort(keys)
        np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
        np.testing.assert_array_equal(got, jnat.radix_argsort(keys))
        np.testing.assert_array_equal(
            voxelize._argsort_keys(keys, native=True),
            voxelize._argsort_keys(keys))


def test_transform_points_match_einsum_and_jax(jlib):
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(30000, 3))
    fid = rng.integers(0, 40, 30000).astype(np.int32)
    R = Rotation.random(40, random_state=1).as_matrix()
    p = rng.normal(size=(40, 3))
    got = runtime.transform_points(pts, fid, R, p)
    np.testing.assert_allclose(
        got, np.einsum("nij,nj->ni", R[fid], pts) + p[fid], rtol=0,
        atol=1e-14)
    np.testing.assert_allclose(got, jnat.transform_points(pts, fid, R, p),
                               rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match="frame id"):
        runtime.transform_points(pts, fid + 1, R, p)


def test_bin_moments_match_reduceat_and_jax(jlib):
    rng = np.random.default_rng(7)
    N = 200000
    pts = rng.normal(size=(N, 3))
    keys = rng.integers(0, 5000, N)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    s, m = runtime.bin_moments(pts, order, starts)
    counts, s_np, m_np = voxelize._reduceat_moments(pts, order, starts)
    np.testing.assert_allclose(s, s_np, rtol=0, atol=1e-12)
    np.testing.assert_allclose(m, m_np, rtol=0, atol=1e-12)
    s_j, m_j = jnat.bin_moments(pts, order, starts)
    np.testing.assert_array_equal(s, s_j)
    np.testing.assert_allclose(m, m_j, rtol=0, atol=1e-12)
    c2, s2, m2 = voxelize._reduceat_moments(pts, order, starts, native=True)
    assert np.array_equal(c2, counts) and np.array_equal(s2, s)
    with pytest.raises(ValueError, match="starts"):
        runtime.bin_moments(pts, order, starts[1:])


def _python_roots(n, edges):
    uf = tbuild._UnionFind(n)
    for a, b in edges:
        uf.union(int(a), int(b))
    return np.array([uf.find(x) for x in range(n)])


def _canon(labels):
    """Each node's label as the first node of its component."""
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    return first[inv]


@pytest.mark.parametrize("n, m", [(6, 0), (5000, 20000), (20000, 8000)])
def test_union_find_partition_and_roots(jlib, n, m):
    """The Python _UnionFind's partition; the JAX native library's roots."""
    rng = np.random.default_rng(n + m)
    edges = rng.integers(0, n, size=(m, 2)).astype(np.int64)
    got = runtime.union_find(n, edges)
    np.testing.assert_array_equal(_canon(got),
                                  _canon(_python_roots(n, edges)))
    np.testing.assert_array_equal(got, jnat.union_find(n, edges))
    with pytest.raises(ValueError, match="outside"):
        runtime.union_find(n, np.array([[0, n]]))


def _smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def test_lzf_round_trip_through_read_pcd(tmp_path, jlib):
    """chip_smoke's LZF encoder (literals and both reference forms) on a
    binary_compressed PCD: the port's decoder (the native library) gives
    the payload, as the JAX package's Python decoder and its library do,
    and read_pcd the cloud, as the JAX reader does."""
    from global_lvba_tpu.io import pcd as jpcd

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(3000, 4)).astype(np.float32)
    pts[:, 3] = np.tile([1.0, 2.0, 2.0, 7.0], 750)     # long matches
    pts[:1000, 2] = 1.5
    path = tmp_path / "c.pcd"
    payload, comp = _smoke()._write_compressed_pcd(path, pts)
    kinds = set()
    i = 0
    while i < len(comp):
        ctrl = comp[i]
        kind = ("literal" if ctrl < 32 else
                "long reference" if ctrl >> 5 == 7 else "short reference")
        kinds.add(kind)
        i += (ctrl + 2 if kind == "literal" else
              3 if kind == "long reference" else 2)
    assert kinds == {"literal", "long reference", "short reference"}
    got = runtime.lzf_decompress(comp, len(payload))
    assert got == payload == pcd._lzf_decompress(comp, len(payload))
    assert got == jpcd._lzf_decompress(comp, len(payload))
    assert got == jnat.lzf_decompress(comp, len(payload))
    fields = ("x", "y", "z", "intensity")
    cloud = pcd.read_pcd(path, fields=fields)
    np.testing.assert_array_equal(cloud, pts)
    np.testing.assert_array_equal(cloud, jpcd.read_pcd(path, fields=fields))
    with pytest.raises(ValueError, match="malformed"):
        runtime.lzf_decompress(bytes([40, 0]), 16)   # a reference before 0


@pytest.fixture(scope="module")
def plane_map():
    sc = make_plane_scene(num_frames=8, points_per_frame=10000, seed=2)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=4)
    return sc, Rp, pp


def test_build_voxel_map_matches_jax_native(plane_map, jlib):
    """80,000 points (above the 2^16 gate): the plane keys, lookup, counts,
    frames and bucket shapes equal the JAX package's native build and the
    port's numpy build; μ and Pc within float32 rounding of both."""
    sc, Rp, pp = plane_map
    kw = dict(eigen_ratios=(0.2,) * 4)
    got = voxelize.build_voxel_map(sc.points_body, sc.frame_ids, Rp, pp, 1.0,
                                   device=CARD, **kw)
    for ref in (jvox.build_voxel_map(sc.points_body, sc.frame_ids, Rp, pp,
                                     1.0, **kw),
                voxelize.build_voxel_map(sc.points_body, sc.frame_ids, Rp,
                                         pp, 1.0, **kw)):
        assert got.num_planes == ref.num_planes > 100
        assert got.stats == ref.stats
        for a, b in zip(got.lookup.plane_keys + got.lookup.subdiv_keys,
                        ref.lookup.plane_keys + ref.lookup.subdiv_keys):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got.lookup.centers, ref.lookup.centers,
                                   rtol=0, atol=1e-12)
        assert len(got.buckets) == len(ref.buckets)
        for a, b in zip(got.buckets, ref.buckets):
            np.testing.assert_array_equal(a.n, b.n)
            np.testing.assert_array_equal(a.frame, b.frame)
            np.testing.assert_allclose(a.mu, b.mu, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(a.Pc, b.Pc, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def joint():
    js = make_joint_scene(8, 20000, num_landmarks=600, seed=3, px_noise=0.3)
    sc = js.lidar
    clouds = [sc.points_body[sc.frame_ids == i] for i in range(8)]
    return js, clouds


def test_build_grid_map_matches_jax_native(joint, jlib):
    """Keys by the library: the JAX package's native grid map array for
    array, and the port's numpy one."""
    js, clouds = joint
    sc = js.lidar
    got = depth.build_grid_map(clouds, sc.R_true, sc.p_true, device=CARD)
    for ref in (jdepth.build_grid_map(clouds, sc.R_true, sc.p_true),
                depth.build_grid_map(clouds, sc.R_true, sc.p_true)):
        for f in ("keys", "starts", "counts", "points"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
        for a, b in zip(got.frame_voxel_keys, ref.frame_voxel_keys):
            np.testing.assert_array_equal(a, b)


def test_build_components_matches_jax_native(joint, jlib):
    """The library's roots are the JAX native path's, so its tracks come
    out in the same order, array for array; against the Python labels
    (the CPU path) the same tracks in another order."""
    js, _ = joint
    got = tbuild.build_components(js.keypoints, js.matches, obser_thr=3,
                                  device=CARD)
    ref = jbuild.build_components(js.keypoints, js.matches, obser_thr=3)
    assert got.obs_img.shape[0] > 50
    for f in ("obs_img", "obs_kp", "obs_uv", "obs_valid", "num_obs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert got.stats == ref.stats
    cpu = tbuild.build_components(js.keypoints, js.matches, obser_thr=3)

    def rows(ts):
        return sorted(map(tuple, np.concatenate(
            [ts.obs_img, ts.obs_kp], axis=1).tolist()))

    assert rows(cpu) == rows(got) and cpu.stats == got.stats


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """A library that cannot be built raises, naming the compiler; the
    CUDA-device path does not fall back to numpy."""
    monkeypatch.setattr(build, "HOST_CXX", "g++-not-installed")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+-not-installed not found"):
        runtime.radix_argsort(np.arange(5))
    pts = np.random.default_rng(0).normal(size=(70000, 3))
    with pytest.raises(RuntimeError, match="not found"):
        voxelize.build_voxel_map(pts, np.zeros(70000, np.int32),
                                 np.eye(3)[None], np.zeros((1, 3)), 1.0,
                                 device=CARD)
    assert not list(tmp_path.iterdir())


def test_failed_compile_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(build, "HOST_SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(runtime, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp"):
        runtime.library()
    assert not any(p.suffix == ".so" for p in (tmp_path / "out").iterdir())


def test_run_visual_ba_card_host_paths_match_jax_native(monkeypatch, jlib):
    """The slice as a whole: run_visual_ba with a CUDA device's host paths
    (native.on_device patched, the depth maps through render_depth_maps'
    card route; the tensors on the CPU, so the maps come from zbuffer's
    plain version in one call) against the JAX
    package's run with its native library, both solving and fusing in
    float64 (tests/test_torch_visual_pipeline.py's scene and settings).
    The JAX C++ rasterizer contracts its distortion polynomial into FMAs
    and moves boundary pixels off numpy's maps, so its zbuffer_ranges is
    pointed at its own _zbuffer_host here, which the port's maps equal.
    Every count in stats and the track observations equal (the same
    union-find roots), poses, points and the post-BA reprojection within
    1e-8, the final cost within 1e-10 relative (the existing parity
    test's limits)."""
    import functools

    import jax.numpy as jnp

    from global_lvba_tpu.config import LvbaConfig as JLvbaConfig
    from global_lvba_tpu.pipeline import visual_ba as jvba
    from global_lvba_tpu.tracks import fuse as jfuse
    from global_lvba_tpu_torch.config import LvbaConfig
    from global_lvba_tpu_torch.kernels import zbuffer as zb
    from global_lvba_tpu_torch.models.synthetic import perturb_poses
    from global_lvba_tpu_torch.pipeline import visual_ba
    from global_lvba_tpu_torch.tracks import fuse

    js = make_joint_scene(num_frames=12, points_per_frame=20000, seed=3,
                          px_noise=0.3)
    sc = js.lidar
    R_odom, p_odom = perturb_poses(sc.R_true, sc.p_true, 0.004, 0.01, seed=9)
    clouds = [sc.points_body[sc.frame_ids == i] for i in range(12)]

    def host_zbuffer(pts, starts, counts, Rcw, tcw, cam, out):
        idx = np.concatenate([np.arange(s, s + c)
                              for s, c in zip(starts, counts)])
        out[...] = jdepth._zbuffer_host(cam, Rcw, tcw, pts[idx])
        return out

    monkeypatch.setattr(jnat, "zbuffer_ranges", host_zbuffer)
    calls = []
    plain = zb.zbuffer
    monkeypatch.setattr(zb, "zbuffer", lambda *a: calls.append(1)
                        or plain(*a))
    monkeypatch.setattr(native, "on_device", lambda d: True)
    monkeypatch.setattr(visual_ba, "render_depth_maps",
                        depth._render_zbuffer)
    for mod, f, dt in ((jvba, jfuse.fuse_tracks, jnp.float64),
                       (visual_ba, fuse.fuse_tracks, torch.float64)):
        monkeypatch.setattr(mod, "fuse_tracks", functools.partial(f,
                                                                  dtype=dt))
    cfgs = []
    for C in (JLvbaConfig, LvbaConfig):
        cfg = C()
        cfg.window_ba.size = 6
        cfg.window_ba.anchor_leaf_size = 0.02
        cfg.BALM_stage2.root_voxel_size = 0.5
        cfg.BALM_stage2.eigen_ratio_array = [0.08] * 4
        cfg.track_fusion.obser_thr = 3
        cfgs.append(cfg)
    cfgs[1].solver.dtype = "float64"
    kw = dict(clouds=clouds, lidar_times=sc.times, R_opt=sc.R_true,
              p_opt=sc.p_true, R_orig=R_odom, p_orig=p_odom,
              image_times=js.image_times, cam_R=R_odom[js.image_frame],
              cam_p=p_odom[js.image_frame], Rci=js.Rci, tci=js.tci,
              keypoints=js.keypoints, matches=js.matches)
    ref = jvba.run_visual_ba(cam=js.cam, cfg=cfgs[0], **kw)
    got = visual_ba.run_visual_ba(cam=js.cam, cfg=cfgs[1], device="cpu",
                                  **kw)
    assert len(calls) == 1
    keys = ("tracks_fused", "tri_selected", "depth_selected",
            "tracks_with_plane", "observations", "solve_iters",
            "total_components", "kept_components", "edges", "max_obs")
    assert {k: got.stats[k] for k in keys} == {k: ref.stats[k] for k in keys}
    for a, b in zip(got.track_obs, ref.track_obs):
        assert np.array_equal(a, b)
    for f in ("Rcw", "tcw", "points", "points_pre"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=0,
                                   atol=1e-8, err_msg=f)
    assert abs(got.mean_reproj_post - ref.mean_reproj_post) < 1e-8
    assert abs(got.stats["cost"] - ref.stats["cost"]) <= 1e-10 * \
        ref.stats["cost"]
    assert got.mean_reproj_post < 1.0 and got.mean_reproj_post < \
        got.mean_reproj_pre
