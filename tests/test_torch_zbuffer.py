"""The depth maps' z-buffer (kernels/zbuffer.py; csrc/zbuffer.cu on the card)
through its plain torch version on the CPU, against the port's and the
JAX package's numpy _zbuffer_host (after tests/test_native.py:122-172),
and the card path of render_depth_maps (image_ranges, one call over all
images) rehearsed on the CPU.

Tolerance: the share of pixels whose depth differs by more than 1e-6 from
_zbuffer_host stays below 1e-3, the JAX package's own limit for its C++
rasterizer.  The plain version rounds as numpy does (R p as the BLAS's
FMA chain, every other operation once), so where numpy's BLAS forms R p
as that chain the maps are bitwise _zbuffer_host's; a BLAS that orders
R p otherwise moves a point on a pixel border or an occlusion boundary
one pixel over.  Everything else (ranges against a gathered copy, images at
once against one at a time, the kernel against the plain version on the
card, tests/test_torch_cuda.py) is bit for bit."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from scipy.spatial.transform import Rotation

from global_lvba_tpu.geometry.camera import CameraModel as JCameraModel
from global_lvba_tpu.pipeline import depth as jdepth
from global_lvba_tpu_torch.geometry.camera import CameraModel
from global_lvba_tpu_torch.kernels import launch_counts, zbuffer as zb
from global_lvba_tpu_torch.models.synthetic import make_joint_scene
from global_lvba_tpu_torch.pipeline import depth

SHARE = 1e-3
CAM = dict(fx=400.0, fy=410.0, cx=320.0, cy=240.0, k1=-0.05, k2=0.08,
           p1=-0.001, p2=0.0005, width=640, height=480)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (the suite's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed, n):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 20, size=n)
    return pts


def _poses(m):
    R = np.stack([Rotation.from_rotvec([0.05 - 0.02 * i, -0.1, 0.02 * i])
                  .as_matrix() for i in range(m)])
    t = np.stack([[0.1 * i, -0.2, 0.5] for i in range(m)])
    return R, t


def _call(fn, pts, starts, counts, offsets, R, t, cam):
    return fn(torch.as_tensor(pts), torch.as_tensor(starts, dtype=torch.int64),
              torch.as_tensor(counts, dtype=torch.int32),
              torch.as_tensor(offsets, dtype=torch.int64),
              torch.as_tensor(R), torch.as_tensor(t), cam).numpy()


def _whole(pts, R, t, cam):
    """The wrapper (its plain version on the CPU) over one range a image
    holding every point."""
    M = R.shape[0]
    return _call(zb.zbuffer, pts, [0] * M, [pts.shape[0]] * M,
                 np.arange(M + 1), R, t, cam)


def test_plain_matches_zbuffer_host():
    """300,000 points: the port's and the JAX package's _zbuffer_host
    (bitwise each other) within the 1e-3 pixel share, per image."""
    cam, jcam = CameraModel(**CAM), JCameraModel(**CAM)
    pts = _points(7, 300_000)
    R, t = _poses(2)
    got = _whole(pts, R, t, cam)
    for i in range(2):
        ref = depth._zbuffer_host(cam, R[i], t[i], pts)
        assert np.array_equal(ref, jdepth._zbuffer_host(jcam, R[i], t[i],
                                                        pts))
        assert (ref > 0).sum() > 50_000
        share = np.mean(np.abs(got[i] - ref) > 1e-6)
        assert share < SHARE, f"{share:.2e} of pixels differ"


def test_ranges_match_gathered_points():
    """CSR ranges read in place equal the gathered copy as one range, bit
    for bit (after test_native.py:146-172), empty ranges included."""
    cam = CameraModel(**CAM)
    rng = np.random.default_rng(11)
    N = 200_000
    pts = _points(11, N)
    starts = np.sort(rng.integers(0, N - 512, size=64)).astype(np.int64)
    counts = rng.integers(0, 512, size=64).astype(np.int32)
    counts[::9] = 0
    idx = np.concatenate([np.arange(s, s + c) for s, c in zip(starts, counts)])
    R, t = _poses(1)
    got = _call(zb.zbuffer, pts, starts, counts, [0, 64], R, t, cam)
    ref = _whole(np.ascontiguousarray(pts[idx]), R, t, cam)
    np.testing.assert_array_equal(got, ref)
    assert (got > 0).sum() > 1000


def test_points_in_front_counts_the_z_gate():
    """points_in_front (the bound's count of projected points) is the
    number of covisible points whose camera-frame Z, as _zbuffer_host
    forms it, passes Z >= 1e-3, over ranges and images (an image without
    a range counts none); points behind every image count none."""
    rng = np.random.default_rng(13)
    N = 50_000
    pts = _points(13, N)
    R, t = _poses(3)
    starts = np.sort(rng.integers(0, N - 400, size=30)).astype(np.int64)
    counts = rng.integers(0, 400, size=30).astype(np.int32)
    offsets = np.array([0, 12, 12, 30])
    want = 0
    for m in range(3):
        for r in range(offsets[m], offsets[m + 1]):
            q = pts[starts[r]:starts[r] + counts[r]]
            Z = (q @ R[m].astype(np.float32).T + t[m].astype(np.float32))[:, 2]
            want += int((Z >= 1e-3).sum())
    args = [torch.as_tensor(a) for a in (pts, starts, counts, offsets, R, t)]
    got = zb.points_in_front(*args)
    assert got == want and 0 < got < int(counts.sum())
    behind = pts.copy()
    behind[:, 2] = -np.abs(behind[:, 2]) - 30.0
    assert zb.points_in_front(torch.as_tensor(behind), *args[1:]) == 0


def test_empty_and_behind_the_camera():
    """No range, empty ranges, and points that all lie behind (Z < 1e-3)
    give maps of exact zeros."""
    cam = CameraModel(**CAM)
    pts = _points(2, 5000)
    R, t = _poses(3)
    behind = pts.copy()
    behind[:, 2] = -np.abs(behind[:, 2]) - 30.0     # far behind every image
    got = _call(zb.zbuffer, pts, [0, 10], [0, 0], [0, 0, 2, 2], R, t, cam)
    assert got.shape == (3, 480, 640) and not got.any()
    got = _whole(behind, R, t, cam)
    assert not got.any()
    empty = _call(zb.zbuffer, pts, [], [], [0], R[:0], t[:0], cam)
    assert empty.shape == (0, 480, 640)


def test_all_images_at_once_equal_one_at_a_time():
    cam = CameraModel(**CAM)
    pts = _points(5, 60_000)
    rng = np.random.default_rng(5)
    M = 4
    starts = np.sort(rng.integers(0, 59_000, size=40)).astype(np.int64)
    counts = rng.integers(1, 1000, size=40).astype(np.int32)
    offsets = np.array([0, 12, 12, 25, 40])
    R, t = _poses(M)
    got = _call(zb.zbuffer, pts, starts, counts, offsets, R, t, cam)
    for m in range(M):
        lo, hi = offsets[m], offsets[m + 1]
        one = _call(zb.zbuffer, pts, starts[lo:hi], counts[lo:hi],
                    [0, hi - lo], R[m:m + 1], t[m:m + 1], cam)
        np.testing.assert_array_equal(got[m], one[0])


@pytest.fixture(scope="module")
def scene():
    js = make_joint_scene(12, 20000, seed=3, px_noise=0.3)
    sc = js.lidar
    clouds = [sc.points_body[sc.frame_ids == i] for i in range(12)]
    Rcw, tcw = depth.camera_world_to_cam(js.Rci, js.tci,
                                         sc.R_true[js.image_frame],
                                         sc.p_true[js.image_frame])
    gm = depth.build_grid_map(clouds, sc.R_true, sc.p_true)
    return js, gm, Rcw, tcw


def test_image_ranges_are_each_images_covisible_rows(scene):
    js, gm, _, _ = scene
    sc = js.lidar
    starts, counts, offsets = depth.image_ranges(gm, sc.times, js.image_times)
    assert offsets.shape == (len(js.image_times) + 1,)
    assert starts.dtype == np.int64 and counts.dtype == np.int32
    for i, t_img in enumerate(js.image_times):
        vox = depth.covisible_voxels(gm, sc.times, float(t_img))
        s, c = depth.gather_voxel_ranges(gm, vox)
        lo, hi = offsets[i], offsets[i + 1]
        np.testing.assert_array_equal(starts[lo:hi], s)
        np.testing.assert_array_equal(counts[lo:hi], c)


def test_render_depth_maps_card_path_on_the_cpu(scene, monkeypatch):
    """render_depth_maps' card path (_render_zbuffer: image_ranges, one
    zbuffer call over all images, the maps back as host numpy) rehearsed
    on CPU tensors: bitwise the plain version image by image on the
    gathered points, and within the pixel share of the CPU path
    (_zbuffer_host); one call, no launch counted (the plain version)."""
    js, gm, Rcw, tcw = scene
    sc = js.lidar
    cpu = depth.render_depth_maps(js.cam, gm, sc.times, js.image_times, Rcw,
                                  tcw, device="cpu")
    before = launch_counts()["zbuffer"]
    calls = []
    plain = zb.zbuffer
    monkeypatch.setattr(zb, "zbuffer",
                        lambda *a: calls.append(1) or plain(*a))
    got = depth._render_zbuffer(js.cam, gm, sc.times, js.image_times, Rcw,
                                tcw, device="cpu")
    assert len(calls) == 1 and launch_counts()["zbuffer"] == before
    assert got.dtype == np.float32 and got.shape == cpu.shape
    for i, t_img in enumerate(js.image_times):
        pts = depth.gather_voxel_points(
            gm, depth.covisible_voxels(gm, sc.times, float(t_img)))
        if pts.shape[0]:
            ref = _whole(pts, Rcw[i:i + 1], tcw[i:i + 1], js.cam)[0]
            np.testing.assert_array_equal(got[i], ref)
        share = np.mean(np.abs(got[i] - cpu[i]) > 1e-6)
        assert share < SHARE, (i, share)
    assert (got > 0).sum() > 10_000


def _ranges(seed, N=5000, R=40, M=7):
    """Random CSR ranges over N points with repeated ranges, a range of no
    points, ranges that share a start but not a count, an image with no
    ranges and one with a range twice."""
    rng = np.random.default_rng(seed)
    base_s = np.sort(rng.integers(0, N - 600, size=R)).astype(np.int64)
    base_c = rng.integers(1, 600, size=R).astype(np.int32)
    base_c[3] = 0
    base_s[5], base_c[5] = base_s[4], base_c[4] + 7
    lists = [rng.choice(R, size=rng.integers(1, R), replace=False)
             for _ in range(M)]
    lists[2] = np.zeros(0, int)
    lists[4] = np.concatenate([lists[4], lists[4][:1]])
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    sel = np.concatenate(lists).astype(int)
    return (torch.as_tensor(base_s[sel]), torch.as_tensor(base_c[sel]),
            torch.as_tensor(offsets))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transposed_ranges_equal_image_lists(seed):
    """transpose_ranges: each image's multiset of ranges (start, count) is
    its CSR list, empty images and repeats included; the keys ascend and a
    range's images ascend; `first` opens each distinct range once."""
    starts, counts, offsets = _ranges(seed)
    tr = zb.transpose_ranges(starts, counts, offsets)
    M = offsets.shape[0] - 1
    assert tr.start.shape == starts.shape and tr.image.dtype == torch.int32
    key = (tr.start << 32) | tr.count
    assert bool((key[1:] >= key[:-1]).all())
    same = key[1:] == key[:-1]
    assert bool((tr.image[1:][same] >= tr.image[:-1][same]).all())
    assert tr.first.tolist() == [True] + (~same).tolist()
    for m in range(M):
        lo, hi = int(offsets[m]), int(offsets[m + 1])
        want = sorted(zip(starts[lo:hi].tolist(), counts[lo:hi].tolist()))
        at = tr.image == m
        got = sorted(zip(tr.start[at].tolist(), tr.count[at].tolist()))
        assert got == want, m
    assert not bool((tr.image == 2).any())


@pytest.mark.parametrize("piece", [64, zb.PIECE])
def test_range_pieces_cover_each_range_once(piece):
    """range_pieces: a distinct range's pieces tile its points in order,
    each at most `piece` long (an empty range has none), and carry the
    range's run of sorted pairs."""
    starts, counts, offsets = _ranges(4)
    tr = zb.transpose_ranges(starts, counts, offsets)
    pc = zb.range_pieces(tr, piece)
    assert int(pc.count.max()) <= piece and int(pc.count.min()) > 0
    key = (tr.start << 32) | tr.count
    firsts = torch.nonzero(tr.first).squeeze(1).tolist() + [key.shape[0]]
    covered = {}
    for p in range(pc.start.shape[0]):
        lo, hi = int(pc.pair_lo[p]), int(pc.pair_hi[p])
        assert lo in firsts and hi == firsts[firsts.index(lo) + 1]
        k = int(key[lo])
        covered.setdefault(k, []).append((int(pc.start[p]),
                                          int(pc.count[p])))
    for a, b in zip(firsts[:-1], firsts[1:]):
        s, c = int(tr.start[a]), int(tr.count[a])
        runs = covered.get(int(key[a]), [])
        assert sum(n for _, n in runs) == c
        at = s
        for s_p, n in runs:
            assert s_p == at
            at += n


def _behind_all(points, r, t):
    """True where every point fails the kernel's Z gate through the Z row
    r (3,), t (float32)."""
    R = [torch.tensor(0.0)] * 6 + [torch.tensor(float(v)) for v in r] \
        + [torch.tensor(0.0)] * 2 + [torch.tensor(float(t))]
    R = [x.float() for x in R]
    Z = zb._row(R, 2, *torch.as_tensor(points).unbind(1))
    return bool((Z < 1e-3).all()), Z


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(rot=st.tuples(*[st.floats(-3.1, 3.1)] * 3),
       scale=st.sampled_from([1e-3, 0.1, 1.0, 30.0, 1e4]),
       shift=st.floats(-3.0, 3.0), ulps=st.integers(-6, 6),
       seed=st.integers(0, 2 ** 31 - 1))
def test_cull_never_drops_a_point_in_front(rot, scale, shift, ulps, seed):
    """The cull's plain mirror (cull_z, the kernel's test): where it
    culls a box, no point of the box passes Z >= 1e-3 through the float32
    chain (_row).  Each pose puts the box's nearest point a few ulps from
    Z = 1e-3 after a shift of up to three times the cull's margin either
    way (about a sixth of 300 boxes are culled), the box's eight corners
    among its points."""
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-1, 1, size=(40, 3)) * scale).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    pts[:8] = [[(lo, hi)[(c >> d) & 1][d] for d in range(3)]
               for c in range(8)]
    r = Rotation.from_rotvec(rot).as_matrix()[2].astype(np.float32)
    _, Z0 = _behind_all(pts, r, np.float32(0.0))
    j = int(torch.argmax(Z0))
    mag = float(np.maximum(np.abs(r * lo), np.abs(r * hi)).sum())
    t = np.float32(1e-3 - float(Z0[j]) + shift * zb.CULL_MARGIN * mag)
    for _ in range(abs(ulps)):
        t = np.nextafter(t, np.float32(np.sign(ulps) * np.inf))
    behind, Z = _behind_all(pts, r, t)
    culled = bool(zb.cull_z(torch.as_tensor(r)[None], torch.tensor([t]),
                            torch.as_tensor(lo)[None],
                            torch.as_tensor(hi)[None])[0])
    assert behind or not culled, (float(Z.max()), t)


def test_cull_removes_boxes_behind_and_keeps_the_rest():
    """cull_z culls a box wholly behind the camera, keeps one that
    straddles Z = 1e-3 or lies in front, one seen through a NaN pose and
    the empty box of points whose Z coordinate is all NaN (lo = +inf,
    hi = -inf, as the kernel's fminf / fmaxf leave it)."""
    inf = float("inf")
    r = torch.tensor([[0.0, 0.0, 1.0]] * 5)
    t = torch.tensor([0.0, 0.0, 0.0, float("nan"), 0.0])
    lo = torch.tensor([[-1, -1, -5.0], [-1, -1, -1.0], [-1, -1, 2.0],
                       [-1, -1, -5.0], [-1, -1, inf]])
    hi = torch.tensor([[1, 1, -2.0], [1, 1, 1.0], [1, 1, 3.0],
                       [1, 1, -2.0], [1, 1, -inf]])
    assert zb.cull_z(r, t, lo, hi).tolist() == [True, False, False, False,
                                                 False]


def test_work_counts_the_cull(scene):
    """work(): every (piece, image) pair the mirror culls has no point in
    front; the kept pairs' points and the pairs add up; the bound's
    operations count the kept pairs' Z rows."""
    js, gm, Rcw, tcw = scene
    sc = js.lidar
    starts, counts, offsets = depth.image_ranges(gm, sc.times, js.image_times)
    args = [torch.as_tensor(a) for a in (gm.points, starts, counts, offsets,
                                         Rcw, tcw)]
    w = zb.work(*args, js.cam)
    pc = zb.range_pieces(zb.transpose_ranges(*args[1:4]))
    piece, img, kept = zb.cull_pairs(args[0], pc, args[4], args[5])
    assert w["pairs"] == kept.numel() and w["culled"] == int((~kept).sum())
    assert 0 < w["culled"] < w["pairs"]
    assert w["covisible"] == int(counts.sum())
    cams = zb._cams(args[4], args[5], torch.device("cpu"))
    for p, m in zip(piece[~kept].tolist(), img[~kept].tolist()):
        s, c = int(pc.start[p]), int(pc.count[p])
        Z = zb._row(cams[m].unbind(), 2, *args[0][s:s + c].unbind(1))
        assert not bool((Z >= 1e-3).any())
    assert w["ops"][1] == zb.ZBUFFER_Z_OPS[1] * w["kept_points"] + (
        zb.ZBUFFER_OPS[1] - zb.ZBUFFER_Z_OPS[1]) * w["in_front"]


def test_entry_points_need_a_card_unless_asked_for_the_cpu(scene,
                                                           monkeypatch):
    """render_depth_maps, colorize_clouds and undistort_images run on the
    card by default: with no card they raise, and run with
    device="cpu"."""
    from global_lvba_tpu_torch.pipeline import outputs

    js, gm, Rcw, tcw = scene
    sc = js.lidar
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((js.cam.height, js.cam.width, 3), np.uint8)
    clouds = [sc.points_body[sc.frame_ids == i] for i in range(2)]
    calls = {
        "render_depth_maps": lambda **k: depth.render_depth_maps(
            js.cam, gm, sc.times, js.image_times[:1], Rcw[:1], tcw[:1],
            **k),
        "colorize_clouds": lambda **k: outputs.colorize_clouds(
            js.cam, clouds, sc.times[:2], sc.R_true[:2], sc.p_true[:2],
            js.image_times[:1], [img], Rcw[:1], tcw[:1], **k),
        "undistort_images": lambda **k: outputs.undistort_images(
            js.cam, [img], **k),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert call(device="cpu") is not None, name
