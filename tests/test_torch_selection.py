"""Selection kernels 4 and 5 of the PyTorch port: their plain versions
against the JAX package's Pallas kernels in interpret mode, on the
bf16-split packing the TPU path feeds them (as tests/test_exact_dots.py
runs them), the selection over a list of buckets (one buffer, one launch
on the card) and its launcher's bucket table, and the port's frame table
against the JAX one."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.factors import padding as jpad
from global_lvba_tpu.factors import plane_eigen as jpe
from global_lvba_tpu.map.voxelize import build_voxel_map
from global_lvba_tpu.models.synthetic import make_plane_scene, perturb_poses
from global_lvba_tpu.ops.pallas.selection import entry_reduce, table_select
from global_lvba_tpu_torch.factors import plane_eigen as pe
from global_lvba_tpu_torch.kernels import build, selection as sel


@pytest.fixture(scope="module")
def scene_buckets():
    W = 24
    scene = make_plane_scene(num_frames=W, points_per_frame=600, seed=3)
    vm = build_voxel_map(
        scene.points_body, scene.frame_ids, scene.R_true, scene.p_true,
        voxel_size=1.0, eigen_ratios=(0.2, 0.2, 0.2, 0.2),
    )
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.004, 0.015, seed=1)
    return W, jpad.buckets_to_device(vm, dtype=jnp.float32), Rp, pp


def test_table_select_plain_matches_pallas_bit_exact(scene_buckets):
    W, buckets, Rp, pp = scene_buckets
    tbl = np.concatenate([Rp.reshape(W, 9), pp], axis=1).astype(np.float32)
    tbl3 = jnp.concatenate(jpe._split3_bf16(jnp.asarray(tbl)), axis=1)
    for fa in buckets:
        frame = np.asarray(fa.frame).reshape(-1).copy()
        frame[::7] = W + 3                        # ids >= W select nothing
        g = np.asarray(table_select(jnp.asarray(frame), tbl3, W,
                                    interpret=True))
        want = (g[:12] + g[12:24] + g[24:36]).T   # (VK, 12)
        got = sel.table_select_plain(torch.as_tensor(frame),
                                     torch.as_tensor(tbl)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[::7] == 0).all()
        np.testing.assert_array_equal(got[1::7], tbl[frame[1::7]])


def _planted_ids(frame, P, seed):
    """frame (flat) with the ids -1, P and P + 3 planted at three seeded
    places: each selects a zero row."""
    f = frame.copy()
    pick = np.random.default_rng(seed).choice(f.size, 3, replace=False)
    f[pick] = (-1, P, P + 3)
    return f, pick


def test_table_select_buckets_plain_matches_pallas_bit_exact(scene_buckets):
    """table_select_buckets over all of the fixture's buckets (ids -1, P
    and P + 3 planted in each) gives each bucket the rows of JAX's Pallas
    table_select in interpret mode, bit for bit, as views of one buffer in
    bucket order."""
    W, buckets, Rp, pp = scene_buckets
    assert len(buckets) > 1
    tbl = np.concatenate([Rp.reshape(W, 9), pp], axis=1).astype(np.float32)
    tbl3 = jnp.concatenate(jpe._split3_bf16(jnp.asarray(tbl)), axis=1)
    frames, wants, picks = [], [], []
    for i, fa in enumerate(buckets):
        frame, pick = _planted_ids(np.asarray(fa.frame).reshape(-1), W, i)
        g = np.asarray(table_select(jnp.asarray(frame), tbl3, W,
                                    interpret=True))
        frames.append(torch.as_tensor(frame))
        wants.append((g[:12] + g[12:24] + g[24:36]).T)
        picks.append(pick)
    got = sel.table_select_buckets(frames, torch.as_tensor(tbl))
    assert len(got) == len(frames)
    base = got[0].data_ptr()
    off = 0
    for rows, want, pick, f in zip(got, wants, picks, frames):
        np.testing.assert_array_equal(rows.numpy(), want)
        assert (rows[torch.as_tensor(pick)] == 0).all()
        assert rows.data_ptr() == base + off * 12 * 4    # one buffer
        np.testing.assert_array_equal(
            rows.numpy(), sel.table_select(f, torch.as_tensor(tbl)).numpy())
        off += f.shape[0]
    assert sel.table_select_buckets([], torch.as_tensor(tbl)) == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_table_select_buckets_plain_matches_index_select(dtype):
    """Seeded ids over more buckets than one launch takes, some empty, in
    float32 and float64: each bucket's rows are index_select's where the id
    lies in [0, P), zero elsewhere."""
    rng = np.random.default_rng(7)
    P = 40
    tbl = torch.as_tensor(rng.normal(size=(P, 12))).to(dtype)
    sizes = [int(x) for x in rng.integers(0, 50, sel.SELECT_MAX_BUCKETS + 3)]
    sizes[2] = 0
    frames = [torch.as_tensor(rng.integers(-3, P + 4, n), dtype=torch.int32)
              for n in sizes]
    got = sel.table_select_buckets(frames, tbl)
    for rows, f in zip(got, frames):
        ok = (f >= 0) & (f < P)
        want = torch.index_select(tbl, 0, f.long().clamp(0, P - 1))
        want[~ok] = 0
        assert rows.shape == (f.shape[0], 12) and rows.dtype == dtype
        assert torch.equal(rows, want)


def test_table_select_launcher_matches_the_kernel():
    """table_select_buckets' launches hold at most the kernel's bucket
    table, and the launcher takes the bucket count, the ids, counts and
    first rows per bucket, the table, P, C, the output and the stream
    (float32 and float64 alike)."""
    src = (build.CSRC / "selection.cu").read_text()
    assert (f"constexpr int kMaxSelectBuckets = {sel.SELECT_MAX_BUCKETS};"
            in src)
    for name in ("table_select", "table_select_f64"):
        assert build.SIGNATURES[name][2] == ([build._I] + [build._P] * 4
                                             + [build._I] * 2
                                             + [build._P] * 2)


def _entry_vals(fa, seed, dtype):
    """Random per-entry channels, zero on dead entries (as the chain
    writes them)."""
    n = np.asarray(fa.n).reshape(-1)
    vals = np.random.default_rng(seed).normal(size=(n.size, 30))
    vals[n <= 0] = 0.0
    return vals.astype(dtype)


def test_entry_reduce_plain_matches_pallas(scene_buckets):
    W, buckets, _, _ = scene_buckets
    for i, fa in enumerate(buckets):
        vals = _entry_vals(fa, i, np.float32)
        frame = np.asarray(fa.frame).reshape(-1)
        vals3 = jnp.concatenate(jpe._split3_bf16(jnp.asarray(vals)), axis=1)
        g = np.asarray(entry_reduce(jnp.asarray(frame), vals3, W,
                                    interpret=True))
        want = g[:, :30] + g[:, 30:60] + g[:, 60:90]
        tbl = pe._frame_table_np(frame, np.asarray(fa.n), W)
        got = sel.entry_reduce_plain(torch.as_tensor(vals),
                                     torch.as_tensor(tbl)).numpy()
        # float32 sums over the same entries in another order
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-6)


def test_entry_reduce_plain_matches_add_at(scene_buckets):
    W, buckets, _, _ = scene_buckets
    for i, fa in enumerate(buckets):
        vals = _entry_vals(fa, 10 + i, np.float64)
        frame = np.asarray(fa.frame).reshape(-1)
        want = np.zeros((W, 30))
        np.add.at(want, frame, vals)
        tbl = pe._frame_table_np(frame, np.asarray(fa.n), W)
        got = sel.entry_reduce_plain(torch.as_tensor(vals),
                                     torch.as_tensor(tbl)).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=1e-12)


def test_frame_table_matches_jax(scene_buckets):
    W, buckets, _, _ = scene_buckets
    for fa in buckets:
        frame, n = np.asarray(fa.frame), np.asarray(fa.n)
        np.testing.assert_array_equal(pe._frame_table_np(frame, n, W),
                                      jpe._frame_table_np(frame, n, W))
        t = pe.frame_gather_table(pe.PlaneFactorArrays(
            torch.tensor(n), None, None, torch.tensor(frame)), W)
        assert t.dtype == torch.int32 and t.shape[0] == W
        # entries index the flat (v, k) grid; the sentinel V*K pads rows
        assert int(t.max()) <= n.size and (t.shape[1] % 8) == 0


def _plant_frames(frame, n, W, seed):
    """frame with the ids -1, W and W + 3 planted in live entries: the
    frame tables leave those entries out."""
    f = frame.copy().reshape(-1)
    live = np.flatnonzero(n.reshape(-1) > 0)
    pick = np.random.default_rng(seed).choice(live, 3, replace=False)
    f[pick] = (-1, W, W + 3)
    return f.reshape(frame.shape)


def test_merged_frame_table_equals_the_per_bucket_reduces(scene_buckets):
    """One entry_reduce through the merged table of all buckets over their
    concatenated per-entry channels equals the sum of the per-bucket
    reduces (float64, 1e-12 of max |.|), with out-of-range frame ids
    planted in every bucket (left out of both) and out-of-range indices
    planted in the merged table (adding nothing)."""
    W, buckets, _, _ = scene_buckets
    assert len(buckets) > 1
    fas, vals, per = [], [], []
    for i, b in enumerate(buckets):
        n = np.asarray(b.n).astype(np.float64)
        frame = _plant_frames(np.asarray(b.frame), n, W, i)
        fa = pe.PlaneFactorArrays(torch.as_tensor(n), None, None,
                                  torch.as_tensor(frame))
        v = torch.as_tensor(_entry_vals(b, 20 + i, np.float64))
        fas.append(fa)
        vals.append(v)
        per.append(sel.entry_reduce_plain(v, pe.frame_gather_table(fa, W)))
    merged = pe.buckets_frame_table(fas, W)
    E = sum(v.shape[0] for v in vals)
    assert merged.dtype == torch.int32 and merged.shape[0] == W
    assert merged.shape[1] % 8 == 0 and int(merged.max()) == E
    allv = torch.cat(vals)
    got = sel.entry_reduce_plain(allv, merged).numpy()
    want = sum(per).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-12)
    # against np.add.at over the live in-range entries
    frame = np.concatenate([fa.frame.numpy().reshape(-1) for fa in fas])
    n = np.concatenate([fa.n.numpy().reshape(-1) for fa in fas])
    ok = (n > 0) & (frame >= 0) & (frame < W)
    assert int((n > 0).sum() - ok.sum()) == 3 * len(fas)
    ref = np.zeros((W, 30))
    np.add.at(ref, frame[ok], allv.numpy()[ok])
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-12)
    # out-of-range indices in the table add nothing
    planted = merged.clone()
    pad = planted == E
    rows = torch.nonzero(pad.any(dim=1)).reshape(-1)[:4]
    for r, bad in zip(rows.tolist(), (-1, E + 1, E + 3, 2 ** 31 - 1)):
        planted[r, int(torch.nonzero(pad[r])[0])] = bad
    assert not torch.equal(planted, merged)
    assert torch.equal(sel.entry_reduce_plain(allv, planted),
                       sel.entry_reduce_plain(allv, merged))


def test_frame_gather_table_is_the_one_bucket_merge(scene_buckets):
    W, buckets, _, _ = scene_buckets
    for fa in buckets:
        t = pe.PlaneFactorArrays(torch.as_tensor(np.array(fa.n)), None,
                                 None, torch.as_tensor(np.array(fa.frame)))
        assert torch.equal(pe.frame_gather_table(t, W),
                           pe.buckets_frame_table([t], W))
    with pytest.raises(ValueError, match="no bucketed"):
        pe.buckets_frame_table([], W)
