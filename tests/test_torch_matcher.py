"""Matcher kernel 6 of the PyTorch port: its plain version against the JAX
package's Pallas kernel in interpret mode (the shapes of
tests/test_pallas_matcher.py), exact ties, ragged tails, invalid slots,
and the port's match_pair / match_pair_arrays / match_all_pairs against
the JAX ones (float32 on the CPU, as the JAX matcher runs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.frontend import matching as jm
from global_lvba_tpu.ops.pallas.matcher import top2_similarity as j_top2
from global_lvba_tpu_torch.frontend import matching as pm
from global_lvba_tpu_torch.kernels import matcher as km


def _unit(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _plain(d1, d2, v1=None, v2=None):
    t = lambda x: None if x is None else torch.as_tensor(x)
    vals, idx, col = km.top2_similarity(t(d1), t(d2), t(v1), t(v2))
    return vals.numpy(), idx.numpy(), col.numpy()


@pytest.mark.parametrize("shape,seed,tail", [((512, 1024), 0, False),
                                             ((256, 768), 2, True),
                                             ((256, 256), 1, False)])
def test_plain_matches_pallas_interpret(shape, seed, tail):
    rng = np.random.default_rng(seed)
    d1, d2 = _unit(rng, shape[0]), _unit(rng, shape[1])
    if tail:   # the global best in the last, partial column tile
        d2[700], d2[730] = d1[3], d1[77]
    vals, idx, col = j_top2(jnp.asarray(d1), jnp.asarray(d2), tm=256, tn=512,
                            interpret=True)
    got = _plain(d1, d2)
    # float32 dots of unit vectors in another summation order
    np.testing.assert_allclose(got[0], np.asarray(vals), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], np.asarray(idx))
    np.testing.assert_array_equal(got[2], np.asarray(col))
    if tail:
        assert got[1][3] == 700 and got[1][77] == 730


def test_exact_ties_take_the_lowest_index():
    rng = np.random.default_rng(4)
    d1, d2 = _unit(rng, 64), _unit(rng, 300)
    d2[[40, 170, 299]] = d1[5]          # three identical best columns
    d1[[9, 60]] = d2[11]                # two identical best rows
    vals, idx, col = _plain(d1, d2)
    assert idx[5] == 40 and vals[5, 0] == vals[5, 1]
    assert col[11] == 9
    sim = d1 @ d2.T
    np.testing.assert_array_equal(idx, sim.argmax(1))
    np.testing.assert_array_equal(col, sim.argmax(0))


def test_invalid_rows_and_columns():
    rng = np.random.default_rng(5)
    d1, d2 = _unit(rng, 100), _unit(rng, 90)
    d2[:10] = d1[:10]                   # perfect matches, then masked
    v1 = np.ones(100, bool)
    v2 = np.ones(90, bool)
    v1[[0, 1]] = False
    v2[[2, 3]] = False
    v2[50:] = False
    vals, idx, col = _plain(d1, d2, v1, v2)
    sim = np.where(v1[:, None] & v2[None, :], d1 @ d2.T, -2.0)
    np.testing.assert_array_equal(idx, sim.argmax(1))
    np.testing.assert_array_equal(col, sim.argmax(0))
    np.testing.assert_allclose(vals, -np.sort(-sim, axis=1)[:, :2], atol=1e-6)
    assert (vals[[0, 1]] == -2.0).all() and (col[50:] == 0).all()
    j, ok = pm.match_pair(*(torch.as_tensor(x) for x in (d1, v1, d2, v2)))
    assert set(np.flatnonzero(ok.numpy())) >= {4, 5, 6, 7, 8, 9}
    assert not ok.numpy()[[0, 1, 2, 3]].any()


@pytest.fixture(scope="module")
def descriptor_sets():
    """Five sets of 200 slots: noisy copies of one set (so pairs match) and
    random masks."""
    rng = np.random.default_rng(7)
    base = _unit(rng, 200)
    descs, valids = [], []
    for k in range(5):
        d = base + rng.normal(scale=0.04, size=base.shape).astype(np.float32)
        d = d[rng.permutation(200)] if k % 2 else d
        descs.append((d / np.linalg.norm(d, axis=1, keepdims=True))
                     .astype(np.float32))
        valids.append(rng.uniform(size=200) > 0.15)
    return descs, valids


def test_match_pair_matches_jax(descriptor_sets):
    descs, valids = descriptor_sets
    args = (descs[0], valids[0], descs[2], valids[2])
    j, ok = pm.match_pair(*(torch.as_tensor(x) for x in args))
    jj, jok = jm.match_pair(*(jnp.asarray(x) for x in args), 0.7, 0.8)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(j.numpy()[ok.numpy()],
                                  np.asarray(jj)[np.asarray(jok)])
    assert ok.numpy().sum() > 100


def test_match_pair_arrays_matches_jax(descriptor_sets):
    descs, valids = descriptor_sets
    got = pm.match_pair_arrays(descs[1], descs[3][:150], valids[1],
                               valids[3][:150], device="cpu")
    want = jm.match_pair_arrays(descs[1], descs[3][:150], valids[1],
                                valids[3][:150], use_pallas=False)
    assert got.dtype == np.int32 and got.shape[0] > 50
    np.testing.assert_array_equal(got, want)
    empty = pm.match_pair_arrays(descs[0][:0], descs[1], device="cpu")
    assert empty.shape == (0, 2)


def test_match_all_pairs_matches_jax(descriptor_sets):
    descs, valids = descriptor_sets
    pairs = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    # a chunk of 4 leaves a partial last chunk (10 pairs)
    got = pm.match_all_pairs(descs, valids, pairs, chunk=4, min_matches=3,
                             device="cpu")
    want = jm.match_all_pairs(descs, valids, pairs, chunk=4, min_matches=3)
    assert set(got) == set(want) == set(pairs)
    for key in pairs:
        np.testing.assert_array_equal(got[key], want[key])
    # mixed shapes go pair by pair
    mixed = [descs[0], descs[1][:120]]
    got = pm.match_all_pairs(mixed, [valids[0], valids[1][:120]], [(0, 1)],
                             device="cpu")
    want = jm.match_all_pairs(mixed, [valids[0], valids[1][:120]], [(0, 1)])
    np.testing.assert_array_equal(got[(0, 1)], want[(0, 1)])


def test_batched_pairs_equal_single_pairs(descriptor_sets):
    descs, valids = descriptor_sets
    d_all = torch.as_tensor(np.stack(descs))
    v_all = torch.as_tensor(np.stack(valids))
    ia = torch.tensor([0, 3, 4], dtype=torch.int32)
    ib = torch.tensor([2, 1, 4], dtype=torch.int32)
    vals, idx, col = km.top2_similarity(d_all, d_all, v_all, v_all, ia, ib)
    assert vals.shape == (3, 200, 2) and col.shape == (3, 200)
    for p, (a, b) in enumerate(zip(ia.tolist(), ib.tolist())):
        one = km.top2_similarity(d_all[a], d_all[b], v_all[a], v_all[b])
        for x, y in zip((vals[p], idx[p], col[p]), one):
            assert torch.equal(x, y)
    with pytest.raises(ValueError):
        km.top2_similarity(d_all, d_all)           # stacks need pair lists


@pytest.mark.parametrize("pair", [(0, 5), (5, 0), (-1, 2), (2, -1)])
def test_pairs_outside_the_stack_raise(descriptor_sets, pair):
    """A pair index outside [0, N) raises on the host (a negative one
    would wrap around in torch indexing, and the kernel must never read
    past its stacks)."""
    descs, valids = descriptor_sets
    with pytest.raises(ValueError):
        pm.match_all_pairs(descs, valids, [(0, 1), pair], device="cpu")
    d_all = torch.as_tensor(np.stack(descs))
    v_all = torch.as_tensor(np.stack(valids))
    ia = torch.tensor([0, pair[0]], dtype=torch.int32)
    ib = torch.tensor([1, pair[1]], dtype=torch.int32)
    with pytest.raises(IndexError):
        km.top2_similarity(d_all, d_all, v_all, v_all, ia, ib)


# ---- the kernel's work units (csrc/matcher.cu), emulated on the CPU ----

def _ends(v, K):
    """1 + the last valid slot (0 if none), as the kernel's valid_end."""
    if v is None:
        return K
    nz = np.flatnonzero(v)
    return int(nz[-1]) + 1 if nz.size else 0


def _masks(kind, K, rng):
    v = np.zeros(K, bool)
    if kind == "leading":
        v[:max(1, K * 2 // 3)] = True
    elif kind == "scattered":
        v = rng.uniform(size=K) > 0.5
    elif kind == "one":
        v[K // 2] = True
    elif kind == "all":
        v[:] = True
    return v      # "none": no valid slot


MASKS = ["leading", "scattered", "empty", "one", "all"]


@pytest.mark.parametrize("K1,K2", [(1, 1), (2, 300), (128, 129),
                                   (300, 2), (129, 640), (2048, 2048)])
def test_unit_plan_covers_every_valid_tile_once(K1, K2):
    """Over the P·R·C units, every (row tile, column tile) of a pair that
    holds a valid (row, column) product is computed by exactly one unit,
    and no unit computes a tile past the last valid row or column."""
    rng = np.random.default_rng(K1 + K2)
    R, C = km.unit_grid(K1, K2)
    for ka in MASKS:
        for kb in MASKS:
            va, vb = _masks(ka, K1, rng), _masks(kb, K2, rng)
            a_end, b_end = _ends(va, K1), _ends(vb, K2)
            seen = {}
            for rt in range(R):
                for cu in range(C):
                    plan = km.unit_plan(rt, cu, K1, K2, a_end, b_end)
                    if plan is None:
                        continue
                    cols, c_stop, c_hi = plan
                    assert cols[0] == cu * km.UNIT_COLS and c_stop <= c_hi
                    assert all(c < b_end for c in cols)
                    for c0 in cols:
                        seen[(rt, c0)] = seen.get((rt, c0), 0) + 1
            assert all(n == 1 for n in seen.values())
            for rt in range(R):
                rows = va[rt * km.ROW_TILE:(rt + 1) * km.ROW_TILE]
                for c0 in range(0, K2, km.COL_TILE):
                    cols = vb[c0:c0 + km.COL_TILE]
                    if rows.any() and cols.any():
                        assert (rt, c0) in seen


def _merge(s, o):
    """The kernel's (best, second, index) merge, over rows (torch)."""
    b, sec, i = s
    ob, osec, oi = o
    take = (ob > b) | ((ob == b) & (oi < i))
    second = torch.maximum(torch.minimum(b, ob), torch.maximum(sec, osec))
    return torch.where(take, ob, b), second, torch.where(take, oi, i)


def _take_best(s, o):
    b, i = s
    ob, oi = o
    take = (ob > b) | ((ob == b) & (oi < i))
    return torch.where(take, ob, b), torch.where(take, oi, i)


def _tile_top2(sim, c0):
    """(best, second, index) of each row of a column tile."""
    n = sim.shape[1]
    best, arg = sim.max(dim=1)
    second = (torch.topk(sim, 2, dim=1).values[:, 1] if n > 1
              else torch.full_like(best, float("-inf")))
    return best, second, arg.to(torch.int64) + c0


def _emulate(d1, d2, v1, v2):
    """top2_similarity as the kernel decomposes it: units, their row and
    column partials (column tiles merged into a running state, closed
    forms for what a unit skips), then the reduction in order; the
    products are the plain version's."""
    K1, K2 = d1.shape[0], d2.shape[0]
    sim = torch.bmm(torch.as_tensor(d1)[None],
                    torch.as_tensor(d2)[None].transpose(1, 2))[0]
    ok = torch.as_tensor(v1)[:, None] & torch.as_tensor(v2)[None, :]
    sim = torch.where(ok, sim, torch.full_like(sim, -2.0))
    a_end, b_end = _ends(v1, K1), _ends(v2, K2)
    R, C = km.unit_grid(K1, K2)
    ninf = float("-inf")
    rows = [[None] * C for _ in range(R)]
    cols = [[None] * C for _ in range(R)]
    for rt in range(R):
        r_lo, r_hi = rt * km.ROW_TILE, min((rt + 1) * km.ROW_TILE, K1)
        n = r_hi - r_lo
        for cu in range(C):
            c_lo = cu * km.UNIT_COLS
            c_hi = min(c_lo + km.UNIT_COLS, K2)
            plan = km.unit_plan(rt, cu, K1, K2, a_end, b_end)
            if plan is None:
                rows[rt][cu] = (torch.full((n,), -2.0),
                                torch.full((n,), -2.0 if c_hi - c_lo > 1
                                           else ninf),
                                torch.full((n,), c_lo, dtype=torch.int64))
                cols[rt][cu] = (torch.full((c_hi - c_lo,), -2.0),
                                torch.full((c_hi - c_lo,), r_lo,
                                           dtype=torch.int64))
                continue
            tiles, c_stop, c_hi = plan
            st = (torch.full((n,), ninf), torch.full((n,), ninf),
                  torch.full((n,), 2 ** 31 - 1, dtype=torch.int64))
            cv, ci = [], []
            for c0 in tiles:
                c1 = min(c0 + km.COL_TILE, K2)
                tile = sim[r_lo:r_hi, c0:c1]
                st = _merge(st, _tile_top2(tile, c0))
                b, a = tile.max(dim=0)
                cv.append(b)
                ci.append(a.to(torch.int64) + r_lo)
            if c_stop < c_hi:
                st = _merge(st, (torch.full((n,), -2.0),
                                 torch.full((n,), -2.0 if c_hi - c_stop > 1
                                            else ninf),
                                 torch.full((n,), c_stop,
                                            dtype=torch.int64)))
                cv.append(torch.full((c_hi - c_stop,), -2.0))
                ci.append(torch.full((c_hi - c_stop,), r_lo,
                                     dtype=torch.int64))
            rows[rt][cu] = st
            cols[rt][cu] = (torch.cat(cv), torch.cat(ci))
    vals, idx = [], []
    for rt in range(R):
        s = rows[rt][0]
        for cu in range(1, C):
            s = _merge(s, rows[rt][cu])
        vals.append(torch.stack([s[0], s[1]], dim=1))
        idx.append(s[2])
    colarg = []
    for cu in range(C):
        s = cols[0][cu]
        for rt in range(1, R):
            s = _take_best(s, cols[rt][cu])
        colarg.append(s[1])
    return (torch.cat(vals), torch.cat(idx).to(torch.int32),
            torch.cat(colarg).to(torch.int32))


@pytest.mark.parametrize("K1,K2,ka,kb", [
    (300, 2000, "all", "all"), (300, 2000, "leading", "scattered"),
    (129, 640, "scattered", "leading"), (128, 129, "empty", "all"),
    (2, 300, "one", "one"), (1, 1, "all", "all"), (300, 2, "all", "empty"),
    (640, 513, "leading", "leading")])
def test_unit_decomposition_equals_plain_bit_for_bit(K1, K2, ka, kb):
    """The work units and their merges give top2_similarity_plain's
    values and indices bit for bit, with planted ties and tail winners."""
    rng = np.random.default_rng(K1 * 7 + K2)
    d1, d2 = _unit(rng, K1), _unit(rng, K2)
    v1, v2 = _masks(ka, K1, rng), _masks(kb, K2, rng)
    if K1 > 10 and K2 > 600:
        d2[[40, 300, K2 - 1]] = d1[5]       # identical best columns
        d1[[9, K1 - 2]] = d2[11]            # identical best rows
        d2[K2 - 3] = d1[3]                  # a best column in the tail
    got = _emulate(d1, d2, v1, v2)
    want = km.top2_similarity_plain(*(torch.as_tensor(x)
                                      for x in (d1, d2, v1, v2)))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
