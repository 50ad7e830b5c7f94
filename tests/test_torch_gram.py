"""Gram kernel 3 (syrk_, 3xTF32) on the CPU: the tf32 split's plain version
(rounding, reconstruction, layout), the accuracy of the three-product sum,
syrk_plain_ against the JAX Pallas SYRK at precision="highest", and the
wrapper's argument checks and tile schedules (syrk_kernel's and the
float64 syrk_f64_kernel's).  The CUDA kernels themselves
run only on the card (chip_smoke.py holds them to these plain versions)."""

import math

import numpy as np
import pytest
import torch

from global_lvba_tpu.ops.pallas import gram as jgram
from global_lvba_tpu_torch.kernels import gram

F32, F64 = torch.float32, torch.float64


def _operand(Kr, N, seed=0):
    return torch.as_tensor(
        np.random.default_rng(seed).normal(size=(Kr, N)).astype(np.float32))


def _tf32_reference(x: float) -> float:
    """Nearest tf32 value (10 explicit mantissa bits, fp32's exponent
    range), ties away from zero, by exact float64 arithmetic."""
    if x == 0.0 or not math.isfinite(x):
        return x
    _, e = math.frexp(x)                      # |x| = f · 2^e, 0.5 <= f < 1
    quantum = 2.0 ** max(e - 11, -136)        # subnormal fp32: 2^-149 · 2^13
    return math.copysign(math.floor(abs(x) / quantum + 0.5) * quantum, x)


def test_split_hi_and_lo_keep_ten_mantissa_bits():
    hi, lo = gram.tf32_split_plain(_operand(1001, 270))
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).abs().max()) == 0


def test_split_recovers_a():
    A = _operand(1001, 270, seed=1)
    hi, lo = gram.tf32_split_plain(A)
    rec = (hi[:270, :1001].double() + lo[:270, :1001].double()).T
    rel = (rec - A.double()).abs() / A.double().abs()
    assert float(rel.max()) <= 2.0 ** -22


def test_rounding_ties_away_from_zero_on_planted_values():
    u = 2.0 ** -10                                   # tf32's ulp at 1
    planted = [
        (1 + u / 2, 1 + u),                          # tie: away from zero
        (-(1 + u / 2), -(1 + u)),
        (1 + 1.5 * u, 1 + 2 * u),                    # tie on an odd value
        (1 + u / 2 - 2.0 ** -23, 1.0),               # just below the tie
        (2 - u / 4, 2.0),                            # carries into the exponent
        (2.0 ** -137, 2.0 ** -136),                  # subnormal ties: fp32's
        (1.5 * 2.0 ** -136, 2.0 ** -135),            # exponent range kept
    ]
    x = torch.tensor([a for a, _ in planted], dtype=F32)
    got = gram._tf32_rna(x).double().tolist()
    want = [_tf32_reference(float(np.float32(a))) for a, _ in planted]
    assert got == want
    assert got == [b for _, b in planted]


@pytest.mark.parametrize("Kr, N", [(1001, 270), (37, 60), (90, 48), (1, 6),
                                   (33, 7), (64, 128)])
def test_split_layout_zeros_subnormals_negatives_padding(Kr, N):
    A = _operand(Kr, N, seed=Kr + N)
    flat = A.view(-1)
    specials = [0.0, -0.0, 1e-40, -3e-42, -2.5, -1.0000001, 7e-39, -1e-45]
    flat[:len(specials)] = torch.tensor(specials[:flat.numel()], dtype=F32)
    hi, lo = gram.tf32_split_plain(A)
    Np, Krp = gram.padded_shape(Kr, N)
    assert hi.shape == lo.shape == (Np, Krp)
    assert Np % gram.TILE == 0 and Krp % gram.KTILE == 0
    assert hi.dtype == lo.dtype == F32
    # padding: exact zeros outside (N, Kr)
    for t in (hi, lo):
        assert not t[N:].any() and not t[:, Kr:].any()
    # element (k, n) of A at (n, k), each rounded as cvt.rna.tf32.f32
    a = A.double().numpy()
    want_hi = np.vectorize(_tf32_reference)(a)
    want_lo = np.vectorize(_tf32_reference)(
        (A - torch.as_tensor(want_hi, dtype=F32)).double().numpy())
    np.testing.assert_array_equal(hi[:N, :Kr].T.double().numpy(), want_hi)
    np.testing.assert_array_equal(lo[:N, :Kr].T.double().numpy(), want_lo)
    # a normal value keeps its sign in hi
    normal = A.abs() >= 2.0 ** -126
    assert bool((torch.sign(hi[:N, :Kr].T) == torch.sign(A))[normal].all())


def test_split_on_cpu_is_the_plain_version():
    A = _operand(70, 30)
    for k, p in zip(gram.tf32_split(A), gram.tf32_split_plain(A)):
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))


def test_three_products_match_the_gram():
    A = _operand(1001, 270, seed=2)
    hi, lo = gram.tf32_split_plain(A)
    h, l = hi[:270, :1001].double(), lo[:270, :1001].double()
    G3 = l @ h.T + h @ l.T + h @ h.T          # loᵀhi + hiᵀlo + hiᵀhi
    ref = A.double().T @ A.double()
    assert float((G3 - ref).abs().max() / ref.abs().max()) <= 2.0 ** -20


@pytest.mark.parametrize("Kr, N", [(90, 48), (1001, 270), (37, 60)])
def test_syrk_plain_matches_pallas_highest(Kr, N):
    A = np.random.default_rng(Kr).normal(size=(Kr, N))
    want = np.asarray(jgram.syrk(A, precision="highest", interpret=True))
    G0 = np.random.default_rng(N).normal(size=(N, N))
    G0 = G0 + G0.T
    got = gram.syrk_(torch.as_tensor(G0.copy()), torch.as_tensor(A))
    np.testing.assert_allclose(got.numpy() - G0, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_syrk_returns_at_once_on_an_empty_operand():
    g = torch.ones(6, 6, dtype=F32)
    before = dict(gram.LAUNCHES)
    out = gram.syrk_(g, torch.empty(0, 6, dtype=F32))
    assert out is g and bool((g == 1).all()) and gram.LAUNCHES == before


def test_check_args():
    A = torch.zeros(1001, 270, dtype=F32)
    assert gram.check_args(torch.zeros(270, 270, dtype=F32), A) == (
        1001, 270, 384, 1024)
    assert gram.check_args(None, A) == (1001, 270, 384, 1024)
    with pytest.raises(TypeError, match="float32"):
        gram.check_args(torch.zeros(270, 270, dtype=F32), A.double())
    with pytest.raises(TypeError, match="float32"):
        gram.check_args(torch.zeros(270, 270, dtype=F64), A)
    with pytest.raises(ValueError, match="contiguous"):
        gram.check_args(None, torch.zeros(270, 1001, dtype=F32).T)
    with pytest.raises(ValueError, match="gram must be contiguous"):
        gram.check_args(torch.zeros(270, 270, dtype=F32).T, A)
    with pytest.raises(ValueError, match="gram is"):
        gram.check_args(torch.zeros(271, 270, dtype=F32), A)
    with pytest.raises(ValueError, match=r"\(Kr, N\)"):
        gram.check_args(None, torch.zeros(270, dtype=F32))


def test_split_has_no_fallback_off_cpu():
    # syrk_'s own case is in test_torch_plane_eigen.test_no_fallback_off_cpu
    with pytest.raises(ValueError, match="unsupported device"):
        gram.tf32_split(torch.zeros(3, 6, device="meta"))


@pytest.mark.parametrize("tiles, ktiles, sms, want", [
    (300, 128, 132, (264, 3)),    # N = 3,072: two whole waves, 36 x 3 parts
    (300, 1, 132, (300, 1)),      # one k-tile: nothing to split
    (264, 10, 132, (264, 1)),     # whole waves only
    (1, 32, 132, (0, 4)),         # one tile: at most 4 parts
    (1, 2, 132, (0, 2)),          # at most one part per k-tile
    (200, 64, 132, (200, 1)),     # a tail of 68 tiles: no room for 2 parts
])
def test_tile_schedule(tiles, ktiles, sms, want):
    assert gram.tile_schedule(tiles, ktiles, sms) == want


@pytest.mark.parametrize("Kr, N, want", [
    (6144, 3072, (300, 264, 3)),  # aligned W=512: 384 k-tiles, 36 x 3 parts
    (5781, 3072, (300, 264, 3)),  # a corridor chunk
    (96, 3072, (300, 264, 3)),    # 6 k-tiles still split the tail in 3
    (1001, 270, (6, 0, 4)),       # ragged: 63 k-tiles, 6 tiles x 4 parts
    (1001, 60, (1, 0, 4)),
    (16, 60, (1, 1, 1)),          # one k-tile: nothing to split
    (17, 60, (1, 0, 2)),          # two k-tiles: two parts
])
def test_f64_schedule(Kr, N, want):
    assert gram.f64_schedule(Kr, N, 132) == want


@pytest.mark.parametrize("Kr, N, want", [(1001, 270, (384, 1024)),
                                         (4095, 3072, (3072, 4096)),
                                         (32, 128, (128, 32)),
                                         (1, 6, (128, 32))])
def test_padded_shape(Kr, N, want):
    assert gram.padded_shape(Kr, N) == want
