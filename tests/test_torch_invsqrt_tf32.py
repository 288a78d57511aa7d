"""The 3xTF32 numerics of the invsqrt_ns CUDA kernel, predicted on the CPU.

The kernel (scale_letkf_torch/csrc/invsqrt_ns.cu) runs every product of the
fused Newton–Schulz iteration on the tensor cores with a 3xTF32 split: each
operand element x becomes hi = x rounded to TF32 (to nearest, ties away
from zero, as `cvt.rna.tf32.f32` rounds) and lo = x − hi cut to TF32
(toward zero), and every k-step of 8 accumulates lo·hi and hi·lo, then
hi·hi, into one float32 accumulator. This file emulates those products in
torch float32 — both roundings by integer operations on the bits — runs
its own copy of the fused iteration on them, and holds the result to
the bounds the kernel is held to on the card: float64 eigh at
tests/test_torch_invsqrt.py's bounds, and invsqrt_ns_plain (full FP32) at
chip_smoke.py's TOL_RANDOM. It is the CPU prediction of the kernel's error.
"""

import numpy as np
import pytest
import torch

from scale_letkf_torch.ops import invsqrt

torch.set_num_threads(1)

CASES = [(K, cond) for K in (20, 50, 100) for cond in (1e2, 1e3, 1e4)]
TOL_F64 = {1e2: 2e-5, 1e3: 1e-4, 1e4: 1e-3}     # test_torch_invsqrt.py
TOL_PLAIN = {1e2: 1e-4, 1e3: 1e-4, 1e4: 1e-3}   # chip_smoke.py TOL_RANDOM


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as cvt.rna.tf32.f32 rounds: to nearest, ties
    away from zero, 10 mantissa bits kept (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """float32 cut to TF32 (toward zero: the low 13 bits cleared)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """The kernel's split: x = hi + lo to 2^-21, hi = tf32(x),
    lo = tf32_cut(x − hi)."""
    hi = tf32(x)
    return hi, tf32_cut(x - hi)


def mm3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched x @ w in the kernel's 3xTF32 order: per k-step of 8, lo·hi
    and hi·lo, then hi·hi, each summed in float32 into one accumulator."""
    xh, xl = split(x)
    wh, wl = split(w)
    acc = torch.zeros(x.shape[:-1] + w.shape[-1:], dtype=torch.float32)
    for k in range(0, x.shape[-1], 8):
        ks = slice(k, k + 8)
        acc = acc + xl[..., ks] @ wh[..., ks, :]
        acc = acc + xh[..., ks] @ wl[..., ks, :]
        acc = acc + xh[..., ks] @ wh[..., ks, :]
    return acc


def ns_3xtf32(a, areg, it_lo=18, it_hi=2):
    """invsqrt_ns_plain's algorithm with every product by mm3."""
    eye = torch.eye(a.shape[-1])

    def step(y, z):
        t = 1.5 * eye - 0.5 * mm3(z, y)
        return mm3(y, t), mm3(t, z)

    y, z = areg, eye.expand_as(a)
    for _ in range(it_lo):
        y, z = step(y, z)
    y = mm3(a, z)
    for _ in range(it_hi):
        y, z = step(y, z)
    z = 0.5 * (z + z.transpose(-1, -2))
    return z, mm3(z, z)


def _spd_batch(rng, B, K, cond):
    """tests/test_invsqrt.py's LETKF-shaped Grams hᵀh·scale/40 + (K-1)·I."""
    scale = (cond - 1.0) * (K - 1) / (1.0 + np.sqrt(K / 40.0)) ** 2
    h = rng.standard_normal((B, 40, K))
    return np.einsum("blk,blj->bkj", h, h) * (scale / 40) + (K - 1) * np.eye(K)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32 spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 * 0.99,
                      one + ulp * 1.5, 3.0, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         0.0, -0.0], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert not (got.view(torch.int32) & 0x1FFF).any()
    cut = tf32_cut(x)
    assert torch.equal(cut, torch.tensor([one, -one, one, one + ulp, 3.0, 0.0,
                                          -0.0], dtype=torch.float32))


def test_split_reconstructs_to_2_pow_minus_21():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 16)
         * 10.0 ** rng.uniform(-30, 30, 1 << 16)).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, lo = split(xt)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = np.abs(hi.double().numpy() + lo.double().numpy() - x)
    assert np.all(err <= 2.0 ** -21 * np.abs(x))


def test_3xtf32_product_is_fp32_accurate():
    """Against float64, a 3xTF32 product keeps float32's accuracy where one
    TF32 pass loses three digits."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64, 64)).astype(np.float32)
    w = rng.standard_normal((4, 64, 64)).astype(np.float32)
    ref = x.astype(np.float64) @ w.astype(np.float64)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    scale = np.abs(ref).max()
    err3 = np.abs(mm3(xt, wt).double().numpy() - ref).max() / scale
    err32 = np.abs((xt @ wt).double().numpy() - ref).max() / scale
    err1 = np.abs((tf32(xt) @ tf32(wt)).double().numpy() - ref).max() / scale
    assert err3 <= 4 * max(err32, 2.0 ** -24), (err3, err32)
    assert err1 > 100 * err3


@pytest.mark.parametrize("K,cond", CASES)
def test_3xtf32_iteration_matches_eigh_and_plain(K, cond):
    rng = np.random.default_rng(100 + K)
    c = _spd_batch(rng, 8, K, cond)
    w, v = np.linalg.eigh(c)
    isq_ref = np.einsum("bik,bk,bjk->bij", v, 1.0 / np.sqrt(w), v)
    a, areg, cn = invsqrt.ns_operands(torch.from_numpy(c.astype(np.float32)),
                                      torch.full((8,), K - 1.0))
    z, zz = ns_3xtf32(a, areg)
    z_p, zz_p = invsqrt.invsqrt_ns_plain(a, areg)
    assert torch.isfinite(z).all() and torch.isfinite(zz).all()
    isq = (z[:, :K, :K] * torch.rsqrt(cn)[:, None, None]).double().numpy()
    err_f64 = np.abs(isq - isq_ref).max() / np.abs(isq_ref).max()
    assert err_f64 <= TOL_F64[cond], err_f64
    tol = TOL_PLAIN[cond]
    assert float((z - z_p).abs().max()) <= tol * float(z_p.abs().max())
    assert float((zz - zz_p).abs().max()) <= tol * float(zz_p.abs().max())


@pytest.mark.parametrize("K", [20, 50, 100])
def test_3xtf32_iteration_scaled_identity(K):
    """The zero-obs Gram C = s·I comes out as s^{-1/2}·I to 1e-6."""
    s = (K - 1) / 1.25
    c = s * torch.eye(K).expand(2, K, K).contiguous()
    a, areg, cn = invsqrt.ns_operands(c, torch.full((2,), s))
    z, _ = ns_3xtf32(a, areg)
    isq = z[:, :K, :K] * torch.rsqrt(cn)[:, None, None]
    err = float((isq - torch.eye(K) / s ** 0.5).abs().max()) * s ** 0.5
    assert err <= 1e-6, err
