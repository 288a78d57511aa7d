"""Peaks of one NVIDIA H100 SXM and the least time each piece of work could
take on it: the yardstick of every roofline and mfu metric.

The peaks are NVIDIA's data sheet (dense, no sparsity, at the full 700-W
power limit). The operation and byte counts are copied from chip_smoke.py
(`roofline`, `nbytes`, DYN_FLOPS, ADV_FLOPS, NS_PRODUCTS and the operands of
check_dyn, check_adv and check_invsqrt) and from
scale_letkf_torch/bench_fullsize.py (the SI step's byte model), computed
from shapes alone: every input byte read once, every output byte written
once, so each bound is a lower bound and a share of it cannot pass 100%.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
F32 = 4
# operations per output point, counted from the plain versions'
# expressions: kernel #2 (dyn_tendency) with ∇⁴ on its four fields, kernel
# #3 (adv_ud3) per tracer point with ∇⁴; kernel #1 (invsqrt_ns): 3
# products per Newton–Schulz iteration (18 + 2), the re-anchor and Z·Z
DYN_FLOPS = 224
ADV_FLOPS = 62
NS_PRODUCTS = 3 * (18 + 2) + 2
NQ = 6


def bound_s(nbytes: float, flops: float, flop_per_s: float) -> float:
    """The least seconds for work moving nbytes and doing flops."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


def dyn_tendency_s(members: int, nz: int, ny: int, nx: int) -> float:
    """Kernel #2 over `members` members: reads ρ, ρu, ρv, ρθ, p′ and ρw,
    writes the five tendencies."""
    n, nw = members * nz * ny * nx, members * (nz + 1) * ny * nx
    return bound_s(F32 * (9 * n + 2 * nw), DYN_FLOPS * n, FP32_FLOP_PER_S)


def adv_ud3_s(members: int, nz: int, ny: int, nx: int) -> float:
    """Kernel #3 over `members` members: reads the NQ tracers, ρ, ρu, ρv
    and ρw, writes the NQ tendencies."""
    n, nw = members * nz * ny * nx, members * (nz + 1) * ny * nx
    return bound_s(F32 * ((2 * NQ + 3) * n + nw), ADV_FLOPS * NQ * n,
                   FP32_FLOP_PER_S)


def invsqrt_s(grams: int, K: int) -> float:
    """Kernel #1 over `grams` K×K Grams padded to kp = ⌈K/64⌉·64: reads a
    and areg, writes C^-1/2 and C^-1; every product three TF32 passes."""
    kp = -(-K // 64) * 64
    return bound_s(4 * F32 * grams * kp * kp,
                   NS_PRODUCTS * 2.0 * kp ** 3 * grams, TF32_FLOP_PER_S / 3)


def si_step_bytes(nz: int, ny: int, nx: int, n_small: int,
                  phys_interval: int = 0) -> float:
    """Bytes a member-step of the split-explicit step moves at least: 11
    float32 fields S; 3 stages of slow tendencies (read the state, write
    the tendency: 2S), the acoustic substeps (5 deviation fields read and
    written: 10/11 S each), and a physics step (2S) every phys_interval
    steps where the composition runs physics."""
    S = 11 * nz * ny * nx * F32
    ns_total = max(1, n_small // 3) + max(1, n_small // 2) + n_small
    phys = 2 * S / phys_interval if phys_interval > 0 else 0.0
    return 3 * 2 * S + ns_total * (10 / 11) * S + phys


def analysis_s(points: int, K: int, local_obs: float, nv: int = 11) -> float:
    """The least seconds of a LETKF analysis of `points` gridpoints with
    local_obs selected obs in all: the ensemble read and written once; the
    Grams (2·L·K² each, FP32), kernel #1's products (TF32, three passes)
    and the weight application (2·K²·nv a point, FP32)."""
    kp = -(-K // 64) * 64
    nbytes = 2 * F32 * K * nv * points
    ops_s = ((2.0 * local_obs * K * K + 2.0 * K * K * nv * points)
             / FP32_FLOP_PER_S
             + NS_PRODUCTS * 2.0 * kp ** 3 * points / (TF32_FLOP_PER_S / 3))
    return max(nbytes / HBM_BYTES_PER_S, ops_s)
