"""Tests of the port that need a CUDA GPU; without one they skip.

This file imports neither jax nor the reference package, so it also runs on
a GPU machine without jax, with the jax-configuring conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The CUDA kernels are held against their plain PyTorch versions on the
card, and the analysis, the forecast, the DA cycle and the ensemble H(x)
(4-D and radar) on the card against the same runs on the CPU (which the
parity tests hold against the reference package).
Stencil bounds per field, relative to max|plain|: 2e-5 for the whole
tendency, 1e-5 for the tracers (the reference's bounds for its Pallas
kernels).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from scale_letkf_torch import gpu_check
from scale_letkf_torch.model import dycore
from scale_letkf_torch.ops import invsqrt, stencil, tendency
from scale_letkf_torch.utils import kernels

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "18km_japan.toml")
CASES = [(K, cond) for K in (20, 50, 100) for cond in (1e2, 1e3, 1e4)]
# kernel vs float64 eigh, relative to max|isq| (tests/test_torch_invsqrt.py)
TOL_F64 = {1e2: 2e-5, 1e3: 1e-4, 1e4: 1e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels run only there")
    from scale_letkf_torch.utils.device import require_cuda
    return require_cuda()


def _spd_batch(rng, B, K, cond):
    """LETKF-shaped Grams hᵀh·scale/40 + (K-1)·I (tests/test_invsqrt.py)."""
    scale = (cond - 1.0) * (K - 1) / (1.0 + np.sqrt(K / 40.0)) ** 2
    h = rng.standard_normal((B, 40, K))
    return np.einsum("blk,blj->bkj", h, h) * (scale / 40) + (K - 1) * np.eye(K)


@pytest.mark.cuda
@pytest.mark.parametrize("K,cond", CASES)
def test_cuda_kernel_matches_plain(cuda_device, K, cond):
    """The kernel against invsqrt_ns_plain: 1e-4·max|isq| up to cond 1e3,
    1e-3 at cond 1e4 (the same algorithm with 3xTF32 tensor-core products
    against FP32 ones; tests/test_torch_invsqrt_tf32.py predicts ≤ 1.5e-5
    and ≤ 1.5e-4)."""
    rng = np.random.default_rng(K)
    c = torch.as_tensor(_spd_batch(rng, 512, K, cond), dtype=torch.float32,
                        device=cuda_device)
    a, areg, _ = invsqrt.ns_operands(
        c, torch.full((512,), K - 1.0, device=cuda_device))
    isq_k, inv_k = invsqrt.invsqrt_ns_kernel(a, areg)
    isq_p, inv_p = invsqrt.invsqrt_ns_plain(a, areg)
    torch.cuda.synchronize()
    tol = 1e-3 if cond > 1e3 else 1e-4
    assert float((isq_k - isq_p).abs().max()) <= tol * float(isq_p.abs().max())
    assert float((inv_k - inv_p).abs().max()) <= tol * float(inv_p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("K,cond", CASES)
def test_cuda_kernel_matches_eigh_bit_repeatable(cuda_device, K, cond):
    """The kernel against float64 eigh at test_torch_invsqrt.py's bounds, and
    two launches on the same operands bit-identical (it has no atomics)."""
    rng = np.random.default_rng(100 + K)
    c = _spd_batch(rng, 64, K, cond)
    w, v = np.linalg.eigh(c)
    isq_ref = np.einsum("bik,bk,bjk->bij", v, 1.0 / np.sqrt(w), v)
    a, areg, cn = invsqrt.ns_operands(
        torch.as_tensor(c, dtype=torch.float32, device=cuda_device),
        torch.full((64,), K - 1.0, device=cuda_device))
    z1, zz1 = invsqrt.invsqrt_ns_kernel(a, areg)
    z2, zz2 = invsqrt.invsqrt_ns_kernel(a, areg)
    torch.cuda.synchronize()
    assert torch.equal(z1, z2) and torch.equal(zz1, zz2)
    isq = (z1[:, :K, :K] * torch.rsqrt(cn)[:, None, None]).double().cpu()
    err = np.abs(isq.numpy() - isq_ref).max() / np.abs(isq_ref).max()
    assert err <= TOL_F64[cond], err


@pytest.mark.cuda
def test_cuda_wrapper_launches_kernel(cuda_device):
    from scale_letkf_torch.utils import kernels
    c = 9.0 * torch.eye(50, device=cuda_device).expand(3, 50, 50).contiguous()
    before = kernels.LAUNCHES["invsqrt_ns"]
    isq, _ = invsqrt.invsqrt_ns(c, torch.full((3,), 9.0, device=cuda_device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["invsqrt_ns"] == before + 1
    torch.testing.assert_close(isq, torch.eye(50, device=cuda_device)
                               .expand(3, 50, 50) / 3.0)
    with pytest.raises(ValueError):
        invsqrt.invsqrt_ns_kernel(torch.eye(64, device=cuda_device)[None],
                                  torch.eye(64)[None])


@pytest.mark.cuda
def test_cuda_analysis_matches_cpu(cuda_device):
    """The coarsened 18-km analysis (K = 20, so the kernel path) on the card
    against the CPU: increments per variable to 1e-4·max|Δ_v| + 2 ulp."""
    from scale_letkf_torch.gpu_check import coarse_analysis_vs_cpu
    res = coarse_analysis_vs_cpu(cuda_device, CONFIG)
    assert res["kernel_launches"] == {"cuda": res["levels"], "cpu": 0}
    assert res["finite"]
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res


def _dyn_state(device, B=2, nz=12, ny=40, nx=64, seed=0):
    """Random states (seeded numpy, scale_letkf_torch/gpu_check.py) with the
    18-km stretched metric and p′ from the moist pressure. Returns (state,
    rho_ref, p_pert, vg)."""
    s, rho_ref, p_pert = gpu_check.random_dyn_state(seed, B, nz, ny, nx,
                                                    device)
    return s, rho_ref, p_pert, gpu_check.metrics(nz, device)["stretched"]


@pytest.mark.cuda
@pytest.mark.parametrize("divdmp", [0.0, 0.05])
def test_cuda_dyn_tendency_matches_plain(cuda_device, divdmp):
    s, rho_ref, p_pert, vg = _dyn_state(cuda_device)
    args = (s.rho, s.rhou, s.rhov, s.rhow, s.rhot, p_pert, rho_ref, vg.dzc,
            vg.dzf, 18000.0, 18000.0, 1e-3, divdmp, 30.0)
    out = tendency.dyn_tendencies_kernel(*args)
    ref = tendency.dyn_tendencies_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert float((a - b).abs().max()) <= 2e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kdiff4", [0.0, 1e-3])
def test_cuda_adv_ud3_matches_plain(cuda_device, kdiff4):
    s, _, _, vg = _dyn_state(cuda_device, seed=1)
    args = (s.rhoq, s.rho, s.rhou, s.rhov, s.rhow, vg.dzc, 18000.0,
            18000.0, kdiff4)
    out = stencil.adv_flux_divergence_kernel(*args)
    ref = stencil.adv_flux_divergence_plain(*args)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", gpu_check.RAGGED_SHAPES)
@pytest.mark.parametrize("name", ["dyn_tendency", "adv_ud3"])
def test_cuda_stencil_kernel_ragged_shapes(cuda_device, name, shape):
    """Tiles cut by the domain's edge and axes narrower than a tile and its
    halo, under both metrics, divdmp 0 / 0.05, kdiff4 0 / 1e-3 and 1 or 6
    tracers; each kernel run twice, both runs within the bound."""
    rows = gpu_check.ragged_kernels_vs_plain(cuda_device, name, [shape])
    assert len(rows) == 8
    for row in rows:
        assert row["finite"] and row["rel_err"] <= row["tol"], row


@pytest.mark.cuda
def test_cuda_tendencies_launch_both_kernels(cuda_device):
    """dycore.tendencies on CUDA tensors goes through both kernels, once
    each, batched or single-member; open lateral boundaries raise."""
    s, rho_ref, _, vg = _dyn_state(cuda_device, seed=2)
    p_ref = torch.zeros_like(rho_ref)
    cfg = dycore.DycoreConfig(dx=18000.0, dy=18000.0, dz=300.0, dt=30.0)
    for state in (s, dycore.DycoreState(*(f[0] for f in s))):
        before = dict(kernels.LAUNCHES)
        out = dycore.tendencies(state, cfg, rho_ref, p_ref, vg)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["dyn_tendency"] == before["dyn_tendency"] + 1
        assert kernels.LAUNCHES["adv_ud3"] == before["adv_ud3"] + 1
        assert all(a.shape == b.shape for a, b in zip(out, state))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        dycore.tendencies(s, dataclasses.replace(cfg, lateral="open"),
                          rho_ref, p_ref, vg)


@pytest.mark.cuda
def test_cuda_forecast_matches_cpu(cuda_device):
    """The coarsened 18-km forecast (K = 4, 3 steps) on the card against
    the CPU, per field within 1e-4·max|increment| plus twice the CPU run's
    own rounding floor (scale_letkf_torch/gpu_check.py)."""
    from scale_letkf_torch.gpu_check import coarse_forecast_vs_cpu
    res = coarse_forecast_vs_cpu(cuda_device, CONFIG)
    assert res["kernel_launches"]["cuda"] == {
        "dyn_tendency": 3 * res["steps"], "adv_ud3": 3 * res["steps"]}
    assert res["finite"]
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res


@pytest.mark.cuda
def test_cuda_cycle_matches_cpu(cuda_device):
    """One run_osse cycle at the coarsened sizes (K = 20, so all three
    kernels run) on the card against the CPU: every kernel launched as
    expected, the obs QC equal, and per field of the final ensemble and
    nature state within the forecast's bound (gpu_check.py)."""
    res = gpu_check.osse_vs_cpu(cuda_device, CONFIG)
    assert res["kernel_launches"]["device"] == res["expected_launches"]
    assert not any(res["kernel_launches"]["cpu"].values())
    assert res["finite"] and res["qc_equal"]
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res


@pytest.mark.cuda
def test_cuda_obsope_slots_matches_cpu(cuda_device):
    """The 4-D obs operator on a 3-slot window, history on the host,
    conventional and radar obs: QC equal, H(x) per element within 2e-5 of
    its range plus 4 ulp (12 for PS)."""
    res = gpu_check.hx_slots_vs_cpu(cuda_device, CONFIG)
    assert res["qc_equal"] and res["finite"] and res["outside_window"] > 0
    assert {"REF", "Vr", "T", "PS"} <= set(res["max_err_over_tol"])
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res


@pytest.mark.cuda
def test_cuda_radar_hx_matches_cpu(cuda_device):
    """Radar H(x) with METHOD_REF_CALC 1, 2 and 3, with and without the
    terminal velocity, non-zero hydrometeors: as the 4-D check."""
    rows = gpu_check.radar_hx_vs_cpu(cuda_device, CONFIG)
    assert len(rows) == 6
    for row in rows:
        assert row["qc_equal"] and row["finite"], row
        assert {"REF", "Vr"} <= set(row["max_err_over_tol"])
        assert all(e <= 1 for e in row["max_err_over_tol"].values()), row
