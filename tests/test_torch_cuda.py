"""Tests of the port that need a CUDA GPU; without one they skip.

This file imports neither jax nor the reference package, so it also runs on
a GPU machine without jax, with the jax-configuring conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The CUDA kernels are held against their plain PyTorch versions on the
card, and the analysis, the forecast, the DA cycle, the ensemble H(x)
(4-D, radar and H08), the physics, the terrain dynamics, the pp step's
smoothing, the coarsened production cycle, the analysis with a
deterministic member and additive inflation, the letkf and cycle verbs
with them, the Jacobi eigensolver, EFSO, the full-size executors
(coarsened: the tiled, streamed and resident cycles and cycle --streamed),
the cycle verb with a nested child in the open lateral mode and the fused
cycle on the card against the same runs on the CPU (which the parity tests
hold against the reference package); the grid's SI halo step and its fused
cycle against the undecomposed runs on the card.
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
RADAR_CONFIG = str(Path(CONFIG).with_name("bda_1km_radar.toml"))
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
@pytest.mark.parametrize("metric", ["uniform", "stretched"])
def test_cuda_open_kernels_match_plain(cuda_device, metric):
    """Both stencil kernels in the open lateral mode against their plain
    versions on 2 × 12 × 40 × 64 random states (fields that vary from cell
    to cell up to the edges), divdmp 0.05, kdiff4 1e-3, at the periodic
    mode's bounds; the open result differs from the periodic one."""
    s, rho_ref, p_pert = gpu_check.random_dyn_state(3, 2, 12, 40, 64,
                                                    cuda_device)
    vg = gpu_check.metrics(12, cuda_device)[metric]
    for kernel, plain, args, tol in (
            (tendency.dyn_tendencies_kernel, tendency.dyn_tendencies_plain,
             gpu_check.dyn_operands(s, rho_ref, p_pert, vg, 0.05, 1e-3,
                                    "open"), gpu_check.TOL_TENDENCY),
            (stencil.adv_flux_divergence_kernel,
             stencil.adv_flux_divergence_plain,
             gpu_check.adv_operands(s, vg, 1e-3, "open"),
             gpu_check.TOL_STENCIL)):
        out, ref = kernel(*args), plain(*args)
        periodic = kernel(*args[:-1], "periodic")
        torch.cuda.synchronize()
        out, ref, periodic = (x if isinstance(x, tuple) else (x,)
                              for x in (out, ref, periodic))
        assert max(gpu_check.rel_errors(out, ref)) <= tol
        assert max(gpu_check.rel_errors(periodic, ref)) > tol


@pytest.mark.cuda
def test_cuda_nested_verb_matches_cpu(cuda_device):
    """The cycle verb with a [nest] section (tests/test_cli_nested.py's
    experiment, the child open) on the card against the CPU: parent and
    child analyses within 1e-4·max|Δ|·(1 + 2·floor), both stencil kernels
    launched on the card and never on the CPU."""
    res = gpu_check.nested_verb_vs_cpu(cuda_device)
    assert res["finite"]
    for k in ("dyn_tendency", "adv_ud3"):
        assert res["kernel_launches"]["device"][k] > 0
        assert res["kernel_launches"]["cpu"][k] == 0
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res


@pytest.mark.cuda
def test_cuda_fused_cycle_matches_cpu(cuda_device):
    """One FusedCycle step of the coarsened radar configuration on the card
    against the CPU: the ensemble within 1e-4·max|Δ|·(1 + 2·floor), the
    same obs used, every kernel launched as expected."""
    res = gpu_check.fused_vs_cpu(cuda_device, RADAR_CONFIG)
    assert res["finite"]
    assert res["kernel_launches"]["device"] == res["expected_launches"]
    assert res["nobs_used"]["device"] == res["nobs_used"]["cpu"] > 0
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res


@pytest.mark.cuda
@pytest.mark.parametrize("shape", gpu_check.RAGGED_SHAPES)
@pytest.mark.parametrize("name", ["dyn_tendency", "adv_ud3"])
def test_cuda_stencil_kernel_open_ragged_shapes(cuda_device, name, shape):
    """The open lateral mode (edge-clamped x/y, a nested child's) at the
    ragged and tiny shapes, uniform and stretched metrics, divdmp 0 / 0.05,
    kdiff4 0 / 1e-3, 1 or 6 tracers: each kernel run twice, both runs
    within the periodic mode's bound."""
    rows = gpu_check.ragged_kernels_vs_plain(cuda_device, name, [shape],
                                             lateral="open")
    assert len(rows) == 8
    for row in rows:
        assert row["finite"] and row["rel_err"] <= row["tol"], row


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
    each, batched or single-member, in both lateral modes (lateral="open"
    launches both kernels too, and gives the CPU's open tendencies)."""
    s, rho_ref, _, vg = _dyn_state(cuda_device, seed=2)
    p_ref = torch.zeros_like(rho_ref)
    cfg = dycore.DycoreConfig(dx=18000.0, dy=18000.0, dz=300.0, dt=30.0)
    for lateral in ("periodic", "open"):
        cfg_l = dataclasses.replace(cfg, lateral=lateral)
        for state in (s, dycore.DycoreState(*(f[0] for f in s))):
            before = dict(kernels.LAUNCHES)
            out = dycore.tendencies(state, cfg_l, rho_ref, p_ref, vg)
            torch.cuda.synchronize()
            assert (kernels.LAUNCHES["dyn_tendency"]
                    == before["dyn_tendency"] + 1)
            assert kernels.LAUNCHES["adv_ud3"] == before["adv_ud3"] + 1
            assert all(a.shape == b.shape for a, b in zip(out, state))
    cpu = torch.device("cpu")
    open_cfg = dataclasses.replace(cfg, lateral="open")
    out = dycore.tendencies(s, open_cfg, rho_ref, p_ref, vg)
    ref = dycore.tendencies(
        dycore.DycoreState(*(f.cpu() for f in s)), open_cfg, rho_ref.cpu(),
        p_ref.cpu(), dycore.VGrid(*(f.cpu() for f in vg)))
    for a, b in zip(out, ref):
        assert float((a.cpu() - b).abs().max()) <= 2e-5 * float(
            b.abs().max())


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


@pytest.mark.cuda
def test_cuda_physics_modules_match_cpu(cuda_device):
    """Each physics scheme alone (Kessler, NSW6, radiation, the surface
    layer, the PBL step, three physics-suite steps) on small seeded states
    on the card against the CPU: a returned state per field within
    1e-4·max|increment| + 4 ulp, a diagnostic within 3e-5·max + 4 ulp (the
    bounds of tests/test_torch_physics.py), plus twice the CPU's own
    rounding floor."""
    res = gpu_check.physics_modules_vs_cpu(cuda_device)
    assert set(res["max_err_over_tol"]) == {
        "kessler", "nsw6", "radiation", "surface", "pbl", "physics_step"}
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res


@pytest.mark.cuda
def test_cuda_physics_paths_match_cpu(cuda_device):
    """The coarsened physics-suite forecast with per-member Davies forcing
    (two forecasts threading the skin temperature), the radar
    configuration's Kessler forecast over its window and its radar cycle on
    the card against the CPU, within the forecast's bound
    (gpu_check.coarse_physics_vs_cpu)."""
    radar = str(Path(CONFIG).parent / "bda_1km_radar.toml")
    res = gpu_check.coarse_physics_vs_cpu(cuda_device, CONFIG, radar)
    assert gpu_check.physics_check_passes(res), res


@pytest.mark.cuda
def test_cuda_terrain_modules_match_cpu(cuda_device):
    """tendencies_terrain (plain PyTorch on the card) on hills, uniform
    fluxes kept away from zero, to 2e-5·max|CPU| plus twice the CPU's own
    rounding floor, and two SI steps with terrain metrics as the forecast
    checks, both lateral modes; an unforced terrain forecast keeps
    Σ J·ρ·dzc to 1e-5 (gpu_check.terrain_modules_vs_cpu)."""
    res = gpu_check.terrain_modules_vs_cpu(cuda_device, CONFIG)
    for lateral in ("periodic", "open"):
        r = res[lateral]
        assert r["finite"], res
        assert all(e <= 1 for part in ("tendencies", "si_steps")
                   for e in r[part].values()), res
    assert res["mass"]["jacobian_mass_rel_change"] <= 1e-5, res


@pytest.mark.cuda
def test_cuda_terrain_tendencies_launch_no_stencil_kernel(cuda_device):
    """With terrain metrics the slow tendency leaves kernels #2 and #3;
    flat metrics on the card give dycore.tendencies' result (the kernels')
    to the kernels' bounds."""
    from scale_letkf_torch.model import terrain
    nz, ny, nx = 12, 24, 40
    fz = np.concatenate([[0.0], np.cumsum(300.0 * 1.04 ** np.arange(nz))])
    cz = 0.5 * (fz[1:] + fz[:-1])
    topo = gpu_check.hills(ny, nx)
    fields, rho_ref, p_ref = gpu_check.terrain_state(0, 2, cz, fz, topo,
                                                     gpu_check.DX,
                                                     gpu_check.DX)
    s = dycore.DycoreState(*(torch.as_tensor(f, device=cuda_device)
                             for f in fields))
    cfg = dycore.DycoreConfig(dx=gpu_check.DX, dy=gpu_check.DX, dz=300.0,
                              dt=gpu_check.DT)
    vg = dycore.make_vgrid(cz, fz, cuda_device)
    cols = [torch.as_tensor(a, device=cuda_device) for a in (rho_ref, p_ref)]
    m = terrain.make_metrics(torch.as_tensor(topo, device=cuda_device), cz,
                             fz, cfg.dx, cfg.dy)
    kernels.reset_launches()
    terrain.tendencies_terrain(s, cfg, *cols, m, vg)
    assert kernels.LAUNCHES["dyn_tendency"] == kernels.LAUNCHES["adv_ud3"] == 0
    flat = terrain.make_metrics(torch.zeros_like(m.jac), cz, fz, cfg.dx,
                                cfg.dy)
    got = terrain.tendencies_terrain(s, cfg, *cols, flat, vg)
    want = dycore.tendencies(s, cfg, *cols, vg)
    for name, a, b in zip(s._fields, got, want):
        tol = gpu_check.TOL_STENCIL if name == "rhoq" else gpu_check.TOL_TENDENCY
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), name


@pytest.mark.cuda
def test_cuda_topo_and_h08_match_cpu(cuda_device):
    """The pp step's smoothing on the card takes the CPU's passes and gives
    its field to 1e-5 of the highest; H08 H(x) on the card: the CPU's QC,
    BTs to gpu_check.BT_TOL K, sensitive pressures equal but for at most
    1% on an adjacent level."""
    topo = gpu_check.topo_vs_cpu(cuda_device, CONFIG)
    assert topo["passes"]["device"] == topo["passes"]["cpu"] > 0, topo
    assert topo["max_err_over_tol"] <= 1, topo
    h = gpu_check.h08_hx_vs_cpu(cuda_device, CONFIG)
    assert h["finite"] and h["qc_equal"] and h["h08_good"] > 0, h
    assert h["bt_max_abs_err_k"] <= gpu_check.BT_TOL, h
    assert h["btclr_max_abs_err_k"] <= gpu_check.BT_TOL, h
    assert h["plev_differ_adjacent"], h
    assert h["plev_differ_share"] <= gpu_check.PLEV_ADJACENT_SHARE, h


@pytest.mark.cuda
def test_cuda_production_cycle_matches_cpu(cuda_device):
    """The coarsened production cycle (terrain, physics suite, Davies,
    conventional + H08 obs) on the card against the CPU
    (gpu_check.production_cycle_vs_cpu): states, O−B and O−A within their
    bounds, QC equal, H08 obs assimilated, no stencil kernel launched."""
    res = gpu_check.production_cycle_vs_cpu(cuda_device, CONFIG)
    launches = res["kernel_launches"]
    assert res["terrain"] and res["finite"] and res["qc_equal"], res
    assert res["h08_assimilated"] > 0, res
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res
    assert launches["device"]["invsqrt_ns"] > 0, res
    assert launches["device"]["dyn_tendency"] == 0, res
    assert launches["device"]["adv_ud3"] == 0, res
    assert not any(launches["cpu"].values()), res


@pytest.mark.cuda
def test_cuda_det_addi_analysis_matches_cpu(cuda_device):
    """The coarsened analysis with a deterministic member and additive
    inflation (shuffled, q ratio, the source on the host) on the card
    against the CPU: ensemble and member increments within
    1e-4·max|Δ| + 2 ulp per variable."""
    res = gpu_check.coarse_det_addi_vs_cpu(cuda_device, CONFIG)
    assert res["finite"] and res["det_moved"]
    assert res["kernel_launches"]["device"] > 0
    assert res["kernel_launches"]["cpu"] == 0
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res


@pytest.mark.cuda
def test_cuda_det_verbs_match_cpu(cuda_device):
    """letkf and cycle with 'mdet' and 'addi' files, --device cuda against
    --device cpu on the same files."""
    res = gpu_check.det_verbs_vs_cpu(cuda_device)
    launches = res["kernel_launches"]
    assert res["det_moved"], res
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res
    assert launches["letkf.device"] > 0 and launches["cycle.device"] > 0
    assert launches["letkf.cpu"] == launches["cycle.cpu"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 16])
def test_cuda_jacobi_matches_cpu(cuda_device, K):
    """The Jacobi eigensolver on the card against the CPU and float64
    LAPACK at tests/test_eigh_jacobi.py's float32 bounds."""
    res = gpu_check.jacobi_vs_cpu(cuda_device, K)
    assert res["passes"], res


@pytest.mark.cuda
def test_cuda_efso_matches_cpu(cuda_device):
    """efso_impact at the coarsened 18-km grid, with and without advected
    and vertical localization: ΔJ on the card within 1e-5·max|ΔJ| of the
    CPU's (the convolutions pinned to full FP32)."""
    res = gpu_check.coarse_efso_vs_cpu(cuda_device, CONFIG)
    assert res["finite"]
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res


# --- the full-size executors, coarsened ------------------------------------
@pytest.mark.cuda
def test_cuda_tiled_analysis_matches_cpu(cuda_device):
    """analyze_tiled, plain and pipelined, on the card against the CPU:
    per variable within 1e-4·max|Δ| + 2 ulp + one bfloat16 spacing of the
    analysis perturbation; the pipelined tiles equal to the plain ones;
    the solver launched per level and tile on the card only."""
    res = gpu_check.tiled_vs_cpu(cuda_device, CONFIG)
    launches = res["kernel_launches"]
    assert res["finite"] and res["pipeline_bit_equal"], res
    assert launches["device"] == launches["device_pipelined"] \
        == res["expected_launches"] and launches["cpu"] == 0, res
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["streamed", "resident"])
def test_cuda_cycle_executors_match_cpu(cuda_device, name):
    """StreamedCycle (terrain, physics, per-member Davies, 4-D slots) and
    ResidentCycle (physics, Davies, a segment boundary inside the window)
    on the card against the CPU, with the CPU's own rounding floor; the
    kernels launched as expected on the card and never on the CPU."""
    fn = {"streamed": gpu_check.streamed_vs_cpu,
          "resident": gpu_check.resident_vs_cpu}[name]
    res = fn(cuda_device, CONFIG)
    assert res["finite"] and res["qc_equal"], res
    assert res["kernel_launches"]["device"] == res["expected_launches"], res
    assert not any(res["kernel_launches"]["cpu"].values()), res
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res


@pytest.mark.cuda
def test_cuda_streamed_verb_matches_cpu(cuda_device):
    """cycle --streamed with --device cuda against --device cpu on the
    same files; with a [process] table the card's run equals its run
    without one."""
    res = gpu_check.streamed_verb_vs_cpu(cuda_device)
    assert res["meta"] == res["grid_meta"] == {"cycles": 1, "streamed": True}
    assert res["kernel_launches"]["device"]["invsqrt_ns"] > 0, res
    assert (res["kernel_launches"]["device_grid"]
            == res["grid_expected_launches"]), res
    assert not any(res["kernel_launches"]["cpu"].values()), res
    assert all(e <= 1 for e in res["max_err_over_tol"].values()), res
    assert res["grid_distance"] == 0 and res["grid_aux_equal"], res


@pytest.mark.cuda
def test_cuda_grid_si_halo_step_matches_undecomposed(cuda_device):
    """Two split-explicit steps of a 2-member ensemble (the 18-km
    configuration's levels coarsened to 36 × 48 columns) on a (1, 2, 2)
    grid in this process — every block on the card, its halo exchanged by
    device copies — against the undecomposed step on the card, to the
    reference's bound for its SI halo step (rtol 3e-5, atol 1e-4 of
    max|field|); kernels #2 and #3 launched once a stage on each block."""
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.model.dycore_si import SplitConfig, rk3_step_si
    from scale_letkf_torch.parallel import halo
    from scale_letkf_torch.parallel.mesh import make_mesh
    from scale_letkf_torch.synthetic import synthetic_ens_dycore_device
    cfg, grid, dycfg, dom = load_config_and_grid(CONFIG, {"nx": 48,
                                                          "ny": 36})
    driver = make_driver(cfg, grid, dycfg, dom, cuda_device)
    ens, _, _ = synthetic_ens_dycore_device(0, 2, grid, dom, cuda_device,
                                            u0=10.0)
    split = SplitConfig(dtau=dycfg.dt / driver.n_small)
    col = (driver.rho_ref, driver.p_ref, driver.z_centers)
    mesh = make_mesh(1, 2, 2)
    kernels.reset_launches()
    out = ens
    for _ in range(2):
        out = halo.rk3_step_si_halo_ens(out, dycfg, split, *col, mesh,
                                        driver.n_small, vg=driver.vg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dyn_tendency"] == 2 * 3 * 4
    assert kernels.LAUNCHES["adv_ud3"] == 2 * 3 * 4
    ref = ens
    for _ in range(2):
        ref = rk3_step_si(ref, dycfg, split, *col, driver.n_small, driver.vg)
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=3e-5,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
def test_cuda_grid_fused_cycle_is_undecomposed(cuda_device):
    """Two FusedCycle steps of the radar configuration coarsened to 24 × 24
    columns (K = 20, 15 steps, 400 REF/VR gates; gpu_check.
    fused_grid_on_device), the second from the first's analysis and
    inflation, on a (2, 2, 2) grid in this process equal the undecomposed
    steps on the card bit for bit in each cycle — the analysis ensemble, the
    inflation, the obs counts, O−B and O−A by group and the guess and
    analysis means — with every kernel launched as expected on the grid:
    #2 and #3 on every block's batch, #1 on every share's level chunks."""
    res = gpu_check.fused_grid_on_device(cuda_device, RADAR_CONFIG)
    assert res["cycles"] == 2
    assert res["bit_equal"], res
    assert res["kernel_launches"] == res["expected_launches"], res
    assert res["nobs_used"] > 0


# bench_fullsize's nine benches at coarse sizes (name → keyword arguments;
# COARSE_LOAD coarsens the analysis benches' configuration, which has no
# overrides of its own, to these columns with K = 20 members, so that the
# solver is kernel #1)
BENCH_COARSE = {
    "radar": {"n_obs_target": 20_000},
    "18km": {},
    "radar_resident": {"n_obs_target": 20_000},
    "18km_resident": {},
    "radar_cycle": {"overrides": {"nx": 32, "ny": 32, "dx": 3000.0,
                                  "dy": 3000.0},
                    "members": 20, "n_obs_target": 20_000},
    "18km_cycle": {"nsteps": 2, "overrides": {"nx": 48, "ny": 40},
                   "members": 20, "n_sonde": 60, "n_ps": 100},
    "18km_fullwindow": {"nsteps": 2, "slots": False,
                        "overrides": {"nx": 48, "ny": 40}, "members": 20,
                        "n_sonde": 60, "n_ps": 100},
    "tendency_fused": {"nz": 12, "ny": 40, "nx": 48, "reps": 3},
    "osse_impact": {"members": 20, "n_cycles": 2, "steps_per_cycle": 2,
                    "spinup_steps": 0, "member_batch": 10, "tile_rows": 20,
                    "n_sonde": 60, "n_ps": 100,
                    "overrides": {"nx": 48, "ny": 40, "nz": 36,
                                  "dx": 36000.0, "dy": 36000.0}},
}
COARSE_LOAD = {"radar": {"nx": 32, "ny": 32, "dx": 3000.0, "dy": 3000.0},
               "18km": {"nx": 48, "ny": 40}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BENCH_COARSE))
def test_cuda_bench_fullsize_coarse(cuda_device, monkeypatch, name):
    """Each of bench_fullsize's nine benches runs on the card at a coarse
    size with finite numbers; the analyses launch kernel #1, the tendency
    bench #2 and #3 with the kernels within 2e-5 of the plain path (the
    whole tendency's bound, relative to max|plain|); the OSSE's four curves
    have a value a cycle (its analysis-below-guess check is the smoke's, at
    the bench's width: this size and no spin-up need not show it)."""
    import json
    import math

    from scale_letkf_torch import bench_fullsize
    kind = "radar" if name.startswith("radar") else "18km"
    if name in ("radar", "18km", "radar_resident", "18km_resident"):
        load = bench_fullsize._load_cfg

        def coarse(path, overrides=None):
            cfg, grid, dycfg, dom = load(path, {**COARSE_LOAD[kind],
                                                **(overrides or {})})
            cfg.ensemble.member = 20
            return cfg, grid, dycfg, dom
        monkeypatch.setattr(bench_fullsize, "_load_cfg", coarse)
    kw = dict(BENCH_COARSE[name])
    if name != "tendency_fused":
        kw["config"] = RADAR_CONFIG if kind == "radar" else CONFIG
    kernels.reset_launches()
    res = bench_fullsize.BENCHES[name](device=cuda_device, **kw)
    torch.cuda.synchronize()
    json.dumps(res)

    def numbers(x):
        if isinstance(x, dict):
            return [n for v in x.values() for n in numbers(v)]
        if isinstance(x, list):
            return [n for v in x for n in numbers(v)]
        return [x] if isinstance(x, float) else []
    assert all(math.isfinite(v) for v in numbers(res)), res
    if name == "tendency_fused":
        assert kernels.LAUNCHES["dyn_tendency"] > 0
        assert kernels.LAUNCHES["adv_ud3"] > 0
        assert res["fused_max_rel_err"] <= 2e-5, res
    else:
        assert kernels.LAUNCHES["invsqrt_ns"] > 0, res
    if name == "osse_impact":
        assert all(len(res[k]) == 2 for k in ("rmse_gues", "rmse_anal",
                                              "rmse_ctrl", "spread_gues"))
