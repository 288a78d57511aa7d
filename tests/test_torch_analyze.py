"""The port's LETKF analysis slice as a whole against the reference package:

  restart → state_trans → build_obs_context → analyze → state_trans_inv

on configs/18km_japan.toml coarsened to 24×20×4 with K = 20, from the same
numpy inputs. The reference runs its production solver, the Pallas kernel
(eigh_impl='ns_pallas') in TPU interpret mode, with the float32 obs-table
gather; the port runs its kernel's plain version (CPU tensors).

Increments (anal − gues) agree per variable to 1e-4·max|Δ_v| plus 2 ulp of
max|field_v|: the two sides' float32 sums round differently, and pressure
(~1e5 Pa) differs by one ulp between the reference's own backends.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scale_letkf_tpu import state as ref_state
from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_tpu.da.letkf import analyze as ref_analyze
from scale_letkf_tpu.da.letkf_obs import build_obs_context as ref_context
from scale_letkf_torch import state
from scale_letkf_torch.cli.main import load_config_and_grid
from scale_letkf_torch.da import letkf
from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.io.convert import ensemble_to_torch
from scale_letkf_torch.ops.obs_select import candidate_width
from scale_letkf_torch.synthetic import synthetic_conv_network, synthetic_gues
from scale_letkf_torch.utils.timing import Timer

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "18km_japan.toml")
K = 20
CPU = torch.device("cpu")


def _rtps_adaptive(cfg):
    cfg.letkf.relax_alpha = 0.0
    cfg.letkf.relax_alpha_spread = 0.9
    cfg.letkf.relax_spread_out = True
    cfg.letkf.infl_mul_adaptive = True
    cfg.letkf.infl_mul_min = 1.0
    cfg.letkf.nobs_out = True


def _varlocal_q(cfg):
    # PS obs leave moisture alone, T obs reach w at half weight: three
    # var-local groups, (u, v, T, p), w and the six moisture variables
    ones = [1.0] * state.NV3D
    ps = ones.copy()
    ps[state.IA_Q0:] = [0.0] * state.NQ
    t = ones.copy()
    t[state.IA_W] = 0.5
    cfg.var_local.ps = tuple(ps)
    cfg.var_local.t = tuple(t)
    cfg.letkf.q_update_top = 97000.0
    cfg.letkf.q_sprd_max = 0.03
    cfg.letkf.boundary_buffer_width = 100.0e3
    cfg.letkf.relax_to_inflated_prior = True


CASES = {"rtpp": None, "rtps_adaptive": _rtps_adaptive,
         "varlocal_q": _varlocal_q}


def _configs(case):
    over = {"nx": 24, "ny": 20, "nz": 4}
    cfg_r, grid_r, _, _ = ref_load(CONFIG, over)
    cfg, grid, _, _ = load_config_and_grid(CONFIG, over)
    for c in (cfg_r, cfg):
        c.ensemble.member = K
        c.letkf.eigh_impl = "ns_pallas"
        c.letkf.hdxb_gather_bf16 = False
        if CASES[case] is not None:
            CASES[case](c)
    return cfg_r, grid_r, cfg, grid


def _inputs(cfg, grid):
    """Restart ensemble (float32, via the reference's state_trans_inv of a
    synthetic analysis ensemble), obs, and ensemble H(x)."""
    rng = np.random.default_rng(0)
    gues = synthetic_gues(rng, K, grid.nz, grid.ny, grid.nx, grid.cz)
    restart = np.array(ref_state.state_trans_inv(jnp.asarray(gues)))
    obs = synthetic_conv_network(cfg, grid, rng, n_sonde=30, n_ps=60)
    ensval = (obs.dat[None] + rng.standard_normal((K, obs.nobs))
              * obs.err[None]).astype(np.float32)
    return restart, obs, ensval


def _run_reference(restart, obs, ensval, cfg, grid):
    gues = ref_state.state_trans(jnp.asarray(restart))
    ctx = ref_context(obs, ensval, np.zeros(obs.nobs, np.int32), cfg, grid)
    z = jnp.asarray(grid.calc_z(np.zeros((grid.ny, grid.nx))), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        anal, _, diag = ref_analyze(gues, ctx, cfg, grid, z)
    out = ref_state.state_trans_inv(
        anal, positive_definite_q=cfg.letkf.positive_definite_q,
        positive_definite_qhyd=cfg.letkf.positive_definite_qhyd)
    return np.asarray(gues), np.asarray(anal), np.asarray(out), diag


def _run_port(restart, obs, ensval, cfg, grid, timer=None):
    gues = state.state_trans(ensemble_to_torch(restart, CPU))
    ctx = build_obs_context(obs, ensval, np.zeros(obs.nobs, np.int32), cfg,
                            grid)
    z = grid.calc_z(torch.zeros((grid.ny, grid.nx)))
    anal, diag = letkf.analyze(gues, ctx, cfg, grid, z, device=CPU,
                               timer=timer)
    out = state.state_trans_inv(
        anal, positive_definite_q=cfg.letkf.positive_definite_q,
        positive_definite_qhyd=cfg.letkf.positive_definite_qhyd)
    return gues.numpy(), anal.numpy(), out.numpy(), diag


def _assert_increments_close(before, after, before_ref, after_ref, ulps=2):
    for v in range(before.shape[1]):
        inc = after[:, v] - before[:, v]
        inc_ref = after_ref[:, v] - before_ref[:, v]
        tol = (1e-4 * np.abs(inc_ref).max()
               + ulps * np.spacing(np.abs(before_ref[:, v]).max()))
        np.testing.assert_allclose(inc, inc_ref, rtol=0, atol=tol,
                                   err_msg=f"variable {v}")


@pytest.mark.parametrize("case", list(CASES))
def test_analysis_slice_matches_reference(case):
    cfg_r, grid_r, cfg, grid = _configs(case)
    restart, obs, ensval = _inputs(cfg, grid)
    g_r, a_r, out_r, d_r = _run_reference(restart, obs, ensval, cfg_r, grid_r)
    timer = Timer(CPU)
    g, a, out, d = _run_port(restart, obs, ensval, cfg, grid, timer)

    assert np.isfinite(a).all() and np.isfinite(out).all()
    np.testing.assert_allclose(g, g_r, rtol=1e-6)
    _assert_increments_close(g, a, g_r, a_r)
    # restart variables are products and quotients of two analysis
    # variables (ρ = p/(R_tot·T), ρθ, ρu), so they carry both 2-ulp budgets
    # and one more rounding: 6 ulp
    _assert_increments_close(restart, out, restart, out_r, ulps=6)
    assert np.abs(a - g).max(axis=(0, 2, 3, 4))[:state.IA_Q0].min() > 0
    np.testing.assert_array_equal(d.nobs_per_level, d_r.nobs_per_level)
    assert d.nobs_per_level.min() > 0
    # the RTPS factor goes through xbᵀ·Pao·xb, so it carries the solvers'
    # difference: 1e-4, the transform's tolerance against the Pallas kernel
    for name, rtol in (("infl_field", 1e-5), ("rtps_field", 1e-4),
                       ("nobs_field", 0)):
        got, want = getattr(d, name), getattr(d_r, name)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=rtol, err_msg=name)
    # one solve per level, chunk and var-local group
    groups = 3 if case == "varlocal_q" else 1
    assert timer.counts["solve"] == grid.nz * groups
    assert d.chunk == grid.nx * grid.ny


def test_gridpoint_chunks_give_the_same_analysis(monkeypatch):
    """Splitting each level into gridpoint chunks changes nothing but the
    batch: a budget of ~100 gridpoints per chunk reproduces the one-chunk
    analysis."""
    _, _, cfg, grid = _configs("rtps_adaptive")
    restart, obs, ensval = _inputs(cfg, grid)
    g, a, _, d = _run_port(restart, obs, ensval, cfg, grid)
    B = grid.nx * grid.ny
    ctx = build_obs_context(obs, ensval, np.zeros(obs.nobs, np.int32), cfg,
                            grid)
    cand_w = sum(candidate_width(ct.buckets) for ct in ctx.ctypes)
    sel_w = sum(ct.max_nobs for ct in ctx.ctypes)
    per_gp = 16 * cand_w + 16 * sel_w * (K + 1)
    monkeypatch.setattr(letkf, "CPU_CHUNK_BYTES", 100 * per_gp)
    timer = Timer(CPU)
    g2, a2, _, d2 = _run_port(restart, obs, ensval, cfg, grid, timer)
    assert d2.chunk == 100
    n_chunks = -(-B // 100)
    assert timer.counts["solve"] == grid.nz * n_chunks
    np.testing.assert_allclose(a2, a, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(d2.infl_field, d.infl_field, rtol=1e-6)
    np.testing.assert_array_equal(d2.nobs_field, d.nobs_field)


def test_analysis_products_in_full_fp32(monkeypatch):
    """analyze runs its float32 products (Gram, weight application) without
    TF32 even when the caller chose it, and gives the choice back."""
    _, _, cfg, grid = _configs("rtpp")
    restart, obs, ensval = _inputs(cfg, grid)
    matmul = torch.backends.cuda.matmul
    seen = []
    core = letkf.letkf_core

    def recording(*args, **kwargs):
        seen.append(matmul.fp32_precision)
        return core(*args, **kwargs)

    monkeypatch.setattr(letkf, "letkf_core", recording)
    saved = matmul.fp32_precision
    matmul.fp32_precision = "tf32"
    try:
        _run_port(restart, obs, ensval, cfg, grid)
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = saved
    assert seen == ["ieee"] * grid.nz


def test_unported_inputs_raise():
    """A device mesh, the last input that raised, is ported (parallel/;
    tests/test_torch_mesh_analysis.py holds it to the reference): on the
    (2, 2, 2) grid the analysis equals the single block's to float32
    rounding of the per-level means (1e-5 of max|Δ| + 2 ulp); a grid that
    does not divide the domain raises."""
    from scale_letkf_torch.parallel.mesh import make_mesh
    _, _, cfg, grid = _configs("rtpp")
    restart, obs, ensval = _inputs(cfg, grid)
    gues = state.state_trans(ensemble_to_torch(restart, CPU))
    ctx = build_obs_context(obs, ensval, np.zeros(obs.nobs, np.int32), cfg,
                            grid)
    z = grid.calc_z(torch.zeros((grid.ny, grid.nx)))
    one, _ = letkf.analyze(gues, ctx, cfg, grid, z, device=CPU)
    mesh = make_mesh(2, 2, 2)
    anal, _ = letkf.analyze(mesh.shard_ensemble(gues), ctx, cfg, grid, z,
                            device=CPU, mesh=mesh)
    got = mesh.gather_ensemble(anal)
    for v in range(gues.shape[1]):
        d = (one[:, v] - gues[:, v]).abs().max()
        tol = 1e-5 * d + 2 * torch.finfo(torch.float32).eps \
            * one[:, v].abs().max()
        assert (got[:, v] - one[:, v]).abs().max() <= tol, v
    with pytest.raises(ValueError, match="nx = 24 does not divide into 5"):
        letkf.analyze(gues, ctx, cfg, grid, z, device=CPU,
                      mesh=make_mesh(1, 1, 5))
