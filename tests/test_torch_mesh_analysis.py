"""The port's analysis on a process grid (da/letkf.py analyze(mesh=), the
ensemble transpose) against the reference's sharded analysis and the port's
own single-block analysis, on tests/test_analysis_sharded.py's make_case
(K = 8, 3 × 8 × 8, float64 inputs) and the (2, 2, 2) grid of the 8 virtual
devices; then CycleDriver.analysis on the grid against the undecomposed one.

Bounds: the grid against the port's single block to rtol 1e-12 / atol
1e-12 (the same per-gridpoint arithmetic in float64, batched differently);
against the reference's sharded analysis to the reference's own bound for
sharded against single-device (rtol 1e-5, atol 1e-6;
tests/test_analysis_sharded.py), the inflation field to rtol 1e-6 / atol
1e-8 as there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scale_letkf_tpu.da.letkf import analyze as ref_analyze
from scale_letkf_tpu.parallel.mesh import make_mesh as ref_make_mesh
from scale_letkf_torch.config import Config, EnsembleConfig, LetkfConfig
from scale_letkf_torch.da import letkf
from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.grid import Grid, Projection
from scale_letkf_torch.obs.types import ID_T, ID_U, Observations
from scale_letkf_torch.parallel.mesh import Sharded, make_mesh
from scale_letkf_torch.state import IA_P, IA_Q0, IA_T, IA_U, NV3D
from test_analysis_sharded import make_case

torch.set_num_threads(1)
CPU = torch.device("cpu")
GRID = (2, 2, 2)
TIGHT = dict(rtol=1e-12, atol=1e-12)
REF = dict(rtol=1e-5, atol=1e-6)


def _port_case(K=8, NZ=3, NY=8, NX=8, nobs=25, seed=0, letkf_kw=None,
               det=False):
    """make_case's inputs for the port: the same draws in the same order;
    det: the context carries the departures of the member gues[0] + 0.1."""
    grid = Grid.uniform(nx=NX, ny=NY, nz=NZ, dx=2e3, dy=2e3, dz=500.0,
                        proj=Projection(kind="LC"))
    rng = np.random.default_rng(seed)
    gues = np.zeros((K, NV3D, NZ, NY, NX))
    gues[:, IA_U] = 5.0 + rng.standard_normal((K, NZ, NY, NX))
    gues[:, IA_T] = 280.0 + rng.standard_normal((K, NZ, NY, NX))
    gues[:, IA_P] = 850e2 * np.exp(
        -np.arange(NZ)[None, :, None, None] * 0.1) \
        + rng.standard_normal((K, NZ, NY, NX))
    gues[:, IA_Q0] = 1e-3 + 1e-4 * rng.standard_normal((K, NZ, NY, NX))
    lon2d, lat2d = grid.lonlat
    jj = rng.integers(1, NY - 1, nobs)
    ii = rng.integers(1, NX - 1, nobs)
    kk = rng.integers(0, NZ, nobs)
    elem = np.where(rng.uniform(size=nobs) < 0.5, ID_T, ID_U).astype(np.int32)
    obs = Observations(
        elem=elem, lon=lon2d[jj, ii], lat=lat2d[jj, ii],
        lev=850e2 * np.exp(-kk * 0.1),
        dat=np.where(elem == ID_T, 280.0, 5.0) + rng.standard_normal(nobs),
        err=np.ones(nobs), typ=np.zeros(nobs, np.int32), dif=np.zeros(nobs))
    ia = np.where(elem == ID_T, IA_T, IA_U)
    ensval = np.stack([gues[m, ia, kk, jj, ii] for m in range(K)])
    cfg = Config(ensemble=EnsembleConfig(member=K),
                 letkf=LetkfConfig(**(letkf_kw or {"infl_mul": 1.1})))
    cfg.letkf_obs.hori_local = tuple([10.0e3] + [-1.0] * 23)
    ctx = build_obs_context(obs, ensval, np.zeros(nobs, np.int32), cfg, grid,
                            ensval_det=ensval[0] + 0.1 if det else None)
    z_full = grid.calc_z(torch.zeros((NY, NX), dtype=torch.float64))
    return grid, torch.as_tensor(gues), ctx, cfg, z_full


def _gathered(mesh, anal):
    assert isinstance(anal, Sharded)
    return mesh.gather_ensemble(anal).numpy()


def _both(letkf_kw=None, det=False, **kw):
    """(reference single, reference sharded, port single, port grid) of
    the case: the reference's (anal, anal_det, diag), the port's (anal,
    diag). kw: "ref" and "port", callables giving each call's extra
    arguments afresh (an rng is consumed by the call)."""
    g_r, gues_r, ctx_r, cfg_r, z_r = make_case(letkf_kw=letkf_kw)
    grid, gues, ctx, cfg, z = _port_case(letkf_kw=letkf_kw, det=det)
    np.testing.assert_array_equal(gues.numpy(), np.asarray(gues_r))
    det_r = gues_r[0] + 0.1 if det else None
    det_p = gues[0] + 0.1 if det else None
    ref_kw = kw.get("ref", dict)
    port_kw = kw.get("port", dict)
    ref1 = ref_analyze(gues_r, ctx_r, cfg_r, g_r, z_r, gues_det=det_r,
                       **ref_kw())
    refm = ref_analyze(gues_r, ctx_r, cfg_r, g_r, z_r, gues_det=det_r,
                       mesh=ref_make_mesh(*GRID), **ref_kw())
    a1, d1 = letkf.analyze(gues, ctx, cfg, grid, z, device=CPU,
                           gues_det=det_p, **port_kw())
    mesh = make_mesh(*GRID)
    am, dm = letkf.analyze(mesh.shard_ensemble(gues), ctx, cfg, grid, z,
                           device=CPU, gues_det=det_p, mesh=mesh,
                           **port_kw())
    return ref1, refm, (a1.numpy(), d1), (_gathered(mesh, am), dm)


def test_grid_analysis_equals_single_block_and_reference():
    ref1, refm, (a1, _), (am, dm) = _both()
    np.testing.assert_allclose(am, a1, **TIGHT)
    np.testing.assert_allclose(am, np.asarray(refm[0]), **REF)
    np.testing.assert_allclose(np.asarray(refm[0]), np.asarray(ref1[0]),
                               **REF)
    # the guess and analysis means of diag.stats against the ensembles
    np.testing.assert_allclose(dm.stats["anal_mean"].numpy(),
                               am.mean(axis=0), **TIGHT)
    # the 8 shares of one process cover the 8 × 8 columns once
    assert sum(n for n, _ in dm.share_chunks) == 64


def test_grid_analysis_adaptive_and_det():
    """The member's analysis against the port's single block (the
    reference's make_case carries no deterministic departures)."""
    kw = {"infl_mul": 1.0, "infl_mul_adaptive": True}
    _, refm, (a1, d1), (am, dm) = _both(kw, det=True)
    np.testing.assert_allclose(am, a1, **TIGHT)
    np.testing.assert_allclose(dm.anal_det.numpy(), d1.anal_det.numpy(),
                               **TIGHT)
    np.testing.assert_allclose(dm.infl_field, d1.infl_field, **TIGHT)
    np.testing.assert_allclose(am, np.asarray(refm[0]), **REF)
    np.testing.assert_allclose(dm.infl_field, refm[2].infl_field,
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("shuffle,q_ratio", [(False, False), (True, True)])
def test_grid_analysis_additive_inflation(shuffle, q_ratio):
    """INFL_ADD 0.5 with the source the guess plus seeded noise; the
    shuffle draws its permutation from default_rng(1) on both sides."""
    kw = {"infl_mul": 1.1, "infl_add": 0.5, "infl_add_shuffle": shuffle,
          "infl_add_q_ratio": q_ratio}
    g_r, gues_r, *_ = make_case()
    addi = np.asarray(gues_r) + np.random.default_rng(1).standard_normal(
        gues_r.shape)
    _, refm, (a1, _), (am, _) = _both(kw, **{
        "ref": lambda: {"addi_ens": jnp.asarray(addi),
                        "rng": np.random.default_rng(1)},
        "port": lambda: {"addi_ens": torch.as_tensor(addi),
                         "rng": np.random.default_rng(1)}})
    np.testing.assert_allclose(am, a1, **TIGHT)
    np.testing.assert_allclose(am, np.asarray(refm[0]), **REF)


def test_grid_analysis_rtps_field():
    kw = {"infl_mul": 1.0, "relax_alpha_spread": 0.9,
          "relax_spread_out": True, "nobs_out": True}
    _, refm, (a1, d1), (am, dm) = _both(kw)
    np.testing.assert_allclose(am, a1, **TIGHT)
    np.testing.assert_allclose(dm.rtps_field, d1.rtps_field, **TIGHT)
    np.testing.assert_array_equal(dm.nobs_field, d1.nobs_field)
    np.testing.assert_allclose(dm.rtps_field, refm[2].rtps_field, **REF)


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 1, 1)])
def test_grid_forecast_with_boundary_relaxation(shape):
    """CycleDriver.forecast on a grid with Davies relaxation toward
    per-member targets (gpu_check.per_member_boundary) — each block's
    weights and targets its own slice — equals the undecomposed forecast
    exactly (the periodic halo step is the same arithmetic, the relaxation
    pointwise), on tests/test_torch_cycle.py's configuration: (2, 2, 2)
    through the halo steps, (2, 1, 1) through each slab's undecomposed
    step."""
    from scale_letkf_torch.cycle import CycleDriver
    from scale_letkf_torch.gpu_check import per_member_boundary
    from scale_letkf_torch.io.convert import dycore_state_to_torch
    from test_torch_cycle import setup_pair, states
    _, d, g_r, g, cfg, dom = setup_pair()
    _, ens = states(g_r, dom)
    bdy = per_member_boundary(g, dom, ens.rho.shape[0], CPU)

    def run(mesh):
        drv = CycleDriver(g, cfg, d.dycfg, d.rho_ref, d.p_ref, mesh=mesh,
                          core=d.core, n_small=d.n_small, bdy=bdy,
                          bdy_width=3, bdy_tau=60.0)
        out = drv.forecast(dycore_state_to_torch(ens, CPU), 2, t0=600.0)
        return out if mesh is None else mesh.gather_ensemble(out)

    want = run(None)
    got = run(make_mesh(*shape))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(want.rhot, dycore_state_to_torch(ens, CPU).rhot)
