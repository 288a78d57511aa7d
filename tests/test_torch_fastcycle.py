"""The fused cycle of a fixed obs network (da/fastcycle.py FusedCycle) and
the structural obs context against the reference package, on the CPU.

Cases: tests/test_fastcycle.py's conventional network (8×8×6, K = 8, T and
U at 4 levels of 20 sites, adaptive inflation, RTPP 0.2) and its radar
template (12×12×12, K = 8, rain blobs, reflectivity in dBZ with the ref-zero
relabelling, Kessler-free explicit core), each package given the same numpy
states and obs values.

- build_obs_context(structural=True) on the radar template: every obs in
  the buckets, bucket membership equal, dat bit-equal.
- _hx_ens to the H(x) bound of tests/test_torch_obsope.py (2e-5 of the
  range plus 4 ulp), QC equal; _qc_mask equal to the reference's mask,
  on the reference's own H(x), with a gross outlier.
- assimilate on the same forecast ensemble and obs values: restart
  increments to 1e-4·max|Δ| plus 6 ulp (tests/test_torch_cycle.py's
  analysis bound), nobs_used equal, O−B and O−A to 1e-4 relative.
- step (forecast + assimilate): the same bound plus twice the port's own
  rounding floor (ROADMAP §3), measured from inputs rounded once.
- run_osse equals a loop of the port's own step fed the same noise (the
  generator is the port's: it cannot be the reference's jax.random), and
  its first cycle's analysis RMSE is below its guess RMSE (the
  reference's check).
- The reference's refusals: H08 templates and linear-Z reflectivity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_letkf_tpu.da.fastcycle import FusedCycle as RefFused
from scale_letkf_tpu.da.letkf_obs import build_obs_context as ref_context
from scale_letkf_tpu.model.dycore import DycoreState as RefState
from scale_letkf_tpu.model.dycore import to_collocated as ref_collocated
from scale_letkf_tpu.state import state_trans as ref_trans
from scale_letkf_torch import config as pcfg
from scale_letkf_torch.cycle import CycleDriver
from scale_letkf_torch.da.fastcycle import FusedCycle
from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.grid import Grid, Projection
from scale_letkf_torch.io.convert import (
    dycore_state_to_numpy, dycore_state_to_torch,
)
from scale_letkf_torch.model.dycore import DycoreConfig, DycoreState
from scale_letkf_torch.model.dycore import to_collocated
from scale_letkf_torch.obs.types import (
    ID_H08IR, ID_RADAR_REF, ID_RADAR_REF_ZERO, Observations,
)
from scale_letkf_torch.state import state_trans
from test_fastcycle import _setup as ref_setup
from test_torch_cycle import assert_increments, floor_of, rounded

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _np(s):
    return DycoreState(*(np.ascontiguousarray(np.asarray(f)) for f in s))


def _obs(o):
    return Observations(**{k: np.array(getattr(o, k)) for k in (
        "elem", "lon", "lat", "lev", "dat", "err", "typ", "dif", "meta")})


def _port_driver(driver_r, cfg, mesh=None):
    """The port's CycleDriver of the reference driver's grid, dycore and
    reference columns, with the port's copy of its config (on the process
    grid `mesh` when given)."""
    g = driver_r.grid
    grid = Grid(nx=g.nx, ny=g.ny, nz=g.nz, dx=g.dx, dy=g.dy, cz=g.cz, fz=g.fz,
                proj=Projection(kind=g.proj.kind))
    dc = driver_r.dycfg
    dycfg = DycoreConfig(dx=dc.dx, dy=dc.dy, dz=dc.dz, dt=dc.dt,
                         ztop=dc.ztop)

    def col(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32)
    return CycleDriver(grid, cfg, dycfg, col(driver_r.rho_ref),
                       col(driver_r.p_ref), mesh=mesh)


def _conv_cfg():
    dx = 2000.0
    cfg = pcfg.Config(ensemble=pcfg.EnsembleConfig(member=8),
                      letkf=pcfg.LetkfConfig(infl_mul=1.0,
                                             infl_mul_adaptive=True,
                                             relax_alpha=0.2))
    cfg.letkf_obs.hori_local = tuple([3.0 * dx] + [-1.0] * 23)
    cfg.obs_error.u = cfg.obs_error.v = cfg.obs_error.t = 0.05
    return cfg


@pytest.fixture(scope="module")
def conv():
    """The conventional case: reference and port drivers and fused
    cycles, the forecast ensemble (2 steps of the reference), the nature
    run advanced 2 steps, obs values from it (obsmake of the reference)."""
    from scale_letkf_tpu.da.obsmake import obsmake as ref_obsmake
    from scale_letkf_tpu.state import state_to_history as ref_history
    grid_r, cfg_r, driver_r, truth0, ens, template_r = ref_setup()
    truth = driver_r.forecast_one(truth0, 2)
    ens_f = driver_r.forecast(ens, 2)
    nf = ref_history(ref_trans(ref_collocated(truth)), driver_r.z_full,
                     driver_r.topo)
    obs = ref_obsmake(nf, template_r, grid_r, cfg_r, driver_r.z_full,
                      np.random.default_rng(1))
    assert obs.nobs == template_r.nobs
    driver = _port_driver(driver_r, _conv_cfg())
    return {"driver_r": driver_r, "driver": driver,
            "fc_r": RefFused(driver_r, template_r, nsteps=2),
            "fc": FusedCycle(driver, _obs(template_r), nsteps=2),
            "truth0": _np(truth0), "ens": _np(ens), "ens_f": _np(ens_f),
            "dat": np.asarray(obs.dat)}


def _radar_case(NY=12, NX=12):
    """tests/test_fastcycle.py's radar template and forecast ensemble,
    with the port's config and driver beside the reference's, on NY × NX
    columns; the initial ensemble and nature member under 'ens' and
    'truth0'."""
    from scale_letkf_tpu.config import (
        Config, EnsembleConfig, LetkfConfig, RadarConfig)
    from scale_letkf_tpu.cycle import CycleDriver as RefDriver
    from scale_letkf_tpu.da.letkf_obs import preprocess_radar_obs
    from scale_letkf_tpu.da.obsope import compute_hx_single
    from scale_letkf_tpu.grid import Grid as RefGrid
    from scale_letkf_tpu.grid import Projection as RefProjection
    from scale_letkf_tpu.model.dycore import DycoreConfig as RefDycoreConfig
    from scale_letkf_tpu.model.ideal import (
        add_warm_bubble, balanced_state, perturb_ensemble)
    from scale_letkf_tpu.obs.types import (
        QC_GOOD, QC_REF_LOW, TYP_PHARAD)
    from scale_letkf_tpu.obs.types import Observations as RefObservations
    from scale_letkf_tpu.state import state_to_history
    from test_radar_osse import seed_rain

    NZ, DZ, DX, K = 12, 500.0, 2000.0, 8
    grid = RefGrid.uniform(nx=NX, ny=NY, nz=NZ, dx=DX, dy=DX, dz=DZ,
                           proj=RefProjection(kind="LC"))
    vl = tuple([0.2] + [-1.0] * 20 + [1500.0, -1.0, -1.0])
    kw = dict(radar=dict(method_ref_calc=3, min_radar_ref_member=1,
                         radar_ref_thres_dbz=10.0))
    cfg = Config(ensemble=EnsembleConfig(member=K),
                 letkf=LetkfConfig(infl_mul=1.05),
                 radar=RadarConfig(**kw["radar"]))
    cfg.letkf_obs.hori_local = tuple([4.0e3] + [-1.0] * 23)
    cfg.letkf_obs.vert_local = vl
    cfg_p = pcfg.Config(ensemble=pcfg.EnsembleConfig(member=K),
                        letkf=pcfg.LetkfConfig(infl_mul=1.05),
                        radar=pcfg.RadarConfig(**kw["radar"]))
    cfg_p.letkf_obs.hori_local = tuple([4.0e3] + [-1.0] * 23)
    cfg_p.letkf_obs.vert_local = vl
    dycfg = RefDycoreConfig(dx=DX, dy=DX, dz=DZ, dt=1.0, ztop=NZ * DZ)
    s0, rho_ref, p_ref = balanced_state(NZ, NY, NX, DZ,
                                        qv_prof=0.008 * np.ones(NZ))
    driver_r = RefDriver(grid, cfg, dycfg, rho_ref, p_ref)
    radar_site = (float(grid.lonlat[0][1, 1]), float(grid.lonlat[1][1, 1]),
                  50.0)
    base = add_warm_bubble(s0, DZ, DX, DX, amplitude=2.0)
    allp = perturb_ensemble(jax.random.PRNGKey(5), base, K + 1,
                            amplitude=0.5)
    scales = np.abs(1.0 + 0.4 * np.random.default_rng(7)
                    .standard_normal(K + 1)).astype(np.float32)
    allp = jax.vmap(seed_rain)(allp, jnp.asarray(scales))
    truth0 = jax.tree.map(lambda a: a[0], allp)
    ens = jax.tree.map(lambda a: a[1:], allp)
    truth = driver_r.forecast_one(truth0, 5)
    ens_f = driver_r.forecast(ens, 5)
    lon2d, lat2d = grid.lonlat
    recs = [(lon2d[j, i], lat2d[j, i], (k + 0.5) * DZ)
            for k in range(2, 9, 2) for j in range(2, NY - 2, 2)
            for i in range(2, NX - 2, 2)]
    n = len(recs)
    raw = RefObservations(
        elem=np.full(n, ID_RADAR_REF, np.int32),
        lon=np.asarray([r[0] for r in recs]),
        lat=np.asarray([r[1] for r in recs]),
        lev=np.asarray([r[2] for r in recs]), dat=np.zeros(n),
        err=np.ones(n), typ=np.full(n, TYP_PHARAD, np.int32),
        dif=np.zeros(n), meta=np.asarray(radar_site))
    nf = state_to_history(ref_trans(ref_collocated(truth)), driver_r.z_full,
                          driver_r.topo)
    y, qc = compute_hx_single(nf, raw, grid, cfg, driver_r.z_full)
    y, qc = np.asarray(y), np.asarray(qc)
    keep = (qc == QC_GOOD) | (qc == QC_REF_LOW)
    obs = raw.select(keep)
    lin = 10.0 ** (y[keep] / 10.0)
    lin[qc[keep] == QC_REF_LOW] = 0.5
    lin[::7] = 0.5
    obs.dat = lin
    obs.err = np.full(obs.nobs, cfg.obs_error.radar_ref)
    template_r = preprocess_radar_obs(obs, cfg)
    assert (template_r.elem == ID_RADAR_REF_ZERO).any()
    assert (template_r.elem == ID_RADAR_REF).any()
    return {"driver_r": driver_r, "driver": _port_driver(driver_r, cfg_p),
            "cfg_r": cfg, "cfg": cfg_p, "template_r": template_r,
            "ens_f": _np(ens_f), "ens": _np(ens), "truth0": _np(truth0)}


@pytest.fixture(scope="module")
def radar():
    case = _radar_case()
    return {**case,
            "fc_r": RefFused(case["driver_r"], case["template_r"], nsteps=5),
            "fc": FusedCycle(case["driver"], _obs(case["template_r"]),
                             nsteps=5)}


def test_structural_context_matches_reference(radar):
    """The template-only context: every obs of the preprocessed radar
    template (ref-zero included) in the buckets, each ctype's bucket table
    and members equal to the reference's, dat bit-equal and untouched."""
    t_r = radar["template_r"]
    ctx_r = ref_context(t_r, None, np.zeros(t_r.nobs, np.int32),
                        radar["cfg_r"], radar["driver_r"].grid,
                        structural=True)
    ctx = build_obs_context(_obs(t_r), None, np.zeros(t_r.nobs, np.int32),
                            radar["cfg"], radar["driver"].grid,
                            structural=True)
    np.testing.assert_array_equal(ctx.dat, t_r.dat)
    np.testing.assert_array_equal(ctx.dat, ctx_r.dat)
    np.testing.assert_array_equal(ctx.qc, ctx_r.qc)
    assert ctx.hdxb.shape == ctx_r.hdxb.shape and not ctx.hdxb.any()
    assert sum(len(ct.obs_idx) for ct in ctx.ctypes) == t_r.nobs
    assert len(ctx.ctypes) == len(ctx_r.ctypes) == 2
    for ct, ct_r in zip(ctx.ctypes, ctx_r.ctypes):
        assert (ct.elem, ct.typ, ct.max_nobs) == (ct_r.elem, ct_r.typ,
                                                  ct_r.max_nobs)
        np.testing.assert_array_equal(ct.obs_idx, ct_r.obs_idx)
        np.testing.assert_array_equal(ct.buckets.table,
                                      np.asarray(ct_r.buckets.table))
    # the fused cycle's context is this one (err overrides idempotent)
    np.testing.assert_array_equal(radar["fc"].ctx.dat, t_r.dat)


def _hx_close(y, y_r):
    y_r = np.asarray(y_r)
    tol = 2e-5 * (y_r.max() - y_r.min()) + 4 * np.spacing(
        np.float32(np.abs(y_r).max()))
    assert np.abs(y.numpy() - y_r).max() <= tol


@pytest.mark.parametrize("name", ["conv", "radar"])
def test_qc_mask_matches_reference(conv, radar, name):
    """_hx_ens close to the reference's with equal QC; _qc_mask on the
    reference's own H(x), QC and departures (obs 0 made a gross outlier)
    equal to the reference's mask."""
    case = conv if name == "conv" else radar
    fc, fc_r = case["fc"], case["fc_r"]
    ens_f = case["ens_f"]
    gues_r = ref_trans(jax.vmap(ref_collocated)(RefState(*map(jnp.asarray,
                                                              ens_f))))
    y_r, qc_r = fc_r._hx_ens(gues_r)
    y, qc = fc._hx_ens(state_trans(to_collocated(
        dycore_state_to_torch(ens_f, CPU))))
    _hx_close(y, y_r)
    np.testing.assert_array_equal(qc.numpy(), np.asarray(qc_r))
    dat = np.asarray(case["dat"] if name == "conv"
                     else case["template_r"].dat).copy()
    dat[0] += 1000.0
    dep_r = jnp.asarray(dat, y_r.dtype) - jnp.mean(y_r, axis=0)
    good_r = np.asarray(fc_r._qc_mask(y_r, qc_r, dep_r))
    good = fc._qc_mask(torch.as_tensor(np.asarray(y_r)),
                       torch.as_tensor(np.asarray(qc_r)),
                       torch.as_tensor(np.asarray(dep_r)))
    np.testing.assert_array_equal(good.numpy(), good_r)
    assert not good_r[0] and good_r.sum() > 0
    if name == "radar":
        zero = radar["template_r"].elem == ID_RADAR_REF_ZERO
        assert good_r[zero].any() and not good_r.all()


def _assimilated(case, dat):
    fc, fc_r = case["fc"], case["fc_r"]
    ens_r, infl_r, diag_r = fc_r.assimilate(
        RefState(*map(jnp.asarray, case["ens_f"])), jnp.asarray(dat),
        fc_r.initial_inflation())
    ens, infl, diag = fc.assimilate(
        dycore_state_to_torch(case["ens_f"], CPU),
        torch.as_tensor(dat, dtype=torch.float32), fc.initial_inflation())
    return (ens, infl, diag), (ens_r, infl_r, diag_r)


def _diag_close(diag, diag_r):
    assert int(diag["nobs_used"]) == int(diag_r["nobs_used"])
    for k in ("omb_rmse", "oma_rmse"):
        np.testing.assert_allclose(float(diag[k]), float(diag_r[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(diag["oma_rmse"]) < float(diag["omb_rmse"])


@pytest.mark.parametrize("name", ["conv", "radar", "conv_outlier"])
def test_assimilate_matches_reference(conv, radar, name):
    case = radar if name == "radar" else conv
    dat = np.asarray(case["dat"] if case is conv
                     else radar["template_r"].dat).copy()
    if name == "conv_outlier":
        dat[0] += 1000.0
    (ens, infl, diag), (ens_r, infl_r, diag_r) = _assimilated(case, dat)
    assert_increments(dycore_state_to_numpy(ens), case["ens_f"],
                      [np.asarray(f) for f in ens_r])
    _diag_close(diag, diag_r)
    np.testing.assert_allclose(infl.numpy(), np.asarray(infl_r), rtol=1e-4,
                               atol=1e-6)
    if name != "radar":
        n = len(dat) - (name == "conv_outlier")
        assert int(diag["nobs_used"]) == n


def test_step_matches_reference(conv):
    """forecast + assimilate: the conventional case's 2 steps from the
    initial ensemble."""
    fc, fc_r = conv["fc"], conv["fc_r"]
    dat = conv["dat"]
    ens_r, _, diag_r = fc_r.step(RefState(*map(jnp.asarray, conv["ens"])),
                                 jnp.asarray(dat), fc_r.initial_inflation())

    def port(e):
        return fc.step(dycore_state_to_torch(e, CPU),
                       torch.as_tensor(dat, dtype=torch.float32),
                       fc.initial_inflation())
    ens, _, diag = port(conv["ens"])
    ens2, _, _ = port(rounded(conv["ens"], 9))
    assert_increments(dycore_state_to_numpy(ens), conv["ens"],
                      [np.asarray(f) for f in ens_r],
                      extra=floor_of(ens2, ens))
    _diag_close(diag, diag_r)
    # the driver's timer is back, and the step recorded no section
    assert conv["driver"].timer.enabled
    assert "forecast" not in conv["driver"].timer.records


def test_run_osse_is_a_loop_of_step(conv):
    """Two cycles of run_osse against the port's own step fed the same
    nature run and noise; the analysis improves on the guess."""
    fc, d = conv["fc"], conv["driver"]
    truth, ens, series = fc.run_osse(
        dycore_state_to_torch(conv["truth0"], CPU),
        dycore_state_to_torch(conv["ens"], CPU), n_cycles=2, seed=4)
    gen = torch.Generator().manual_seed(4)
    t = dycore_state_to_torch(conv["truth0"], CPU)
    e = dycore_state_to_torch(conv["ens"], CPU)
    infl = fc.initial_inflation()
    for c in range(2):
        t = d.forecast_one(t, 2)
        y_nat, _ = fc._hx(state_trans(to_collocated(t)))
        dat = y_nat + fc._err * torch.randn(fc._err.shape, generator=gen)
        e, infl, diag = fc.step(e, dat, infl)
        assert float(series["omb"][c]) == float(diag["omb_rmse"])
        assert float(series["oma"][c]) == float(diag["oma_rmse"])
        assert int(series["nobs_used"][c]) == int(diag["nobs_used"])
    for a, b in zip(ens, e):
        assert torch.equal(a, b)
    for a, b in zip(truth, t):
        assert torch.equal(a, b)
    # the reference's own checks (tests/test_fastcycle.py): the first
    # cycle's analysis improves on its guess
    assert series["rmse_anal"][0] < series["rmse_gues"][0]
    assert series["oma"][0] < series["omb"][0]
    assert (series["nobs_used"] > 0).all()
    assert len(series["seconds"]) == 2


def test_fused_refusals(conv):
    """H08 templates and linear-Z reflectivity are refused."""
    tmpl = _obs(conv["fc_r"].template)
    tmpl.elem[0] = ID_H08IR
    with pytest.raises(NotImplementedError, match="H08"):
        FusedCycle(conv["driver"], tmpl, nsteps=2)
    tmpl = _obs(conv["fc_r"].template)
    tmpl.elem[0], tmpl.dat[0] = ID_RADAR_REF, 500.0
    with pytest.raises(ValueError, match="linear-Z"):
        FusedCycle(conv["driver"], tmpl, nsteps=2)

