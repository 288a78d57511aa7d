"""The deterministic member (DET_RUN) and additive inflation (INFL_ADD) of
the port's analysis against the reference package, on the CPU.

- letkf_core's transmd on every solver of the port against the reference's
  production solver (the Pallas kernel in TPU interpret mode) and, in
  float64, against its eigh;
- analyze with a deterministic member, on tests/test_torch_analyze.py's
  coarsened 18-km slice (24×20×4, K = 20) in its RTPP and var-local cases:
  ensemble and deterministic increments to 1e-4·max|increment| + 2 ulp
  (_assert_increments_close);
- the additive increment, apply_additive_inflation from the same inputs in
  both packages (shuffle on and off, the INFL_ADD_REF_ONLY weight of radar
  reflectivity obs, INFL_ADD_Q_RATIO): to rtol 1e-6, the analysis through
  analyze to the increments bound.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scale_letkf_tpu import state as ref_state
from scale_letkf_tpu.da import inflation as ref_infl
from scale_letkf_tpu.da.letkf import analyze as ref_analyze
from scale_letkf_tpu.da.letkf_obs import build_obs_context as ref_context
from scale_letkf_tpu.obs.types import Observations as RefObservations
from scale_letkf_tpu.ops import letkf_core as ref_core
from scale_letkf_torch import state
from scale_letkf_torch.da import inflation
from scale_letkf_torch.da import letkf
from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.io.convert import ensemble_to_torch
from scale_letkf_torch.obs.types import (
    ID_RADAR_REF, TYP_PHARAD, Observations,
)
from scale_letkf_torch.ops.letkf_core import letkf_core
from scale_letkf_torch.synthetic import synthetic_gues
from test_torch_analyze import (
    CPU, K, _assert_increments_close, _configs, _inputs,
)

torch.set_num_threads(1)

REF_SOLVER = {"ns_kernel": "ns_pallas", "ns": "ns", "eigh": "lax",
              "jacobi": "jacobi"}


def _core_problem(K_, dtype, seed=4):
    rng = np.random.default_rng(seed)
    B, L = 32, 30
    hdxb = (0.5 * rng.standard_normal((B, L, K_))).astype(dtype)
    rdiag = rng.uniform(0.5, 2.0, (B, L)).astype(dtype)
    rloc = rng.uniform(0.0, 1.0, (B, L)).astype(dtype)
    rloc[:3] = 0.0              # zero-obs rows
    dep = rng.standard_normal((B, L)).astype(dtype)
    depd = (dep + 0.3 * rng.standard_normal((B, L))).astype(dtype)
    infl = np.full(B, 1.1, dtype)
    return hdxb, rdiag, rloc, dep, infl, depd


def _close(got, want, ulps=2):
    want = np.asarray(want)
    scale = np.abs(want).max()
    tol = 1e-4 * scale + ulps * np.spacing(scale.astype(want.dtype))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


@pytest.mark.parametrize("solver", ["ns_kernel", "ns", "eigh", "jacobi"])
def test_transmd_matches_reference(solver):
    """float32: transmd (and transm beside it) against the reference's
    letkf_core on the same solver, the Pallas kernel in interpret mode for
    ns_kernel; zero-obs rows give zero."""
    K_ = 20
    args = _core_problem(K_, np.float32)
    with pltpu.force_tpu_interpret_mode():
        r = ref_core.letkf_core(*(jnp.asarray(a) for a in args[:5]),
                                depd=jnp.asarray(args[5]),
                                eigh_impl=REF_SOLVER[solver])
    res = letkf_core(*(torch.from_numpy(a) for a in args[:5]),
                     depd=torch.from_numpy(args[5]), solver=solver)
    _close(res.transmd.numpy(), r.transmd)
    _close(res.transm.numpy(), r.transm)
    assert float(res.transmd[:3].abs().max()) == 0.0
    assert float(res.transmd.abs().max()) > 0.0


@pytest.mark.parametrize("solver", ["eigh", "jacobi"])
def test_transmd_float64_and_unused(solver):
    """float64 against the reference's eigh; without depd transmd is zero,
    as the reference's."""
    K_ = 8
    args = _core_problem(K_, np.float64, seed=5)
    r = ref_core.letkf_core(*(jnp.asarray(a) for a in args[:5]),
                            depd=jnp.asarray(args[5]), eigh_impl="lax")
    res = letkf_core(*(torch.from_numpy(a) for a in args[:5]),
                     depd=torch.from_numpy(args[5]), solver=solver)
    np.testing.assert_allclose(res.transmd.numpy(), np.asarray(r.transmd),
                               rtol=0, atol=1e-9)
    res0 = letkf_core(*(torch.from_numpy(a) for a in args[:5]),
                      solver=solver)
    assert float(res0.transmd.abs().max()) == 0.0


def _det_inputs(cfg, grid, restart, obs):
    """A deterministic member (restart variables, one synthetic analysis
    member of another seed) and its H(x) near the obs."""
    rng = np.random.default_rng(11)
    det = synthetic_gues(rng, 1, grid.nz, grid.ny, grid.nx, grid.cz)
    det_restart = np.array(ref_state.state_trans_inv(jnp.asarray(det)))[0]
    ensval_det = (obs.dat + 0.5 * rng.standard_normal(obs.nobs)
                  * obs.err).astype(np.float32)
    return det_restart, ensval_det


def _ref_obs(obs):
    return RefObservations(**{k: getattr(obs, k) for k in (
        "elem", "lon", "lat", "lev", "dat", "err", "typ", "dif", "meta")})


def _run_both(cfg_r, grid_r, cfg, grid, restart, obs, ensval, det=None,
              ensval_det=None, addi=None, seed=3):
    """Analysis variables: (ref guess, ref anal, ref det, ref anal_det),
    then the port's four."""
    qc = np.zeros(obs.nobs, np.int32)
    z = grid_r.calc_z(np.zeros((grid.ny, grid.nx)))
    gues_r = ref_state.state_trans(jnp.asarray(restart))
    ctx_r = ref_context(_ref_obs(obs), ensval, qc, cfg_r, grid_r,
                        ensval_det=ensval_det)
    det_r = (None if det is None
             else ref_state.state_trans(jnp.asarray(det)[None])[0])
    with pltpu.force_tpu_interpret_mode():
        a_r, ad_r, _ = ref_analyze(
            gues_r, ctx_r, cfg_r, grid_r, jnp.asarray(z, jnp.float32),
            gues_det=det_r,
            addi_ens=None if addi is None else jnp.asarray(addi),
            rng=np.random.default_rng(seed))
    gues = state.state_trans(ensemble_to_torch(restart, CPU))
    ctx = build_obs_context(obs, ensval, qc, cfg, grid, ensval_det=ensval_det)
    det_p = (None if det is None
             else state.state_trans(ensemble_to_torch(det[None], CPU))[0])
    a, diag = letkf.analyze(
        gues, ctx, cfg, grid, grid.calc_z(torch.zeros((grid.ny, grid.nx))),
        device=CPU, gues_det=det_p,
        addi_ens=None if addi is None else torch.from_numpy(addi),
        rng=np.random.default_rng(seed))
    def host(x):
        return None if x is None else np.asarray(x)
    return (host(gues_r), host(a_r), host(det_r), host(ad_r), gues.numpy(),
            a.numpy(), host(det_p), host(diag.anal_det))


@pytest.mark.parametrize("case", ["rtpp", "varlocal_q"])
def test_analyze_with_deterministic_member(case):
    cfg_r, grid_r, cfg, grid = _configs(case)
    restart, obs, ensval = _inputs(cfg, grid)
    det, ensval_det = _det_inputs(cfg, grid, restart, obs)
    g_r, a_r, d_r, ad_r, g, a, d, ad = _run_both(
        cfg_r, grid_r, cfg, grid, restart, obs, ensval, det, ensval_det)
    assert np.isfinite(ad).all()
    _assert_increments_close(g, a, g_r, a_r)
    _assert_increments_close(d[None], ad[None], d_r[None], ad_r[None])
    # the member moved, in the mass and wind fields alike
    assert np.abs(ad - d).max(axis=(1, 2, 3))[:state.IA_Q0].min() > 0


def _radar_obs(grid, n=60, seed=9):
    """Radar reflectivity obs (PAWR report type, z levels) in the middle of
    the domain, for the INFL_ADD_REF_ONLY weight."""
    rng = np.random.default_rng(seed)
    lon, lat = grid.ij_to_lonlat(rng.uniform(8, 14, n), rng.uniform(6, 12, n))
    dbz = rng.uniform(10.0, 40.0, n)
    return Observations(
        elem=np.full(n, ID_RADAR_REF, np.int32), lon=lon, lat=lat,
        lev=rng.uniform(500.0, 3000.0, n), dat=10.0 ** (0.1 * dbz),
        err=np.full(n, 5.0), typ=np.full(n, TYP_PHARAD, np.int32),
        dif=np.zeros(n), meta=np.asarray([135.0, 35.0, 0.0]))


ADDI_CASES = {
    "plain": {},
    "shuffle": {"infl_add_shuffle": True},
    "ref_only": {"infl_add_ref_only": True},
    "q_ratio": {"infl_add_q_ratio": True, "infl_add_shuffle": True},
}


def _addi_setup(case):
    cfg_r, grid_r, cfg, grid = _configs("rtpp")
    for c in (cfg_r, cfg):
        c.letkf.infl_add = 0.1
        for k, v in ADDI_CASES[case].items():
            setattr(c.letkf, k, v)
    restart, obs, ensval = _inputs(cfg, grid)
    if case == "ref_only":
        # a 20-km radar localization: the weight's cutoff (73 km) leaves
        # the domain's edges out
        for c in (cfg_r, cfg):
            hl = list(c.letkf_obs.hori_local)
            hl[TYP_PHARAD] = 20.0e3
            c.letkf_obs.hori_local = tuple(hl)
        rad = _radar_obs(grid)
        rng = np.random.default_rng(10)
        obs = Observations.concatenate([obs, rad])
        ensval = np.concatenate(
            [ensval, (20.0 + 8.0 * rng.standard_normal((K, rad.nobs)))
             .astype(np.float32)], axis=1)
    addi = synthetic_gues(np.random.default_rng(12), K, grid.nz, grid.ny,
                          grid.nx, grid.cz)
    return cfg_r, grid_r, cfg, grid, restart, obs, ensval, addi


@pytest.mark.parametrize("case", list(ADDI_CASES))
def test_additive_increment_matches_reference(case):
    """The increment alone: apply_additive_inflation of both packages on a
    zero analysis, with the shuffle of the same generator, the radar weight
    of each package's own obs context and the same guess mean: rtol 1e-6."""
    cfg_r, grid_r, cfg, grid, restart, obs, ensval, addi = _addi_setup(case)
    lt = cfg.letkf
    qc = np.zeros(obs.nobs, np.int32)
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    xs, ys = grid.xy
    gx = np.broadcast_to(xs[None, :], (ny, nx)).reshape(-1).astype(np.float32)
    gy = np.broadcast_to(ys[:, None], (ny, nx)).reshape(-1).astype(np.float32)
    w_r = w = None
    if lt.infl_add_ref_only:
        ctx_r = ref_context(_ref_obs(obs), ensval, qc, cfg_r, grid_r)
        ctx = build_obs_context(obs, ensval, qc, cfg, grid)
        (ct_r,) = [c for c in ctx_r.ctypes if c.elem == ID_RADAR_REF]
        (ct,) = [c for c in ctx.ctypes if c.elem == ID_RADAR_REF]
        w_r = ref_infl.radar_proximity_weight(
            gx, gy, ctx_r.x[ct_r.obs_idx], ctx_r.y[ct_r.obs_idx],
            ct_r.hori_scale, buckets=ct_r.buckets, obs_x_all=ctx_r.x,
            obs_y_all=ctx_r.y)
        w = inflation.radar_proximity_weight(
            torch.from_numpy(gx), torch.from_numpy(gy), ctx.x[ct.obs_idx],
            ctx.y[ct.obs_idx], ct.hori_scale, buckets=ct.buckets,
            obs_x_all=ctx.x, obs_y_all=ctx.y)
        np.testing.assert_allclose(w.numpy(), w_r, rtol=1e-12)
        assert 0 < (w_r > 0).sum() < w_r.size
        w_r = jnp.asarray(w_r.reshape(ny, nx), jnp.float32)
        w = w.float().reshape(ny, nx)
    shuf = (inflation.knuth_shuffle(np.random.default_rng(3), K)
            if lt.infl_add_shuffle else None)
    if shuf is not None:
        np.testing.assert_array_equal(
            shuf, ref_infl.knuth_shuffle(np.random.default_rng(3), K))
        assert (shuf != np.arange(K)).any()
    gm = np.asarray(ref_state.state_trans(jnp.asarray(restart))).mean(0)
    zero = np.zeros_like(addi)
    inc_r = np.asarray(ref_infl.apply_additive_inflation(
        jnp.asarray(zero), jnp.asarray(addi), lt.infl_add, shuffle=shuf,
        weight=w_r, q_ratio=lt.infl_add_q_ratio, gues_mean=jnp.asarray(gm)))
    inc = inflation.apply_additive_inflation(
        torch.from_numpy(zero), torch.from_numpy(addi), lt.infl_add,
        shuffle=shuf, weight=w, q_ratio=lt.infl_add_q_ratio,
        gues_mean=torch.from_numpy(gm)).numpy()
    np.testing.assert_allclose(inc, inc_r, rtol=1e-6, atol=0)
    assert np.abs(inc).max() > 0
    if lt.infl_add_ref_only:
        assert (inc[:, :, :, np.asarray(w) == 0] == 0).all()


@pytest.mark.parametrize("case", list(ADDI_CASES))
def test_analyze_with_additive_inflation(case):
    """The whole analysis with the additive stage (rng seed 3) against the
    reference's: increments to 1e-4·max|increment| + 2 ulp."""
    cfg_r, grid_r, cfg, grid, restart, obs, ensval, addi = _addi_setup(case)
    g_r, a_r, _, _, g, a, _, _ = _run_both(cfg_r, grid_r, cfg, grid, restart,
                                           obs, ensval, addi=addi)
    assert np.isfinite(a).all()
    _assert_increments_close(g, a, g_r, a_r)


def test_analyze_needs_its_inputs():
    """INFL_ADD > 0 without a source ensemble and a deterministic member
    without depd are refused, as the reference refuses the first."""
    _, _, cfg, grid = _configs("rtpp")
    restart, obs, ensval = _inputs(cfg, grid)
    gues = state.state_trans(ensemble_to_torch(restart, CPU))
    ctx = build_obs_context(obs, ensval, np.zeros(obs.nobs, np.int32), cfg,
                            grid)
    z = grid.calc_z(torch.zeros((grid.ny, grid.nx)))
    with pytest.raises(ValueError, match="depd"):
        letkf.analyze(gues, ctx, cfg, grid, z, device=CPU, gues_det=gues[0])
    cfg.letkf.infl_add = 0.1
    with pytest.raises(ValueError, match="additive-inflation ensemble"):
        letkf.analyze(gues, ctx, cfg, grid, z, device=CPU)


def test_gpu_check_det_helpers_on_cpu():
    """gpu_check's deterministic-member, additive-inflation, Jacobi, EFSO
    and H08-fit comparisons, run with the CPU in the card's place: each
    runs its paths, and a run agrees with itself exactly."""
    from pathlib import Path
    from scale_letkf_torch import gpu_check
    config = str(Path(__file__).resolve().parents[1] / "configs"
                 / "18km_japan.toml")
    res = {"analysis": gpu_check.coarse_det_addi_vs_cpu(CPU, config),
           "verbs": gpu_check.det_verbs_vs_cpu(CPU)}
    assert gpu_check.det_check_passes(res)
    assert not any(res["analysis"]["max_err_over_tol"].values())
    assert not any(res["verbs"]["max_err_over_tol"].values())
    assert gpu_check.jacobi_vs_cpu(CPU, 8, B=64)["passes"]
    efso = gpu_check.coarse_efso_vs_cpu(CPU, config)
    assert efso["finite"] and not any(efso["max_err_over_tol"].values())
    fit = gpu_check.h08_fit_vs_cpu(CPU, steps=20)
    assert fit["passes"] and fit["coef_max_rel_diff"] == 0.0
