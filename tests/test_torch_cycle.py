"""The analysis half of the DA cycle as a whole against the reference
package, on the CPU: CycleDriver.analysis (H(x) in the driver, and the
precomputed-H(x) path) and a 2-cycle run_osse.

The analysis runs three ways: H(x) in the driver, the precomputed-H(x)
path, and the 4-D obs operator on per-slot snapshots.

Configuration: configs/18km_japan.toml (its core, dt, substeps, sponge,
localization, RTPP, inflation and 7-slot window settings) on a 16×12×8
domain of its 18-km cells with levels dz 1 km × 1.1ᵏ (ztop ≈ 11 km, so the
sonde levels up to 200 hPa lie inside), K = 6; the reference gathers
float32 (hdxb_gather_bf16 off), as the port does. The restart ensemble and
the nature run are the reference bench's synthetic construction (balanced
column, 2-K tapered ρθ noise) with a 10 m/s wind; the obs are a synthetic
conventional network (25 sondes × 8 levels × U/V/T/Q, 40 PS) made by
obsmake from the nature run.

Tolerances: restart-space increments per field to 1e-4·max|Δ| plus 6 ulp
of max|field| (tests/test_torch_analyze.py's bound: restart variables are
products and quotients of two analysis variables); analysis-space means and
spreads to 1e-4 of the variable's largest increment plus 2 ulp of its
largest mean (numpy's float64 mean and spread of the reference's
ensembles); O−B / O−A statistics to 1e-5 relative plus the float32
rounding of H(x). run_osse adds the forecasts, whose float32
arithmetic amplifies rounding (ROADMAP §3): its bound adds twice the port's
own rounding floor, measured by a second port run from inputs perturbed by
one rounding.
"""

import dataclasses
import weakref
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_letkf_tpu.bench_fullsize import _synthetic_ens_dycore
from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_tpu.cli.main import make_driver as ref_make_driver
from scale_letkf_tpu.da.obsope import obsope_ensemble as ref_obsope
from scale_letkf_tpu.model.dycore import DycoreState as RefState
from scale_letkf_tpu.model.dycore import to_collocated as ref_collocated
from scale_letkf_tpu.obs.types import Observations as RefObservations
from scale_letkf_tpu.state import state_to_history as ref_history
from scale_letkf_tpu.state import state_trans as ref_trans
from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
from scale_letkf_torch.cycle import CycleDriver
from scale_letkf_torch.da.monitor import MONIT_GROUPS
from scale_letkf_torch.da.obsmake import obsmake
from scale_letkf_torch.da.obsope import assign_slots
from scale_letkf_torch.io.convert import (
    dycore_state_to_numpy, dycore_state_to_torch,
)
from scale_letkf_torch.model.dycore import DycoreState, to_collocated
from scale_letkf_torch.state import state_to_history, state_trans
from scale_letkf_torch.synthetic import synthetic_conv_network

torch.set_num_threads(1)
CPU = torch.device("cpu")
CONFIG = str(Path(__file__).resolve().parents[1] / "configs"
             / "18km_japan.toml")
K = 6
OVER = {"nx": 16, "ny": 12, "nz": 8, "dz": 1000.0, "dz_stretch": 1.1}


def setup_pair():
    """(reference driver, port driver, reference grid, port grid, cfg)."""
    out = []
    for load, make in ((ref_load, ref_make_driver), (load_config_and_grid,
                                                     make_driver)):
        cfg, grid, dycfg, dom = load(CONFIG, OVER)
        cfg.ensemble.member = K
        cfg.letkf.hdxb_gather_bf16 = False
        out.append((make(cfg, grid, dycfg, dom) if make is ref_make_driver
                    else make(cfg, grid, dycfg, dom, CPU), grid, cfg, dom))
    (d_r, g_r, cfg_r, dom), (d, g, cfg, _) = out
    return d_r, d, g_r, g, cfg, dom


def states(grid_r, dom, seed=0):
    """(nature member, K-member ensemble) as numpy DycoreStates."""
    s, _, _ = _synthetic_ens_dycore(np.random.default_rng(seed), K + 1,
                                    grid_r, dom, amp_theta=2.0)
    s = s._replace(rhou=(10.0 * s.rho).astype(np.float32))
    return (DycoreState(*(np.ascontiguousarray(f[0]) for f in s)),
            DycoreState(*(np.ascontiguousarray(f[1:]) for f in s)))


def to_ref(s):
    return RefState(*(jnp.asarray(f) for f in s))


def template(cfg, grid):
    """The obs network, in both packages' Observations."""
    obs = synthetic_conv_network(cfg, grid, np.random.default_rng(1),
                                 n_sonde=25, n_ps=40)
    arrays = {k: getattr(obs, k) for k in ("elem", "lon", "lat", "lev",
                                           "dat", "err", "typ", "dif")}
    return RefObservations(**arrays), obs


def assert_increments(out, init, out_r, ulps=6, extra=None):
    """Per field: |Δ − Δ_ref| ≤ 1e-4·max|Δ_ref| + ulps·ulp(max|field|)
    (+ extra[field], a measured floor)."""
    for name, a, b, f0 in zip(DycoreState._fields, out, out_r, init):
        a, b, f0 = (np.asarray(x, np.float64) for x in (a, b, f0))
        tol = (1e-4 * np.abs(b - f0).max()
               + ulps * np.spacing(np.float32(np.abs(f0).max()))
               + (extra or {}).get(name, 0.0))
        err = np.abs(a - b).max()
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def assert_stats(st, st_r, obsdep):
    """Departure statistics per monitored group: the same obs counts, bias
    and RMSE to 1e-5 relative plus 12 float32 ulp of the group's largest
    obs value (the float32 H(x); 12 for PS's prsadj power)."""
    assert st.nobs == st_r.nobs
    for n, ids in MONIT_GROUPS:
        if st.nobs[n]:
            ulp = np.spacing(np.float32(np.abs(
                obsdep.dat[np.isin(obsdep.elem, ids)]).max()))
            for a, b in ((st.rmse[n], st_r.rmse[n]),
                         (st.bias[n], st_r.bias[n])):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=12 * ulp,
                                           err_msg=n)


@pytest.fixture(scope="module")
def case():
    d_r, d, g_r, g, cfg, dom = setup_pair()
    nature, ens = states(g_r, dom)
    tmpl_r, tmpl = template(cfg, g)
    # obs from the nature run, made once (by the port) for both packages
    nat_t = dycore_state_to_torch(nature, CPU)
    obs = obsmake(state_to_history(state_trans(to_collocated(nat_t)),
                                   d.z_full, d.topo),
                  tmpl, g, cfg, d.z_full, np.random.default_rng(2))
    obs_r = RefObservations(**{k: getattr(obs, k) for k in (
        "elem", "lon", "lat", "lev", "dat", "err", "typ", "dif")})
    return d_r, d, g_r, g, cfg, nature, ens, tmpl_r, tmpl, obs_r, obs


@pytest.mark.parametrize("path", ["integrated", "precomputed_hx",
                                  "hist_slots"])
def test_analysis_matches_reference(case, path):
    d_r, d, g_r, g, cfg, nature, ens, _, _, obs_r, obs = case
    kw_r = kw = {}
    if path == "hist_slots":
        # the 4-D obs operator: the configuration's 7 one-hour slots, each
        # its own snapshot (ρθ scaled by 1 + 2e-3·(slot − 4)), and the obs
        # spread over ±4 h, so some fall outside the window
        hist = np.stack([np.asarray(ref_trans(jax_vmap_collocated(to_ref(
            ens._replace(rhot=ens.rhot * np.float32(1 + 2e-3 * (s - 3)))))))
            for s in range(7)], axis=1)
        dif = np.random.default_rng(7).uniform(-4 * 3600, 4 * 3600, obs.nobs)
        obs_r = RefObservations(**{k: getattr(obs_r, k) for k in (
            "elem", "lon", "lat", "lev", "dat", "err", "typ")}, dif=dif)
        obs = dataclasses.replace(obs, dif=dif)
        kw_r = kw = {"hist_slots": hist, "slots": assign_slots(dif, cfg)}
        assert {0, 8} <= set(kw["slots"].tolist())
    elif path == "precomputed_hx":
        # the reference's own ensemble H(x), as a separate obsope gives it
        gues_r = ref_trans(jax_vmap_collocated(to_ref(ens)))
        hx = ref_obsope({k: v for k, v in _vmap_history(gues_r, d_r).items()},
                        obs_r, g_r, d_r.cfg, d_r.z_full)
        pre = (np.asarray(hx.ensval), hx.qc, None)
        kw_r = kw = {"precomputed_hx": pre}
    ens_a_r, info_r = d_r.analysis(to_ref(ens), obs_r, **kw_r)
    ens_a, info = d.analysis(dycore_state_to_torch(ens, CPU), obs, **kw)
    assert_stats(info["stats_gues"], info_r["stats_gues"], info["obsdep"])
    assert_stats(info["stats_anal"], info_r["stats_anal"], info["obsdep"])
    assert info["stats_gues"].nobs["U"] > 100
    assert (info["stats_gues_bytype"].format("O-B")
            .splitlines()[:3] == info_r["stats_gues_bytype"].format("O-B")
            .splitlines()[:3])
    assert_increments(dycore_state_to_numpy(ens_a), ens,
                      [np.asarray(f) for f in ens_a_r])
    for key in ("gues", "anal"):
        stack = np.asarray(info_r[key])
        mean_r, sprd_r = stack.mean(axis=0), stack.std(axis=0, ddof=1)
        for v in range(mean_r.shape[0]):
            # a spread is as exact as the mean it is taken around
            tol = (1e-4 * np.abs(np.asarray(info_r["anal"])[:, v]
                                 - np.asarray(info_r["gues"])[:, v]).max()
                   + 2 * np.spacing(np.float32(np.abs(mean_r[v]).max())))
            for got, want in ((info[f"{key}_mean"][v], mean_r[v]),
                              (info[f"{key}_sprd"][v], sprd_r[v])):
                assert np.abs(got.numpy() - want).max() <= tol, (key, v)
    o, o_r = info["obsdep"], info_r["obsdep"]
    np.testing.assert_array_equal(o.qc, o_r.qc)
    np.testing.assert_allclose(o.oma, o_r.oma, rtol=0,
                               atol=1e-4 * np.abs(o_r.oma - o_r.omb).max()
                               + 1e-5 * np.abs(o_r.dat).max())
    assert info["diag"].chunk == g.nx * g.ny


def jax_vmap_collocated(s):
    import jax
    return jax.vmap(ref_collocated)(s)


def _vmap_history(gues_r, d_r):
    import jax
    return jax.vmap(lambda a: ref_history(a, d_r.z_full, d_r.topo))(gues_r)


def test_run_osse_matches_reference(case):
    """Two cycles of 2 forecast steps: nature run, obsmake, forecast,
    analysis; the final ensemble and nature state, and every cycle's RMSE,
    spread and departure statistics."""
    d_r, d, g_r, g, cfg, nature, ens, tmpl_r, tmpl, _, _ = case
    truth_r, ens_r, res_r = d_r.run_osse(to_ref(nature), to_ref(ens), tmpl_r,
                                         n_cycles=2, steps_per_cycle=2,
                                         seed=3)

    def port(nat, e):
        return d.run_osse(dycore_state_to_torch(nat, CPU),
                          dycore_state_to_torch(e, CPU), tmpl, n_cycles=2,
                          steps_per_cycle=2, seed=3)

    truth, ens_p, res = port(nature, ens)
    rng = np.random.default_rng(4)
    rounded = [DycoreState(*(
        (f * (1.0 + 2.0 ** -24 * rng.standard_normal(f.shape))).astype(
            np.float32) for f in s)) for s in (nature, ens)]
    truth2, ens_p2, _ = port(*rounded)

    def floor(a, b):
        return {n: 2 * float((x - y).abs().max())
                for n, x, y in zip(DycoreState._fields, a, b)}
    assert_increments(dycore_state_to_numpy(ens_p), ens,
                      [np.asarray(f) for f in ens_r],
                      extra=floor(ens_p2, ens_p))
    assert_increments(dycore_state_to_numpy(truth), nature,
                      [np.asarray(f) for f in truth_r],
                      extra=floor(truth2, truth))
    assert len(res.nobs) == 2 and res.nobs[0] > 200
    for a, b in ((res.rmse_gues, res_r.rmse_gues),
                 (res.rmse_anal, res_r.rmse_anal), (res.spread, res_r.spread)):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    for c in range(2):
        assert res.stats_gues[c].nobs == res_r.stats_gues[c].nobs
        for n, v in res_r.stats_anal[c].rmse.items():
            if res.stats_anal[c].nobs[n]:
                np.testing.assert_allclose(res.stats_anal[c].rmse[n], v,
                                           rtol=1e-4, err_msg=n)
    assert res.infl_field is None and res_r.infl_field is None
    # the last cycle's analysis info
    assert torch.isfinite(res.info["anal_sprd"]).all()
    assert res.info["obsdep"].qc.shape == (res.nobs[1],)


def test_run_osse_frees_each_ensemble(case, monkeypatch):
    """run_osse and analysis keep no ensemble past the step that consumes
    it: when analyze starts, the ensemble handed in and the forecast are
    both freed (only the guess and what analyze makes stay beside it)."""
    import scale_letkf_torch.cycle as cycle_mod
    d, g, cfg, nature, ens, tmpl = (case[1], case[3], case[4], case[5],
                                    case[6], case[8])
    refs, seen = [], []
    forecast, analyze = d.forecast, cycle_mod.analyze

    def spy_forecast(e, n):
        out = forecast(e, n)
        refs.append(weakref.ref(out.rho))
        return out

    def spy_analyze(*args, **kw):
        seen.append([r() is None for r in refs])
        return analyze(*args, **kw)

    monkeypatch.setattr(d, "forecast", spy_forecast)
    monkeypatch.setattr(cycle_mod, "analyze", spy_analyze)
    states = [dycore_state_to_torch(nature, CPU),
              dycore_state_to_torch(ens, CPU)]
    refs.append(weakref.ref(states[1].rho))
    truth, ens_a, res = d.run_osse(states.pop(0), states.pop(0), tmpl,
                                   n_cycles=2, steps_per_cycle=1)
    assert seen == [[True, True], [True, True, True]]
    assert len(res.rmse_anal) == 2 and torch.isfinite(ens_a.rho).all()


def test_driver_takes_cfg_in_reference_order(case):
    d = case[1]
    assert isinstance(d, CycleDriver) and d.cfg is case[4]
    assert d.z_full.shape == (8, 12, 16) and float(d.topo.abs().max()) == 0


def test_gpu_check_hx_helpers_on_cpu():
    """gpu_check's H(x) comparisons, run with the CPU in the card's place:
    the obs mix reaches every element and slot it is meant to, and a run
    agrees with itself exactly."""
    from scale_letkf_torch import gpu_check
    res = gpu_check.hx_slots_vs_cpu(CPU, CONFIG)
    rows = gpu_check.radar_hx_vs_cpu(CPU, CONFIG)
    assert res["outside_window"] > 0 and len(rows) == 6
    for r in (res, *rows):
        assert r["qc_equal"] and r["finite"] and r["good_obs"] > 100
        assert {"U", "T", "Q", "PS", "REF", "Vr"} <= set(r["max_err_over_tol"])
        assert not any(r["max_err_over_tol"].values())


@pytest.mark.parametrize("kw", ["det", "addi_ens"])
def test_analysis_unported_members_raise(case, kw):
    """A deterministic member (DET_RUN) and an additive-inflation ensemble
    (INFL_ADD 0.1, its members shuffled by default_rng(5)) go through the
    port's analysis as through the reference's: the ensemble and the
    analysed deterministic member to the restart increments bound."""
    d_r, d, g_r, g, cfg, nature, ens, _, _, obs_r, obs = case
    kw_r, kw_p = {}, {}
    if kw == "det":
        det = DycoreState(*(np.ascontiguousarray(f) for f in nature))
        kw_r["det"] = to_ref(det)
        kw_p["det"] = dycore_state_to_torch(det, CPU)
    else:
        _, addi = states(g_r, {**case_dom()}, seed=4)
        addi_r = ref_trans(jax_vmap_collocated(to_ref(addi)))
        kw_r.update(addi_ens=addi_r, rng=np.random.default_rng(5))
        kw_p.update(addi_ens=torch.from_numpy(np.array(addi_r)),
                    rng=np.random.default_rng(5))
    saved = (d_r.cfg.letkf.infl_add, d_r.cfg.letkf.infl_add_shuffle,
             cfg.letkf.infl_add, cfg.letkf.infl_add_shuffle)
    if kw == "addi_ens":
        for c in (d_r.cfg, cfg):
            c.letkf.infl_add, c.letkf.infl_add_shuffle = 0.1, True
    try:
        ens_a_r, info_r = d_r.analysis(to_ref(ens), obs_r, **kw_r)
        ens_a, info = d.analysis(dycore_state_to_torch(ens, CPU), obs,
                                 **kw_p)
    finally:
        (d_r.cfg.letkf.infl_add, d_r.cfg.letkf.infl_add_shuffle,
         cfg.letkf.infl_add, cfg.letkf.infl_add_shuffle) = saved
    assert_increments(dycore_state_to_numpy(ens_a), ens,
                      [np.asarray(f) for f in ens_a_r])
    assert_stats(info["stats_anal"], info_r["stats_anal"], info["obsdep"])
    if kw == "det":
        det_a = DycoreState(*dycore_state_to_numpy(info["det"]))
        assert_increments(det_a, nature, [np.asarray(f)
                                          for f in info_r["det"]])
        assert np.abs(det_a.rhot - nature.rhot).max() > 0
    else:
        assert info["det"] is None


def case_dom():
    """The [domain] table of the cycle tests' configuration."""
    return ref_load(CONFIG, OVER)[3]


# --- the physics suite, Kessler physics and Davies boundary forcing --------
# The 18-km configuration's physics as the reference bench composes it
# (nsw6 microphysics, slab capacity 2e5; radiation every 2 physics steps
# here, so a 5-step forecast at phys_interval 2 recomputes, reuses and — in
# its remainder chunk — recomputes radiation), and Davies relaxation over a
# 3-cell buffer (the configuration's 10 would cover this 16×12 domain).
PHYS = {"mp_scheme": "nsw6", "rad_interval": 2, "slab_capacity": 2.0e5}


def moist_states(grid_r, dom, seed=0):
    """states() with the reference bench's per-member rain and cloud blobs
    (2 g/kg of rain at the peak), so the microphysics has work."""
    s, _, _ = _synthetic_ens_dycore(np.random.default_rng(seed), K + 1,
                                    grid_r, dom, amp_theta=2.0, qr_blob=2e-3)
    s = s._replace(rhou=(10.0 * s.rho).astype(np.float32))
    return (DycoreState(*(np.ascontiguousarray(f[0]) for f in s)),
            DycoreState(*(np.ascontiguousarray(f[1:]) for f in s)))


def boundary_file(path, grid, dom, per_member: bool):
    """A boundary file from the balanced base state (t0 = 0) to the base
    warmed by 0.1% with a 5 m/s wind (t1 = 3600 s); per member, member m
    warmed by 0.1·(m + 1)%."""
    from scale_letkf_torch.model.boundary import BoundaryData, save_boundary
    from scale_letkf_torch.synthetic import base_boundary
    base = DycoreState(*(np.ascontiguousarray(f.numpy())
                         for f in base_boundary(grid, dom, CPU).state0))
    warm = [base._replace(rhot=base.rhot * np.float32(1 + 1e-3 * (m + 1)),
                          rhou=base.rho * np.float32(5.0))
            for m in range(K if per_member else 1)]
    s1 = (DycoreState(*(np.stack(f) for f in zip(*warm))) if per_member
          else warm[0])
    s0 = (DycoreState(*(np.stack([f] * K) for f in base)) if per_member
          else base)
    save_boundary(path, BoundaryData(s0, s1, 0.0, 3600.0))


def physics_pair(extra: dict):
    """setup_pair's drivers with `extra` merged into the [domain] table."""
    out = []
    for load, make in ((ref_load, ref_make_driver), (load_config_and_grid,
                                                     make_driver)):
        cfg, grid, dycfg, dom = load(CONFIG, OVER)
        cfg.ensemble.member = K
        cfg.letkf.hdxb_gather_bf16 = False
        dom = {**dom, **extra}
        out.append((make(cfg, grid, dycfg, dom) if make is ref_make_driver
                    else make(cfg, grid, dycfg, dom, CPU), grid, cfg, dom))
    (d_r, g_r, _, dom), (d, g, cfg, _) = out
    return d_r, d, g_r, g, cfg, dom


def rounded(s, seed):
    rng = np.random.default_rng(seed)
    return DycoreState(*((f * (1.0 + 2.0 ** -24 * rng.standard_normal(
        f.shape))).astype(np.float32) for f in s))


def floor_of(a, b):
    """Twice the change of each field between two port runs."""
    return {n: 2 * float((x - y).abs().max())
            for n, x, y in zip(DycoreState._fields, a, b)}


@pytest.mark.parametrize("bdy", ["shared", "per_member"])
def test_physics_forecast_matches_reference(tmp_path, bdy):
    """Two forecasts in a row (7 steps from t0 = 0: a chunk of
    phys_interval = 5 and a remainder of 2, the second physics step reusing
    the radiation cache; then 3 steps from t0 = 210 s on the boundary
    clock, the radiation index starting over) with the physics suite and
    Davies relaxation toward a boundary file shared by all members or per
    member: the states after each, and the slab skin temperature the
    driver threads from the first into the second (cold-started by the
    first)."""
    f = tmp_path / "bdy.npz"
    _, _, g_r0, g0, _, dom0 = physics_pair({})
    boundary_file(f, g0, dom0, bdy == "per_member")
    extra = {"physics": PHYS, "bdy_file": str(f), "bdy_width": 3,
             "bdy_tau": 600.0}
    d_r, d, g_r, g, cfg, dom = physics_pair(extra)
    _, ens = moist_states(g_r, dom)
    e1_r = d_r.forecast(to_ref(ens), 7, t0=0.0)
    tsfc1_r = np.asarray(d_r.tsfc)
    e2_r = d_r.forecast(e1_r, 3, t0=210.0)

    def port(e, driver):
        e1 = driver.forecast(dycore_state_to_torch(e, CPU), 7, t0=0.0)
        tsfc1 = driver.tsfc.clone()
        return e1, tsfc1, driver.forecast(e1, 3, t0=210.0), driver.tsfc

    e1, tsfc1, e2, tsfc2 = port(ens, d)
    d2 = physics_pair(extra)[1]
    e1b, tsfc1b, e2b, tsfc2b = port(rounded(ens, 5), d2)
    assert_increments(dycore_state_to_numpy(e1), ens,
                      [np.asarray(x) for x in e1_r],
                      extra=floor_of(e1b, e1))
    assert_increments(dycore_state_to_numpy(e2), ens,
                      [np.asarray(x) for x in e2_r],
                      extra=floor_of(e2b, e2))
    assert_tsfc(tsfc1, tsfc1b, tsfc1_r, ens)
    assert_tsfc(tsfc2, tsfc2b, d_r.tsfc, ens)
    assert float((tsfc2 - tsfc1).abs().max()) > 0
    # 7 steps at phys_interval 5 → two physics steps; 3 → one more
    assert d.timer.counts["forecast/physics"] == 3
    assert d.timer.counts["forecast/boundary"] == 10


def assert_tsfc(got, alt, want, ens):
    """The skin temperature as assert_increments holds a field: its change
    from the cold start to 1e-4, plus 4 ulp, plus twice the port's own
    rounding floor (alt: the run from rounded inputs)."""
    from scale_letkf_torch.model.physics_suite import skin_temperature
    want = np.asarray(want, np.float64)
    cold = skin_temperature(dycore_state_to_torch(ens, CPU)).double().numpy()
    tol = (1e-4 * np.abs(want - cold).max()
           + 4 * np.spacing(np.float32(np.abs(want).max()))
           + 2 * float((got - alt).abs().max()))
    assert got.shape == want.shape
    err = np.abs(got.double().numpy() - want).max()
    assert err <= tol, f"tsfc: {err:.3e} > {tol:.3e}"


def test_kessler_forecast_matches_reference():
    """use_physics (Kessler on the stretched per-level dz every
    phys_interval = 5 steps): 7 steps, a full chunk and a remainder."""
    d_r, d, g_r, g, cfg, dom = physics_pair({"use_physics": True})
    _, ens = moist_states(g_r, dom, seed=1)
    want = d_r.forecast(to_ref(ens), 7)
    got = d.forecast(dycore_state_to_torch(ens, CPU), 7)
    d2 = physics_pair({"use_physics": True})[1]
    alt = d2.forecast(dycore_state_to_torch(rounded(ens, 6), CPU), 7)
    assert_increments(dycore_state_to_numpy(got), ens,
                      [np.asarray(x) for x in want], extra=floor_of(alt, got))
    assert d.timer.counts["forecast/physics"] == 2
    # the rain blobs fell and evaporated
    assert float((got.rhoq[:, 2] - torch.from_numpy(ens.rhoq[:, 2])
                  ).abs().max()) > 1e-6


def test_physics_run_osse_matches_reference(tmp_path):
    """Two run_osse cycles of 3 steps with the physics suite and shared
    Davies forcing: the nature run cold-starts its slab every cycle, the
    ensemble threads its own, and the analysis's H(x) and O−A monitor read
    the stability-corrected screen diagnostics of the ensemble's skin
    temperature (members and mean)."""
    f = tmp_path / "bdy.npz"
    _, _, g_r0, g0, _, dom0 = physics_pair({})
    boundary_file(f, g0, dom0, False)
    extra = {"physics": PHYS, "bdy_file": str(f), "bdy_width": 3,
             "bdy_tau": 600.0}
    d_r, d, g_r, g, cfg, dom = physics_pair(extra)
    nature, ens = moist_states(g_r, dom, seed=2)
    tmpl_r, tmpl = template(cfg, g)
    truth_r, ens_r, res_r = d_r.run_osse(to_ref(nature), to_ref(ens),
                                         tmpl_r, n_cycles=2,
                                         steps_per_cycle=3, seed=3)

    def port(driver, nat, e):
        return driver.run_osse(dycore_state_to_torch(nat, CPU),
                               dycore_state_to_torch(e, CPU), tmpl,
                               n_cycles=2, steps_per_cycle=3, seed=3)

    truth, ens_p, res = port(d, nature, ens)
    d2 = physics_pair(extra)[1]
    truth2, ens_p2, _ = port(d2, rounded(nature, 7), rounded(ens, 8))
    assert_increments(dycore_state_to_numpy(ens_p), ens,
                      [np.asarray(x) for x in ens_r],
                      extra=floor_of(ens_p2, ens_p))
    assert_increments(dycore_state_to_numpy(truth), nature,
                      [np.asarray(x) for x in truth_r],
                      extra=floor_of(truth2, truth))
    assert_tsfc(d.tsfc, d2.tsfc, d_r.tsfc, ens)
    for a, b in ((res.rmse_gues, res_r.rmse_gues),
                 (res.rmse_anal, res_r.rmse_anal), (res.spread, res_r.spread)):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    for c in range(2):
        assert res.stats_gues[c].nobs == res_r.stats_gues[c].nobs
        for n, v in res_r.stats_anal[c].rmse.items():
            if res.stats_anal[c].nobs[n]:
                np.testing.assert_allclose(res.stats_anal[c].rmse[n], v,
                                           rtol=1e-4, err_msg=n)
    # one physics step of 3 steps a cycle, in the nature run and the
    # ensemble forecast each
    assert d.timer.counts["nature/physics"] == 2
    assert d.timer.counts["forecast/physics"] == 2


def test_forecast_one_refuses_per_member_boundaries(tmp_path):
    f = tmp_path / "bdy.npz"
    _, d, _, g, _, dom = physics_pair({})
    boundary_file(f, g, dom, True)
    _, d, _, g, _, dom = physics_pair({"bdy_file": str(f), "bdy_width": 3})
    nature, _ = states(physics_pair({})[2], dom)
    with pytest.raises(ValueError, match="per-member boundary data"):
        d.forecast_one(dycore_state_to_torch(nature, CPU), 1)


def test_physics_forecast_drops_each_state():
    """In a physics-suite forecast (7 steps: physics after steps 5 and 7)
    every state is freed once the next one exists: when a dynamics step
    starts, the inputs of all earlier steps but the first (a view of the
    ensemble the caller holds) are gone, the physics step's outputs too."""
    import weakref
    d_r, d, g_r, g, cfg, dom = physics_pair({"physics": PHYS})
    _, ens = moist_states(g_r, dom)
    refs, seen = [], []
    step = d._dyn_step

    def spy(s):
        seen.append([r() is None for r in refs[1:]])
        refs.append(weakref.ref(s.rhot))
        return step(s)

    d._dyn_step = spy
    d.forecast(dycore_state_to_torch(ens, CPU), 7)
    assert len(seen) == 7 and all(all(x) for x in seen), seen


def test_state_to_history_tsfc_matches_reference(case):
    """The cycle's guess with a skin temperature 2 K above or below each
    member's lowest-level air: the stability-corrected screen diagnostics
    (and ps) against the reference's, member by member, to 2e-5 of each
    field's range plus 4 float32 ulp (tests/test_torch_obsope.py)."""
    from scale_letkf_torch.model.physics_suite import skin_temperature
    from test_torch_obs_operators import assert_close
    d_r, d, g_r, g, cfg, nature, ens = case[:7]
    e = dycore_state_to_torch(ens, CPU)
    gues = state_trans(to_collocated(e))
    sign = torch.from_numpy(np.random.default_rng(11).choice(
        [-1.0, 1.0], (K, g.ny, g.nx)).astype(np.float32))
    tsfc = skin_temperature(e) + 2.0 * sign
    got = state_to_history(gues, d.z_full, d.topo, tsfc=tsfc)
    gues_r = np.asarray(ref_trans(jax_vmap_collocated(to_ref(ens))))
    want = [ref_history(jnp.asarray(gues_r[m]), d_r.z_full, d_r.topo,
                        tsfc=jnp.asarray(tsfc[m].numpy())) for m in range(K)]
    for k in ("t2m", "q2m", "u10m", "v10m", "ps"):
        assert_close(got[k], np.stack([np.asarray(w[k]) for w in want]), k)
    assert not torch.equal(got["t2m"],
                           state_to_history(gues, d.z_full, d.topo)["t2m"])
