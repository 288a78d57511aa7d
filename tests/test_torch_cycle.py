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
    (INFL_ADD) reach analyze, which names their ROADMAP item."""
    d, ens, obs = case[1], case[6], case[10]
    e = dycore_state_to_torch(ens, CPU)
    arg = (DycoreState(*(f[0] for f in e)) if kw == "det"
           else state_trans(to_collocated(e)))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.*deterministic member"):
        d.analysis(e, obs, **{kw: arg})
