"""The member-streamed cycle (da/bigcycle.py StreamedCycle) against the
reference package's, on the CPU, from the same numpy inputs.

Configuration: tests/test_torch_cycle.py's (configs/18km_japan.toml on a
16×12×8 domain of its 18-km cells, stretched levels, SI core, K = 6; the
nature and ensemble states of the reference bench's construction with a
10 m/s wind; 25 sondes and 40 PS obs made by obsmake from the nature
state). The executors run member batches of 3 (4 requested: the largest
divisor of K) and analysis tiles of 4 rows. Two compositions: the
configuration's (flat, 3-D H(x)), and the production one — a 500-m hill
(topo_file), the physics suite (nsw6, radiation every 2 physics steps) and
per-member Davies forcing from a boundary file — with a 3-slot 4-D window
(slots 1–3 two steps apart, the analysis at slot 2 after 2 steps: H(x) at
steps 0, 2 and 4, the window integrated in two segments, the physics
cadence restarting in each).

Tolerances (tests/test_torch_cycle.py assert_increments): each variable's
change from the start to 1e-4·max|Δ_ref| plus 6 float32 ulp of its largest
value, plus twice the port's own rounding floor where a forecast is in the
path (a second port run from inputs perturbed by one rounding: the float32
forecasts amplify rounding); the analysis adds one bfloat16 spacing of the
analysis perturbation x′ per element, at most 2⁻⁷·|x′| (the tiles carry x′
in bfloat16 both ways, and a last-bit difference may flip a rounding).
H(x) to 2e-5 of its range plus 4 ulp (tests/test_torch_obsope.py) plus
the floor, QC exactly equal, the O−B statistics by assert_stats and the O−A
RMSE to 1e-4 (the run_osse test's bound).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_letkf_tpu.da.bigcycle import StreamedCycle as RefStreamed
from scale_letkf_tpu.da.bigcycle import _slot_parts as ref_slot_parts
from scale_letkf_tpu.da.monitor import monit_dep as ref_monit_dep
from scale_letkf_tpu.model.dycore import DycoreState as RefState
from scale_letkf_tpu.obs.types import Observations as RefObservations
from scale_letkf_torch.da.bigcycle import (
    StreamedCycle, batch_of, phase_table, slot_parts,
)
from scale_letkf_torch.da.obsmake import obsmake
from scale_letkf_torch.io.convert import dycore_state_to_torch
from scale_letkf_torch.model.dycore import to_collocated
from scale_letkf_torch.obs.types import Observations
from scale_letkf_torch.state import state_to_history, state_trans
from test_torch_cycle import (
    CPU, K, PHYS, assert_increments, assert_stats, boundary_file,
    moist_states, physics_pair, rounded, states, template,
)
from test_torch_terrain import topo_file

torch.set_num_threads(1)
BATCH, ROWS, STEPS = 4, 4, 2
SLOTS = {"slot_start": 1, "slot_end": 3, "slot_base": 2}


def anal_vars(ens) -> np.ndarray:
    """(K, NV3D, nz, ny, nx) analysis variables of a numpy DycoreState."""
    return state_trans(to_collocated(dycore_state_to_torch(ens, CPU))
                       ).numpy()


def assert_vars(got, init, want, floor=None, pert=None):
    """Per analysis variable v: |Δ − Δ_ref| ≤ 1e-4·max|Δ_ref| + 6 ulp of
    max|x| (+ floor[v]) (+ 2⁻⁷·|x′_ref| per element, pert the reference's
    analysis perturbations)."""
    for v in range(got.shape[1]):
        a, b, f0 = (np.asarray(x[:, v], np.float64) for x in (got, want,
                                                               init))
        tol = (1e-4 * np.abs(b - f0).max()
               + 6 * np.spacing(np.float32(np.abs(f0).max()))
               + (0.0 if floor is None else floor[v]))
        if pert is not None:
            tol = tol + 2.0 ** -7 * np.abs(pert[:, v])
        err = np.abs(a - b)
        assert (err <= tol).all(), (v, float(np.max(err - tol)))


def assert_hx(got, want, alt):
    """H(x) to 2e-5 of its range plus 4 ulp of its largest magnitude
    (tests/test_torch_obsope.py), plus twice the port's own rounding floor
    (alt: the run from rounded inputs)."""
    tol = (2e-5 * np.ptp(want) + 4 * np.spacing(np.float32(np.abs(
        want).max())) + 2 * np.abs(got - alt).max())
    assert np.abs(got - want).max() <= tol


def var_floor(a, b):
    """Twice the change of each analysis variable between two port runs."""
    return [2 * float(np.abs(a[:, v] - b[:, v]).max())
            for v in range(a.shape[1])]


def ref_obs(obs: Observations) -> RefObservations:
    return RefObservations(**{k: getattr(obs, k) for k in (
        "elem", "lon", "lat", "lev", "dat", "err", "typ", "dif")})


def run_ref(d_r, ens, obs, nsteps):
    """The reference's phases one by one (its cycle() composes them):
    guess, H(x), analysis, O−A of the analysis mean, restart."""
    sc = RefStreamed(d_r, member_batch=BATCH, tile_rows=ROWS)
    obs_r = ref_obs(obs)
    gues, ensval, qc, t = sc.forecast_and_hx(RefState(*ens), nsteps, obs_r)
    res = {"gues": gues.copy(), "ensval": ensval, "qc": qc,
           "batches": t["batches"]}
    anal, infl, ctx, _ = sc.analysis(gues, obs_r, ensval, qc)
    _, mean_hx, _, _ = sc._programs(obs_r, nsteps)
    tsfc = (None if sc.tsfc_host is None
            else jnp.asarray(sc.tsfc_host.mean(axis=0)))
    y_a = np.asarray(mean_hx(jnp.asarray(anal.mean(axis=0,
                                                   dtype=np.float32)),
                             tsfc))
    res.update(anal=anal, ctx=ctx, tsfc=sc.tsfc_host,
               stats_gues=ref_monit_dep(ctx.elem, ctx.dep, ctx.qc),
               stats_anal=ref_monit_dep(ctx.elem, ctx.dat - y_a, ctx.qc))
    res["out"] = sc.to_state(anal)[0]
    return res


def run_port(d, ens, obs, nsteps, **kw):
    sc = StreamedCycle(d, member_batch=BATCH, tile_rows=ROWS, **kw)
    out, infl, rep = sc.cycle(ens, obs, nsteps)
    return sc, out, rep


def check_against_reference(d, ens, obs, nsteps, ref, alt):
    """The port's phases against the reference's, and its cycle() against
    its own phases: alt is a port driver for the run from rounded inputs
    (the floor)."""
    sc = StreamedCycle(d, member_batch=BATCH, tile_rows=ROWS)
    gues, ensval, qc, t = sc.forecast_and_hx(ens, nsteps, obs)
    gues0 = gues.copy()
    sc_b = StreamedCycle(alt, member_batch=BATCH, tile_rows=ROWS)
    gues_b, ensval_b, qc_b, _ = sc_b.forecast_and_hx(rounded(ens, 5),
                                                     nsteps, obs)
    init = anal_vars(ens)
    fl = var_floor(gues_b, gues0)
    assert t["batches"] == ref["batches"] == K // batch_of(K, BATCH) == 2
    assert_vars(gues0, init, ref["gues"], fl)
    np.testing.assert_array_equal(qc, ref["qc"])
    good = qc == 0
    assert good.sum() > 100
    for e in np.unique(obs.elem):
        m = good & (obs.elem == e)
        assert_hx(ensval[:, m], ref["ensval"][:, m], ensval_b[:, m])
    anal, _, ctx, t_a = sc.analysis(gues, obs, ensval, qc)
    anal_b, _, _, _ = sc_b.analysis(gues_b, obs, ensval_b, qc_b)
    assert t_a["letkf_tiles"] == 3
    pert_r = ref["anal"] - ref["anal"].mean(axis=0)
    assert_vars(anal, init, ref["anal"], var_floor(anal_b, anal), pert_r)
    out, _ = sc.to_state(ref["anal"])
    assert_increments(out, ens, ref["out"])
    # cycle() is the phases composed: the same analysis, and the O−B / O−A
    # statistics of the reference's phases
    sc2, out2, rep = run_port(d, ens, obs, nsteps)
    out_p, _ = sc2.to_state(anal)
    for a, b in zip(out2, out_p):
        np.testing.assert_array_equal(a, b)
    assert_stats(rep["stats_gues"], ref["stats_gues"], ctx)
    # O−A of an analysis that carries the forecast's rounding: RMSE to
    # 1e-4 (tests/test_torch_cycle.py's run_osse bound)
    st, st_r = rep["stats_anal"], ref["stats_anal"]
    assert st.nobs == st_r.nobs
    for n, v in st_r.rmse.items():
        if st.nobs[n]:
            np.testing.assert_allclose(st.rmse[n], v, rtol=1e-4, err_msg=n)
    assert "DAS_LETKF" in phase_table(rep) and "TOTAL" in phase_table(rep)
    return sc, sc_b


def flat_case():
    d_r, d, g_r, g, cfg, dom = physics_pair({})
    nature, ens = states(g_r, dom)
    _, tmpl = template(cfg, g)
    nat_t = dycore_state_to_torch(nature, CPU)
    obs = obsmake(state_to_history(state_trans(to_collocated(nat_t)),
                                   d.z_full, d.topo),
                  tmpl, g, cfg, d.z_full, np.random.default_rng(2))
    return d_r, d, cfg, ens, obs


def test_slot_parts_match_reference():
    """The parts' step points, obs indices and counts are the reference's
    (which pads each subset to a power of two ≥ 64 for XLA, the port
    does not), single-slot windows give none."""
    _, _, cfg, _, obs = flat_case()
    cfg.obsope.slot_end = cfg.obsope.slot_start
    assert slot_parts(obs, cfg, 30.0, 4) == (None, None)
    for k, v in SLOTS.items():
        setattr(cfg.obsope, k, v)
    cfg.obsope.slot_tinterval = 60.0
    obs.dif = np.random.default_rng(0).choice(
        [-90.0, -60.0, 0.0, 29.0, 60.0, 95.0], obs.nobs)
    parts, win = slot_parts(obs, cfg, 30.0, 4)
    parts_r, win_r = ref_slot_parts(ref_obs(obs), cfg, 30.0, 4)
    np.testing.assert_array_equal(win, win_r)
    assert not win.all()
    assert [p[0] for p in parts] == [p[0] for p in parts_r] == [2, 4, 6]
    for (pt, sub, idx, n), (_, sub_r, idx_r, n_r) in zip(parts, parts_r):
        assert n == n_r == len(idx) and sub.nobs == n
        np.testing.assert_array_equal(idx, idx_r)
        assert sub_r.nobs >= max(64, n)
        np.testing.assert_array_equal(sub.dat, obs.dat[idx])
    with pytest.raises(ValueError, match="multiple of the model dt"):
        cfg.obsope.slot_tinterval = 45.0
        slot_parts(obs, cfg, 30.0, 4)


@pytest.fixture(scope="module")
def flat():
    d_r, d, cfg, ens, obs = flat_case()
    ref = run_ref(d_r, ens, obs, STEPS)
    return d, cfg, ens, obs, ref


def test_streamed_cycle_matches_reference(flat):
    d, cfg, ens, obs, ref = flat
    check_against_reference(d, ens, obs, STEPS, ref, physics_pair({})[1])


def test_streamed_forecast_equals_driver_forecast(flat):
    """The streamed guess is CycleDriver.forecast's, in analysis variables
    (the same forecast in other batches)."""
    d, cfg, ens, obs, _ = flat
    gues, _, _, _ = StreamedCycle(d, member_batch=2).forecast_and_hx(
        ens, STEPS, obs)
    want = state_trans(to_collocated(d.forecast(
        dycore_state_to_torch(ens, CPU), STEPS))).numpy()
    np.testing.assert_array_equal(gues, want)


def test_streamed_pipeline_matches_plain(flat):
    """The pipelined stream gives the same cycle."""
    d, cfg, ens, obs, _ = flat
    _, out0, rep0 = run_port(d, ens, obs, STEPS)
    _, out1, rep1 = run_port(d, ens, obs, STEPS, pipeline=True)
    assert rep1["pipelined"] and rep1["letkf_pipelined"]
    for a, b in zip(out0, out1):
        np.testing.assert_array_equal(a, b)


def production_case(tmp_path, slots: bool = True):
    """The production composition with per-member boundary data and (slots)
    the 3-slot window, the obs spread over the slots."""
    _, _, _, g0, _, dom0 = physics_pair({})
    f = tmp_path / "bdy.npz"
    boundary_file(f, g0, dom0, True)
    extra = {"physics": PHYS, "bdy_file": str(f), "bdy_width": 3,
             "bdy_tau": 600.0, "topo_file": topo_file(tmp_path, g0)}

    def pair():
        d_r, d, g_r, g, cfg, dom = physics_pair(extra)
        for c in (cfg, d_r.cfg):
            for k, v in SLOTS.items():
                setattr(c.obsope, k, v)
            c.obsope.slot_tinterval = 2 * dom["dt"]
            if not slots:
                c.obsope.slot_end = c.obsope.slot_start
        return d_r, d, g_r, g, cfg, dom

    d_r, d, g_r, g, cfg, dom = pair()
    nature, ens = moist_states(g_r, dom, seed=2)
    _, tmpl = template(cfg, g)
    nat_t = dycore_state_to_torch(nature, CPU)
    obs = obsmake(state_to_history(state_trans(to_collocated(nat_t)),
                                   d.z_full, d.topo),
                  tmpl, g, cfg, d.z_full, np.random.default_rng(2))
    if slots:
        times = (np.arange(1, 4) - 2) * 2 * dom["dt"]
        obs.dif = np.random.default_rng(4).choice(times, obs.nobs)
    return d_r, d, pair()[1], ens, obs


def test_streamed_production_4d_matches_reference(tmp_path):
    """Terrain, the physics suite, per-member Davies forcing and the 4-D
    window: the guess, the slot-matched H(x), the analysis and the slab
    skin temperature threaded through the segments."""
    d_r, d, alt, ens, obs = production_case(tmp_path)
    assert d.metrics is not None and d.bdy.state0.rho.dim() == 4
    ref = run_ref(d_r, ens, obs, STEPS)
    sc, sc_b = check_against_reference(d, ens, obs, STEPS, ref, alt)
    assert (ref["qc"] == 97).sum() == 0
    # the skin temperature of the window's end (step 6), the floor from
    # the run from rounded inputs
    got, alt_t, want = sc.tsfc_host, sc_b.tsfc_host, ref["tsfc"]
    cold = anal_vars(ens)[:, 3, 0]
    tol = (1e-4 * np.abs(want - cold).max()
           + 4 * np.spacing(np.float32(np.abs(want).max()))
           + 2 * np.abs(got - alt_t).max())
    assert np.abs(got - want).max() <= tol
    assert np.abs(got - cold).max() > 0


def test_synthetic_radar_volume_matches_reference():
    """The radar volume generator is the reference bench's, value for value
    from the same generator (a cut target: 120 × 55 × 7 gates)."""
    from scale_letkf_tpu.bench_fullsize import _synthetic_radar_volume
    from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
    from scale_letkf_torch.cli.main import load_config_and_grid
    from scale_letkf_torch.synthetic import synthetic_radar_volume
    path = str(Path(__file__).resolve().parents[1] / "configs"
               / "bda_1km_radar.toml")
    cfg_r, _, _, dom = ref_load(path)
    cfg, _, _, _ = load_config_and_grid(path)
    want = _synthetic_radar_volume(cfg_r, dom, np.random.default_rng(3),
                                   100_000)
    got = synthetic_radar_volume(cfg, dom, np.random.default_rng(3), 100_000)
    assert got.nobs == want.nobs > 60_000
    for k in ("elem", "lon", "lat", "lev", "dat", "err", "typ", "dif",
              "meta"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
