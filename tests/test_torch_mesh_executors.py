"""The executors on the port's process grid, on the CPU: the fused cycle
(da/fastcycle.py FusedCycle on CycleDriver(mesh=)), the nested cycle
(nested.py NestedCycleDriver of two grid drivers, its bracket sharded) and
the explicit core over terrain (parallel/halo.py rk3_step_blocks with each
block's extended metrics), against the port's undecomposed runs exactly
and against the JAX package.

Exactness. A grid runs the undecomposed arithmetic on every block, and the
fused cycle's reductions over the members (the worst QC, the mean of H(x),
the radar min-member count, the guess and analysis means) run over all K
members in member order, so a grid's results equal the undecomposed ones
bit for bit (rtol = atol = 0). The block planes are multiples of 32 on the
CPU, as tests/test_torch_mesh_physics.py explains: 16 × 16 columns for the
fused cycle's cases and the terrain forecast, a 32 × 32 parent and child
for the nested cycle (16 × 16 blocks, 24 × 24 extended). In the open
lateral mode the child's grid dynamics carry the reference's open-halo
behaviour, so there the grid is held to the undecomposed nested cycle whose
child steps with the halo step of the whole ensemble on the same grid
(gpu_check.halo_dynamics), as tests/test_torch_mesh_physics.py holds the
open grid forecast.

Against the JAX package (its drivers on make_mesh of the 8 virtual
devices, its GSPMD path), at the bounds of the undecomposed parity tests:
the fused cycle's assimilate and step at tests/test_torch_fastcycle.py's,
the nested cycle at tests/test_torch_nesting.py's (the port's grid in the
periodic mode; in the open mode the reference's mesh steps the global open
step, so the port's undecomposed nested cycle is held to it), the explicit
terrain forecast at tests/test_torch_terrain.py::
test_explicit_core_with_terrain_matches_reference's.

Cases: tests/test_fastcycle.py's conventional network and
tests/test_torch_fastcycle.py's radar template at 16 × 16 columns (K = 8);
tests/test_nested_cycle.py's configuration at 32 × 32 in both domains (K =
4); tests/test_torch_cycle.py's coarsened 18-km configuration at 16 × 16
with tests/test_torch_terrain.py's coastal hill, the explicit core at dt
1 s.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_tpu.cli.main import make_driver as ref_make_driver
from scale_letkf_tpu.cycle import CycleDriver as RefDriver
from scale_letkf_tpu.da.fastcycle import FusedCycle as RefFused
from scale_letkf_tpu.model.dycore import DycoreState as RefState
from scale_letkf_tpu.parallel.mesh import make_mesh as ref_make_mesh
from scale_letkf_torch import gpu_check
from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
from scale_letkf_torch.da.fastcycle import FusedCycle
from scale_letkf_torch.io.convert import (
    dycore_state_to_numpy, dycore_state_to_torch,
)
from scale_letkf_torch.parallel.mesh import ProcessGrid, Sharded, make_mesh
from scale_letkf_torch.utils.timing import EventTimer, Timer
from test_fastcycle import _setup as ref_setup
from test_nested_cycle import CONFIG as NEST_CONFIG
from test_torch_cycle import (
    CONFIG, assert_increments, floor_of, moist_states, rounded, to_ref,
)
from test_torch_fastcycle import (
    _conv_cfg, _diag_close, _np, _obs, _port_driver, _radar_case,
)
from test_torch_nesting import _nest_case, _ref_obs
from test_torch_terrain import topo_file

torch.set_num_threads(1)
CPU = torch.device("cpu")
SHAPES = [(2, 2, 2), (2, 1, 1), (1, 2, 2)]
N = 16


def _global(driver, x):
    return driver.mesh.gather_ensemble(x) if isinstance(x, Sharded) else x


# --- the fused cycle ---------------------------------------------------------

@pytest.fixture(scope="module")
def cases():
    """The conventional and radar cases at N × N columns: the reference's
    undecomposed driver, the port's config, the template, the initial
    ensemble and nature member, the forecast ensemble (radar) and obs
    values, steps a cycle."""
    from scale_letkf_tpu.da.obsmake import obsmake as ref_obsmake
    from scale_letkf_tpu.model.dycore import to_collocated as ref_collocated
    from scale_letkf_tpu.state import state_to_history as ref_history
    from scale_letkf_tpu.state import state_trans as ref_trans
    grid_r, cfg_r, driver_r, truth0, ens, template_r = ref_setup(NY=N, NX=N)
    truth = driver_r.forecast_one(truth0, 2)
    nf = ref_history(ref_trans(ref_collocated(truth)), driver_r.z_full,
                     driver_r.topo)
    obs = ref_obsmake(nf, template_r, grid_r, cfg_r, driver_r.z_full,
                      np.random.default_rng(1))
    assert obs.nobs == template_r.nobs
    radar = _radar_case(N, N)
    return {"conv": {"driver_r": driver_r, "cfg": _conv_cfg(),
                     "template_r": template_r, "ens": _np(ens),
                     "truth0": _np(truth0), "ens_f": _np(driver_r.forecast(
                         ens, 2)), "dat": np.asarray(obs.dat), "nsteps": 2},
            "radar": {**radar, "dat": np.asarray(radar["template_r"].dat),
                      "nsteps": 5}}


def _fused(case, mesh=None, timed=False):
    d = _port_driver(case["driver_r"], case["cfg"], mesh)
    return FusedCycle(d, _obs(case["template_r"]), case["nsteps"],
                      timed=timed)


def _fused_run(case, mesh=None, timed=False):
    """One step from the initial ensemble, then run_osse of 2 cycles from
    the initial states (seed 4): (step's global ensemble, inflation and
    diag; run_osse's global truth, ensemble and series; the cycle)."""
    fc = _fused(case, mesh, timed=timed)
    ens, infl, diag = fc.step(dycore_state_to_torch(case["ens"], CPU),
                              torch.as_tensor(case["dat"],
                                              dtype=torch.float32),
                              fc.initial_inflation())
    if mesh is not None:
        assert isinstance(ens, Sharded)
    step = (_global(fc.driver, ens), infl, diag)
    truth, ens, series = fc.run_osse(
        dycore_state_to_torch(case["truth0"], CPU),
        dycore_state_to_torch(case["ens"], CPU), n_cycles=2, seed=4)
    return step, (truth, _global(fc.driver, ens), series), fc


@pytest.fixture(scope="module")
def undecomposed(cases):
    return {name: _fused_run(case) for name, case in cases.items()}


def _tensors(d):
    """The tensors of a diag or series dict in key order (group dicts
    flattened; chunk and seconds left out)."""
    out = []
    for k in sorted(d):
        if k in ("chunk", "seconds"):
            continue
        v = d[k]
        out += ([v[n] for n in sorted(v)] if isinstance(v, dict) else [v])
    return out


def _equal(a, b):
    for x, y in zip(a, b, strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["conv", "radar"])
def test_grid_fused_cycle_is_undecomposed(cases, undecomposed, name, shape):
    """FusedCycle on a driver with make_mesh(*shape): a step (its forecast
    a Sharded, which FusedCycle took for a global ensemble until it ran on
    the grid) and run_osse of 2 cycles equal the undecomposed ones bit for
    bit — the ensembles, the nature run, the inflation, the obs counts, the
    O−B and O−A (by group too), the guess and analysis means and the errors
    against the truth. Each grid step gathers every member slab once for
    H(x) and transposes twice; the timed cycle's EventTimer records the
    grid's sections."""
    want = undecomposed[name]
    got = _fused_run(cases[name], make_mesh(*shape), timed=True)
    (ens, infl, diag), (truth, ens_o, series), fc = got
    (ens0, infl0, diag0), (truth0, ens_o0, series0), _ = want
    _equal([*ens, infl, *_tensors(diag)], [*ens0, infl0, *_tensors(diag0)])
    _equal([*truth, *ens_o, *_tensors(series)],
           [*truth0, *ens_o0, *_tensors(series0)])
    assert series["nobs_used"].min() > 0
    assert sum(n for n, _ in diag["chunk"]) == N * N
    counts = fc.timer.counts
    assert counts["obsope/gather"] == 3 * 2 * shape[0]
    assert counts["das_letkf/transpose"] == 3 * 2
    assert counts.get("forecast/halo", 0) == (
        3 * 3 * cases[name]["nsteps"] if shape[1] * shape[2] > 1 else 0)
    assert fc.driver.timer.records == {}


def test_grid_fused_step_reads_no_host_index(cases, monkeypatch):
    """The share indices are made once: a grid step computes none (each
    would be a copy from the host that waits for the device)."""
    fc = _fused(cases["radar"], make_mesh(2, 2, 2))

    def refused(*a, **k):
        raise AssertionError("share_points in a step")
    monkeypatch.setattr(ProcessGrid, "share_points", refused)
    fc.step(dycore_state_to_torch(cases["radar"]["ens"], CPU),
            torch.as_tensor(cases["radar"]["dat"], dtype=torch.float32),
            fc.initial_inflation())


@pytest.mark.parametrize("shape", SHAPES)
def test_share_index_is_made_once(shape):
    """ProcessGrid.share_index is share_points on the device, one tensor
    for each (block, ny, nx, device) however often it is asked for, and
    gather_points puts every share's values at those points."""
    mesh, ny, nx = make_mesh(*shape), 8, 12
    rng = np.random.default_rng(3)
    shares, want = {}, np.zeros((2, ny * nx), np.float32)
    for b in range(mesh.n_blocks):
        idx = mesh.share_index(b, ny, nx, CPU)
        np.testing.assert_array_equal(idx.numpy(),
                                      mesh.share_points(b, ny, nx))
        assert mesh.share_index(b, ny, nx, CPU) is idx
        shares[b] = rng.standard_normal((2, idx.numel())).astype(np.float32)
        want[:, idx.numpy()] = shares[b]
    got = mesh.gather_points({b: torch.from_numpy(v)
                              for b, v in shares.items()}, ny, nx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_event_timer_on_the_cpu_is_a_timer():
    """Off the card an EventTimer reads the host clock as a Timer does:
    nested sections, their counts and the report."""
    t = EventTimer(CPU)
    for _ in range(2):
        with t.section("a"):
            with t.section("b"):
                pass
    assert t.counts == {"a": 2, "a/b": 2}
    assert set(t.records) == {"a", "a/b"}
    assert "a" in t.report() and t._pending == []
    assert not isinstance(Timer(CPU), EventTimer)


def _ref_mesh_fused(case):
    d = case["driver_r"]
    return RefFused(RefDriver(d.grid, d.cfg, d.dycfg, d.rho_ref, d.p_ref,
                              mesh=ref_make_mesh(2, 2, 2)),
                    case["template_r"], nsteps=case["nsteps"])


@pytest.mark.parametrize("name", ["conv", "radar"])
def test_grid_fused_cycle_matches_reference(cases, name):
    """The grid's FusedCycle on make_mesh(2, 2, 2) against the reference's
    FusedCycle on a make_mesh(2, 2, 2) driver: assimilate on the forecast
    ensemble and, for the conventional case, a step from the initial
    ensemble, each at tests/test_torch_fastcycle.py's step bound — restart
    increments to 1e-4·max|Δ| + 6 ulp plus twice the port's rounding floor
    (a port run from inputs rounded once), nobs_used equal, O−B and O−A to
    1e-4 — and the inflation to 1e-4. The floor enters assimilate too: at
    16 × 16 columns one rounding of the conventional case's inputs moves
    the port's ρw by 4.2e-5, above 1e-4·max|Δ| (2.8e-5), and the
    undecomposed port and reference part by 3.0e-5 there, as the grid and
    the reference's mesh do."""
    case = cases[name]
    fc_r = _ref_mesh_fused(case)
    fc = _fused(case, make_mesh(2, 2, 2))
    dat = case["dat"]
    ens_r, infl_r, diag_r = fc_r.assimilate(
        RefState(*map(jnp.asarray, case["ens_f"])), jnp.asarray(dat),
        fc_r.initial_inflation())

    def assimilated(e):
        out = fc.assimilate(dycore_state_to_torch(e, CPU),
                            torch.as_tensor(dat, dtype=torch.float32),
                            fc.initial_inflation())
        return _global(fc.driver, out[0]), out[1], out[2]
    ens, infl, diag = assimilated(case["ens_f"])
    ens2 = assimilated(rounded(case["ens_f"], 9))[0]
    assert_increments(dycore_state_to_numpy(ens), case["ens_f"],
                      [np.asarray(f) for f in ens_r],
                      extra=floor_of(ens2, ens))
    _diag_close(diag, diag_r)
    np.testing.assert_allclose(infl.numpy(), np.asarray(infl_r), rtol=1e-4,
                               atol=1e-6)
    if name != "conv":
        return
    ens_r, _, diag_r = fc_r.step(RefState(*map(jnp.asarray, case["ens"])),
                                 jnp.asarray(dat), fc_r.initial_inflation())

    def port(e):
        out = fc.step(dycore_state_to_torch(e, CPU),
                      torch.as_tensor(dat, dtype=torch.float32),
                      fc.initial_inflation())
        return _global(fc.driver, out[0]), out[2]
    ens, diag = port(case["ens"])
    ens2, _ = port(rounded(case["ens"], 9))
    assert_increments(dycore_state_to_numpy(ens), case["ens"],
                      [np.asarray(f) for f in ens_r],
                      extra=floor_of(ens2, ens))
    _diag_close(diag, diag_r)


# --- the nested cycle --------------------------------------------------------
NEST32 = NEST_CONFIG.replace("nx = 24", "nx = 32").replace("ny = 24",
                                                           "ny = 32")
PROCESS = """
[process]
mesh_member = 2
mesh_y = 2
mesh_x = 2
"""


def _nested(lateral, extra="", halo_mesh=None, rounding=False):
    """One coupled cycle (4 parent, 8 child steps) of NEST32 with the
    child's lateral mode (and `extra` TOML), from the numpy inputs of
    _nest_case (rounded once when `rounding`); halo_mesh: step the
    undecomposed child with the halo step of the whole ensemble on it.
    Returns (global parent and child analyses, info, the nested driver,
    the inputs: parent and child ensembles and obs)."""
    _, port, p_ens, c_ens, p_obs, c_obs = _nest_case(lateral, NEST32, extra)
    parent, child, geom, ncd = port
    if halo_mesh is not None:
        gpu_check.halo_dynamics(child, halo_mesh)
    nest = ncd(parent, child, geom)
    p_in, c_in = ((rounded(p_ens, 5), rounded(c_ens, 6)) if rounding
                  else (p_ens, c_ens))
    p_a, c_a, info = nest.cycle(dycore_state_to_torch(p_in, CPU),
                                dycore_state_to_torch(c_in, CPU), p_obs,
                                c_obs, steps_parent=4, steps_child=8)
    return (_global(parent, p_a), _global(child, c_a), info, nest,
            (p_ens, c_ens, p_obs, c_obs))


@pytest.mark.parametrize("lateral", ["periodic", "open"])
def test_grid_nested_cycle_is_undecomposed(lateral, monkeypatch):
    """The nested cycle with parent and child on make_mesh(2, 2, 2): both
    analyses and the O−B / O−A tables of both domains equal the
    undecomposed nested cycle's exactly (with an open child, the one whose
    child steps with the grid's halo dynamics). The child's bracket is
    sharded like its ensemble and built without gathering the parent
    ensemble (gather_ensemble never runs)."""
    want = _nested(lateral, halo_mesh=make_mesh(2, 2, 2)
                   if lateral == "open" else None)
    gathers, brackets = [], []
    gather = ProcessGrid.gather_ensemble
    monkeypatch.setattr(ProcessGrid, "gather_ensemble",
                        lambda self, sh: gathers.append(sh) or gather(self,
                                                                      sh))
    from scale_letkf_torch import cycle as cycle_mod
    block = cycle_mod.CycleDriver._bdy_block

    def spy(self, bdy, b, sh, b0, B):
        brackets.append(type(bdy.state0))
        return block(self, bdy, b, sh, b0, B)
    monkeypatch.setattr(cycle_mod.CycleDriver, "_bdy_block", spy)
    got = _nested(lateral, PROCESS)
    monkeypatch.undo()
    assert len(gathers) == 2       # the two results, gathered here
    assert brackets and set(brackets) == {Sharded}
    assert got[3].child.bdy is None
    _equal([*got[0], *got[1]], [*want[0], *want[1]])
    for dom in ("parent", "child"):
        for k in ("stats_gues", "stats_anal"):
            a, b = got[2][dom][k], want[2][dom][k]
            assert (a.nobs, a.rmse, a.bias) == (b.nobs, b.rmse, b.bias)
    assert got[2]["child"]["stats_gues"].nobs["T"] > 0


@pytest.mark.parametrize("lateral", ["periodic", "open"])
def test_grid_nested_cycle_matches_reference(lateral):
    """The reference's NestedCycleDriver of make_mesh(2, 2, 2) drivers
    (make_driver, make_nested with [process]) against the port's grid
    (periodic) or its undecomposed cycle (open): each domain's analysis to
    tests/test_torch_nesting.py's bound (restart increments plus twice the
    port's rounding floor)."""
    extra = PROCESS if lateral == "periodic" else ""
    got = _nested(lateral, extra)
    alt = _nested(lateral, extra, rounding=True)
    p_ens, c_ens, p_obs, c_obs = got[4]
    ref = _nest_case(lateral, NEST32, PROCESS)[0]
    assert ref[0].mesh is not None and ref[1].mesh is not None
    p_r, c_r, _ = ref[3](*ref[:3]).cycle(
        RefState(*map(jnp.asarray, p_ens)), RefState(*map(jnp.asarray, c_ens)),
        _ref_obs(p_obs), _ref_obs(c_obs), steps_parent=4, steps_child=8)
    for k, (init, want) in enumerate(((p_ens, p_r), (c_ens, c_r))):
        assert_increments(dycore_state_to_numpy(got[k]), init,
                          [np.asarray(f) for f in want],
                          extra=floor_of(alt[k], got[k]))


# --- the explicit core over terrain ------------------------------------------
OVER = {"nx": N, "ny": N, "nz": 8, "dz": 1000.0, "dz_stretch": 1.1,
        "dt": 1.0, "core": "explicit"}
K = 6


@pytest.fixture(scope="module")
def hill(tmp_path_factory):
    """The [domain] overrides with the coastal hill's topo_file, and the
    seeded moist ensemble (numpy)."""
    tmp = tmp_path_factory.mktemp("hill")
    over = {**OVER, "topo_file": topo_file(tmp, load_config_and_grid(
        CONFIG, OVER)[1])}
    _, grid_r, _, dom = ref_load(CONFIG, over)
    return over, moist_states(grid_r, dom, seed=5)[1]


def _terrain_driver(over, shape=None, halo="gspmd"):
    cfg, grid, dycfg, dom = load_config_and_grid(CONFIG, over)
    cfg.ensemble.member = K
    if shape is not None:
        (cfg.process.mesh_member, cfg.process.mesh_y,
         cfg.process.mesh_x) = shape
    return make_driver(cfg, grid, dataclasses.replace(dycfg, halo=halo),
                       dom, CPU)


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 2)])
def test_grid_explicit_terrain_forecast_is_undecomposed(hill, shape):
    """3 explicit-core steps over the hill on make_mesh(*shape), with halo
    'explicit' and 'explicit_overlap' (the overlap's strips cut from the
    extended metrics' own rows and columns), equal the undecomposed
    rk3_step_terrain forecast bit for bit."""
    over, ens = hill
    d0 = _terrain_driver(over)
    assert d0.metrics is not None and d0.mesh is None
    want = d0.forecast(dycore_state_to_torch(ens, CPU), 3)
    for h in ("explicit", "explicit_overlap"):
        d = _terrain_driver(over, shape, h)
        assert d.core == "explicit" and d.exchange
        got = _global(d, d.forecast(dycore_state_to_torch(ens, CPU), 3))
        _equal(got, want)
        assert d.timer.counts["forecast/halo"] == 9
    assert float((want.rhow - torch.from_numpy(ens.rhow)).abs().max()) > 0


def test_grid_explicit_terrain_forecast_matches_reference(hill):
    """The port's make_mesh(2, 2, 2) driver against the reference's
    make_mesh(2, 2, 2) driver (its GSPMD path, which runs the explicit core
    over terrain): 3 steps at tests/test_torch_terrain.py's bound (restart
    increments plus twice the port's rounding floor)."""
    over, ens = hill
    cfg, grid, dycfg, dom = ref_load(CONFIG, over)
    cfg.ensemble.member = K
    cfg.process.mesh_member = cfg.process.mesh_y = cfg.process.mesh_x = 2
    d_r = ref_make_driver(cfg, grid, dycfg, dom)
    assert d_r.mesh is not None and d_r.metrics is not None
    want = d_r.forecast(to_ref(ens), 3)
    d = _terrain_driver(over, (2, 2, 2))
    got = _global(d, d.forecast(dycore_state_to_torch(ens, CPU), 3))
    alt = _global(d, _terrain_driver(over, (2, 2, 2)).forecast(
        dycore_state_to_torch(rounded(ens, 12), CPU), 3))
    assert_increments(dycore_state_to_numpy(got), ens,
                      [np.asarray(x) for x in want], extra=floor_of(alt, got))


# --- the card's coarse checks, with the CPU in the card's place --------------

@pytest.mark.parametrize("check", ["terrain", "nested"])
def test_gpu_check_grid_executors_on_cpu(check):
    """gpu_check's coarse grid checks of mesh_checks run here with the CPU
    in the card's place: the explicit terrain step on (1, 2, 2) bit-equal
    to the undecomposed one (its overlap variant too), and the nested grid
    cycle (the 18-km parent coarsened, K = 20, the open 24 × 24 child)
    bit-equal to its composition."""
    if check == "terrain":
        res = gpu_check.terrain_grid_step_on_device(CPU, CONFIG)
        assert res["bit_equal"] and res["rhow_moved"] > 0
        assert all(v == 0 for v in res["overlap_over_tol"].values())
        return
    res = gpu_check.nested_grid_cycle_on_device(CPU, CONFIG)
    assert res["bit_equal"] and res["stats_equal"], res
    assert res["bracket_sections"] == 2 and min(res["nobs"]) > 0
