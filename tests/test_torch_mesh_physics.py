"""Physics on the port's process grid (parallel/halo.py physics_step_blocks,
CycleDriver(mesh=) with Kessler and with the physics suite), on the CPU.

Configuration: tests/test_torch_cycle.py's (configs/18km_japan.toml on its
18-km cells, levels dz 1 km × 1.1ᵏ, K = 6, the SI core) at 16 × 16 columns,
the suite as tests/test_torch_cycle.py composes it (nsw6, radiation every 2
physics steps, slab capacity 2e5), Davies relaxation over 3 cells toward a
shared boundary file. The forecasts are two calls of 5 and 3 steps at
phys_interval 5: a full chunk, then a remainder, the second call continuing
the first's skin temperature.

Exactness. A grid runs the undecomposed arithmetic on every block, so its
forecast equals the undecomposed one bit for bit (rtol = atol = 0), the
skin temperature included. On the CPU that needs every elementwise loop to
take its values in the same code: ATen's vectorized pow and exp (SLEEF) and
the scalar code of a loop's tail (the last len mod 32 elements under
AVX-512) may round differently in the last bit, so a block whose (y, x)
plane is not a multiple of 32 can part from the whole domain by an ulp in
a surface-layer pow. The 16 × 16 domain keeps every block's plane (8 × 8,
16 × 8, 16 × 16) a multiple of 32; on the card every element runs the same
code (chip_smoke.py holds the full-size grids exactly). In the open lateral
mode a decomposing grid's dynamics carry the reference's open-halo
behaviour (tests/test_torch_halo.py::test_open_halo_step_gap_to_the_global_
open_step), so there the grid is held exactly to the undecomposed driver
whose dynamics step is the halo step of the whole ensemble on the same
grid: the physics and the schedule are the undecomposed ones.

Against the JAX package: its CycleDriver on make_mesh(2, 2, 2) of the 8
virtual devices (its gspmd path) at tests/test_torch_cycle.py's bounds —
restart increments to 1e-4·max|Δ| + 6 ulp plus twice the port's rounding
floor (a port run from inputs perturbed by one rounding), the skin
temperature to 1e-4 of its change + 4 ulp plus twice its floor. The port's
grid in the periodic mode; in the open mode the reference's mesh runs the
global open step, so the port's undecomposed driver is held to it. The
reference's PBL reads the lateral mode from its module global (model/
dycore.py lateral_bc), the port's from the driver's DycoreConfig: the
reference's forecasts are traced inside lateral_bc of the mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_tpu.cli.main import make_driver as ref_make_driver
from scale_letkf_tpu.model.dycore import lateral_bc
from scale_letkf_torch import cycle as cycle_mod
from scale_letkf_torch import gpu_check
from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
from scale_letkf_torch.io.convert import (
    dycore_state_to_numpy, dycore_state_to_torch,
)
from scale_letkf_torch.parallel.mesh import Sharded, make_mesh
from scale_letkf_torch.state import ensemble_mean
from test_torch_cycle import (
    CONFIG, PHYS, assert_increments, assert_tsfc, boundary_file,
    moist_states, rounded, template, to_ref,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
K = 6
OVER = {"nx": 16, "ny": 16, "nz": 8, "dz": 1000.0, "dz_stretch": 1.1}
SHAPES = [(2, 2, 2), (2, 1, 1), (1, 2, 2)]


@pytest.fixture(scope="module")
def bdy_file(tmp_path_factory):
    f = tmp_path_factory.mktemp("bdy") / "bdy.npz"
    _, grid, _, dom = load_config_and_grid(CONFIG, OVER)
    boundary_file(f, grid, dom, False)
    return str(f)


def _extra(kind, bdy_file):
    phys = ({"use_physics": True} if kind == "kessler"
            else {"physics": PHYS})
    return {**phys, "bdy_file": bdy_file, "bdy_width": 3, "bdy_tau": 600.0}


def _port(kind, lateral, bdy_file, shape=None):
    """The port's driver (on make_mesh(*shape) when given), with its grid,
    cfg and [domain] table."""
    cfg, grid, dycfg, dom = load_config_and_grid(CONFIG, OVER)
    cfg.ensemble.member = K
    cfg.letkf.hdxb_gather_bf16 = False
    if shape is not None:
        (cfg.process.mesh_member, cfg.process.mesh_y,
         cfg.process.mesh_x) = shape
    dycfg = dataclasses.replace(dycfg, lateral=lateral)
    dom = {**dom, **_extra(kind, bdy_file)}
    return make_driver(cfg, grid, dycfg, dom, CPU), grid, cfg, dom


def _reference(kind, lateral, bdy_file):
    """The JAX package's driver on make_mesh(2, 2, 2), its grid, cfg."""
    cfg, grid, dycfg, dom = ref_load(CONFIG, OVER)
    cfg.ensemble.member = K
    cfg.letkf.hdxb_gather_bf16 = False
    cfg.process.mesh_member = cfg.process.mesh_y = cfg.process.mesh_x = 2
    dycfg = dataclasses.replace(dycfg, lateral=lateral)
    d = ref_make_driver(cfg, grid, dycfg, {**dom, **_extra(kind, bdy_file)})
    assert d.mesh is not None
    return d, grid, cfg, dom


def _global(driver, x):
    return driver.mesh.gather_ensemble(x) if isinstance(x, Sharded) else x


def _two_calls(driver, ens):
    """5 steps, then 3 more continuing the first call's skin temperature:
    (state and tsfc after the first, state and tsfc after the second), all
    global."""
    e1 = driver.forecast(dycore_state_to_torch(ens, CPU), 5)
    t1 = _global(driver, driver.tsfc)
    e2 = driver.forecast(e1, 3, t0=150.0)
    return (_global(driver, e1), t1, _global(driver, e2),
            _global(driver, driver.tsfc))


@pytest.mark.parametrize("lateral", ["periodic", "open"])
@pytest.mark.parametrize("kind", ["kessler", "suite"])
def test_grid_physics_forecast_is_undecomposed(kind, lateral, bdy_file):
    """Two forecast calls with Kessler or the suite and Davies forcing on
    the (2, 2, 2), (2, 1, 1) and (1, 2, 2) grids equal the undecomposed
    forecast at rtol = atol = 0 (in the open mode, the undecomposed driver
    with the grid's halo dynamics), the skin temperature included; the
    physics sections, and the PBL's halo under them, run on the grid."""
    dom = _port(kind, lateral, bdy_file)[3]
    _, ens = moist_states(ref_load(CONFIG, OVER)[1], dom, seed=4)
    for shape in SHAPES:
        mesh = make_mesh(*shape)
        ref = _port(kind, lateral, bdy_file)[0]
        if lateral == "open" and mesh.spatial:
            gpu_check.halo_dynamics(ref, mesh)
        want = _two_calls(ref, ens)
        d = _port(kind, lateral, bdy_file, shape)[0]
        assert d.mesh == mesh
        got = _two_calls(d, ens)
        for a, b in zip(got, want):
            if a is None:
                assert b is None and kind == "kessler"
                continue
            for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
                torch.testing.assert_close(x, y, rtol=0, atol=0)
        # a physics step a call: for every block's batch together on a
        # decomposing grid, for each member slab on a member-only one
        counts = d.timer.counts
        assert counts["forecast/physics"] == (2 if mesh.spatial else 4)
        if kind == "suite" and mesh.spatial:
            # two exchanges a physics step: (ρu, ρv), then (du, dv, ρ)
            assert counts["forecast/physics/halo"] == 4
        assert not torch.equal(got[2].rhot, want[0].rhot)


@pytest.mark.parametrize("lateral", ["periodic", "open"])
@pytest.mark.parametrize("kind", ["kessler", "suite"])
def test_grid_physics_forecast_matches_reference(kind, lateral, bdy_file):
    """The two calls against the JAX package's driver on make_mesh(2, 2, 2)
    (its gspmd path): the port's (2, 2, 2) grid in the periodic mode, its
    undecomposed driver in the open mode (the reference's mesh steps the
    global open step there)."""
    d_r, g_r, _, dom = _reference(kind, lateral, bdy_file)
    _, ens = moist_states(g_r, dom, seed=4)
    with lateral_bc(lateral):
        e1_r = d_r.forecast(to_ref(ens), 5)
        t1_r = None if d_r.tsfc is None else np.asarray(d_r.tsfc)
        e2_r = d_r.forecast(e1_r, 3, t0=150.0)
    shape = (2, 2, 2) if lateral == "periodic" else None
    got = _two_calls(_port(kind, lateral, bdy_file, shape)[0], ens)
    alt = _two_calls(_port(kind, lateral, bdy_file, shape)[0],
                     rounded(ens, 5))
    for k, want in ((0, e1_r), (2, e2_r)):
        assert_increments(dycore_state_to_numpy(got[k]), ens,
                          [np.asarray(x) for x in want],
                          extra={n: 2 * float((x - y).abs().max())
                                 for n, x, y in zip(ens._fields, got[k],
                                                    alt[k])})
    if kind == "suite":
        assert_tsfc(got[1], alt[1], t1_r, ens)
        assert_tsfc(got[3], alt[3], d_r.tsfc, ens)
        assert float((got[3] - got[1]).abs().max()) > 0


def test_grid_continues_its_skin_temperature(bdy_file):
    """The second call continues the first's slab, not a cold start: on the
    (2, 2, 2) grid a second call from a cold start gives another skin
    temperature and state."""
    d = _port("suite", "periodic", bdy_file, (2, 2, 2))[0]
    _, ens = moist_states(*ref_load(CONFIG, OVER)[1::2], seed=4)
    e1 = d.forecast(dycore_state_to_torch(ens, CPU), 5)
    assert isinstance(d.tsfc, Sharded)
    cold = _port("suite", "periodic", bdy_file, (2, 2, 2))[0]
    e2 = d.forecast(e1, 3, t0=150.0)
    e2c = cold.forecast(e1, 3, t0=150.0)
    t2, t2c = (x.mesh.gather_ensemble(x.tsfc) for x in (d, cold))
    assert float((t2 - t2c).abs().max()) > 0.1
    assert not torch.equal(d.mesh.gather_ensemble(e2).rhot,
                           d.mesh.gather_ensemble(e2c).rhot)


def test_member_only_grid_reads_each_slabs_skin_temperature(bdy_file):
    """A member-only (2, 1, 1) grid forecasts each slab from its own
    members' skin temperature (members 3–5's in slab 1, not members 0–2's)
    and threads each slab's own result: a resumed tsfc whose members
    differ (member m at its cold start + m K) gives the undecomposed
    forecast and tsfc exactly."""
    from scale_letkf_torch.model.physics_suite import skin_temperature
    dom = _port("suite", "periodic", bdy_file)[3]
    _, ens = moist_states(ref_load(CONFIG, OVER)[1], dom, seed=5)
    e = dycore_state_to_torch(ens, CPU)
    tsfc = skin_temperature(e) + torch.arange(K, dtype=torch.float32)[
        :, None, None]
    out = []
    for shape in (None, (2, 1, 1)):
        d = _port("suite", "periodic", bdy_file, shape)[0]
        d.tsfc = tsfc.clone()
        s = d.forecast(e, 5)
        out.append((_global(d, s), _global(d, d.tsfc)))
    (want, t_want), (got, t_got) = out
    torch.testing.assert_close(t_got, t_want, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _spy_history(monkeypatch):
    """Records the tsfc of every state_to_history call of cycle.py."""
    calls = []
    hist = cycle_mod.state_to_history

    def spy(*a, tsfc=None, **kw):
        calls.append(tsfc)
        return hist(*a, tsfc=tsfc, **kw)

    monkeypatch.setattr(cycle_mod, "state_to_history", spy)
    return calls


def _ps_template(cfg, grid):
    """tests/test_torch_cycle.py's network with the PS stations 50 m above
    the ground, so that their H(x) adjusts the surface pressure with the
    screen-level temperature and humidity (obs/operators.py prsadj)."""
    from scale_letkf_torch.obs.types import ID_PS
    obs = template(cfg, grid)[1]
    obs.lev[obs.elem == ID_PS] = 50.0
    return obs


@pytest.fixture(scope="module")
def osse(bdy_file):
    """One run_osse cycle of 6 steps (two physics steps) with the suite and
    Davies forcing, undecomposed and on the (2, 2, 2) grid (each driver,
    nature run, final ensemble, result and the tsfc of every
    state_to_history call of cycle.py)."""
    runs = {}
    mp = pytest.MonkeyPatch()
    try:
        for shape in (None, (2, 2, 2)):
            d, grid, cfg, dom = _port("suite", "periodic", bdy_file, shape)
            nature, ens = moist_states(ref_load(CONFIG, OVER)[1], dom,
                                       seed=2)
            calls = _spy_history(mp)
            truth, ens_a, res = d.run_osse(
                dycore_state_to_torch(nature, CPU),
                dycore_state_to_torch(ens, CPU), _ps_template(cfg, grid),
                n_cycles=1, steps_per_cycle=6, seed=3)
            mp.undo()
            runs[shape] = (d, truth, _global(d, ens_a), res, calls)
    finally:
        mp.undo()
    return runs


def test_grid_physics_cycle_is_undecomposed(osse):
    """One run_osse cycle with the suite on the (2, 2, 2) grid: the final
    ensemble, nature run and skin temperature, the guess and analysis
    means and spreads, and the O−B / O−A tables equal the undecomposed
    cycle's exactly."""
    d0, truth0, ens0, res0, _ = osse[None]
    d, truth, ens, res, _ = osse[(2, 2, 2)]
    for a, b in zip((*ens, *truth), (*ens0, *truth0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(_global(d, d.tsfc), d0.tsfc, rtol=0, atol=0)
    for k in ("gues_mean", "gues_sprd", "anal_mean", "anal_sprd"):
        torch.testing.assert_close(res.info[k], res0.info[k], rtol=0, atol=0)
    for tag in ("stats_gues", "stats_anal"):
        a, b = getattr(res, tag)[0], getattr(res0, tag)[0]
        assert a.nobs == b.nobs and a.rmse == b.rmse and a.bias == b.bias
    np.testing.assert_array_equal(res.info["obsdep"].oma,
                                  res0.info["obsdep"].oma)
    assert d.timer.counts["forecast/physics/halo"] == 4


def test_grid_hx_reads_the_skin_temperature(osse):
    """The grid's H(x) passes each member slab's skin temperature to the
    screen diagnostics (as the undecomposed path passes its own), and the
    monitor its member-order mean: the PS H(x) with it differs from the
    neutral diagnosis."""
    from scale_letkf_torch.da.obsope import compute_hx_single
    from scale_letkf_torch.model.dycore import to_collocated
    from scale_letkf_torch.obs.types import ID_PS
    from scale_letkf_torch.state import state_to_history, state_trans
    d, _, ens, res, calls = osse[(2, 2, 2)]
    calls0 = osse[None][4]
    # obsmake (no tsfc), the slabs' H(x) (one call a slab) and the monitor
    assert [c is None for c in calls] == [True, False, False, False]
    assert [c is None for c in calls0] == [True, False, False]
    tsfc = _global(d, d.tsfc)
    torch.testing.assert_close(torch.cat(calls[1:3]), calls0[1], rtol=0,
                               atol=0)
    torch.testing.assert_close(calls[3], calls0[2], rtol=0, atol=0)
    o = _ps_template(d.cfg, d.grid)
    ps = torch.from_numpy(o.elem == ID_PS)
    assert ps.any()
    fields = state_trans(to_collocated(ens))
    with_t, _ = compute_hx_single(state_to_history(
        fields, d.z_full, d.topo, tsfc=tsfc), o, d.grid, d.cfg, d.z_full)
    neutral, _ = compute_hx_single(state_to_history(
        fields, d.z_full, d.topo), o, d.grid, d.cfg, d.z_full)
    assert float((with_t[:, ps] - neutral[:, ps]).abs().max()) > 0


def test_monitor_mean_is_member_order(bdy_file, monkeypatch):
    """The O−A monitor's skin temperature is state.ensemble_mean of the
    members (their sum in member order, over K), not torch.mean (whose
    summation order depends on the tensor: at K = 20 the CPU's differs from
    member order at a few hundred of these 256 columns), undecomposed and on
    the (2, 2, 2) grid alike: an analysis of 20 members whose skin
    temperatures spread over 10 K."""
    from scale_letkf_torch.model.physics_suite import skin_temperature
    from scale_letkf_torch.synthetic import synthetic_ens_dycore_device
    for shape in (None, (2, 2, 2)):
        d, grid, cfg, dom = _port("suite", "periodic", bdy_file, shape)
        cfg.ensemble.member = 20
        ens, _, _ = synthetic_ens_dycore_device(6, 20, grid, dom, CPU,
                                                u0=10.0)
        gen = torch.Generator().manual_seed(7)
        tsfc = skin_temperature(ens) + 10.0 * torch.rand(
            ens.rho.shape[:1] + ens.rho.shape[-2:], generator=gen)
        d.tsfc = tsfc
        calls = _spy_history(monkeypatch)
        d.analysis(ens, _ps_template(cfg, grid))
        monkeypatch.undo()
        want = ensemble_mean(tsfc)
        assert torch.equal(calls[-1], want)
        assert not torch.equal(torch.mean(tsfc, dim=0), want)


# --- the fcst and cycle verbs with a [process] grid and physics ------------
PROCESS = """
[process]
mesh_member = 2
mesh_y = 2
mesh_x = 2
"""


@pytest.fixture(scope="module")
def cli_exp(tmp_path_factory):
    """tests/test_cli.py's experiment (12 × 12 × 8, K = 4, the explicit
    core) with [process] (2, 2, 2): a Kessler configuration (use_physics)
    and a [physics] one (tests/test_torch_cli.py's suite); an init
    checkpoint, the same with a resumed skin temperature (each member's
    lowest-level air ± 3 K) in its aux, and two cycles' obs from obsmake of
    a nature member."""
    from scale_letkf_torch.da.obsmake import make_obs_network, obsmake
    from scale_letkf_torch.grid import Grid, Projection
    from scale_letkf_torch.io import checkpoint
    from scale_letkf_torch.model.dycore import DycoreState, to_collocated
    from scale_letkf_torch.model.physics_suite import skin_temperature
    from scale_letkf_torch.obs import io as obsio
    from scale_letkf_torch.state import state_to_history, state_trans
    from test_cli import CONFIG as CLI_CONFIG
    from test_torch_cli import PHYS_TOML
    from test_torch_fcst import _members
    tmp = tmp_path_factory.mktemp("cli_grid")
    texts = {"kessler": CLI_CONFIG.replace("[domain]\n",
                                           "[domain]\nuse_physics = true\n"),
             "suite": CLI_CONFIG + PHYS_TOML}
    for kind, text in texts.items():
        (tmp / f"{kind}.toml").write_text(text + PROCESS)
    members = _members(5, 3)
    init = DycoreState(*(np.stack(f) for f in zip(*members[1:])))
    checkpoint.save_ensemble(tmp / "init", init, basename="anal.@@@@")
    tsfc = skin_temperature(DycoreState(*(torch.from_numpy(f)
                                          for f in init))).numpy()
    sign = np.random.default_rng(9).choice([-1.0, 1.0], tsfc.shape)
    checkpoint.save_ensemble(tmp / "init_tsfc", init, basename="anal.@@@@",
                             aux={"tsfc": (tsfc + 3.0 * sign).astype(
                                 np.float32)})
    grid = Grid.uniform(nx=12, ny=12, nz=8, dx=2000.0, dy=2000.0, dz=500.0,
                        proj=Projection())
    cfg = load_config_and_grid(str(tmp / "kessler.toml"))[0]
    nat = DycoreState(*(torch.from_numpy(f) for f in members[0]))
    z = grid.calc_z(torch.zeros((12, 12)))
    obs = obsmake(state_to_history(state_trans(to_collocated(nat)), z,
                                   torch.zeros((12, 12))),
                  make_obs_network(grid, np.random.default_rng(0),
                                   n_profiles=15, levels_hpa=(900.0, 800.0)),
                  grid, cfg, z, np.random.default_rng(5))
    for c in range(2):
        obsio.write_obs(str(tmp / f"obs{c}.dat"), obs)
    return tmp


@pytest.mark.parametrize("verb", ["fcst", "cycle"])
@pytest.mark.parametrize("kind", ["kessler", "suite"])
def test_verbs_run_physics_on_a_process_grid(cli_exp, kind, verb):
    """fcst (3 steps: one physics step) and cycle (2 cycles of 2 steps,
    the suite's skin temperature resumed from the init and written beside
    the analysis) with [process] (2, 2, 2) and Kessler or the suite, in
    both packages: the port's outputs against the reference's (its gspmd
    mesh) at tests/test_torch_cli.py's bounds, its floor a port run from an
    init perturbed by one rounding."""
    from scale_letkf_tpu.cli.main import main as ref_main
    from scale_letkf_tpu.io import checkpoint as ref_ckpt
    from scale_letkf_torch.cli.main import main
    from scale_letkf_torch.io import checkpoint
    from test_torch_cli import run
    tmp = cli_exp
    init = "init_tsfc" if kind == "suite" else "init"
    args = ([verb, "--config", str(tmp / f"{kind}.toml")]
            + (["--steps", "3"] if verb == "fcst" else
               ["--cycles", "2", "--steps-per-cycle", "2", "--obs-pattern",
                str(tmp / "obs{cycle}.dat")]))
    tag = f"{kind}_{verb}"
    run(ref_main, *args, "--init", str(tmp / init), "--out",
        str(tmp / f"ref_{tag}"))
    out = run(main, *args, "--init", str(tmp / init), "--out",
              str(tmp / f"port_{tag}"), "--device", "cpu")
    assert "physics" in out and "halo" in out
    e0, aux0, _ = checkpoint.load_ensemble(tmp / init)
    rng = np.random.default_rng(8)
    checkpoint.save_ensemble(tmp / f"{tag}_r", type(e0)(*(
        (f * (1.0 + 2.0 ** -24 * rng.standard_normal(f.shape))).astype(
            np.float32) for f in e0)), basename="anal.@@@@", aux=aux0)
    run(main, *args, "--init", str(tmp / f"{tag}_r"), "--out",
        str(tmp / f"port2_{tag}"), "--device", "cpu")
    ref, aux_r, _ = ref_ckpt.load_ensemble(tmp / f"ref_{tag}")
    got, aux, _ = checkpoint.load_ensemble(tmp / f"port_{tag}")
    got2, aux2, _ = checkpoint.load_ensemble(tmp / f"port2_{tag}")
    assert_increments(got, e0, ref, extra={
        n: 2 * float(np.abs(a - b).max())
        for n, a, b in zip(e0._fields, got, got2)})
    assert set(aux) == set(aux_r)
    if kind == "suite" and verb == "cycle":
        t0, tr, t, t2 = (x["tsfc"] for x in (aux0, aux_r, aux, aux2))
        tol = (1e-4 * np.abs(tr - t0).max()
               + 4 * np.spacing(np.float32(np.abs(tr).max()))
               + 2 * np.abs(t - t2).max())
        assert np.abs(t - tr).max() <= tol
        assert np.abs(t - t0).max() > 0
