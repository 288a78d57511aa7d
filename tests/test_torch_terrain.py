"""The port's terrain-following dynamics (scale_letkf_torch/model/terrain.py)
and the drivers that run it, on the CPU, against the reference package
from the same numpy inputs.

- Metrics and ρW: make_metrics rolls ∂h/∂x periodically whatever the
  lateral mode (the reference builds them outside any lateral_bc context);
  equal to the reference's to 1e-6 relative.
- Flat topography: tendencies_terrain equals dycore.tendencies exactly,
  uniform and stretched levels, periodic and open.
- Hills: tendencies per field to 2e-5·max|reference| (the bound of the
  flat core's parity tests, tests/test_torch_dycore.py), uniform and
  stretched levels, periodic and open, divergence damping off and on, on
  states whose mass fluxes keep away from zero (UD3's upwind switch is the
  flux's sign, and ρW is a difference over terrain) — asserted.
- Steps: three explicit rk3_step_terrain steps and two rk3_step_si steps
  with metrics (the 18-km configuration coarsened to 16×12×8) per field to
  1e-4·max|increment| plus twice the port's own rounding floor (its change
  when the inputs are perturbed by one rounding; ROADMAP §3), periodic and
  open; an unforced SI terrain forecast keeps Σ J·ρ·dzc to 1e-5.
- Drivers: CycleDriver with a topo_file, the physics suite and Davies
  relaxation (forecast; a run_osse cycle) and the explicit core with
  terrain, against the reference's drivers, at tests/test_torch_cycle.py's
  bounds; a terrain driver sizes its member batch by its own measured
  working set.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_tpu.model import dycore as ref
from scale_letkf_tpu.model import dycore_si as ref_si
from scale_letkf_tpu.model import terrain as ref_terrain
from scale_letkf_torch import cycle as cycle_mod
from scale_letkf_torch import gpu_check
from scale_letkf_torch.cli.main import load_config_and_grid
from scale_letkf_torch.io.convert import (
    dycore_state_to_numpy, dycore_state_to_torch, vgrid_to_torch,
)
from scale_letkf_torch.model import dycore, dycore_si, terrain
from test_torch_cycle import (
    PHYS, assert_increments, assert_tsfc, boundary_file, floor_of,
    moist_states, physics_pair, rounded, template, to_ref,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
CONFIG = str(Path(__file__).resolve().parents[1] / "configs"
             / "18km_japan.toml")
NZ, NY, NX = 8, 10, 16
DX = 2000.0
FLUX_MIN = 0.05      # |mass flux| the test states keep away from zero


def levels(kind: str, nz: int = NZ):
    """(cz, fz) of 500-m uniform or 300 m × 1.15ᵏ stretched levels."""
    dz = np.full(nz, 500.0) if kind == "uniform" else 300.0 * 1.15 ** np.arange(nz)
    fz = np.concatenate([[0.0], np.cumsum(dz)])
    return 0.5 * (fz[1:] + fz[:-1]), fz


def hills(ny=NY, nx=NX, amp=300.0):
    return gpu_check.hills(ny, nx, amp)


def hill_state(seed, B, cz, fz, topo):
    """gpu_check.terrain_state on DX cells: every mass flux of the terrain
    tendency keeps away from zero."""
    return gpu_check.terrain_state(seed, B, cz, fz, topo, DX, DX)


def port_setup(kind, lateral, divdmp=0.05, dt=5.0):
    cz, fz = levels(kind)
    cfg = dycore.DycoreConfig(dx=DX, dy=DX, dz=500.0, dt=dt, divdmp=divdmp,
                              lateral=lateral, ztop=float(fz[-1]))
    cfg_r = ref.DycoreConfig(**{k: v for k, v in dataclasses.asdict(
        cfg).items()})
    vg_r = None if kind == "uniform" else ref.make_vgrid(cz, fz)
    vg = None if vg_r is None else vgrid_to_torch(vg_r, CPU)
    return cz, fz, cfg, cfg_r, vg, vg_r


def assert_rel(out, expect, rel, names=dycore.DycoreState._fields):
    for name, a, b in zip(names, out, expect):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).max()
        err = np.abs(a - b).max()
        assert err <= rel * scale, f"{name}: {err:.3e} > {rel}·{scale:.3e}"


def test_make_metrics_rolls_periodically_as_the_reference():
    cz, fz = levels("stretched")
    topo = hills()
    m = terrain.make_metrics(torch.from_numpy(topo), cz, fz, DX, 1.5 * DX)
    m_r = ref_terrain.make_metrics(jnp.asarray(topo), cz, fz, DX, 1.5 * DX)
    assert_rel(m, m_r, 1e-6, terrain.TerrainMetrics._fields)
    # the edge hill wraps: ∂h/∂x at the last x-face differences across it
    want = (topo[:, 0] - topo[:, -1]) / DX
    np.testing.assert_allclose(m.gx[0, :, -1].numpy(),
                               want * (1 - cz[0] / fz[-1]), rtol=1e-5)


@pytest.mark.parametrize("lateral", ["periodic", "open"])
def test_contravariant_w_matches_reference(lateral):
    cz, fz = levels("stretched")
    topo = hills()
    fields, _, _ = hill_state(0, 1, cz, fz, topo)
    s = dycore.DycoreState(*(torch.from_numpy(f) for f in fields))
    m = terrain.make_metrics(torch.from_numpy(topo), cz, fz, DX, DX)
    m_r = ref_terrain.make_metrics(jnp.asarray(topo), cz, fz, DX, DX)
    with ref.lateral_bc(lateral):
        want = ref_terrain.contravariant_w(
            ref.DycoreState(*(jnp.asarray(f[0]) for f in fields)), m_r)
    got = terrain.contravariant_w(s, m, lateral)
    assert_rel([got[0]], [want], 1e-6, ["rhoW"])
    inner = got[:, 1:-1].abs()
    # periodic: exactly the ±(0.1-0.5) of the construction; open: the edge
    # columns differ, the rest keeps away from zero
    assert float(inner[..., 1:-1].min()) > FLUX_MIN


@pytest.mark.parametrize("lateral", ["periodic", "open"])
@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_flat_topography_reduces_to_dycore_tendencies(kind, lateral):
    cz, fz, cfg, _, vg, _ = port_setup(kind, lateral)
    fields, rho_ref, p_ref = hill_state(1, 2, cz, fz, np.zeros((NY, NX),
                                                               np.float32))
    s = dycore.DycoreState(*(torch.from_numpy(f) for f in fields))
    m = terrain.make_metrics(torch.zeros((NY, NX)), cz, fz, DX, DX)
    flat = dycore.tendencies(s, cfg, torch.from_numpy(rho_ref),
                             torch.from_numpy(p_ref), vg)
    got = terrain.tendencies_terrain(s, cfg, torch.from_numpy(rho_ref),
                                     torch.from_numpy(p_ref), m, vg)
    for a, b in zip(got, flat):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("divdmp", [0.0, 0.05])
@pytest.mark.parametrize("lateral", ["periodic", "open"])
@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_tendencies_terrain_match_reference(kind, lateral, divdmp):
    cz, fz, cfg, cfg_r, vg, vg_r = port_setup(kind, lateral, divdmp)
    topo = hills()
    fields, rho_ref, p_ref = hill_state(2, 2, cz, fz, topo)
    s = dycore.DycoreState(*(torch.from_numpy(f) for f in fields))
    m = terrain.make_metrics(torch.from_numpy(topo), cz, fz, DX, DX)
    m_r = ref_terrain.make_metrics(jnp.asarray(topo), cz, fz, DX, DX)
    # the fluxes the upwind switch reads keep away from zero
    jac_xf = 0.5 * (m.jac + torch.roll(m.jac, -1, -1))
    assert float((jac_xf * s.rhou).abs().min()) > FLUX_MIN
    rgw = terrain.contravariant_w(s, m, lateral) * m.jac
    assert float(rgw[:, 1:-1, :, 1:-1].abs().min()) > FLUX_MIN
    got = terrain.tendencies_terrain(s, cfg, torch.from_numpy(rho_ref),
                                     torch.from_numpy(p_ref), m, vg)
    assert got.rhow.shape == s.rhow.shape and got.rhoq.shape == s.rhoq.shape
    for b in range(2):
        with ref.lateral_bc(lateral):
            want = ref_terrain.tendencies_terrain(
                ref.DycoreState(*(jnp.asarray(f[b]) for f in fields)), cfg_r,
                jnp.asarray(rho_ref), jnp.asarray(p_ref), m_r, vg=vg_r)
        assert_rel([f[b] for f in got], want, 2e-5)


def test_tendencies_terrain_batch_equals_members():
    cz, fz, cfg, _, vg, _ = port_setup("stretched", "periodic")
    topo = hills()
    fields, rho_ref, p_ref = hill_state(3, 3, cz, fz, topo)
    s = dycore.DycoreState(*(torch.from_numpy(f) for f in fields))
    m = terrain.make_metrics(torch.from_numpy(topo), cz, fz, DX, DX)
    args = (cfg, torch.from_numpy(rho_ref), torch.from_numpy(p_ref), m, vg)
    batch = terrain.tendencies_terrain(s, *args)
    for b in range(3):
        one = terrain.tendencies_terrain(
            dycore.DycoreState(*(f[b] for f in s)), *args)
        for x, y in zip(batch, one):
            torch.testing.assert_close(x[b], y, rtol=0, atol=0)


def rounded_fields(fields, seed):
    rng = np.random.default_rng(seed)
    return [(f * (1.0 + 2.0 ** -24 * rng.standard_normal(f.shape))
             ).astype(np.float32) for f in fields]


def assert_steps(expect, out, out_rounded, fields):
    """Per field: |port − reference| ≤ 1e-4·max|increment| + 2·floor."""
    for name, a, b, c, f0 in zip(dycore.DycoreState._fields, expect, out,
                                 out_rounded, fields):
        a = np.asarray(a)
        assert np.isfinite(b).all(), name
        scale = 1e-4 * np.abs(a - f0).max()
        floor = np.abs(c - b).max()
        err = np.abs(b - a).max()
        assert err <= scale + 2 * floor, (
            f"{name}: {err:.3e} > {scale:.3e} + 2·{floor:.3e}")


@pytest.mark.parametrize("lateral", ["periodic", "open"])
def test_rk3_step_terrain_matches_reference(lateral):
    cz, fz, cfg, cfg_r, vg, vg_r = port_setup("stretched", lateral, dt=0.5)
    cfg = dataclasses.replace(cfg, sponge_height=2000.0, sponge_tau=60.0)
    cfg_r = dataclasses.replace(cfg_r, sponge_height=2000.0, sponge_tau=60.0)
    topo = hills()
    fields, rho_ref, p_ref = hill_state(4, 1, cz, fz, topo)
    fields = [f[0] for f in fields]
    zc = np.asarray(cz, np.float32)
    m_r = ref_terrain.make_metrics(jnp.asarray(topo), cz, fz, DX, DX)
    s_r = ref.DycoreState(*(jnp.asarray(f) for f in fields))
    for _ in range(3):
        s_r = ref_terrain.rk3_step_terrain(
            s_r, cfg_r, jnp.asarray(rho_ref), jnp.asarray(p_ref),
            jnp.asarray(zc), m_r, vg=vg_r)

    def port(fs):
        from scale_letkf_torch.utils.timing import Timer
        timer = Timer(CPU)
        m = terrain.make_metrics(torch.from_numpy(topo), cz, fz, DX, DX)
        s = dycore_state_to_torch(fs, CPU)
        for _ in range(3):
            s = terrain.rk3_step_terrain(
                s, cfg, torch.from_numpy(rho_ref), torch.from_numpy(p_ref),
                torch.from_numpy(zc), m, vg, timer=timer)
        assert timer.counts == {"tendencies": 9, "sponge": 3}
        return dycore_state_to_numpy(s)

    assert_steps(s_r, port(fields), port(rounded_fields(fields, 5)), fields)


def si_case(lateral):
    """The 18-km configuration coarsened to 16×12×8 with hills of 500 m,
    its stretched levels and core; a balanced state with the config's qv,
    ρθ noise of 0.5 K·ρ and 5 m/s winds."""
    from scale_letkf_torch.model import ideal
    cfg_r, grid_r, dycfg_r, dom = ref_load(CONFIG, {"nx": 16, "ny": 12,
                                                    "nz": 8})
    _, grid, dycfg, _ = load_config_and_grid(CONFIG, {"nx": 16, "ny": 12,
                                                      "nz": 8})
    dycfg = dataclasses.replace(dycfg, lateral=lateral)
    dycfg_r = dataclasses.replace(dycfg_r, lateral=lateral)
    qv = dom["qv_surface"] * np.exp(-grid.cz / 3000.0)
    s, rho_ref, p_ref = ideal.balanced_state(
        grid.nz, grid.ny, grid.nx, float(grid.fz[1] - grid.fz[0]),
        qv_prof=qv, cz=grid.cz)
    rng = np.random.default_rng(6)
    fields = [f.numpy().copy() for f in s]
    shape = fields[0].shape
    fields[1] += (5.0 * fields[0]).astype(np.float32)
    fields[2] += (2.0 * rng.standard_normal(shape) * fields[0]).astype(np.float32)
    fields[4] += (0.5 * rng.standard_normal(shape) * fields[0]).astype(np.float32)
    topo = hills(12, 16, 500.0)
    return (grid, grid_r, dycfg, dycfg_r, dom["n_small"], fields,
            rho_ref.numpy(), p_ref.numpy(), topo)


@pytest.mark.parametrize("lateral", ["periodic", "open"])
def test_rk3_step_si_with_metrics_matches_reference(lateral):
    (grid, grid_r, dycfg, dycfg_r, n_small, fields, rho_ref, p_ref,
     topo) = si_case(lateral)
    zc = np.asarray(grid.cz, np.float32)
    vg_r = ref.make_vgrid(grid_r.cz, grid_r.fz)
    m_r = ref_terrain.make_metrics(jnp.asarray(topo), grid_r.cz, grid_r.fz,
                                   grid.dx, grid.dy)
    split_r = ref_si.SplitConfig(dtau=dycfg_r.dt / n_small)
    s_r = ref.DycoreState(*(jnp.asarray(f) for f in fields))
    for _ in range(2):
        s_r = ref_si.rk3_step_si(s_r, dycfg_r, split_r, jnp.asarray(rho_ref),
                                 jnp.asarray(p_ref), jnp.asarray(zc),
                                 n_small, vg_r, m_r)

    def port(fs):
        m = terrain.make_metrics(torch.from_numpy(topo), grid.cz, grid.fz,
                                 grid.dx, grid.dy)
        out = dycore_si.integrate_si(
            dycore_state_to_torch(fs, CPU), dycfg,
            dycore_si.SplitConfig(dtau=dycfg.dt / n_small),
            torch.from_numpy(rho_ref), torch.from_numpy(p_ref),
            torch.from_numpy(zc), 2, n_small, vgrid_to_torch(vg_r, CPU), m)
        return dycore_state_to_numpy(out)

    out = port(fields)
    assert_steps(s_r, out, port(rounded_fields(fields, 7)), fields)
    # the metric terms act: the flat core's result differs
    flat = dycore_state_to_numpy(dycore_si.integrate_si(
        dycore_state_to_torch(fields, CPU), dycfg,
        dycore_si.SplitConfig(dtau=dycfg.dt / n_small),
        torch.from_numpy(rho_ref), torch.from_numpy(p_ref),
        torch.from_numpy(zc), 2, n_small, vgrid_to_torch(vg_r, CPU)))
    assert np.abs(out[3] - flat[3]).max() > 1e-3 * np.abs(out[3]).max()


def test_unforced_terrain_forecast_keeps_jacobian_weighted_mass():
    """A 6-step SI forecast over hills (periodic, no boundary forcing)
    keeps Σ J·ρ·dzc to 1e-5 of itself."""
    (grid, _, dycfg, _, n_small, fields, rho_ref, p_ref,
     topo) = si_case("periodic")
    vg = dycore.make_vgrid(grid.cz, grid.fz, CPU)
    m = terrain.make_metrics(torch.from_numpy(topo), grid.cz, grid.fz,
                             grid.dx, grid.dy)
    s0 = dycore_state_to_torch(fields, CPU)
    out = dycore_si.integrate_si(
        s0, dycfg, dycore_si.SplitConfig(dtau=dycfg.dt / n_small),
        torch.from_numpy(rho_ref), torch.from_numpy(p_ref),
        torch.as_tensor(grid.cz, dtype=torch.float32), 6, n_small, vg, m)
    m0 = gpu_check.jacobian_mass(s0.rho, m.jac, vg.dzc)
    assert abs(gpu_check.jacobian_mass(out.rho, m.jac, vg.dzc) - m0) <= 1e-5 * m0
    assert float(out.rhow.abs().max()) > 0


# --- the drivers -------------------------------------------------------------

def topo_file(tmp_path, grid):
    """A 500-m coastal hill (tests/test_realcase_cycle.py's) on `grid`,
    saved as the pp verb writes it."""
    x = (np.arange(grid.nx) + 0.5) * grid.dx
    y = (np.arange(grid.ny) + 0.5) * grid.dy
    topo = 500.0 * np.exp(-(((x[None] - 0.6 * grid.nx * grid.dx) / 100e3) ** 2
                            + ((y[:, None] - 0.5 * grid.ny * grid.dy) / 100e3)
                            ** 2))
    path = tmp_path / "topo.npz"
    np.savez(path, topo=topo)
    return str(path)


def terrain_pair(tmp_path, extra):
    """physics_pair's drivers with a topo_file and `extra` in [domain]."""
    _, _, _, g0, _, _ = physics_pair({})
    return physics_pair({"topo_file": topo_file(tmp_path, g0), **extra})


def test_terrain_physics_forecast_matches_reference(tmp_path):
    """Seven steps (a physics chunk of 5 and a remainder of 2) of the SI
    core with terrain metrics, the physics suite and Davies relaxation
    toward a shared boundary file, against the reference's driver."""
    f = tmp_path / "bdy.npz"
    _, _, _, g0, _, dom0 = physics_pair({})
    boundary_file(f, g0, dom0, False)
    extra = {"physics": PHYS, "bdy_file": str(f), "bdy_width": 3,
             "bdy_tau": 600.0}
    d_r, d, g_r, g, cfg, dom = terrain_pair(tmp_path, extra)
    assert d_r.metrics is not None and d.metrics is not None
    assert_rel(d.metrics, d_r.metrics, 1e-6, terrain.TerrainMetrics._fields)
    np.testing.assert_allclose(d.z_full.numpy(), np.asarray(d_r.z_full),
                               rtol=1e-6)
    _, ens = moist_states(g_r, dom)
    want = d_r.forecast(to_ref(ens), 7)
    got = d.forecast(dycore_state_to_torch(ens, CPU), 7)
    tsfc = d.tsfc
    d2 = terrain_pair(tmp_path, extra)[1]
    alt = d2.forecast(dycore_state_to_torch(rounded(ens, 9), CPU), 7)
    assert_increments(dycore_state_to_numpy(got), ens,
                      [np.asarray(x) for x in want], extra=floor_of(alt, got))
    assert_tsfc(tsfc, d2.tsfc, d_r.tsfc, ens)
    assert d.timer.counts["forecast/tendencies"] == 3 * 7
    assert d.timer.counts["forecast/physics"] == 2


def test_terrain_run_osse_matches_reference(tmp_path):
    """One run_osse cycle of 4 steps over the hill with the physics suite
    and Davies forcing: the nature run and the ensemble both on terrain,
    H(x) on the terrain-following heights. The cycle statistics to 1e-4
    relative plus twice the port's own rounding floor, as the states."""
    f = tmp_path / "bdy.npz"
    _, _, _, g0, _, dom0 = physics_pair({})
    boundary_file(f, g0, dom0, False)
    extra = {"physics": PHYS, "bdy_file": str(f), "bdy_width": 3,
             "bdy_tau": 600.0}
    d_r, d, g_r, g, cfg, dom = terrain_pair(tmp_path, extra)
    nature, ens = moist_states(g_r, dom, seed=4)
    tmpl_r, tmpl = template(cfg, g)
    truth_r, ens_r, res_r = d_r.run_osse(to_ref(nature), to_ref(ens),
                                         tmpl_r, n_cycles=1,
                                         steps_per_cycle=4, seed=3)

    def port(driver, nat, e):
        return driver.run_osse(dycore_state_to_torch(nat, CPU),
                               dycore_state_to_torch(e, CPU), tmpl,
                               n_cycles=1, steps_per_cycle=4, seed=3)

    truth, ens_p, res = port(d, nature, ens)
    d2 = terrain_pair(tmp_path, extra)[1]
    truth2, ens_p2, res2 = port(d2, rounded(nature, 10), rounded(ens, 11))
    assert_increments(dycore_state_to_numpy(ens_p), ens,
                      [np.asarray(x) for x in ens_r],
                      extra=floor_of(ens_p2, ens_p))
    assert_increments(dycore_state_to_numpy(truth), nature,
                      [np.asarray(x) for x in truth_r],
                      extra=floor_of(truth2, truth))

    def close(a, b, alt, label):
        """to 1e-4 relative plus twice the port's own rounding floor"""
        tol = 1e-4 * abs(b) + 2 * abs(a - alt)
        assert abs(a - b) <= tol, f"{label}: {a} vs {b} (tol {tol:.3e})"

    for key in ("rmse_gues", "rmse_anal", "spread"):
        for a, b, alt in zip(getattr(res, key), getattr(res_r, key),
                             getattr(res2, key)):
            close(a, b, alt, key)
    assert res.stats_gues[0].nobs == res_r.stats_gues[0].nobs
    for n, v in res_r.stats_anal[0].rmse.items():
        if res.stats_anal[0].nobs[n]:
            close(res.stats_anal[0].rmse[n], v, res2.stats_anal[0].rmse[n],
                  f"O-A {n}")
    assert d.timer.counts["nature/tendencies"] == 3 * 4


def test_explicit_core_with_terrain_matches_reference(tmp_path):
    """core = 'explicit' over the hill steps with rk3_step_terrain (dt 1 s,
    inside the vertical sound CFL of these levels)."""
    from scale_letkf_tpu.cli.main import make_driver as ref_make_driver
    from scale_letkf_torch.cli.main import make_driver
    from test_torch_cycle import K, OVER
    g0 = physics_pair({})[3]
    over = {**OVER, "dt": 1.0, "core": "explicit",
            "topo_file": topo_file(tmp_path, g0)}
    drivers = []
    for load, make in ((ref_load, ref_make_driver),
                       (load_config_and_grid, make_driver),
                       (load_config_and_grid, make_driver)):
        cfg, grid, dycfg, dom = load(CONFIG, over)
        cfg.ensemble.member = K
        drivers.append(make(cfg, grid, dycfg, dom) if make is ref_make_driver
                       else make(cfg, grid, dycfg, dom, CPU))
    d_r, d, d2 = drivers
    assert d.core == "explicit" and d.dycfg.dt == 1.0
    assert d.metrics is not None
    _, ens = moist_states(physics_pair({})[2], dom, seed=5)
    want = d_r.forecast(to_ref(ens), 3)
    got = d.forecast(dycore_state_to_torch(ens, CPU), 3)
    alt = d2.forecast(dycore_state_to_torch(rounded(ens, 12), CPU), 3)
    assert_increments(dycore_state_to_numpy(got), ens,
                      [np.asarray(x) for x in want], extra=floor_of(alt, got))
    assert d.timer.counts == {"forecast": 1, "forecast/tendencies": 9,
                              "forecast/sponge": 3}


def test_terrain_driver_sizes_its_batch_by_its_own_working_set(
        tmp_path, monkeypatch):
    _, flat, _, _, _, _ = physics_pair({})
    _, hill, _, _, _, dom = terrain_pair(tmp_path, {})
    assert flat.metrics is None
    assert flat.fields_per_member == cycle_mod.FORECAST_FIELDS_PER_MEMBER
    assert (hill.fields_per_member
            == cycle_mod.FORECAST_FIELDS_PER_MEMBER_TERRAIN
            > cycle_mod.FORECAST_FIELDS_PER_MEMBER)
    # member_batch on a card with 40 GiB free and 2 GiB cached
    gib = 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (40 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: 3 * gib)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device: 1 * gib)
    field = 480 * 360 * 36 * 4
    cuda = torch.device("cuda")
    for fields in (cycle_mod.FORECAST_FIELDS_PER_MEMBER,
                   cycle_mod.FORECAST_FIELDS_PER_MEMBER_TERRAIN):
        cap = int(0.5 * 42 * gib // (fields * field))
        n = -(-50 // cap)
        assert cycle_mod.member_batch(50, field, cuda, fields) == -(-50 // n)
    # the forecast asks for the driver's own count
    seen = []
    monkeypatch.setattr(cycle_mod, "member_batch",
                        lambda K, fb, dev, fields: seen.append(fields) or K)
    nature, ens = moist_states(physics_pair({})[2], dom)
    hill.forecast(dycore_state_to_torch(ens, CPU), 1)
    flat.forecast(dycore_state_to_torch(ens, CPU), 1)
    assert seen == [cycle_mod.FORECAST_FIELDS_PER_MEMBER_TERRAIN,
                    cycle_mod.FORECAST_FIELDS_PER_MEMBER]


def test_gpu_check_terrain_helpers_on_cpu():
    """gpu_check's terrain, pp and H08 comparisons with the CPU in the
    card's place: the same computation twice gives no error, Σ J·ρ·dzc of
    the unforced terrain forecast holds to 1e-5, the smoothing takes the
    same passes, H08 obs pass QC and the pressures agree."""
    res = gpu_check.terrain_modules_vs_cpu(CPU, CONFIG)
    for lateral in ("periodic", "open"):
        r = res[lateral]
        assert r["finite"]
        assert all(e == 0 for part in ("tendencies", "si_steps")
                   for e in r[part].values()), r
        assert all(f > 0 for f in r["si_steps_floor"].values()), r
    assert res["mass"]["jacobian_mass_rel_change"] <= 1e-5, res["mass"]
    topo_r = gpu_check.topo_vs_cpu(CPU, CONFIG)
    assert topo_r["passes"]["device"] == topo_r["passes"]["cpu"] > 0
    assert topo_r["max_err_over_tol"] == 0
    h = gpu_check.h08_hx_vs_cpu(CPU, CONFIG)
    assert h["qc_equal"] and h["h08_good"] > 0 and h["finite"]
    assert h["bt_max_abs_err_k"] == 0 and h["plev_differ_share"] == 0
