"""The 18-km regional forecast's plain path against the benchmark's plain
reference (benchmark/reference: terrain.py, suite.py, regional.py), piece by
piece, at a tiny size on the CPU from seeded random states: the terrain
tendency over hills, nsw6, radiation, the surface layer and PBL, the
physics step with its slab, the Davies relaxation, and a 2-step composed
forecast over hills with the suite. Besides: make_driver's phys_interval,
and the physics suite's timer sections (a timed forecast equal to an
untimed one, bit for bit).

Every comparison is exact: the reference is written in the program's order
of operations, so on the CPU their float32 results agree bit for bit; any
tolerance would let a reordered or dropped term pass.
"""

import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import _toml
from benchmark.reference import model as M
from benchmark.reference import regional as RG
from benchmark.reference import suite as S
from benchmark.reference import terrain as T
from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
from scale_letkf_torch.gpu_check import terrain_state
from scale_letkf_torch.model import physics_suite as PS
from scale_letkf_torch.model.boundary import BoundaryData, save_boundary
from scale_letkf_torch.model.dycore import DycoreState
from scale_letkf_torch.model.microphysics6 import nsw6_step
from scale_letkf_torch.model.pbl import pbl_step
from scale_letkf_torch.model.terrain import tendencies_terrain
from scale_letkf_torch.utils.timing import Timer

CPU = torch.device("cpu")
CONFIG = (Path(__file__).resolve().parents[1] / "benchmark" / "configs"
          / "japan_18km.toml")
# the benchmark configuration's column (300-m lowest level stretched by
# 1.04) cut to 12 levels, ~4.6 km: the top levels below 0 °C, so the ice
# processes run; 6-cell Davies buffer
TINY = {"nx": 20, "ny": 16, "nz": 12, "bdy_width": 6}
B = 2


def hills(ny, nx):
    j, i = np.mgrid[0:ny, 0:nx]
    return (400.0 * np.exp(-(((i - 0.4 * nx) / 3.0) ** 2
                             + ((j - 0.5 * ny) / 2.5) ** 2))).astype(
        np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The configuration at the tiny size with hills and moving boundary
    data: (the CycleDriver, the reference's Setup, a random state over the
    hills, the boundary data)."""
    tmp = tmp_path_factory.mktemp("ref18km")
    with open(CONFIG, "rb") as f:
        raw = tomllib.load(f)
    raw.pop("benchmark")
    dom = {**raw["domain"], **TINY}
    ny, nx, nz = dom["ny"], dom["nx"], dom["nz"]
    topo = hills(ny, nx)
    np.savez(tmp / "topo.npz", topo=topo)
    col = M.column_of(dom)
    gen = torch.Generator().manual_seed(5)
    base, _, _ = terrain_state(7, 1, col.cz, col.fz, topo, col.dx, col.dy)

    def target(scale):
        f = [torch.as_tensor(a[0]) for a in base]
        return DycoreState(f[0], f[1] * scale, f[2] * scale, f[3] * 0.0,
                           f[4] + torch.rand(f[4].shape, generator=gen), f[5])
    bdy = BoundaryData(target(1.0), target(0.5), 0.0, 600.0)
    save_boundary(tmp / "bdy.npz", bdy)
    dom.update(topo_file=str(tmp / "topo.npz"), bdy_file=str(tmp / "bdy.npz"))
    path = tmp / "c.toml"
    path.write_text(_toml({**raw, "domain": dom}))
    cfg, grid, dycfg, dom = load_config_and_grid(str(path))
    driver = make_driver(cfg, grid, dycfg, dom, CPU)
    su = RG.Setup(col=col, metrics=T.metrics(torch.as_tensor(topo), col),
                  bdy=RG.Boundary(M.State(*bdy.state0), M.State(*bdy.state1),
                                  bdy.t0, bdy.t1),
                  w=RG.weight(ny, nx, dom["bdy_width"], dom["bdy_tau"], CPU),
                  suite=S.settings(dom["physics"]), phys_interval=1,
                  dz_phys=float(col.fz[1] - col.fz[0]))
    fields, _, _ = terrain_state(11, B, col.cz, col.fz, topo, col.dx, col.dy)
    s = DycoreState(*(torch.as_tensor(a) for a in fields))
    return driver, su, s, bdy


def columns(su):
    f32 = torch.float32
    return (torch.as_tensor(np.diff(su.col.fz)[:, None, None], dtype=f32),
            torch.as_tensor(np.diff(su.col.cz)[:, None, None], dtype=f32),
            torch.as_tensor(su.col.cz, dtype=f32))


def _tendency(driver, su, s, bdy):
    dzc, dzf, _ = columns(su)
    prog = tendencies_terrain(s, driver.dycfg, driver.rho_ref, driver.p_ref,
                              driver.metrics, driver.vg)
    return prog, T.tendencies(M.State(*s), su.col, driver.rho_ref,
                              driver.p_ref, dzc, dzf, su.metrics)


def _nsw6(driver, su, s, bdy):
    return nsw6_step(s, 30.0, su.dz_phys), S.nsw6(M.State(*s), 30.0,
                                                    su.dz_phys)


def _radiation(driver, su, s, bdy):
    tsfc = PS.skin_temperature(s) + 3.0
    pcfg = driver.phys_cfg
    return (PS._radiation(s, tsfc, su.dz_phys, pcfg),
            S.radiation(M.State(*s), su.dz_phys, su.suite, tsfc))


def _pbl(driver, su, s, bdy):
    tsfc = PS.skin_temperature(s) + 3.0
    zc = driver.z_centers
    res = pbl_step(s, 30.0, su.dz_phys, zc, tsfc)
    st, shf, lhf = S.pbl(M.State(*s), 30.0, su.dz_phys, zc, tsfc, su.suite)
    return (*res.state, res.sfc.shf, res.sfc.lhf), (*st, shf, lhf)


def _physics_step(driver, su, s, bdy):
    """Two physics steps: the first recomputes radiation, the second reuses
    it; the slab's skin temperature carried between them."""
    zc, pcfg = driver.z_centers, driver.phys_cfg
    ph = PS.PhysicsState(PS.skin_temperature(s), torch.zeros_like(s.rhot),
                         torch.zeros_like(s.rhot[:, 0]))
    c = S.start(M.State(*s))
    p, r = s, M.State(*s)
    for i in range(2):
        p, ph = PS.physics_step(p, ph, i, pcfg, 30.0, su.dz_phys, zc)
        r, c = S.step(r, c, i, su.suite, 30.0, su.dz_phys, zc)
    return (*p, *ph), (*r, *c)


def _davies(driver, su, s, bdy):
    t = np.float32(270.0)
    return (driver._apply_bdy(s, t, bdy),
            RG.relax(M.State(*s), su.bdy, su.w, t, su.col.dt))


def _forecast(driver, su, s, bdy):
    driver.tsfc = None
    prog = driver.forecast(s, 2, t0=120.0)
    ref, tsfc = RG.forecast(M.State(*s), su, 2, 120.0, CPU)
    return (*prog, driver.tsfc), (*ref, tsfc)


PIECES = {"terrain tendency": _tendency, "nsw6": _nsw6,
          "radiation": _radiation, "surface and pbl": _pbl,
          "physics step and slab": _physics_step, "davies": _davies,
          "forecast over hills with the suite": _forecast}


@pytest.mark.parametrize("piece", list(PIECES))
def test_plain_path_is_the_reference(piece, setup):
    prog, ref = PIECES[piece](*setup)
    assert len(prog) == len(ref)
    for n, (a, b) in enumerate(zip(prog, ref)):
        assert torch.equal(a, b), (piece, n, float((a - b).abs().max()))


def test_the_pieces_are_not_trivial(setup):
    """The comparisons above see every scheme act."""
    driver, su, s, bdy = setup
    for piece, field in (("nsw6", 4), ("surface and pbl", 1),
                         ("davies", 0)):
        prog, _ = PIECES[piece](*setup)
        assert not torch.equal(prog[field], s[field]), piece
    q = nsw6_step(s, 30.0, su.dz_phys).rhoq
    assert not torch.equal(q[:, 3:], s.rhoq[:, 3:])      # ice processes
    drhot, rad_sfc = PIECES["radiation"](*setup)[0]
    assert bool((drhot != 0).any()) and bool((rad_sfc > 0).all())


@pytest.mark.parametrize("key", [None, 1, 3])
def test_make_driver_reads_phys_interval(key, tmp_path):
    with open(CONFIG, "rb") as f:
        raw = tomllib.load(f)
    raw.pop("benchmark")
    dom = {**raw["domain"], **TINY}
    dom.pop("phys_interval")
    if key is not None:
        dom["phys_interval"] = key
    path = tmp_path / "c.toml"
    path.write_text(_toml({**raw, "domain": dom}))
    driver = make_driver(*load_config_and_grid(str(path)), CPU)
    assert driver.phys_interval == (5 if key is None else key)


def test_physics_spans_and_timed_equals_untimed(setup):
    driver, su, s, bdy = setup
    out = {}
    for timed in (False, True):
        driver.timer = Timer(CPU, enabled=timed)
        driver.tsfc = None
        out[timed] = (*driver.forecast(s, 2), driver.tsfc)
    timer, driver.timer = driver.timer, Timer(CPU, enabled=False)
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
    rec = timer.records
    for name in ("microphysics", "radiation", "pbl"):
        assert rec[f"forecast/physics/{name}"] > 0
        assert timer.counts[f"forecast/physics/{name}"] == 2
    assert rec["forecast/physics"] >= sum(
        rec[f"forecast/physics/{n}"] for n in ("microphysics", "radiation",
                                                "pbl"))
