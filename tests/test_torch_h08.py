"""The port's Himawari-8 radiance operator (scale_letkf_torch/obs/h08.py) and
the H08 paths of H(x), obsmake, obsope and letkf against the reference
package, from the same numpy inputs, on the CPU.

- The band model on seeded columns (moist, with liquid and ice layers, 24
  levels, zenith 0-1.2 rad) at the default coefficients and at
  docs/h08_calibration.json (the reference's module globals restored by
  monkeypatch): BT to 2e-3 K (the float32 exp/log1p/cumsum chain of both
  packages differs by up to ~1e-4 K here), plev exactly where the largest
  two weights dtau/dp of the column differ by more than 1e-3 of the
  largest (the argmax cannot flip on a last bit there) and to an adjacent
  level elsewhere. The port's own-band path against the reference's ten
  bands followed by its pick, at the same bounds.
- Trans_XtoY_H08 and the driver's H(x) on history fields with a member
  axis (a mixed conventional + H08 set): QC equal; H08 BT, clear-sky BT and
  sensitive pressure as above; the other obs to 2e-5 of their range plus
  4 ulp (tests/test_torch_obsope.py).
- obsmake of a whole-profile H08 template (|BT|, per-channel errors, the
  profiles kept whole) and the verbs obsmake → obsope (the obsda files'
  trailing lev/val2 records) → letkf, integrated and --obsda, on a mixed
  conventional + H08 set: both packages' chains on the same files, the
  analyses per restart field to 1e-4·max|Δ| plus 6 ulp
  (tests/test_torch_cycle.py).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_letkf_tpu.config import Config as RefConfig
from scale_letkf_tpu.da.obsmake import obsmake as ref_obsmake
from scale_letkf_tpu.da.obsope import obsope_ensemble as ref_obsope
from scale_letkf_tpu.grid import Grid as RefGrid
from scale_letkf_tpu.obs import h08 as ref_h08
from scale_letkf_tpu.obs.types import Observations as RefObservations
from scale_letkf_torch.config import Config
from scale_letkf_torch.da.obsmake import default_err, obsmake
from scale_letkf_torch.da.obsope import obsope_ensemble
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.obs import h08
from scale_letkf_torch.obs.types import (
    ID_H08IR, ID_T, QC_GOOD, QC_OBS_BAD, Observations,
)
from scale_letkf_torch.synthetic import synthetic_h08_network

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CALIB = str(ROOT / "docs" / "h08_calibration.json")
BT_TOL = 2e-3        # K
PLEV_MARGIN = 1e-3   # relative gap of the top two weights for an exact plev
OBS_FIELDS = ("elem", "lon", "lat", "lev", "dat", "err", "typ", "dif")


def columns(n=64, nz=24, seed=0):
    """Seeded float32 columns (p descending from ~980 hPa, a 60-K lapse,
    moist low levels, liquid and ice in ~10% of the layers each) and the
    surface: (p, t, qv, qliq, qice, tsfc, psfc, zenith)."""
    rng = np.random.default_rng(seed)
    p = np.geomspace(9.8e4, 1.0e4, nz)[None] * (
        1 + 0.01 * rng.standard_normal((n, 1)))
    t = 288.0 - 60.0 * (1.0 - p / p[:, :1]) + rng.standard_normal((n, nz))
    qv = 0.01 * (p / p[:, :1]) ** 3 * (1 + 0.2 * rng.standard_normal((n, nz)))
    ql = np.where(rng.random((n, nz)) < 0.1, 1e-3 * rng.random((n, nz)), 0.0)
    qi = np.where(rng.random((n, nz)) < 0.1, 1e-3 * rng.random((n, nz)), 0.0)
    tsfc = 290.0 + 3.0 * rng.standard_normal(n)
    psfc = p[:, 0] + 500.0
    zen = rng.uniform(0.0, 1.2, n)
    return [np.asarray(a, np.float32)
            for a in (p, t, qv, ql, qi, tsfc, psfc, zen)]


def weight_gap(args, coef, band):
    """Per column and band: the relative gap between the largest and the
    second-largest all-sky weight dtau/dp (float64 recomputation)."""
    p, t, qv, ql, qi, tsfc, psfc, zen = (a.astype(np.float64) for a in args)
    mid = 0.5 * (p[:, :-1] + p[:, 1:])
    dm = np.maximum(np.concatenate([psfc[:, None], mid], 1)
                    - np.concatenate([mid, 0.5 * p[:, -1:]], 1), 0) / 9.81
    pb = (np.maximum(p, 1) / 1e5) ** coef.wv_p_exp
    sec = 1 / np.maximum(np.cos(zen), 0.2)
    kw = np.asarray(coef.k_wv)[band][:, None]
    kf = np.asarray(coef.k_fix)[band][:, None]
    od = ((kw * qv * pb * dm + kf * dm)
          + (h08.K_LIQ * ql + h08.K_ICE * qi) * dm) * sec[:, None]
    od = od[:, ::-1]
    above = np.exp(-np.cumsum(od, 1) + od)
    w = (above - above * np.exp(-od)) / np.maximum(dm[:, ::-1] * 9.81, 1)[:, :]
    top2 = np.sort(w, 1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) / top2[:, 1]


def assert_plev(got, want, p, gap):
    """plev equal where the top two weights differ by > PLEV_MARGIN, else
    equal or an adjacent level's pressure."""
    sure = gap > PLEV_MARGIN
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got[sure], want[sure])
    for i in np.nonzero(~sure)[0]:
        k = np.nonzero(p[i] == want[i])[0][0]
        assert got[i] in p[i, max(k - 1, 0):k + 2], i


@pytest.fixture(params=["default", "calibrated"])
def coef(request, monkeypatch):
    """The coefficients of both packages: the defaults, or the fitted ones
    loaded by each package's load_calibration (the reference's rebinds its
    module globals; monkeypatch restores them)."""
    for name in ("K_WV", "K_FIX", "WV_P_EXP"):
        monkeypatch.setattr(ref_h08, name, getattr(ref_h08, name))
    if request.param == "default":
        return h08.DEFAULT_COEF
    ref_h08.load_calibration(CALIB)
    c = h08.load_calibration(CALIB)
    assert c != h08.DEFAULT_COEF
    return c


def test_constants_match_reference():
    for name in ("WAVENUM", "K_WV", "K_FIX"):
        np.testing.assert_array_equal(
            np.asarray(getattr(h08, name), np.float32),
            np.asarray(getattr(ref_h08, name), np.float32), name)
    for name in ("NCHAN", "WV_P_EXP", "P0", "K_LIQ", "K_ICE", "C1", "C2",
                 "SAT_LON", "SAT_ALT", "R_EARTH"):
        assert getattr(h08, name) == getattr(ref_h08, name), name


def test_planck_roundtrip():
    t = torch.tensor([200.0, 250.0, 300.0])[:, None]
    wn = torch.tensor(h08.WAVENUM)
    bt = h08.planck_bt(h08.planck_rad(t, wn), wn)
    torch.testing.assert_close(bt, t.expand_as(bt), rtol=1e-6, atol=0)


def test_load_calibration_reads_the_fit():
    c = h08.load_calibration(CALIB)
    assert len(c.k_wv) == len(c.k_fix) == h08.NCHAN
    ref_h08_globals = (ref_h08.K_WV, ref_h08.K_FIX, ref_h08.WV_P_EXP)
    # the port keeps no state: the module constants are untouched
    assert h08.DEFAULT_COEF == h08.H08Coefficients()
    assert (ref_h08.K_WV, ref_h08.K_FIX, ref_h08.WV_P_EXP) == ref_h08_globals


def test_rt_fwd_matches_reference(coef):
    args = columns()
    want = [np.asarray(a) for a in ref_h08.h08_rt_fwd(
        *(jnp.asarray(a) for a in args))]
    got = [a.numpy() for a in h08.h08_rt_fwd(
        *(torch.from_numpy(a) for a in args), coef=coef)]
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=BT_TOL)
    n = len(args[0])
    for b in range(h08.NCHAN):
        gap = weight_gap(args, coef, np.full(n, b))
        assert_plev(got[2][:, b], want[2][:, b], args[0], gap)
    # the own-band path: each column's band alone, the reference's pick
    band = np.random.default_rng(1).integers(0, h08.NCHAN, n)
    own = [a.numpy() for a in h08.h08_rt_fwd(
        *(torch.from_numpy(a) for a in args), coef=coef,
        band=torch.from_numpy(band))]
    rows = np.arange(n)
    for a, b in zip(own[:2], want[:2]):
        np.testing.assert_allclose(a, b[rows, band], rtol=0, atol=BT_TOL)
    assert_plev(own[2], want[2][rows, band], args[0],
                weight_gap(args, coef, band))


def test_satellite_zenith_matches_reference():
    rng = np.random.default_rng(2)
    lon, lat = rng.uniform(100, 180, 50), rng.uniform(-60, 60, 50)
    want = np.asarray(ref_h08.satellite_zenith(jnp.asarray(lon),
                                               jnp.asarray(lat)))
    np.testing.assert_allclose(h08.satellite_zenith(lon, lat), want,
                               rtol=0, atol=2e-6)
    torch.testing.assert_close(
        h08.satellite_zenith(torch.from_numpy(lon), torch.from_numpy(lat)),
        torch.from_numpy(h08.satellite_zenith(lon, lat)))


# --- H(x) on a grid ----------------------------------------------------------

NY = NX = 8
NZ = 24


def history(K=3, seed=3, cloud=True):
    """(K, …) history fields of a moist column with member noise, numpy
    float32, in state_to_history's names."""
    rng = np.random.default_rng(seed)
    p = np.geomspace(9.8e4, 1.0e4, NZ)
    t = 288.0 - 60.0 * (1.0 - p / p[0])
    shape = (K, NZ, NY, NX)
    f = {"p": p[None, :, None, None] * (1 + 1e-3 * rng.standard_normal(shape)),
         "t": t[None, :, None, None] + 0.5 * rng.standard_normal(shape),
         "q": 0.01 * (p / p[0])[None, :, None, None] ** 3
         * (1 + 0.1 * rng.standard_normal(shape))}
    f["rh"] = np.full(shape, 0.5)
    for k in ("qc", "qr", "qi", "qs", "qg", "u", "v", "w"):
        f[k] = np.zeros(shape)
    if cloud:
        f["qc"][:, 6:9, 2:6, 2:6] = 1e-3
        f["qi"][:, 15:18, 3:7, 1:5] = 5e-4
    f["u"] += 5.0
    f["ps"] = f["p"][:, 0] + 500.0
    f["t2m"] = f["t"][:, 0] + 1.0
    f["q2m"] = f["q"][:, 0]
    f["topo"] = np.zeros((K, NY, NX))
    f["u10m"] = f["v10m"] = np.zeros((K, NY, NX))
    return {k: np.asarray(v, np.float32) for k, v in f.items()}


def grids():
    kw = dict(nx=NX, ny=NY, nz=NZ, dx=10e3, dy=10e3, dz=500.0)
    return RefGrid.uniform(**kw), Grid.uniform(**kw)


def mixed_obs(grid):
    """Whole H08 profiles every 2 cells inside a 1-cell margin, one
    outside the domain, and T obs at 700 hPa."""
    h = synthetic_h08_network(Config(), grid, spacing=2, margin=1)
    lon2d, lat2d = grid.lonlat
    out = synthetic_h08_network(Config(), grid, spacing=100, margin=0)
    out.lon = out.lon - 5.0          # far west of the domain
    conv = Observations(
        elem=np.full(4, ID_T, np.int32), lon=lon2d[2:6, 3], lat=lat2d[2:6, 3],
        lev=np.full(4, 7.0e4), dat=np.full(4, 280.0), err=np.ones(4),
        typ=np.zeros(4, np.int32), dif=np.zeros(4))
    return Observations.concatenate([h, out, conv])


def to_ref_obs(obs):
    return RefObservations(**{k: getattr(obs, k) for k in OBS_FIELDS})


def h08_cfgs(**h):
    cfg, cfg_r = Config(), RefConfig()
    cfg.h08 = dataclasses.replace(cfg.h08, **h)
    cfg_r.h08 = dataclasses.replace(cfg_r.h08, **h)
    return cfg, cfg_r


@pytest.mark.parametrize("thrs", [-5.0, 2.0])
def test_obsope_ensemble_h08_matches_reference(thrs):
    g_r, g = grids()
    obs = mixed_obs(g)
    cfg, cfg_r = h08_cfgs(h08_ch_use=(0, 0, 1, 0, 0, 0, 1, 0, 0, 1),
                          h08_cldsky_thrs=thrs)
    f = history()
    z = g.calc_z(torch.zeros((NY, NX)))
    got = obsope_ensemble({k: torch.from_numpy(v) for k, v in f.items()},
                          obs, g, cfg, z)
    want = ref_obsope({k: jnp.asarray(v) for k, v in f.items()},
                      to_ref_obs(obs), g_r, cfg_r, g_r.calc_z(
                          jnp.zeros((NY, NX))))
    np.testing.assert_array_equal(got.qc, want.qc)
    m = obs.elem == ID_H08IR
    good = got.qc == QC_GOOD
    assert (good & m).sum() >= 20 and (~good & m).sum() > 0
    assert (got.qc[m] != QC_OBS_BAD).sum() < m.sum()
    y, y_r = got.ensval.numpy(), np.asarray(want.ensval)
    np.testing.assert_allclose(y[:, m], y_r[:, m], rtol=0, atol=BT_TOL)
    if thrs < 0:
        assert (y[:, m] < 0).all()     # every column flagged cloudy
    else:
        assert (y[:, m] < 0).any() and (y[:, m] > 0).any()
    np.testing.assert_allclose(got.val2, want.val2, rtol=0, atol=BT_TOL)
    # the mean sensitive pressure: an argmax flip in one member moves the
    # mean by a level spacing over K; the members' levels are held exactly
    # by test_rt_fwd_matches_reference
    dp = np.abs(np.diff(f["p"], axis=1)).max()
    np.testing.assert_allclose(got.lev[m], want.lev[m], rtol=0,
                               atol=dp / f["p"].shape[0])
    assert (got.lev[~m] == 0).all() and (got.val2[~m] == 0).all()
    assert got.lev[m & good].min() > 1e3
    c = ~m & good
    tol = 2e-5 * np.ptp(y_r[:, c]) + 4 * np.spacing(np.float32(
        np.abs(y_r[:, c]).max()))
    np.testing.assert_allclose(y[:, c], y_r[:, c], rtol=0, atol=tol)


def test_obsmake_h08_matches_reference():
    g_r, g = grids()
    obs = mixed_obs(g)
    cfg, cfg_r = h08_cfgs()
    cfg.obs_error.h08 = cfg_r.obs_error.h08 = tuple(
        0.5 + 0.1 * np.arange(10))
    f = history(K=1)
    nat = {k: v[0] for k, v in f.items()}
    z = g.calc_z(torch.zeros((NY, NX)))
    got = obsmake({k: torch.from_numpy(v) for k, v in nat.items()}, obs, g,
                  cfg, z, np.random.default_rng(4))
    want = ref_obsmake({k: jnp.asarray(v) for k, v in nat.items()},
                       to_ref_obs(obs), g_r, cfg_r,
                       g_r.calc_z(jnp.zeros((NY, NX))),
                       np.random.default_rng(4))
    for k in ("elem", "lon", "lat", "lev", "err", "typ"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    m = got.elem == ID_H08IR
    # whole profiles kept (the gate does not drop channels), the profile
    # outside the domain dropped
    assert m.sum() % h08.NCHAN == 0
    assert m.sum() == (obs.elem == ID_H08IR).sum() - h08.NCHAN
    assert (got.dat[m] > 150).all()
    np.testing.assert_allclose(got.dat, want.dat, rtol=0, atol=BT_TOL)
    np.testing.assert_array_equal(
        default_err(obs.elem, cfg, obs.lev)[obs.elem == ID_H08IR],
        np.asarray(cfg.obs_error.h08)[np.clip(
            obs.lev[obs.elem == ID_H08IR].astype(int) - 1, 0, 9)])


# --- the verbs on a mixed conventional + H08 set ----------------------------

H08_TOML = """
[h08]
h08_ch_use = [0, 0, 1, 0, 0, 0, 1, 0, 0, 0]
h08_cldsky_thrs = 2.0

[obs_error]
t = 0.2
u = 0.2
v = 0.2
h08 = [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]
"""


@pytest.fixture(scope="module")
def h08_exp(tmp_path_factory):
    """tests/test_cli.py's experiment with an [h08] section, the H08 band
    errors 0.5 K, a conventional template and an H08 template (a profile
    every 3 cells), run through obsmake, obsope and letkf (integrated and
    --obsda) by both packages."""
    from test_cli import CONFIG
    from test_torch_cli import both
    from test_torch_fcst import _members
    from scale_letkf_torch.da.obsmake import make_obs_network
    from scale_letkf_torch.grid import Projection
    from scale_letkf_torch.io import checkpoint
    from scale_letkf_torch.model.dycore import DycoreState
    from scale_letkf_torch.obs import io as obsio
    tmp = tmp_path_factory.mktemp("h08")
    (tmp / "exp.toml").write_text(
        CONFIG.replace("[obs_error]\nt = 0.2\nu = 0.2\nv = 0.2\n", "")
        + H08_TOML)
    members = _members(5, 7)
    checkpoint.save_ensemble(tmp / "init", DycoreState(*(
        np.stack(f) for f in zip(*members[1:]))), basename="anal.@@@@")
    checkpoint.save_member(tmp / "nature.npz", DycoreState(*members[0]))
    grid = Grid.uniform(nx=12, ny=12, nz=8, dx=2000.0, dy=2000.0, dz=500.0,
                        proj=Projection())
    obsio.write_obs(str(tmp / "conv.dat"), make_obs_network(
        grid, np.random.default_rng(0), n_profiles=10,
        levels_hpa=(900.0, 800.0)))
    obsio.write_obs_h08(str(tmp / "tmpl.h08"), synthetic_h08_network(
        Config(), grid, spacing=3, margin=1))
    cfg = ["--config", str(tmp / "exp.toml")]
    for t, out in (("conv.dat", "obs.dat"), ("tmpl.h08", "obs.h08")):
        both(tmp, "obsmake", *cfg, "--nature", str(tmp / "nature.npz"),
             "--obs-template", str(tmp / t), "--seed", "5",
             out_flag="--out", out=out)
    obs = [str(tmp / "ref_obs.dat"), str(tmp / "ref_obs.h08")]
    both(tmp, "obsope", *cfg, "--gues", str(tmp / "init"), "--obs", *obs,
         out_flag="--out", out="obsda.@@@@")
    both(tmp, "letkf", *cfg, "--gues", str(tmp / "init"), "--obs", *obs,
         out_flag="--anal", out="anal")
    both(tmp, "letkf", *cfg, "--gues", str(tmp / "init"), "--obs", *obs,
         "--obsda", str(tmp / "ref_obsda.@@@@"), out_flag="--anal",
         out="anal_obsda")
    return tmp


def test_obsmake_verbs_write_h08(h08_exp):
    from scale_letkf_tpu.obs import io as ref_io
    from scale_letkf_torch.obs import io as obsio
    want = ref_io.read_obs_h08(str(h08_exp / "ref_obs.h08"))
    got = obsio.read_obs_h08(str(h08_exp / "port_obs.h08"))
    assert got.nobs == want.nobs == 16 * h08.NCHAN
    for k in ("elem", "lon", "lat", "lev", "typ"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    np.testing.assert_allclose(got.dat, want.dat, rtol=0, atol=BT_TOL)


def test_obsope_verbs_write_h08_records(h08_exp):
    from scale_letkf_tpu.obs import io as ref_io
    from scale_letkf_torch.obs import io as obsio
    n = (ref_io.read_obs(str(h08_exp / "ref_obs.dat")).nobs
         + ref_io.read_obs_h08(str(h08_exp / "ref_obs.h08")).nobs)
    for m in range(4):
        want = ref_io.read_obs_da(str(h08_exp / f"ref_obsda.{m + 1:04d}"), n)
        got = obsio.read_obs_da(str(h08_exp / f"port_obsda.{m + 1:04d}"), n)
        assert len(got) == len(want) == 6
        np.testing.assert_array_equal(got[3], want[3])
        h = got[4] > 0                       # the H08 records
        assert h.sum() == 16 * h08.NCHAN and (got[3][h] == 0).sum() >= 32
        np.testing.assert_allclose(got[2][h], want[2][h], rtol=0,
                                   atol=BT_TOL)
        np.testing.assert_allclose(got[5], want[5], rtol=0, atol=BT_TOL)
        dp = 3e3    # an argmax flip in a member: a level spacing over K
        np.testing.assert_allclose(got[4], want[4], rtol=0, atol=dp / 4)


@pytest.mark.parametrize("anal", ["anal", "anal_obsda"])
def test_letkf_verbs_agree_with_h08(h08_exp, anal):
    from test_torch_cli import _assert_anal_dirs_agree
    _assert_anal_dirs_agree(h08_exp, f"ref_{anal}", f"port_{anal}")
    if anal == "anal":
        # the O−A monitor drops the cloudy-sky sign of the analysis's BT
        dep_r = np.load(h08_exp / "ref_anal" / "obsdep.npz")
        dep = np.load(h08_exp / "port_anal" / "obsdep.npz")
        np.testing.assert_array_equal(dep["qc"], dep_r["qc"])
        m = (dep_r["qc"] == 0) & (dep_r["elem"] == ID_H08IR)
        assert m.sum() > 0
        np.testing.assert_allclose(dep["oma"][m], dep_r["oma"][m], rtol=0,
                                   atol=BT_TOL)
        assert np.abs(dep["oma"][m]).max() < 50.0
