"""The port's ensemble observation operator and what surrounds it against
the reference package, on the CPU: state_to_history, compute_hx_single,
obsope_ensemble (one slot) and obsope_slots (a 4-D window), obsmake,
obssim, the departure monitor, the obs file formats (each package reads
what the other writes) and load_history.

Inputs as in tests/test_torch_obs_operators.py: seeded numpy analysis
ensembles (K = 3) with hydrometeors on a 16×12×8 stretched LC domain,
float32 fields, the reference with x64 on. Tolerance: 2e-5 of each
output's range over the obs plus 4 float32 ulp of its largest magnitude;
QC exactly equal. PS gets 12 ulp: prsadj raises its float32 base to the
power g/(γ·Rd) = 6.8, which multiplies one rounding by about 7. The obs
mix conventional reports (U, V, T, Q, RH, PS, sondes inside and outside
the domain and levels) with radar reflectivity and radial velocity 2-40 km
from a site at the domain's center.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_letkf_tpu import config as ref_config
from scale_letkf_tpu import state as ref_state
from scale_letkf_tpu.da import monitor as ref_monitor
from scale_letkf_tpu.da import obsmake as ref_obsmake
from scale_letkf_tpu.da import obsope as ref_obsope
from scale_letkf_tpu.da import obssim as ref_obssim
from scale_letkf_tpu.io import checkpoint as ref_ckpt
from scale_letkf_tpu.obs import io as ref_io
from scale_letkf_tpu.obs import types as ref_types
from scale_letkf_tpu.obs.h08 import NCHAN as REF_NCHAN
from scale_letkf_torch import config
from scale_letkf_torch.da import monitor, obsmake, obsope, obssim
from scale_letkf_torch.io import checkpoint
from scale_letkf_torch.io.convert import (
    ensemble_to_torch, fields_to_torch, obsope_result_to_torch,
)
from scale_letkf_torch.obs import io as obsio
from scale_letkf_torch.obs import types
from scale_letkf_torch.obs.types import (
    ID_H08IR, ID_PS, ID_Q, ID_RADAR_REF, ID_RADAR_VR, ID_RH, ID_T, ID_U,
    ID_V, TYP_PHARAD,
)
from scale_letkf_torch.state import state_to_history
from test_torch_obs_operators import (
    K, NX, NY, RADAR, analysis_ensemble, assert_close, grids, history,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def configs(**obsope_kw):
    """(reference Config, port Config) with the same settings: echoes below
    15 dBZ are low (QC_REF_LOW)."""
    pair = (ref_config.Config(), config.Config())
    for c in pair:
        c.radar.min_radar_ref_dbz = 15.0
        for k, v in obsope_kw.items():
            setattr(c.obsope, k, v)
    return pair


def obs_arrays(grid, seed, n_conv=140, n_radar=120, dif_span=0.0):
    """Conventional reports (every element; ~10% outside the domain, some
    above the model top) then radar obs, as a dict of Observations
    arrays with the radar site in meta."""
    rng = np.random.default_rng(seed)
    ri = rng.uniform(-1.0, NX + 0.5, n_conv)
    rj = rng.uniform(-1.0, NY + 0.5, n_conv)
    lon_c, lat_c = grid.ij_to_lonlat(ri, rj)
    elem_c = rng.choice([ID_U, ID_V, ID_T, ID_Q, ID_RH, ID_PS],
                        n_conv).astype(np.int32)
    lev_c = np.where(elem_c == ID_PS, rng.uniform(0.0, 150.0, n_conv),
                     rng.uniform(200e2, 1000e2, n_conv))
    dist = rng.uniform(2e3, 4e4, n_radar)
    ang = rng.uniform(0.0, 2 * np.pi, n_radar)
    lon_r = RADAR[0] + dist * np.sin(ang) / (111e3 * np.cos(np.radians(35.)))
    lat_r = RADAR[1] + dist * np.cos(ang) / 111e3
    elem_r = np.where(np.arange(n_radar) % 2 == 0, ID_RADAR_REF,
                      ID_RADAR_VR)
    n = n_conv + n_radar
    return dict(
        elem=np.concatenate([elem_c, elem_r]).astype(np.int32),
        lon=np.concatenate([lon_c, lon_r]),
        lat=np.concatenate([lat_c, lat_r]),
        lev=np.concatenate([lev_c, rng.uniform(300.0, 9e3, n_radar)]),
        dat=rng.standard_normal(n), err=np.ones(n),
        typ=np.concatenate([np.zeros(n_conv),
                            np.full(n_radar, TYP_PHARAD)]).astype(np.int32),
        dif=rng.uniform(-dif_span, dif_span, n),
        meta=np.asarray(RADAR, np.float64))


def both_obs(arrays):
    return (ref_types.Observations(**arrays), types.Observations(**arrays))


def z_full(grid):
    return grid.calc_z(torch.zeros((NY, NX)))


def ref_fields(anal, grid_r):
    return {k: jnp.asarray(v) for k, v in history(anal, grid_r).items()}


@pytest.mark.parametrize("flat", [True, False])
def test_state_to_history_matches_reference(flat):
    g_r, g = grids()
    anal = analysis_ensemble(0)
    topo = (np.zeros((NY, NX), np.float32) if flat else
            np.random.default_rng(0).uniform(0, 400, (NY, NX)).astype(
                np.float32))
    z_r = g_r.calc_z(jnp.asarray(topo))
    want = [ref_state.state_to_history(jnp.asarray(a), z_r,
                                       None if flat else jnp.asarray(topo))
            for a in anal]
    got = state_to_history(torch.from_numpy(anal),
                           g.calc_z(torch.from_numpy(topo)),
                           None if flat else torch.from_numpy(topo))
    assert set(got) == set(want[0])
    for k in got:
        assert got[k].shape == (K,) + want[0][k].shape, k
        assert_close(got[k], np.stack([np.asarray(w[k]) for w in want]), k)
    # only rh is a new full field: hgt and topo are expanded views
    assert got["hgt"].stride()[0] == 0 and got["topo"].stride()[0] == 0
    # with a slab skin temperature (the physics suite's), the screen
    # diagnostics of the Louis surface layer, per member: skin 1.5-6 K
    # above or below the lowest level's air
    rng = np.random.default_rng(5)
    tsfc = (anal[:, 3, 0] + rng.uniform(1.5, 6.0, (K, NY, NX))
            * rng.choice([-1.0, 1.0], (K, NY, NX))).astype(np.float32)
    want = [ref_state.state_to_history(
        jnp.asarray(a), z_r, None if flat else jnp.asarray(topo),
        tsfc=jnp.asarray(t)) for a, t in zip(anal, tsfc)]
    got = state_to_history(torch.from_numpy(anal),
                           g.calc_z(torch.from_numpy(topo)),
                           None if flat else torch.from_numpy(topo),
                           tsfc=torch.from_numpy(tsfc))
    for k in ("t2m", "q2m", "u10m", "v10m", "ps"):
        assert_close(got[k], np.stack([np.asarray(w[k]) for w in want]), k)
    neutral = state_to_history(torch.from_numpy(anal), z_full(g))
    assert not torch.equal(got["t2m"], neutral["t2m"])


def test_compute_hx_single_matches_reference():
    """One member (no member axis) and the ensemble (K leading) against the
    reference's per-member H(x), conventional and radar obs mixed."""
    g_r, g = grids()
    cfg_r, cfg = configs()
    anal = analysis_ensemble(1)
    obs_r, obs = both_obs(obs_arrays(g, 1))
    fr = ref_fields(anal, g_r)
    z_r = g_r.calc_z(np.zeros((NY, NX), np.float32))
    y_r, qc_r = jax.vmap(lambda f: ref_obsope.compute_hx_single(
        f, obs_r, g_r, cfg_r, z_r))(fr)
    fields = fields_to_torch(history(anal, g_r), CPU)
    y, qc = obsope.compute_hx_single(fields, obs, g, cfg, z_full(g))
    np.testing.assert_array_equal(qc.numpy(), np.asarray(qc_r))
    _assert_hx_close(y, y_r, qc_r, obs.elem)
    y1, qc1 = obsope.compute_hx_single({k: v[2] for k, v in fields.items()},
                                       obs, g, cfg, z_full(g))
    np.testing.assert_array_equal(qc1.numpy(), np.asarray(qc_r)[2])
    torch.testing.assert_close(y1, y[2], rtol=0, atol=0, equal_nan=True)
    # every QC kind of the mix shows up: good, PS terrain, low echo, out of
    # the levels, outside the domain
    assert {0, 10, 11, 20, 98} <= set(np.unique(qc.numpy()).tolist())


def _assert_hx_close(y, y_r, qc_r, elem):
    y_r, qc_r = np.asarray(y_r), np.asarray(qc_r)
    good = qc_r == 0
    y = y.numpy() if isinstance(y, torch.Tensor) else y
    for e in np.unique(elem):
        m = good & (elem == e)[None]
        if m.any():
            assert_close(y[m], y_r[m], f"element {e}",
                         ulps=12 if e == ID_PS else 4)


def test_obsope_ensemble_matches_reference():
    g_r, g = grids()
    cfg_r, cfg = configs()
    anal = analysis_ensemble(2)
    obs_r, obs = both_obs(obs_arrays(g, 2))
    z_r = g_r.calc_z(np.zeros((NY, NX), np.float32))
    hx_r = ref_obsope.obsope_ensemble(ref_fields(anal, g_r), obs_r, g_r,
                                      cfg_r, z_r)
    fields = state_to_history(torch.from_numpy(anal), z_full(g))
    hx = obsope.obsope_ensemble(fields, obs, g, cfg, z_full(g))
    assert hx.ensval.shape == (K, obs.nobs) and hx.qc.dtype == np.int32
    np.testing.assert_array_equal(hx.qc, hx_r.qc)
    _assert_hx_close(hx.ensval, hx_r.ensval, np.broadcast_to(hx_r.qc,
                                                             (K, obs.nobs)),
                     obs.elem)
    # the reference's result carried over to the port's type
    conv = obsope_result_to_torch(hx_r, CPU)
    assert conv.ensval.dtype == torch.float32
    np.testing.assert_array_equal(conv.qc, hx_r.qc)


def test_obsope_slots_matches_reference():
    """A 3-slot window (600 s slots, base 2): each obs against its own
    slot's snapshot, obs outside the window QC_TIME; the history stack on
    the host as numpy, as load_history gives it."""
    g_r, g = grids()
    kw = dict(slot_start=1, slot_end=3, slot_base=2, slot_tinterval=600.0)
    cfg_r, cfg = configs(**kw)
    S = 3
    hist = np.stack([analysis_ensemble(10 + s) for s in range(S)], axis=1)
    obs_r, obs = both_obs(obs_arrays(g, 3, n_conv=70, n_radar=50,
                                     dif_span=1200.0))
    slots = obsope.assign_slots(obs.dif, cfg)
    np.testing.assert_array_equal(slots, ref_obsope.assign_slots(obs.dif,
                                                                 cfg_r))
    assert set(np.unique(slots).tolist()) == {0, 1, 2, 3, 4}
    z_r = g_r.calc_z(np.zeros((NY, NX), np.float32))
    z = np.array(z_r)
    fr = jax.vmap(lambda h: ref_state.state_to_history(h, z_r))(
        jnp.asarray(hist))
    hx_r = ref_obsope.obsope_ensemble(fr, obs_r, g_r, cfg_r, z_r, slots=slots)
    hx = obsope.obsope_slots(hist, obs, g, cfg, torch.from_numpy(z), None,
                             slots)
    np.testing.assert_array_equal(hx.qc, hx_r.qc)
    assert (hx.qc[(slots < 1) | (slots > 3)] == 97).all()
    _assert_hx_close(hx.ensval, hx_r.ensval,
                     np.broadcast_to(hx_r.qc, (K, obs.nobs)), obs.elem)
    # the same from a torch history stack
    hx_t = obsope.obsope_slots(torch.from_numpy(hist), obs, g, cfg,
                               torch.from_numpy(z), None, slots)
    torch.testing.assert_close(hx_t.ensval, hx.ensval, rtol=0, atol=0)


def test_h08_obs_raise():
    """H08 obs in a conventional set, which raised NotImplementedError
    until obs/h08.py was ported, now go through the radiance operator as in
    the reference: QC equal, the BT and the clear-sky BT to 2e-3 K (the
    float32 band model; tests/test_torch_h08.py), the sensitive pressure to
    a level spacing over K (an argmax flip in one member), the other obs
    untouched."""
    g_r, g = grids()
    cfg_r, cfg = configs()
    arrays = obs_arrays(g, 4, n_radar=0)
    arrays["elem"][:3] = ID_H08IR
    arrays["lev"][:3] = (9.0, 13.0, 16.0)        # AHI bands
    anal = analysis_ensemble(4)
    obs_r, obs = both_obs(arrays)
    z_r = g_r.calc_z(np.zeros((NY, NX), np.float32))
    hx_r = ref_obsope.obsope_ensemble(ref_fields(anal, g_r), obs_r, g_r,
                                      cfg_r, z_r)
    fields = state_to_history(torch.from_numpy(anal), z_full(g))
    hx = obsope.obsope_ensemble(fields, obs, g, cfg, z_full(g))
    np.testing.assert_array_equal(hx.qc, hx_r.qc)
    h = np.arange(obs.nobs) < 3
    y, y_r = hx.ensval.numpy(), np.asarray(hx_r.ensval)
    assert np.isfinite(y[:, h]).all() and (np.abs(y[:, h]) > 150).all()
    np.testing.assert_allclose(y[:, h], y_r[:, h], rtol=0, atol=2e-3)
    np.testing.assert_allclose(hx.val2, hx_r.val2, rtol=0, atol=2e-3)
    dp = np.abs(np.diff(fields["p"].numpy(), axis=1)).max()
    np.testing.assert_allclose(hx.lev, hx_r.lev, rtol=0, atol=dp / K)
    assert (hx.lev[~h] == 0).all() and (hx.lev[h] > 0).all()
    _assert_hx_close(hx.ensval[:, ~h], y_r[:, ~h],
                     np.broadcast_to(hx_r.qc, (K, obs.nobs))[:, ~h],
                     obs.elem[~h])


def test_obsmake_same_seed_same_obs():
    """Nature-run H(x) plus noise from the same seed: the same obs kept by
    QC, values to the tolerance, errors from the same table."""
    g_r, g = grids()
    cfg_r, cfg = configs()
    nature = analysis_ensemble(5, k=1)[0]
    net = obsmake.make_obs_network(g, np.random.default_rng(0), n_profiles=12,
                                   levels_hpa=(900.0, 700.0, 500.0, 150.0))
    net_r = ref_obsmake.make_obs_network(g_r, np.random.default_rng(0),
                                         n_profiles=12,
                                         levels_hpa=(900.0, 700.0, 500.0,
                                                     150.0))
    for f in dataclasses.fields(net):
        np.testing.assert_array_equal(getattr(net, f.name),
                                      getattr(net_r, f.name), err_msg=f.name)
    arrays = obs_arrays(g, 5)
    tmpl_r, tmpl = both_obs(arrays)
    z_r = g_r.calc_z(np.zeros((NY, NX), np.float32))
    out_r = ref_obsmake.obsmake(
        ref_state.state_to_history(jnp.asarray(nature), z_r), tmpl_r, g_r,
        cfg_r, z_r, np.random.default_rng(7))
    out = obsmake.obsmake(state_to_history(torch.from_numpy(nature),
                                           z_full(g)),
                          tmpl, g, cfg, z_full(g), np.random.default_rng(7))
    assert 0 < out.nobs < tmpl.nobs and out.nobs == out_r.nobs
    for name in ("elem", "lon", "lat", "lev", "err", "typ", "dif", "meta"):
        np.testing.assert_array_equal(getattr(out, name),
                                      getattr(out_r, name), err_msg=name)
    for e in np.unique(out.elem):
        m = out.elem == e
        assert_close(out.dat[m], out_r.dat[m], f"element {e}")
    np.testing.assert_array_equal(
        obsmake.default_err(arrays["elem"], cfg),
        ref_obsmake.default_err(arrays["elem"], cfg_r))


def test_obssim_matches_reference(tmp_path):
    g_r, g = grids()
    cfg_r, cfg = configs()
    cfg_r.radar.method_ref_calc = cfg.radar.method_ref_calc = 2
    nature = analysis_ensemble(6, k=1)[0]
    ids = [ID_T, ID_U, ID_PS, ID_RADAR_REF, ID_RADAR_VR, 3074]
    z_r = g_r.calc_z(np.zeros((NY, NX), np.float32))
    want = ref_obssim.obssim(
        ref_state.state_to_history(jnp.asarray(nature), z_r), ids, g_r,
        cfg_r, radar_lonlatz=RADAR)
    got = obssim.obssim(state_to_history(torch.from_numpy(nature), z_full(g)),
                        ids, g, cfg, radar_lonlatz=RADAR)
    for e in ids:
        assert_close(got[e], want[e], f"element {e}")
    assert got[ID_PS].shape == (NY, NX)
    obssim.write_grads(tmp_path / "p.grd", [got[ID_T], got[ID_U]],
                       [got[ID_PS]])
    ref_obssim.write_grads(tmp_path / "r.grd", [want[ID_T], want[ID_U]],
                           [want[ID_PS]])
    a = np.fromfile(tmp_path / "p.grd", np.float32)
    b = np.fromfile(tmp_path / "r.grd", np.float32)
    assert a.shape == b.shape
    with pytest.raises(ValueError, match="radar position"):
        obssim.obssim(state_to_history(torch.from_numpy(nature), z_full(g)),
                      [ID_RADAR_REF], g, cfg)


def test_monitor_matches_reference():
    rng = np.random.default_rng(8)
    n = 400
    elem = rng.choice([ID_U, ID_V, ID_T, 3074, ID_Q, ID_PS, ID_RADAR_REF,
                       4004, ID_RADAR_VR], n).astype(np.int32)
    typ = rng.choice([0, 7, TYP_PHARAD, 30], n).astype(np.int32)
    dep = rng.standard_normal(n)
    qc = np.where(rng.uniform(size=n) < 0.2, 5, 0).astype(np.int32)
    st, st_r = monitor.monit_dep(elem, dep, qc), ref_monitor.monit_dep(
        elem, dep, qc)
    assert st.nobs == st_r.nobs
    np.testing.assert_array_equal(list(st.rmse.values()),
                                  list(st_r.rmse.values()))
    np.testing.assert_array_equal(list(st.bias.values()),
                                  list(st_r.bias.values()))
    assert st.format("O-B") == st_r.format("O-B")
    tb = monitor.monit_dep_bytype(elem, typ, dep, qc)
    tb_r = ref_monitor.monit_dep_bytype(elem, typ, dep, qc)
    assert list(tb.rows) == list(tb_r.rows) == ["ADPUPA", "ADPSFC",
                                                "PHARAD", "TYP30"]
    assert tb.format("O-A") == tb_r.format("O-A")
    none = np.full(n, 5, np.int32)
    assert (monitor.monit_dep(elem, dep, none).format("x")
            == ref_monitor.monit_dep(elem, dep, none).format("x"))
    assert (monitor.monit_dep_bytype(elem, typ, dep, none).format("x")
            == ref_monitor.monit_dep_bytype(elem, typ, dep, none).format("x"))


def _obs_equal(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                      err_msg=f.name)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_obs_files_read_the_same_in_both_packages(tmp_path, writer):
    """Conventional, radar, H08-profile, obsda and obsdep files written by
    one package read identically in both."""
    _, g = grids()
    w_io, mods = ((obsio, (obsio, ref_io)) if writer == "port"
                  else (ref_io, (obsio, ref_io)))
    arrays = obs_arrays(g, 9, n_conv=60, n_radar=0)
    arrays["elem"][:6] = [ID_U, ID_V, ID_T, ID_Q, ID_RH, ID_PS]
    conv = (types.Observations if writer == "port"
            else ref_types.Observations)(**arrays)
    w_io.write_obs(str(tmp_path / "c.dat"), conv)
    a, b = (m.read_obs(str(tmp_path / "c.dat")) for m in mods)
    _obs_equal(a, b)
    np.testing.assert_allclose(a.dat, arrays["dat"], rtol=1e-6, atol=1e-6)

    rad = obs_arrays(g, 9, n_conv=0, n_radar=40)
    robs = (types.Observations if writer == "port"
            else ref_types.Observations)(**rad)
    w_io.write_obs_radar(str(tmp_path / "r.radar"), robs)
    a, b = (m.read_obs_radar(str(tmp_path / "r.radar")) for m in mods)
    _obs_equal(a, b)
    np.testing.assert_allclose(a.meta, RADAR)

    assert obsio.NCHAN == REF_NCHAN
    nprof = 4
    h = obs_arrays(g, 9, n_conv=nprof * obsio.NCHAN, n_radar=0)
    h["elem"][:] = ID_H08IR
    h["typ"][:] = 22
    for k in ("lon", "lat"):
        h[k] = np.repeat(h[k][::obsio.NCHAN], obsio.NCHAN)
    h["dat"] = 200.0 + 50 * np.abs(h["dat"])
    hobs = (types.Observations if writer == "port"
            else ref_types.Observations)(**h)
    w_io.write_obs_h08(str(tmp_path / "h.h08"), hobs)
    cfgs = (config.Config(), ref_config.Config())
    a, b = (m.read_obs_h08(str(tmp_path / "h.h08"), c)
            for m, c in zip(mods, cfgs))
    _obs_equal(a, b)
    assert a.nobs == nprof * obsio.NCHAN

    n = 50
    rng = np.random.default_rng(9)
    val = rng.standard_normal(n).astype(np.float32)
    qc = rng.integers(0, 3, n).astype(np.int32)
    w_io.write_obs_da(str(tmp_path / "da"), np.zeros(n, np.int32),
                      np.arange(n, dtype=np.int32), val, qc)
    a, b = (m.read_obs_da(str(tmp_path / "da"), n) for m in mods)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[2], val)

    cols = (conv.elem, conv.lon, conv.lat, conv.lev, conv.dat, conv.err,
            conv.typ, conv.dif, np.zeros(conv.nobs, np.int32),
            rng.standard_normal(conv.nobs), rng.standard_normal(conv.nobs))
    w_io.write_obs_dep(str(tmp_path / "dep"), *cols)
    a, b = (m.read_obs_dep(str(tmp_path / "dep")) for m in mods)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_obsdep_record_round_trip(tmp_path):
    rng = np.random.default_rng(10)
    n = 30
    rec = monitor.ObsDepRecord(
        elem=np.full(n, ID_T, np.int32), typ=np.zeros(n, np.int32),
        lon=rng.uniform(130, 140, n), lat=rng.uniform(30, 40, n),
        lev=np.full(n, 85000.0), dat=rng.uniform(270, 290, n),
        err=np.ones(n), qc=np.zeros(n, np.int32),
        omb=rng.standard_normal(n), oma=rng.standard_normal(n))
    rec.save(str(tmp_path / "d.npz"))
    back = monitor.ObsDepRecord.load(str(tmp_path / "d.npz"))
    back_r = ref_monitor.ObsDepRecord.load(str(tmp_path / "d.npz"))
    for f in dataclasses.fields(rec):
        np.testing.assert_array_equal(getattr(back, f.name),
                                      getattr(rec, f.name))
        np.testing.assert_array_equal(getattr(back_r, f.name),
                                      getattr(rec, f.name))
    rec.save_binary(str(tmp_path / "d.dat"))
    cols = ref_io.read_obs_dep(str(tmp_path / "d.dat"))
    np.testing.assert_allclose(cols[9], rec.omb, rtol=1e-6)
    np.testing.assert_allclose(cols[3], rec.lev, rtol=1e-6)


def test_load_history_reads_reference_history(tmp_path):
    hist = np.stack([analysis_ensemble(20 + s, k=2) for s in range(2)],
                    axis=1)
    ref_ckpt.save_history(tmp_path / "r", jnp.asarray(hist), slot_ids=[3, 4])
    checkpoint.save_history(tmp_path / "p", ensemble_to_torch(hist, CPU),
                            slot_ids=[3, 4])
    for d in ("r", "p"):
        np.testing.assert_array_equal(checkpoint.load_history(tmp_path / d),
                                      hist)
        np.testing.assert_array_equal(ref_ckpt.load_history(tmp_path / d),
                                      hist)
    assert checkpoint.load_history(tmp_path) is None
