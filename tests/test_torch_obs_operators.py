"""The port's observation operators (scale_letkf_torch/obs/operators.py) and
the grid geometry they use (Projection.rotcoef, Grid.lonlat_to_ij,
Grid.calc_z_faces) against the reference package, on the CPU.

Inputs are seeded numpy: analysis ensembles (K = 3) on a 16×12×8
stretched Lambert-conformal domain (dz 1 km × 1.1ᵏ, ztop ≈ 11 km), their
history fields from the reference's state_to_history, and obs points
inside and outside the domain. Fields are float32 on both sides; the
reference runs with x64 on (tests/conftest.py), so its obs coordinates,
interpolation weights and everything downstream of them are float64,
while the port casts the float64 host geometry to float32. Tolerance: 2e-5
of each output's range over the obs plus 4 float32 ulp of its largest
magnitude (an interpolated 300-K temperature or 1e5-Pa pressure rounds in
float32 at the fifth digit); QC exactly equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_letkf_tpu import grid as ref_grid
from scale_letkf_tpu import state as ref_state
from scale_letkf_tpu.obs import operators as ref_op
from scale_letkf_torch import grid as port_grid
from scale_letkf_torch.io.convert import fields_to_torch
from scale_letkf_torch.obs import operators as op
from scale_letkf_torch.obs.types import (
    ID_PS, ID_Q, ID_RADAR_REF, ID_RADAR_VR, ID_RH, ID_T, ID_TV, ID_U, ID_V,
)
from scale_letkf_torch.state import IA_Q0, NQ
from scale_letkf_torch.synthetic import smooth_noise, synthetic_gues

torch.set_num_threads(1)

K, NZ, NY, NX = 3, 8, 12, 16
DX = 18.0e3
RADAR = (135.0, 35.0, 0.0)         # site at the domain's center, sea level


def grids(kind="LC"):
    """(reference grid, port grid), both stretched."""
    pair = []
    for mod in (ref_grid, port_grid):
        proj = mod.Projection(kind=kind, basepoint_lon=135.0,
                              basepoint_lat=35.0)
        pair.append(mod.Grid.stretched(NX, NY, NZ, DX, DX, 1000.0, 1.1,
                                       proj=proj))
    return pair


def analysis_ensemble(seed, k=K, hydrometeors=True):
    """(k, NV3D, NZ, NY, NX) float32: synthetic_gues around a lapse-rate
    column, and with hydrometeors half zero, half up to ~4 g/kg."""
    rng = np.random.default_rng(seed)
    g = grids()[1]
    anal = synthetic_gues(rng, k, NZ, NY, NX, g.cz)
    if hydrometeors:
        for v in range(IA_Q0 + 1, IA_Q0 + NQ):
            anal[:, v] = np.maximum(smooth_noise(rng, (k, NZ, NY, NX)), 0.0) \
                * 2e-3
    else:
        anal[:, IA_Q0 + 1:] = 0.0
    return anal


def history(anal, grid_r):
    """The reference's history fields of each member, stacked: a dict of
    numpy arrays with the member axis first."""
    z = grid_r.calc_z(np.zeros((NY, NX), np.float32))
    per = [ref_state.state_to_history(jnp.asarray(a), z) for a in anal]
    return {k: np.stack([np.asarray(p[k]) for p in per]) for k in per[0]}


def assert_close(got, want, name="", rel=2e-5, ulps=4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=name)
    w = want[finite]
    tol = rel * np.ptp(w) + ulps * np.spacing(np.float32(np.abs(w).max()))
    err = np.abs(got[finite] - w).max()
    assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def obs_points(grid, rng, n):
    """n obs positions (lon, lat), ri, rj ∈ [-1, n+0.5]: some outside."""
    ri = rng.uniform(-1.0, NX + 0.5, n)
    rj = rng.uniform(-1.0, NY + 0.5, n)
    lon, lat = grid.ij_to_lonlat(ri, rj)
    return np.asarray(lon), np.asarray(lat)


def geometry(grid, lon, lat):
    """The port's per-obs geometry tensors: ri, rj (float32) and the wind
    rotation, from the float64 host computation."""
    ri, rj = grid.lonlat_to_ij(lon, lat)
    rot = tuple(torch.as_tensor(a, dtype=torch.float32)
                for a in grid.proj.rotcoef(lon, lat))
    return (torch.as_tensor(ri, dtype=torch.float32),
            torch.as_tensor(rj, dtype=torch.float32), rot)


# ---------------------------------------------------------------------------
# grid geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["LC", "PS", "MER", "EQ"])
def test_rotcoef_and_lonlat_to_ij_match_reference(kind):
    g_r, g = grids(kind)
    rng = np.random.default_rng(0)
    lon, lat = obs_points(g, rng, 200)
    for a, b in zip(g.proj.rotcoef(lon, lat), g_r.proj.rotcoef(lon, lat)):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-14)
    for a, b in zip(g.lonlat_to_ij(lon, lat), g_r.lonlat_to_ij(lon, lat)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-13, atol=1e-9)
    # back and forth through the projection
    ri, rj = g.lonlat_to_ij(*g.ij_to_lonlat(np.arange(5.0), np.arange(5.0)))
    np.testing.assert_allclose(ri, np.arange(5.0), atol=1e-8)
    np.testing.assert_allclose(rj, np.arange(5.0), atol=1e-8)


def test_calc_z_faces_matches_reference():
    g_r, g = grids()
    topo = np.random.default_rng(1).uniform(0, 900, (NY, NX)).astype(
        np.float32)
    zf = g.calc_z_faces(torch.from_numpy(topo))
    zf_r = np.asarray(g_r.calc_z_faces(jnp.asarray(topo)))
    assert zf.shape == (NZ + 1, NY, NX) and zf.dtype == torch.float32
    np.testing.assert_allclose(zf.numpy(), zf_r, rtol=1e-6)
    np.testing.assert_allclose(zf[0].numpy(), topo, rtol=1e-6)
    np.testing.assert_allclose(zf[-1].numpy(), g.ztop, rtol=1e-6)
    zc = g.calc_z(torch.from_numpy(topo))
    assert bool((zc > zf[:-1]).all() and (zc < zf[1:]).all())


# ---------------------------------------------------------------------------
# interpolation and vertical coordinates
# ---------------------------------------------------------------------------

def test_interpolators_match_reference():
    g_r, g = grids()
    rng = np.random.default_rng(2)
    f3 = rng.standard_normal((K, NZ, NY, NX)).astype(np.float32)
    f2 = f3[:, 0]
    lon, lat = obs_points(g, rng, 100)
    ri_r, rj_r = g_r.lonlat_to_ij(lon, lat)
    ri, rj, _ = geometry(g, lon, lat)
    rk_np = rng.uniform(-0.5, NZ - 0.5, (K, 100))
    rk = torch.as_tensor(rk_np, dtype=torch.float32)
    t3, t2 = torch.from_numpy(f3), torch.from_numpy(f2)
    want3 = jax.vmap(lambda f, r: ref_op.itpl_3d(f, r, ri_r, rj_r))(
        jnp.asarray(f3), jnp.asarray(rk_np))
    want2 = jax.vmap(lambda f: ref_op.itpl_2d(f, ri_r, rj_r))(jnp.asarray(f2))
    wantc = jax.vmap(lambda f: ref_op.itpl_2d_column(f, ri_r, rj_r))(
        jnp.asarray(f3))
    assert_close(op.itpl_3d(t3, rk, ri, rj), want3, "itpl_3d")
    assert_close(op.itpl_2d(t2, ri, rj), want2, "itpl_2d")
    assert_close(op.itpl_2d_column(t3, ri, rj), wantc, "itpl_2d_column")
    # one member without a member axis
    assert_close(op.itpl_3d(t3[1], rk[1], ri, rj), want3[1], "itpl_3d, one")


def _levels(rng, n):
    """Pressure levels [Pa] from above the model top to below the surface,
    and every fifth obs a surface obs (PS, station elevation 0-300 m)."""
    elem = rng.choice([ID_U, ID_V, ID_T, ID_Q], n).astype(np.int32)
    lev = rng.uniform(150e2, 1080e2, n)
    elem[::5] = ID_PS
    lev[::5] = rng.uniform(0.0, 300.0, len(lev[::5]))
    return elem, lev


def test_phys2ijk_and_phys2ijkz_match_reference():
    g_r, g = grids()
    fields = history(analysis_ensemble(3), g_r)
    rng = np.random.default_rng(3)
    lon, lat = obs_points(g, rng, 150)
    elem, lev = _levels(rng, 150)
    ri_r, rj_r = g_r.lonlat_to_ij(lon, lat)
    ri, rj, _ = geometry(g, lon, lat)
    rk_r, qc_r = jax.vmap(lambda p: ref_op.phys2ijk(
        p, jnp.asarray(elem), ri_r, rj_r, jnp.asarray(lev)))(
        jnp.asarray(fields["p"]))
    rk, qc = op.phys2ijk(torch.from_numpy(fields["p"]),
                         torch.from_numpy(elem), ri, rj,
                         torch.as_tensor(lev, dtype=torch.float32))
    assert_close(rk, rk_r, "rk (log p)")
    np.testing.assert_array_equal(qc.numpy(), np.asarray(qc_r))
    assert {20, 21, 98} <= set(np.unique(qc.numpy()).tolist())

    z = np.array(g_r.calc_z(np.zeros((NY, NX), np.float32)))
    zlev = rng.uniform(-50.0, 12e3, 150)          # below the first level,
    rkz_r, qcz_r = ref_op.phys2ijkz(jnp.asarray(z), ri_r, rj_r,   # above top
                                    jnp.asarray(zlev))
    rkz, qcz = op.phys2ijkz(torch.from_numpy(z), ri, rj,
                            torch.as_tensor(zlev, dtype=torch.float32))
    assert_close(rkz, rkz_r, "rk (z)")
    np.testing.assert_array_equal(qcz.numpy(), np.asarray(qcz_r))
    assert {0, 20, 21, 98} <= set(np.unique(qcz.numpy()).tolist())


def test_prsadj_matches_reference():
    rng = np.random.default_rng(4)
    p = rng.uniform(9.0e4, 1.02e5, 64).astype(np.float32)
    dz = rng.uniform(-200.0, 200.0, 64).astype(np.float32)
    dz[::4] = 0.0
    t = rng.uniform(260.0, 305.0, 64).astype(np.float32)
    q = rng.uniform(0.0, 0.02, 64).astype(np.float32)
    want = ref_op.prsadj(*(jnp.asarray(a) for a in (p, dz, t, q)))
    got = op.prsadj(*(torch.from_numpy(a) for a in (p, dz, t, q)))
    assert_close(got, want, "prsadj")
    np.testing.assert_array_equal(got.numpy()[::4], p[::4])


# ---------------------------------------------------------------------------
# forward operators
# ---------------------------------------------------------------------------

def test_trans_xtoy_conv_matches_reference():
    """U, V (rotated from grid-relative on the LC grid), T, Tv, Q, RH, PS
    and an unknown element, against each member's fields."""
    g_r, g = grids()
    fields = history(analysis_ensemble(5), g_r)
    rng = np.random.default_rng(5)
    n = 210
    lon, lat = obs_points(g, rng, n)
    elem = np.tile(np.asarray([ID_U, ID_V, ID_T, ID_TV, ID_Q, ID_RH, ID_PS],
                              np.int32), n // 7)
    elem[-1] = 1234                                      # QC_OTYPE
    rk_np = rng.uniform(0.0, NZ - 1.0, (K, n))
    rk_np[:, elem == ID_PS] = rng.uniform(0.0, 250.0, (elem == ID_PS).sum())
    ri_r, rj_r = g_r.lonlat_to_ij(lon, lat)
    y_r, qc_r = jax.vmap(lambda f, rk: ref_op.trans_xtoy_conv(
        jnp.asarray(elem), ri_r, rj_r, rk, lon, lat, f, g_r.proj.rotcoef,
        ps_adjust_thres=100.0))(
        {k: jnp.asarray(v) for k, v in fields.items()}, jnp.asarray(rk_np))
    ri, rj, rot = geometry(g, lon, lat)
    y, qc = op.trans_xtoy_conv(torch.from_numpy(elem), ri, rj,
                               torch.as_tensor(rk_np, dtype=torch.float32),
                               rot, fields_to_torch(fields, torch.device("cpu")),
                               ps_adjust_thres=100.0)
    y_r = np.asarray(y_r)
    for e in (ID_U, ID_V, ID_T, ID_TV, ID_Q, ID_RH, ID_PS):
        m = elem == e
        assert_close(y[:, m], y_r[:, m], f"element {e}")
    assert np.isnan(y[:, -1].numpy()).all()
    np.testing.assert_array_equal(qc.numpy(), np.asarray(qc_r))
    assert {0, 10, 90} <= set(np.unique(qc.numpy()).tolist())
    # the rotation is not the identity on this grid
    assert np.abs(np.asarray(g.proj.rotcoef(lon, lat)[1])).max() > 0.01


def _radar_inputs(rng, n):
    """Elementwise calc_ref_vr inputs: hydrometeors a third zero, T on both
    sides of 273.16 K."""
    def q(scale):
        a = rng.uniform(0.0, scale, n)
        a[rng.uniform(size=n) < 0.33] = 0.0
        return a.astype(np.float32)
    return dict(qv=q(0.015), qc_=q(1e-3), qr=q(4e-3), qi=q(1e-3),
                qs=q(3e-3), qg=q(3e-3),
                u=rng.uniform(-20, 20, n).astype(np.float32),
                v=rng.uniform(-20, 20, n).astype(np.float32),
                w=rng.uniform(-3, 3, n).astype(np.float32),
                t=rng.uniform(250.0, 300.0, n).astype(np.float32),
                p=rng.uniform(3.0e4, 1.0e5, n).astype(np.float32),
                az=rng.uniform(0.0, 360.0, n).astype(np.float32),
                elev=rng.uniform(0.0, 30.0, n).astype(np.float32))


@pytest.mark.parametrize("use_tv", [False, True])
@pytest.mark.parametrize("method", [1, 2, 3])
def test_calc_ref_vr_matches_reference(method, use_tv):
    args = _radar_inputs(np.random.default_rng(6 + method), 500)
    kw = dict(method=method, use_terminal_velocity=use_tv)
    ref_r, vr_r = ref_op.calc_ref_vr(
        **{k: jnp.asarray(v) for k, v in args.items()}, **kw)
    ref, vr = op.calc_ref_vr(**{k: torch.from_numpy(v)
                                for k, v in args.items()}, **kw)
    np.testing.assert_allclose(ref.numpy(), np.asarray(ref_r), rtol=2e-5,
                               atol=1e-30)
    assert_close(vr, vr_r, "vr")
    assert float((ref > 0).float().mean()) > 0.3 and float(ref.max()) > 1e3


def test_calc_ref_vr_rejects_unknown_method():
    args = {k: torch.from_numpy(v)
            for k, v in _radar_inputs(np.random.default_rng(0), 4).items()}
    with pytest.raises(ValueError, match="METHOD_REF_CALC"):
        op.calc_ref_vr(**args, method=4)


def test_radar_geometry_matches_reference():
    rng = np.random.default_rng(7)
    lon = 135.0 + rng.uniform(-1.5, 1.5, 300)
    lat = 35.0 + rng.uniform(-1.5, 1.5, 300)
    lev = rng.uniform(0.0, 1.5e4, 300)
    lon[0], lat[0] = RADAR[:2]
    az, el, site = op.radar_geometry(lon, lat, lev, *RADAR)
    az_r, el_r, site_r = ref_op.radar_geometry(
        jnp.asarray(lon), jnp.asarray(lat), jnp.asarray(lev), *RADAR)
    np.testing.assert_allclose(az, np.asarray(az_r), rtol=0, atol=1e-9)
    np.testing.assert_allclose(el, np.asarray(el_r), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(site, np.asarray(site_r))
    assert site[0] and not site[1:].any()


@pytest.mark.parametrize("method", [1, 2, 3])
def test_trans_xtoy_radar_matches_reference(method):
    """Reflectivity [dBZ] and radial velocity of radar obs at 2-40 km from
    the site (and one at the site: QC_OUT_H), beside an obs of another
    element (QC_OTYPE), against each member's fields with hydrometeors."""
    g_r, g = grids()
    fields = history(analysis_ensemble(8), g_r)
    rng = np.random.default_rng(8)
    n = 240
    dist = rng.uniform(2e3, 4e4, n)
    ang = rng.uniform(0.0, 2 * np.pi, n)
    lon = RADAR[0] + dist * np.sin(ang) / (111e3 * np.cos(np.radians(35.0)))
    lat = RADAR[1] + dist * np.cos(ang) / 111e3
    lon[0], lat[0] = RADAR[:2]
    lev = rng.uniform(300.0, 8e3, n)
    elem = np.where(np.arange(n) % 2 == 0, ID_RADAR_REF,
                    ID_RADAR_VR).astype(np.int32)
    elem[1] = ID_T
    z = np.array(g_r.calc_z(np.zeros((NY, NX), np.float32)))
    ri_r, rj_r = g_r.lonlat_to_ij(lon, lat)
    rk_r, _ = ref_op.phys2ijkz(jnp.asarray(z), ri_r, rj_r, jnp.asarray(lev))
    rk_np = np.broadcast_to(np.asarray(rk_r), (K, n))
    kw = dict(method=method, use_terminal_velocity=method == 2,
              min_radar_ref=10.0 ** 0.5, min_radar_ref_dbz=5.0,
              low_ref_shift=-1.0)
    y_r, qc_r = jax.vmap(lambda f, rk: ref_op.trans_xtoy_radar(
        jnp.asarray(elem), ri_r, rj_r, rk, jnp.asarray(lon),
        jnp.asarray(lat), jnp.asarray(lev), RADAR, f, g_r.proj.rotcoef,
        **kw))({k: jnp.asarray(v) for k, v in fields.items()},
               jnp.asarray(rk_np))
    ri, rj, rot = geometry(g, lon, lat)
    az, el, site = op.radar_geometry(lon, lat, lev, *RADAR)
    y, qc = op.trans_xtoy_radar(
        torch.from_numpy(elem), ri, rj,
        torch.as_tensor(rk_np, dtype=torch.float32), rot,
        torch.as_tensor(az, dtype=torch.float32),
        torch.as_tensor(el, dtype=torch.float32), torch.from_numpy(site),
        fields_to_torch(fields, torch.device("cpu")), **kw)
    y_r, qc_r = np.asarray(y_r), np.asarray(qc_r)
    np.testing.assert_array_equal(qc.numpy(), qc_r)
    good = qc_r == 0
    for e in (ID_RADAR_REF, ID_RADAR_VR):
        m = good & (elem == e)[None]
        assert m.sum() > 100
        assert_close(y.numpy()[m], y_r[m], f"element {e}")
    # low echoes sit at MIN_RADAR_REF_DBZ + LOW_REF_SHIFT with QC_REF_LOW
    low = (qc_r == 11) & (elem == ID_RADAR_REF)[None]
    assert low.any()
    np.testing.assert_array_equal(y.numpy()[low], np.float32(4.0))
    assert (qc.numpy()[:, 0] == 98).all() and (qc.numpy()[:, 1] == 90).all()


def test_interpolation_imports_no_sympy():
    """A first H(x) in a fresh process stays cheap: the interpolators'
    shape broadcast does not pull in sympy (torch.broadcast_shapes does,
    seconds of imports)."""
    import subprocess
    import sys
    code = (
        "import sys, torch\n"
        "from scale_letkf_torch.obs import operators as op\n"
        "f = torch.rand(2, 4, 5, 6)\n"
        "r = torch.tensor([1.5, 2.25])\n"
        "y = op.itpl_3d(f, r, r, r) + op.itpl_2d(f[:, 0], r, r)\n"
        "assert y.shape == (2, 2), y.shape\n"
        "print('sympy' in sys.modules)\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=root)
    assert out.stdout.strip() == "False"
