"""The port's offline obs tools (obs/decoders.py, obs/superob.py,
obs/precip.py, numpy and scipy on the host) against the reference's on the
same inputs: every output array exactly equal, and the files either package
writes byte-identical and readable by the other."""

import numpy as np
import pytest

from scale_letkf_tpu.grid import Grid as RefGrid
from scale_letkf_tpu.obs import decoders as ref_dec
from scale_letkf_tpu.obs import precip as ref_precip
from scale_letkf_tpu.obs import superob as ref_sup
from scale_letkf_tpu.obs.types import Observations as RefObservations
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.obs import decoders, precip, superob
from scale_letkf_torch.obs.types import (
    ID_PS, ID_Q, ID_RADAR_REF, ID_RADAR_VR, ID_T, ID_U, TYP_PHARAD,
    Observations,
)
from test_decoders import _rdiag, _write_diag_conv

FIELDS = ("elem", "lon", "lat", "lev", "dat", "err", "typ", "dif")


def assert_same_obs(got, want):
    assert got.nobs == want.nobs
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, k)


def _obs(cls, arrays):
    return cls(**arrays)


def _random_obs(seed=0, n=400):
    """Mixed conventional and radar obs with repeated positions, levels and
    times, so that every superob stage merges some of them."""
    rng = np.random.default_rng(seed)
    grid = Grid.uniform(nx=16, ny=16, nz=10, dx=2e3, dy=2e3, dz=500.0)
    lon2d, lat2d = grid.lonlat
    ci, cj = rng.integers(2, 14, n), rng.integers(2, 14, n)
    elem = rng.choice([ID_U, ID_T, ID_Q, ID_PS, ID_RADAR_REF, ID_RADAR_VR], n)
    return dict(
        elem=elem.astype(np.int32),
        lon=lon2d[cj, ci] + rng.choice([0.0, 0.002], n),
        lat=lat2d[cj, ci],
        lev=rng.choice([1000.0, 1250.0, 2400.0, 5100.0], n)
        + rng.uniform(-50, 50, n).round(),
        dat=rng.standard_normal(n) * 5 + 20,
        err=rng.uniform(1.0, 5.0, n),
        typ=np.where(elem >= ID_RADAR_REF, TYP_PHARAD,
                     rng.choice([0, 2, 7], n)).astype(np.int32),
        dif=rng.choice([-1800.0, -600.0, 0.0, 300.0], n))


@pytest.mark.parametrize("stage", ["removal", "vertical", "temporal",
                                   "radar", "pipeline"])
def test_superob_matches_reference(stage):
    arrays = _random_obs()
    obs, obs_r = _obs(Observations, arrays), _obs(RefObservations, arrays)
    kw = dict(nx=16, ny=16, nz=10, dx=2e3, dy=2e3, dz=500.0)
    grid, grid_r = Grid.uniform(**kw), RefGrid.uniform(**kw)
    if stage == "removal":
        drop = [(2, -1), (-1, ID_Q), (0, ID_T)]
        got = superob.general_removal(obs, drop)
        want = ref_sup.general_removal(obs_r, drop)
    elif stage == "vertical":
        got = superob.superob_vertical(obs, 500.0, min_count=1)
        want = ref_sup.superob_vertical(obs_r, 500.0, min_count=1)
    elif stage == "temporal":
        got = superob.superob_temporal(obs, 900.0, box_z_key=500.0)
        want = ref_sup.superob_temporal(obs_r, 900.0, box_z_key=500.0)
    elif stage == "radar":
        got = superob.superob_radar(obs, grid, 4e3, 1000.0, min_count=2)
        want = ref_sup.superob_radar(obs_r, grid_r, 4e3, 1000.0, min_count=2)
    else:
        kw = dict(drop=[(7, -1)], box_z_vertical=500.0, box_t=900.0,
                  box_xy=4e3, box_z=1000.0, min_count=2)
        got = superob.superob(obs, grid, **kw)
        want = ref_sup.superob(obs_r, grid_r, **kw)
    assert 0 < got.nobs < obs.nobs
    assert_same_obs(got, want)


def test_gsi_diag_conv_matches_reference(tmp_path):
    path = str(tmp_path / "diag")
    blocks = [
        ("  t", _rdiag(3, btype=120, lat=35.0, lon=140.0, elev=10.0,
                       pres=850.0)),
        (" uv", _rdiag(2, btype=220, lat=40.0, lon=135.0, elev=5.0,
                       pres=500.0, qm=4)),
        (" ps", _rdiag(2, btype=181, lat=30.0, lon=130.0, elev=50.0,
                       pres=1000.0, inv_err=0.0)),
        ("  q", _rdiag(2, btype=999, lat=33.0, lon=131.0, elev=5.0,
                       pres=700.0)),
        (" xx", _rdiag(1, btype=120, lat=33.0, lon=131.0, elev=5.0,
                       pres=700.0)),
    ]
    _write_diag_conv(path, blocks)
    obs, omb, qc, idate = decoders.read_gsi_diag_conv(path)
    obs_r, omb_r, qc_r, idate_r = ref_dec.read_gsi_diag_conv(path)
    assert idate == idate_r and obs.nobs == 11
    assert_same_obs(obs, obs_r)
    np.testing.assert_array_equal(omb, omb_r)
    np.testing.assert_array_equal(qc, qc_r)
    assert 0 < qc.sum() < len(qc)


def test_obs2_files_are_interchangeable(tmp_path):
    arrays = _random_obs(1, 50)
    rng = np.random.default_rng(2)
    omb, qc = rng.standard_normal(50), rng.integers(0, 2, 50).astype(float)
    decoders.write_obs2(str(tmp_path / "port.obs2"),
                        _obs(Observations, arrays), omb, qc)
    ref_dec.write_obs2(str(tmp_path / "ref.obs2"),
                       _obs(RefObservations, arrays), omb, qc)
    assert (tmp_path / "port.obs2").read_bytes() == \
        (tmp_path / "ref.obs2").read_bytes()
    got = decoders.read_obs2(str(tmp_path / "ref.obs2"))
    want = ref_dec.read_obs2(str(tmp_path / "port.obs2"))
    assert_same_obs(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    empty = tmp_path / "empty.obs2"
    empty.write_bytes(b"")
    assert decoders.read_obs2(str(empty))[0].nobs == 0
    with pytest.raises(ValueError, match="truncated"):
        list(decoders.iter_fortran_records(
            np.frombuffer(b"\x08\x00\x00\x00abcd", np.uint8)))


def test_decode_prcp_grid_matches_reference():
    rng = np.random.default_rng(3)
    pr = np.where(rng.uniform(size=(8, 10)) < 0.2, -1.0,
                  rng.gamma(0.8, 2.0, (8, 10)))
    lons, lats = np.linspace(130, 140, 10), np.linspace(30, 37, 8)
    got = decoders.decode_prcp_grid(pr, lons, lats, obserr_rel=0.4)
    want = ref_dec.decode_prcp_grid(pr, lons, lats, obserr_rel=0.4)
    assert 0 < got.nobs < pr.size
    assert_same_obs(got, want)


def test_precip_transforms_match_reference():
    rng = np.random.default_rng(4)
    clim = np.where(rng.uniform(size=5000) < 0.4, 0.0,
                    rng.gamma(0.7, 3.0, 5000))
    cdf, ppzero = precip.empirical_cdf(clim)
    cdf_r, ppzero_r = ref_precip.empirical_cdf(clim)
    np.testing.assert_array_equal(cdf, cdf_r)
    assert ppzero == ppzero_r
    pp = np.concatenate([[0.0, 0.03, 1e3], rng.gamma(0.7, 3.0, 60)])
    np.testing.assert_array_equal(precip.pptrans_normal(pp, cdf, ppzero),
                                  ref_precip.pptrans_normal(pp, cdf, ppzero))
    np.testing.assert_array_equal(precip.pptrans_log(pp),
                                  ref_precip.pptrans_log(pp))
    np.testing.assert_array_equal(precip.compact_tail(pp / 10),
                                  ref_precip.compact_tail(pp / 10))
    for ens in (pp[:20], np.zeros(20), np.full(20, 2.0)):
        got = precip.pptrans_normal_mdzero(ens, cdf, ppzero)
        want = ref_precip.pptrans_normal_mdzero(ens, cdf, ppzero)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
