"""PyTorch port of da/letkf_obs.py against the reference package: the same
obs and ensemble H(x) must give identical selection tables and QC, and
departures/perturbations to rtol 1e-6."""

from pathlib import Path

import numpy as np
import pytest
import torch

from scale_letkf_tpu.bench_fullsize import _synthetic_conv_network
from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_tpu import config as ref_config
from scale_letkf_tpu.da import letkf_obs as ref
from scale_letkf_tpu.grid import Grid as RefGrid, Projection as RefProjection
from scale_letkf_tpu.obs.types import Observations, ID_RADAR_REF, TYP_PHARAD
from scale_letkf_torch import config as port_config
from scale_letkf_torch.cli.main import load_config_and_grid
from scale_letkf_torch.da import letkf_obs as port
from scale_letkf_torch.grid import Grid, Projection
from scale_letkf_torch.io.convert import obs_context_to_device
from scale_letkf_torch.obs.types import Observations as PortObservations
from scale_letkf_torch.synthetic import synthetic_conv_network

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "18km_japan.toml")


def _assert_same_context(c, c_ref):
    assert c.nobs == c_ref.nobs
    for name in ("x", "y", "vert", "err", "qc", "elem", "typ", "dat"):
        np.testing.assert_allclose(getattr(c, name), getattr(c_ref, name),
                                   rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(c.dep, c_ref.dep, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(c.hdxb, np.asarray(c_ref.hdxb), rtol=1e-6,
                               atol=1e-12)
    assert c.summary == c_ref.summary
    assert len(c.ctypes) == len(c_ref.ctypes) > 0
    for ct, ct_r in zip(c.ctypes, c_ref.ctypes):
        for name in ("elem", "typ", "hori_scale", "vert_scale", "vert_kind",
                     "max_nobs", "varlocal_group"):
            assert getattr(ct, name) == getattr(ct_r, name), name
        np.testing.assert_array_equal(ct.obs_idx, ct_r.obs_idx)
        b, b_r = ct.buckets, ct_r.buckets
        np.testing.assert_array_equal(b.table, b_r.table)
        assert (b.x0, b.y0, b.spacing_x, b.spacing_y, b.n_dropped, b.nsch) \
            == (b_r.x0, b_r.y0, b_r.spacing_x, b_r.spacing_y, b_r.n_dropped,
                b_r.nsch)


@pytest.mark.parametrize("full_size", [False, True])
def test_conventional_context_matches_reference(full_size):
    """The 18-km config coarsened to 24×20×4 (K = 20), and at its full
    480×360 horizontal size with the ~24k-obs network (K = 50): the
    host-side context is small even there."""
    over = None if full_size else {"nx": 24, "ny": 20, "nz": 4}
    cfg_r, grid_r, _, _ = ref_load(CONFIG, over)
    cfg, grid, _, _ = load_config_and_grid(CONFIG, over)
    K = 50 if full_size else 20
    kw = {} if full_size else dict(n_sonde=30, n_ps=60)
    obs = _synthetic_conv_network(cfg_r, grid_r, np.random.default_rng(0),
                                  **kw)
    obs_p = synthetic_conv_network(cfg, grid, np.random.default_rng(0), **kw)
    for name in ("elem", "lon", "lat", "lev", "dat", "err", "typ"):
        np.testing.assert_array_equal(getattr(obs_p, name),
                                      getattr(obs, name))
    rng = np.random.default_rng(1)
    ensval = (obs.dat[None] + rng.standard_normal((K, obs.nobs))
              * obs.err[None]).astype(np.float32)
    ensval[:, :5] += 100.0         # gross-error rejects
    qc0 = np.zeros(obs.nobs, np.int32)
    c_ref = ref.build_obs_context(obs, ensval, qc0, cfg_r, grid_r)
    c = port.build_obs_context(obs_p, ensval, qc0, cfg, grid)
    _assert_same_context(c, c_ref)
    assert (c.qc[:5] != 0).all()
    if full_size:
        assert sum(ct.buckets.n_dropped for ct in c.ctypes) > 0
    dev = obs_context_to_device(c, torch.device("cpu"))
    assert dev.hdxb.shape == (c.nobs, K) and dev.hdxb.dtype == torch.float32
    assert [t.shape for t in dev.tables] == \
        [ct.buckets.table.shape for ct in c.ctypes]


def test_radar_context_matches_reference():
    """Radar-density case of tests/test_obs_capacity.py (1-km PAWR
    localization, capacity thinning engaged), at 4×10⁴ obs."""
    NZ, NY, NX, K = 2, 48, 48, 4
    nobs = 40_000
    rng = np.random.default_rng(0)
    grid_r = RefGrid.uniform(nx=NX, ny=NY, nz=NZ, dx=1000.0, dy=1000.0,
                             dz=500.0, proj=RefProjection(kind="LC"))
    grid = Grid.uniform(nx=NX, ny=NY, nz=NZ, dx=1000.0, dy=1000.0, dz=500.0,
                        proj=Projection(kind="LC"))
    lon, lat = grid.ij_to_lonlat(rng.uniform(1, NX - 2, nobs),
                                 rng.uniform(1, NY - 2, nobs))
    dbz = rng.uniform(-5.0, 45.0, nobs)
    arrays = dict(
        elem=np.full(nobs, ID_RADAR_REF, np.int32), lon=lon, lat=lat,
        lev=rng.uniform(200.0, 800.0, nobs), dat=10.0 ** (0.1 * dbz),
        err=np.full(nobs, 5.0), typ=np.full(nobs, TYP_PHARAD, np.int32),
        dif=np.zeros(nobs), meta=np.asarray([135.0, 35.0, 0.0]))
    obs = Observations(**arrays)
    obs_p = PortObservations(**arrays)
    hl = [500.0e3] + [-1.0] * 23
    hl[TYP_PHARAD] = 1.0e3
    mx = [0] + [-1] * 23
    mx[TYP_PHARAD] = 30

    def radar_cfg(m):
        """The same radar settings in config module m of either package."""
        cfg = m.Config(ensemble=m.EnsembleConfig(member=K),
                       letkf=m.LetkfConfig(infl_mul=1.0))
        cfg.letkf_obs.hori_local = tuple(hl)
        cfg.letkf_obs.max_nobs_per_grid = tuple(mx)
        vl = list(cfg.letkf_obs.vert_local)
        vl[TYP_PHARAD] = 1000.0
        cfg.letkf_obs.vert_local = tuple(vl)
        return cfg

    cfg_r, cfg = radar_cfg(ref_config), radar_cfg(port_config)
    ensval = 20.0 + 8.0 * rng.standard_normal((K, nobs))
    qc0 = np.zeros(nobs, np.int32)
    c_ref = ref.build_obs_context(obs, ensval, qc0, cfg_r, grid_r)
    c = port.build_obs_context(obs_p, ensval, qc0, cfg, grid)
    _assert_same_context(c, c_ref)
    assert any(ct.buckets.n_dropped > 0 for ct in c.ctypes)
    assert {ct.elem for ct in c.ctypes} >= {ID_RADAR_REF}
