"""Two public functions of ported modules against the reference's:
ops/localization.py gaspari_cohn on tests/test_obs_select.py:139's inputs
(and a finer sweep) to 1e-6 relative in float32, and obs/io.py read_obs_all
on one file of each OBS_IN_FORMAT (PREPBUFR, RADAR, HIMAWARI8), every
field equal."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_tpu.obs import io as ref_io
from scale_letkf_tpu.ops.localization import gaspari_cohn as ref_gc
from scale_letkf_torch.cli.main import load_config_and_grid
from scale_letkf_torch.gpu_check import radar_template
from scale_letkf_torch.obs import io as obsio
from scale_letkf_torch.ops.localization import gaspari_cohn
from scale_letkf_torch.synthetic import (
    synthetic_conv_network, synthetic_h08_network,
)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "18km_japan.toml")
FIELDS = ("elem", "lon", "lat", "lev", "dat", "err", "typ", "dif")


def test_gaspari_cohn_matches_reference():
    r = np.asarray([0.0, 0.5, 1.0, 1.5, 2.0, 2.5], np.float32)
    w = gaspari_cohn(torch.from_numpy(r)).numpy()
    assert w[0] == 1.0 and w[5] == 0.0
    assert np.all(np.diff(w) <= 1e-6)
    np.testing.assert_allclose(w[4], 0.0, atol=1e-6)
    sweep = np.linspace(-2.5, 2.5, 401).astype(np.float32)
    for x in (r, sweep):
        np.testing.assert_allclose(
            gaspari_cohn(torch.from_numpy(x)).numpy(),
            np.asarray(ref_gc(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_read_obs_all_matches_reference(tmp_path):
    over = {"nx": 32, "ny": 24}
    cfg, grid, _, _ = load_config_and_grid(CONFIG, over)
    cfg_r = ref_load(CONFIG, over)[0]
    paths = {"PREPBUFR": tmp_path / "conv.dat",
             "RADAR": tmp_path / "radar.dat",
             "HIMAWARI8": tmp_path / "h08.dat"}
    obsio.write_obs(str(paths["PREPBUFR"]), synthetic_conv_network(
        cfg, grid, np.random.default_rng(0), n_sonde=10, n_ps=20))
    lon, lat = grid.lonlat
    site = {"radar_lon": float(lon[12, 16]), "radar_lat": float(lat[12, 16])}
    obsio.write_obs_radar(str(paths["RADAR"]),
                          radar_template(grid, site, seed=1, n=50))
    obsio.write_obs_h08(str(paths["HIMAWARI8"]), synthetic_h08_network(
        cfg, grid, spacing=8, margin=4))
    for c in (cfg, cfg_r):
        c.obsope.obs_in_name = tuple(str(p) for p in paths.values())
        c.obsope.obs_in_format = tuple(paths)
    got, want = obsio.read_obs_all(cfg), ref_io.read_obs_all(cfg_r)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.nobs == w.nobs > 0
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k), k)
    cfg.obsope.obs_in_format = ("GRIB",)
    with pytest.raises(ValueError, match="unsupported obs format"):
        obsio.read_obs_all(cfg)
