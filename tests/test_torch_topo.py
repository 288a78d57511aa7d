"""The port's topography preprocessing (scale_letkf_torch/model/topo.py) and
the `pp` verb against the reference package, from the same numpy inputs, on
the CPU.

- read_dem (both layouts) and remap_dem_to_grid are host numpy float64 in
  both packages: equal.
- smooth_topo: the reference's lax.while_loop and the port's loop of passes
  stop on the same float32 slope test, so they take the same number of
  passes (the reference's count found by rerunning it with itelim one pass
  short); the fields agree to 1e-5 of the largest elevation (float32 1-2-1
  passes in either order of summation).
- flatten_halo and prepare_topo, then `pp` through both packages' CLIs:
  the same npz to 1e-5 of the largest elevation, and the port's driver
  built from it (topo_file) runs terrain metrics.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_letkf_tpu.cli.main import main as ref_main
from scale_letkf_tpu.grid import Grid as RefGrid
from scale_letkf_tpu.model import topo as ref_topo
from scale_letkf_torch.cli.main import load_config_and_grid, main, make_driver
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.model import topo

torch.set_num_threads(1)
GRID = dict(nx=32, ny=32, nz=10, dx=5e3, dy=5e3, dz=500.0)


def dem_hill(nlon=241, nlat=241, h0=2000.0):
    """A DEM over the model domain: a Gaussian hill at the basepoint,
    seeded roughness, and sea (negative elevation) west of 134.6°E."""
    lon = 135.0 + np.linspace(-3.0, 3.0, nlon)
    lat = 35.0 + np.linspace(-3.0, 3.0, nlat)
    lo, la = np.meshgrid(lon, lat)
    rough = 300.0 * np.random.default_rng(0).standard_normal(lo.shape)
    elev = h0 * np.exp(-(((lo - 135.0) / 0.8) ** 2
                         + ((la - 35.0) / 0.8) ** 2)) + rough
    return np.where(lo < 134.6, -50.0, elev), lon, lat


def close(a, b, scale):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0,
                               atol=1e-5 * scale)


def test_read_dem_matches_reference(tmp_path):
    elev, lon, lat = dem_hill(nlon=50, nlat=40)
    np.savez(tmp_path / "dem.npz", elev=elev, lon=lon, lat=lat)
    elev.astype(np.float32).tofile(tmp_path / "dem.bin")
    geo = dict(nlon=50, nlat=40, lon0=lon[0], dlon=lon[1] - lon[0],
               lat0=lat[0], dlat=lat[1] - lat[0])
    for path, kw in (("dem.npz", {}), ("dem.bin", geo)):
        got = topo.read_dem(str(tmp_path / path), **kw)
        want = ref_topo.read_dem(str(tmp_path / path), **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="geometry|nlon"):
        topo.read_dem(str(tmp_path / "dem.bin"))


def test_remap_matches_reference():
    elev, lon, lat = dem_hill()
    got = topo.remap_dem_to_grid(elev, lon, lat, Grid.uniform(**GRID))
    want = ref_topo.remap_dem_to_grid(elev, lon, lat,
                                      RefGrid.uniform(**GRID))
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0.0 and got.max() > 1000.0


@pytest.mark.parametrize("ratio", [0.5, 0.1, 0.02])
def test_smooth_topo_takes_the_reference_passes(ratio):
    rough = np.abs(np.random.default_rng(1).standard_normal((40, 36))) * 800.0
    dx, dy = 2000.0, 2500.0
    got, passes = topo.smooth_topo(rough, dx, dy, max_slope_ratio=ratio)
    want = np.asarray(ref_topo.smooth_topo(rough, dx, dy,
                                           max_slope_ratio=ratio))
    assert 0 < passes < 100
    # the reference stops after exactly `passes`: not one pass earlier
    at = np.asarray(ref_topo.smooth_topo(rough, dx, dy, ratio,
                                         itelim=passes))
    short = np.asarray(ref_topo.smooth_topo(rough, dx, dy, ratio,
                                            itelim=passes - 1))
    np.testing.assert_array_equal(at, want)
    assert not np.array_equal(short, want)
    close(got.numpy(), want, rough.max())
    assert float(topo.max_slope(got, dx, dy)) <= ratio
    assert abs(float(got.mean()) - rough.mean()) < 1e-3 * rough.mean()


def test_flatten_halo_matches_reference():
    t = np.random.default_rng(2).uniform(0, 1000, (20, 24)).astype(np.float32)
    for width in (0, 2, 3):
        got = topo.flatten_halo(torch.from_numpy(t), width).numpy()
        want = np.asarray(ref_topo.flatten_halo(jnp.asarray(t), width))
        close(got, want, 1000.0)


def test_prepare_topo_matches_reference():
    elev, lon, lat = dem_hill()
    got, passes = topo.prepare_topo(elev, lon, lat, Grid.uniform(**GRID),
                                    max_slope_ratio=0.05)
    want = ref_topo.prepare_topo(elev, lon, lat, RefGrid.uniform(**GRID),
                                 max_slope_ratio=0.05)
    assert got.dtype == np.float64 and passes > 0
    close(got, want, want.max())


def test_pp_verbs_agree_and_the_driver_takes_the_topography(tmp_path,
                                                            capsys):
    elev, lon, lat = dem_hill()
    np.savez(tmp_path / "dem.npz", elev=elev, lon=lon, lat=lat)
    elev.astype(np.float32).tofile(tmp_path / "dem.bin")
    conf = tmp_path / "c.toml"
    conf.write_text("[domain]\nnx = 16\nny = 16\nnz = 8\ndx = 10e3\n"
                    "dy = 10e3\ndz = 1000.0\n")
    geo = f"241,241,{lon[0]},{lon[1] - lon[0]},{lat[0]},{lat[1] - lat[0]}"
    for dem, extra in (("dem.npz", []), ("dem.bin", ["--dem-geometry", geo])):
        args = ["pp", "--config", str(conf), "--dem", str(tmp_path / dem),
                "--max-slope-ratio", "0.05", *extra]
        ref_main(args + ["--out", str(tmp_path / "ref.npz")])
        main(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
        want = np.load(tmp_path / "ref.npz")["topo"]
        got = np.load(tmp_path / "port.npz")["topo"]
        assert got.shape == (16, 16) and got.max() > 100.0
        close(got, want, want.max())
    assert "smoothing passes on cpu" in capsys.readouterr().out

    conf2 = tmp_path / "c2.toml"
    conf2.write_text(conf.read_text()
                     + f"topo_file = '{tmp_path / 'port.npz'}'\n")
    cfg, grid, dycfg, dom = load_config_and_grid(str(conf2))
    driver = make_driver(cfg, grid, dycfg, dom, torch.device("cpu"))
    z0 = driver.z_full[0].numpy()
    assert z0.max() > z0.min() + 100.0      # the first level follows the hill
    assert driver.metrics is not None
    np.testing.assert_array_equal(driver.topo.numpy(),
                                  got.astype(np.float32))


def test_pp_needs_a_gpu_by_default(tmp_path):
    elev, lon, lat = dem_hill(nlon=20, nlat=20)
    np.savez(tmp_path / "dem.npz", elev=elev, lon=lon, lat=lat)
    conf = tmp_path / "c.toml"
    conf.write_text("[domain]\nnx = 8\nny = 8\nnz = 4\n")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["pp", "--config", str(conf), "--dem", str(tmp_path / "dem.npz"),
              "--out", str(tmp_path / "t.npz")])
