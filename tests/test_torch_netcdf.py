"""NetCDF restarts of the port (io/netcdf.py) against the reference's, on the
CPU: a file written by either package reads back in the other bit-equal —
the 11 restart fields, TOPO and the coordinates z, y, x, lon, lat — on a
stretched Lambert-conformal grid, from a tensor or an array; the file keeps
netCDF dimension scales and units."""

import h5py
import numpy as np
import pytest
import torch

from scale_letkf_tpu.grid import Grid as RefGrid
from scale_letkf_tpu.grid import Projection as RefProjection
from scale_letkf_tpu.io import netcdf as ref_nc
from scale_letkf_torch.grid import Grid, Projection
from scale_letkf_torch.io import netcdf
from scale_letkf_torch.state import V3D_RESTART_NAMES

NZ, NY, NX = 6, 8, 10


def _case():
    rng = np.random.default_rng(3)
    restart = rng.standard_normal((11, NZ, NY, NX)).astype(np.float32)
    topo = rng.uniform(0.0, 400.0, (NY, NX))
    kw = dict(nx=NX, ny=NY, nz=NZ, dx=3000.0, dy=3000.0, dz0=200.0,
              stretch=1.1)
    return (restart, topo, Grid.stretched(**kw, proj=Projection(kind="LC")),
            RefGrid.stretched(**kw, proj=RefProjection(kind="LC")))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_restart_files_cross_read_bit_equal(tmp_path, writer):
    restart, topo, grid, grid_r = _case()
    path = str(tmp_path / "restart.nc")
    if writer == "port":
        netcdf.write_restart_nc(path, torch.from_numpy(restart), grid,
                                topo=topo)
    else:
        ref_nc.write_restart_nc(path, restart, grid_r, topo=topo)
    got, coords = netcdf.read_restart_nc(path)
    ref, coords_r = ref_nc.read_restart_nc(path)
    np.testing.assert_array_equal(got, restart)
    np.testing.assert_array_equal(ref, restart)
    assert sorted(coords) == sorted(coords_r) == ["lat", "lon", "topo", "x",
                                                  "y", "z"]
    for k in coords:
        np.testing.assert_array_equal(coords[k], coords_r[k], err_msg=k)
    np.testing.assert_array_equal(coords["topo"], topo)
    np.testing.assert_array_equal(coords["z"], grid.cz)
    lon, lat = grid.lonlat
    np.testing.assert_array_equal(coords["lon"], lon)
    np.testing.assert_array_equal(coords["lat"], lat)
    with h5py.File(path, "r") as f:
        assert list(f["DENS"].dims[0].keys()) == ["z"]
        assert f["z"].attrs["units"] == "m"
        assert f["lon"].attrs["units"] == "degrees_east"
        assert all(n in f for n in V3D_RESTART_NAMES)
    from scale_letkf_tpu.state import V3D_RESTART_NAMES as REF_NAMES
    assert V3D_RESTART_NAMES == REF_NAMES


def test_both_writers_write_the_same_datasets(tmp_path):
    """The port's file and the reference's hold the same datasets with the
    same values, dtypes and attributes."""
    restart, topo, grid, grid_r = _case()
    a, b = str(tmp_path / "port.nc"), str(tmp_path / "ref.nc")
    netcdf.write_restart_nc(a, restart, grid, topo=topo)
    ref_nc.write_restart_nc(b, restart, grid_r, topo=topo)
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert sorted(fa) == sorted(fb)
        for k in fb:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k][()], fb[k][()], err_msg=k)
            assert ({n: v for n, v in fa[k].attrs.items()
                     if n in ("units", "long_name")}
                    == {n: v for n, v in fb[k].attrs.items()
                        if n in ("units", "long_name")}), k
