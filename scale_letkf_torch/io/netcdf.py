"""NetCDF4-compatible restart files (through HDF5, h5py).

Port of scale_letkf_tpu/io/netcdf.py (reference: common_scale.f90 v3d_name
DENS/MOMX/MOMY/MOMZ/RHOT/QV/QC/QR/QI/QS/QG :52-54, read_restart :317,
write_restart :558, and the coordinate variables height/lon/lat :107-110).
NetCDF4 is an HDF5 convention, so h5py suffices: datasets with dimension
scales and the standard attributes make files that netCDF4/xarray open
directly. One file holds the whole domain (the reference writes one per
MPI rank). Host I/O only: h5py is imported inside the functions, so the
module imports where h5py is not installed.
"""

from __future__ import annotations

import numpy as np

from scale_letkf_torch.grid import Grid
from scale_letkf_torch.state import V3D_RESTART_NAMES


def write_restart_nc(path: str, restart: np.ndarray, grid: Grid,
                     topo: np.ndarray | None = None):
    """restart: (NV3D, nz, ny, nx) collocated stack in restart order (an
    array, or a tensor on any device)."""
    import h5py
    if hasattr(restart, "detach"):
        restart = restart.detach().cpu().numpy()
    restart = np.asarray(restart)
    nv, nz, ny, nx = restart.shape
    lon, lat = grid.lonlat
    with h5py.File(path, "w") as f:
        z = f.create_dataset("z", data=np.asarray(grid.cz, np.float64))
        y = f.create_dataset("y", data=(np.arange(ny) + 0.5) * grid.dy)
        x = f.create_dataset("x", data=(np.arange(nx) + 0.5) * grid.dx)
        for ds, name in ((z, "z"), (y, "y"), (x, "x")):
            ds.make_scale(name)
            ds.attrs["units"] = "m"
        f.create_dataset("lon", data=np.asarray(lon)).attrs["units"] = \
            "degrees_east"
        f.create_dataset("lat", data=np.asarray(lat)).attrs["units"] = \
            "degrees_north"
        if topo is not None:
            ds = f.create_dataset("TOPO", data=np.asarray(topo))
            ds.attrs["units"] = "m"
        for i, name in enumerate(V3D_RESTART_NAMES):
            ds = f.create_dataset(name, data=restart[i].astype(np.float32))
            for d, scale in enumerate((z, y, x)):
                ds.dims[d].attach_scale(scale)
            ds.attrs["long_name"] = name


def read_restart_nc(path: str) -> tuple[np.ndarray, dict]:
    """((NV3D, nz, ny, nx) stack, coords dict: z, y, x, lon, lat and topo
    when the file holds TOPO)."""
    import h5py
    with h5py.File(path, "r") as f:
        fields = [np.asarray(f[name]) for name in V3D_RESTART_NAMES]
        coords = {k: np.asarray(f[k]) for k in ("z", "y", "x", "lon", "lat")
                  if k in f}
        if "TOPO" in f:
            coords["topo"] = np.asarray(f["TOPO"])
    return np.stack(fields), coords
