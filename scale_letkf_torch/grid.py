"""Grid geometry and map projection for the limited-area domain.

Port of scale_letkf_tpu/grid.py (reference: common_scale.f90:117-129 grid
sizes, scale_calc_z at common_scale.f90:1434-1495, SCALE MPRJ phys2ij).
Geometry is host work and stays in numpy; only `calc_z` builds a tensor,
on the device it is given.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from scale_letkf_torch.constants import RE, D2R, R2D


@dataclass(frozen=True)
class Projection:
    """Conformal map projection: Lambert conformal ('LC'), Mercator ('MER'),
    polar stereographic ('PS') or equirectangular ('EQ'), basepoint at the
    origin of the projection coordinates."""
    kind: str = "LC"
    basepoint_lon: float = 135.0
    basepoint_lat: float = 35.0
    lc_lat1: float = 30.0     # Lambert standard parallels
    lc_lat2: float = 40.0

    @cached_property
    def _lc(self):
        """Lambert conformal cone constant and scale."""
        la1, la2 = self.lc_lat1 * D2R, self.lc_lat2 * D2R
        if abs(self.lc_lat1 - self.lc_lat2) < 1e-10:
            n = np.sin(la1)
        else:
            n = (np.log(np.cos(la1)) - np.log(np.cos(la2))) / (
                np.log(np.tan(np.pi / 4 + la2 / 2))
                - np.log(np.tan(np.pi / 4 + la1 / 2)))
        f = np.cos(la1) * np.tan(np.pi / 4 + la1 / 2) ** n / n
        return n, f

    def lonlat_to_xy(self, lon, lat):
        """Lon/lat [deg] → projection coordinates [m]."""
        lam = (np.asarray(lon) - self.basepoint_lon) * D2R
        phi = np.asarray(lat) * D2R
        phi0 = self.basepoint_lat * D2R
        if self.kind == "EQ":
            x = RE * np.cos(phi0) * lam
            y = RE * (phi - phi0)
        elif self.kind == "MER":
            x = RE * np.cos(phi0) * lam
            y = RE * np.cos(phi0) * (np.log(np.tan(np.pi / 4 + phi / 2))
                                     - np.log(np.tan(np.pi / 4 + phi0 / 2)))
        elif self.kind == "LC":
            n, f = self._lc
            rho = RE * f / np.tan(np.pi / 4 + phi / 2) ** n
            rho0 = RE * f / np.tan(np.pi / 4 + phi0 / 2) ** n
            x = rho * np.sin(n * lam)
            y = rho0 - rho * np.cos(n * lam)
        elif self.kind == "PS":
            s = np.sign(self.basepoint_lat) or 1.0
            k = 2 * RE / (1 + s * np.sin(phi))
            k0 = 2 * RE / (1 + s * np.sin(phi0))
            x = k * np.cos(phi) * np.sin(lam)
            y = -s * k * np.cos(phi) * np.cos(lam) + s * k0 * np.cos(phi0)
        else:
            raise ValueError(self.kind)
        return x, y

    def xy_to_lonlat(self, x, y):
        """Projection coordinates [m] → lon/lat [deg]."""
        x = np.asarray(x)
        y = np.asarray(y)
        phi0 = self.basepoint_lat * D2R
        if self.kind == "EQ":
            lon = self.basepoint_lon + x / (RE * np.cos(phi0)) * R2D
            lat = (phi0 + y / RE) * R2D
        elif self.kind == "MER":
            c = RE * np.cos(phi0)
            lon = self.basepoint_lon + x / c * R2D
            t = np.exp(y / c) * np.tan(np.pi / 4 + phi0 / 2)
            lat = (2 * np.arctan(t) - np.pi / 2) * R2D
        elif self.kind == "LC":
            n, f = self._lc
            rho0 = RE * f / np.tan(np.pi / 4 + phi0 / 2) ** n
            yy = rho0 - y
            rho = np.sqrt(x * x + yy * yy) * np.sign(n)
            theta = np.arctan2(x, yy)
            lon = self.basepoint_lon + theta / n * R2D
            lat = (2 * np.arctan((RE * f / rho) ** (1.0 / n)) - np.pi / 2) * R2D
        elif self.kind == "PS":
            s = np.sign(self.basepoint_lat) or 1.0
            k0 = 2 * RE / (1 + s * np.sin(phi0))
            yy = y - s * k0 * np.cos(phi0)
            r = np.sqrt(x * x + yy * yy)
            lat = s * (np.pi / 2 - 2 * np.arctan(r / (2 * RE))) * R2D
            lon = self.basepoint_lon + np.arctan2(x, -s * yy) * R2D
        else:
            raise ValueError(self.kind)
        return lon, lat


@dataclass(frozen=True)
class Grid:
    """Global limited-area grid geometry.

    nx, ny, nz  — gridpoint counts; dx, dy — horizontal spacing [m];
    cz, fz      — cell centers / faces of the flat reference column [m]
                  (fz has nz+1 entries, fz[0] = 0 at the surface)."""
    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    cz: np.ndarray = field(repr=False)
    fz: np.ndarray = field(repr=False)
    proj: Projection = field(default_factory=Projection)

    @staticmethod
    def uniform(nx, ny, nz, dx, dy, dz, proj: Projection | None = None) -> "Grid":
        fz = np.arange(nz + 1) * dz
        cz = 0.5 * (fz[:-1] + fz[1:])
        return Grid(nx=nx, ny=ny, nz=nz, dx=dx, dy=dy, cz=cz, fz=fz,
                    proj=proj or Projection())

    @staticmethod
    def stretched(nx, ny, nz, dx, dy, dz0, stretch,
                  proj: Projection | None = None) -> "Grid":
        """Geometrically stretched vertical levels (dz0 at the surface)."""
        dzs = dz0 * stretch ** np.arange(nz)
        fz = np.concatenate([[0.0], np.cumsum(dzs)])
        cz = 0.5 * (fz[:-1] + fz[1:])
        return Grid(nx=nx, ny=ny, nz=nz, dx=dx, dy=dy, cz=cz, fz=fz,
                    proj=proj or Projection())

    @property
    def ztop(self) -> float:
        return float(self.fz[-1])

    @cached_property
    def xy(self):
        """Projection coordinates of cell centers, basepoint at domain center."""
        x = (np.arange(self.nx) + 0.5 - self.nx / 2) * self.dx
        y = (np.arange(self.ny) + 0.5 - self.ny / 2) * self.dy
        return x, y

    @cached_property
    def lonlat(self):
        """(lon2d, lat2d) of cell centers, shape (ny, nx) [deg]."""
        x, y = self.xy
        xx, yy = np.meshgrid(x, y)
        return self.proj.xy_to_lonlat(xx, yy)

    def calc_z(self, topo: torch.Tensor) -> torch.Tensor:
        """Terrain-following height of cell centers, (nz, ny, nx), on topo's
        device and in its dtype: z = (ztop - topo)/ztop · cz + topo, the
        reference's BTF coordinate (common_scale.f90:1434-1459)."""
        cz = torch.as_tensor(self.cz, dtype=topo.dtype, device=topo.device)
        return ((self.ztop - topo)[None] / self.ztop * cz[:, None, None]
                + topo[None])

    def ij_to_lonlat(self, ri, rj):
        """Fractional 0-based gridpoint (ri, rj) → lon/lat [deg]."""
        x = (np.asarray(ri) + 0.5 - self.nx / 2) * self.dx
        y = (np.asarray(rj) + 0.5 - self.ny / 2) * self.dy
        return self.proj.xy_to_lonlat(x, y)
