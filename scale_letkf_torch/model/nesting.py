"""One-way online domain nesting: parent → child boundary forcing.

Port of scale_letkf_tpu/model/nesting.py (reference: PARAM_PROCESS
NUM_DOMAIN/PRC_DOMAINS, common_nml.f90:56-58; the communicator split for
nesting at common_mpi_scale.f90:696-706 feeding SCALE's inter-domain
coupling). The parent's state is interpolated to the child grid and drives
the child's lateral boundary relaxation (model/boundary.py).

Geometry: the child occupies a rectangle of the parent plane, given by the
parent-grid fractional origin (i0, j0) of the child's first cell center and
the integer refinement ratio. Vertical levels may differ; linear
interpolation in height handles both.

Interpolation is separable linear — in x, then y, then height — with each
integer tap clamped to the parent's index range, the function of the
reference's `map_coordinates(order=1, mode="nearest")`. The taps and
weights are computed on the host in float64, as the port's H(x) geometry,
and applied by index_select on the fields' device (any leading axes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scale_letkf_torch.model.dycore import DycoreState


@dataclass(frozen=True)
class NestGeometry:
    i0: float           # parent fractional x-index of child cell (0,0)
    j0: float
    ratio: int          # refinement ratio (child dx = parent dx / ratio)

    def child_coords(self, child_ny: int, child_nx: int):
        """Parent fractional (j, i) coordinates of every child cell center."""
        ci = self.i0 + np.arange(child_nx) / self.ratio
        cj = self.j0 + np.arange(child_ny) / self.ratio
        return cj, ci


def _interp_axis(f: torch.Tensor, dim: int, coord: np.ndarray
                 ) -> torch.Tensor:
    """f linearly interpolated along `dim` (-1, -2 or -3) at the fractional
    indices `coord`, each integer tap clamped to the axis."""
    n = f.shape[dim]
    lo = np.floor(coord)
    w1 = coord - lo
    lo = lo.astype(np.int64)
    shape = (len(coord),) + (1,) * (-1 - dim)

    def taps(i):
        return torch.as_tensor(np.clip(i, 0, n - 1), device=f.device)

    def weight(w):
        return torch.as_tensor(w.reshape(shape), dtype=f.dtype,
                               device=f.device)
    return (f.index_select(dim, taps(lo)) * weight(1.0 - w1)
            + f.index_select(dim, taps(lo + 1)) * weight(w1))


def interp_parent_field(field: torch.Tensor, cj: np.ndarray, ci: np.ndarray,
                        zp: np.ndarray | None = None,
                        zc: np.ndarray | None = None) -> torch.Tensor:
    """Interpolate a parent (..., nz, ny, nx) field to the child grid.

    Horizontal: bilinear at the child cell centers. Vertical: linear in the
    1-D level coordinates zp → zc (identity if omitted)."""
    out = _interp_axis(field, -1, np.asarray(ci, np.float64))
    out = _interp_axis(out, -2, np.asarray(cj, np.float64))
    if zp is None or zc is None:
        return out
    kk = np.interp(np.asarray(zc, np.float64), np.asarray(zp, np.float64),
                   np.arange(field.shape[-3], dtype=np.float64))
    if np.array_equal(kk, np.arange(field.shape[-3])):
        return out          # the same levels: every weight of the map is 1
    return _interp_axis(out, -3, kk)


def _faces(z: np.ndarray) -> np.ndarray:
    """Face heights of centers z, the outer faces extrapolated half a
    level."""
    z = np.asarray(z, np.float64)
    return np.concatenate([[z[0] - (z[1] - z[0]) / 2], 0.5 * (z[1:] + z[:-1]),
                           [z[-1] + (z[-1] - z[-2]) / 2]])


def parent_to_child(parent: DycoreState, geom: NestGeometry,
                    child_shape: tuple[int, int, int],
                    zp: np.ndarray | None = None,
                    zc: np.ndarray | None = None) -> DycoreState:
    """Interpolate a full parent state (any leading axes, e.g. members) to
    the child grid: the child-boundary target of
    boundary.apply_boundary_relaxation. ρw goes between the extrapolated
    face heights of zp and zc."""
    nz, ny, nx = child_shape
    cj, ci = geom.child_coords(ny, nx)
    same = zp is None or zc is None

    def itp(f):
        return interp_parent_field(f, cj, ci, zp, zc)

    return DycoreState(
        rho=itp(parent.rho), rhou=itp(parent.rhou), rhov=itp(parent.rhov),
        rhow=interp_parent_field(parent.rhow, cj, ci,
                                 None if same else _faces(zp),
                                 None if same else _faces(zc)),
        rhot=itp(parent.rhot), rhoq=itp(parent.rhoq))
