"""State carried across from the reference package into the port's tensors.

The system has no learned weights. What crosses between the two packages is
data: the ensemble (K, NV3D, nz, ny, nx), the inflation field, the obs
context (numpy arrays plus bucket tables), the forecast's staggered dycore
states, configuration and vertical metric, and the cycle's history-field
dicts, ensemble H(x) (ObsOpeResult) and slot history stacks. These helpers
turn those numpy arrays into tensors on a given device, so both packages
compute from the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scale_letkf_torch.da.letkf_obs import CtypeContext, ObsContext
from scale_letkf_torch.da.obsope import ObsOpeResult
from scale_letkf_torch.model.dycore import DycoreConfig, DycoreState, VGrid


def ensemble_to_torch(a: np.ndarray, device: torch.device,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An ensemble or field array as a contiguous tensor on `device`."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:    # e.g. a jax array's read-only view
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=device)


@dataclass
class DeviceObsContext:
    """The per-obs arrays of an ObsContext as tensors on one device, with
    each ctype's bucket table beside it (tables[i] belongs to ctypes[i])."""
    x: torch.Tensor              # (nobs,)
    y: torch.Tensor
    vert: torch.Tensor
    err: torch.Tensor
    dep: torch.Tensor
    hdxb: torch.Tensor           # (nobs, K)
    ctypes: list[CtypeContext]
    tables: list[torch.Tensor]   # (mesh_ny, mesh_nx, cap) int32


def obs_context_to_device(ctx: ObsContext, device: torch.device,
                          dtype: torch.dtype = torch.float32
                          ) -> DeviceObsContext:
    """ctx's arrays in `dtype` (the analysis dtype) on `device`."""
    def f(a):
        return ensemble_to_torch(a, device, dtype)
    return DeviceObsContext(
        x=f(ctx.x), y=f(ctx.y), vert=f(ctx.vert), err=f(ctx.err),
        dep=f(ctx.dep), hdxb=f(ctx.hdxb),
        ctypes=list(ctx.ctypes),
        tables=[torch.as_tensor(ct.buckets.table, device=device)
                for ct in ctx.ctypes])


def dycore_state_to_torch(arrays, device: torch.device,
                          dtype: torch.dtype = torch.float32):
    """A DycoreState of contiguous tensors on `device` from six arrays named
    rho, rhou, rhov, rhow, rhot, rhoq: a 6-tuple in that order (a
    DycoreState of either package) or a dict (an npz member file)."""
    if isinstance(arrays, dict) or hasattr(arrays, "files"):
        arrays = [arrays[k] for k in DycoreState._fields]
    if len(arrays) != len(DycoreState._fields):
        raise ValueError(f"a dycore state has {len(DycoreState._fields)} "
                         f"fields, got {len(arrays)}")
    return DycoreState(*(ensemble_to_torch(np.asarray(a), device, dtype)
                         for a in arrays))


def dycore_state_to_numpy(state) -> tuple[np.ndarray, ...]:
    """The six fields of a DycoreState of tensors (any device) as numpy
    arrays, in field order."""
    return tuple(f.detach().cpu().numpy() for f in state)


def dycore_config_from_dict(d: dict):
    """The port's DycoreConfig from `dataclasses.asdict` of the reference's:
    its `advection` backend knob is dropped (the port's device decides)."""
    return DycoreConfig(**{k: v for k, v in d.items() if k != "advection"})


def vgrid_to_torch(vg, device: torch.device,
                   dtype: torch.dtype = torch.float32):
    """The port's VGrid from any (dzc, dzf) pair of arrays (the reference's
    VGrid, as numpy)."""
    return VGrid(*(ensemble_to_torch(np.asarray(a), device, dtype)
                   for a in (vg.dzc, vg.dzf)))


def fields_to_torch(fields: dict, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> dict:
    """A history-field dict (state_to_history of either package) as
    tensors on `device`."""
    return {k: ensemble_to_torch(np.asarray(v), device, dtype)
            for k, v in fields.items()}


def obsope_result_to_torch(res, device: torch.device,
                           dtype: torch.dtype = torch.float32) -> ObsOpeResult:
    """The port's ObsOpeResult from any result with ensval (K, nobs), qc and
    optional lev, val2 (the reference's, as numpy): ensval on `device`."""
    def host(a):
        return None if a is None else np.asarray(a)
    return ObsOpeResult(ensval=ensemble_to_torch(np.asarray(res.ensval),
                                                 device, dtype),
                        qc=np.asarray(res.qc, np.int32), lev=host(res.lev),
                        val2=host(res.val2))
