"""Kernel #5's wrapper and dispatch on the CPU (model/terrain.py).

tendencies_terrain_kernel runs only on a CUDA device: here it must refuse
what the kernel does not take before anything is built or launched, and
tendencies_terrain on CPU tensors must stay the plain path. The kernel
itself is held to the plain path bit for bit in tests/test_torch_cuda.py.
"""

import dataclasses

import pytest
import torch

from scale_letkf_torch import gpu_check
from scale_letkf_torch.model import dycore, terrain
from scale_letkf_torch.utils import kernels

CPU = torch.device("cpu")


def _operands(batch=2, levels="stretched", lateral="periodic", divdmp=0.05):
    return gpu_check.terrain_operands(CPU, batch, lateral, levels, divdmp,
                                      shape=(5, 8, 10))


def _with(t, name, value):
    return t._replace(**{name: value})


def _noncontiguous(f):
    return f.transpose(-1, -2).contiguous().transpose(-1, -2)


# case: (how the operands are broken, the message); another dtype raises
# TypeError (ops/stencil.py's shared check), every other case ValueError
REFUSED = {
    "cpu": (lambda s, cfg, cols, m, vg: (s, cfg, cols, m, vg), "CUDA"),
    "float64": (lambda s, cfg, cols, m, vg: (
        _with(s, "rho", s.rho.double()), cfg, cols, m, vg), "float32"),
    "float64_metric": (lambda s, cfg, cols, m, vg: (
        s, cfg, cols, _with(m, "gx", m.gx.double()), vg), "float32"),
    "noncontiguous": (lambda s, cfg, cols, m, vg: (
        _with(s, "rhou", _noncontiguous(s.rhou)), cfg, cols, m, vg),
        "contiguous"),
    "noncontiguous_metric": (lambda s, cfg, cols, m, vg: (
        s, cfg, cols, _with(m, "jac", _noncontiguous(m.jac)), vg),
        "contiguous"),
    "rhow_levels": (lambda s, cfg, cols, m, vg: (
        _with(s, "rhow", s.rhow[:, 1:].contiguous()), cfg, cols, m, vg),
        "rhow has shape"),
    "rhoq_rank": (lambda s, cfg, cols, m, vg: (
        _with(s, "rhoq", s.rhoq[:, 0].contiguous()), cfg, cols, m, vg),
        "rhoq has shape"),
    "metric_levels": (lambda s, cfg, cols, m, vg: (
        s, cfg, cols, _with(m, "gx_zf", m.gx_zf[1:].contiguous()), vg),
        "gx_zf has shape"),
    "jac_columns": (lambda s, cfg, cols, m, vg: (
        s, cfg, cols, _with(m, "jac", m.jac[:, 1:].contiguous()), vg),
        "jac has shape"),
    "p_ref_levels": (lambda s, cfg, cols, m, vg: (
        s, cfg, (cols[0], cols[1][1:].contiguous()), m, vg),
        "p_ref has"),
    "dzf_levels": (lambda s, cfg, cols, m, vg: (
        s, cfg, cols, m, vg._replace(dzf=vg.dzf[1:].contiguous())),
        "dzf has"),
    "lateral": (lambda s, cfg, cols, m, vg: (
        s, dataclasses.replace(cfg, lateral="wrap"), cols, m, vg),
        "lateral"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_terrain_kernel_wrapper_refuses(case):
    """tendencies_terrain_kernel refuses, naming the fault, CPU tensors,
    non-float32 or non-contiguous operands, inconsistent shapes and an
    unknown lateral mode; nothing is launched."""
    breaks, message = REFUSED[case]
    s, cfg, cols, m, vg = breaks(*_operands())
    kernels.reset_launches()
    error = TypeError if case.startswith("float64") else ValueError
    with pytest.raises(error, match=message):
        terrain.tendencies_terrain_kernel(s, cfg, *cols, m, vg)
    assert kernels.LAUNCHES["terrain_tendency"] == 0


@pytest.mark.parametrize("shape", [(1, 8, 10), (5, 1, 10), (5, 8, 1)])
def test_terrain_kernel_wrapper_refuses_thin_grids(shape):
    """nz, ny and nx below 2 are refused (the kernel's index maps and
    one-sided ∂p′/∂ζ need two of each)."""
    nz, ny, nx = shape
    s, cfg, cols, m, vg = _operands()
    s = dycore.DycoreState(
        *(f[..., :nz + (n == "rhow"), :ny, :nx].contiguous()
          for n, f in zip(s._fields, s)))
    m = terrain.TerrainMetrics(
        *(f[..., :ny, :nx].contiguous() if f.dim() == 2
          else f[:nz + (n.endswith("_zf")), :ny, :nx].contiguous()
          for n, f in zip(m._fields, m)))
    cols = tuple(c[:nz].contiguous() for c in cols)
    vg = dycore.VGrid(vg.dzc[:nz].contiguous(),
                      vg.dzf[:max(nz - 1, 0)].contiguous())
    with pytest.raises(ValueError, match="2 <= nz, ny, nx"):
        terrain.tendencies_terrain_kernel(s, cfg, *cols, m, vg)


@pytest.mark.parametrize("batch", [2, None])
@pytest.mark.parametrize("lateral", ["periodic", "open"])
@pytest.mark.parametrize("levels", ["stretched", "uniform"])
def test_tendencies_terrain_on_cpu_is_the_plain_path(batch, lateral, levels):
    """CPU tensors take the plain path: no kernel launch, and the plain
    function's result exactly."""
    s, cfg, cols, m, vg = _operands(batch, levels, lateral)
    kernels.reset_launches()
    got = terrain.tendencies_terrain(s, cfg, *cols, m, vg)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    want = terrain.tendencies_terrain_plain(s, cfg, *cols, m, vg)
    for name, a, b in zip(s._fields, got, want):
        assert torch.equal(a, b), name
        assert a.shape == getattr(s, name).shape, name
