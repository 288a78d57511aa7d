"""Kernel #2's module (scale_letkf_torch/ops/tendency.py) and the
tendencies that drive it (model/dycore.py tendencies) on the CPU, where the
wrappers run the plain versions, against the reference's whole-tendency
Pallas kernel in interpret mode (ops/pallas_tendency.py tendencies_fused,
block_y = 8, as tests/test_pallas_tendency.py runs it) on a uniform grid,
and against the reference's dycore.tendencies (XLA path) on the stretched
levels the Pallas kernel cannot take. Bound per field: 2e-5·max|reference|
(the bound of tests/test_pallas_tendency.py:53).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scale_letkf_tpu.model import dycore as ref
from scale_letkf_tpu.ops import pallas_tendency as ref_pallas
from scale_letkf_torch.gpu_check import RAGGED_SHAPES
from scale_letkf_torch.io.convert import (
    dycore_config_from_dict, dycore_state_to_numpy, dycore_state_to_torch,
    vgrid_to_torch,
)
from scale_letkf_torch.model import dycore
from scale_letkf_torch.ops import stencil, tendency
from test_torch_dycore import (
    CPU, assert_fields_close, random_state, stretched_levels,
)

torch.set_num_threads(1)


def _case(seed, nz, ny, nx, divdmp):
    rng = np.random.default_rng(seed)
    fields, rho_ref, p_ref = random_state(rng, nz, ny, nx)
    cfg_r = ref.DycoreConfig(dx=2000.0, dy=2000.0, dz=500.0, dt=4.0,
                             divdmp=divdmp, kdiff4=1e-3)
    return (fields, rho_ref, p_ref, cfg_r,
            dycore_config_from_dict(dataclasses.asdict(cfg_r)))


@pytest.mark.parametrize("divdmp", [0.0, 0.05])
def test_tendencies_fused_matches_pallas_kernel(divdmp):
    fields, rho_ref, p_ref, cfg_r, cfg = _case(0, 8, 16, 16, divdmp)
    expect = ref_pallas.tendencies_fused(
        ref.DycoreState(*(jnp.asarray(f) for f in fields)), cfg_r,
        jnp.asarray(rho_ref), jnp.asarray(p_ref), block_y=8, interpret=True)
    out = dycore.tendencies(dycore_state_to_torch(fields, CPU), cfg,
                            torch.from_numpy(rho_ref), torch.from_numpy(p_ref))
    assert_fields_close(dycore_state_to_numpy(out), expect, 2e-5)


@pytest.mark.parametrize("divdmp", [0.0, 0.05])
def test_tendencies_fused_on_stretched_levels_matches_reference(divdmp):
    fields, rho_ref, p_ref, cfg_r, cfg = _case(1, 8, 16, 16, divdmp)
    vg_r = ref.make_vgrid(*stretched_levels(8))
    expect = ref.tendencies(ref.DycoreState(*(jnp.asarray(f) for f in fields)),
                            cfg_r, jnp.asarray(rho_ref), jnp.asarray(p_ref),
                            vg_r)
    out = dycore.tendencies(dycore_state_to_torch(fields, CPU), cfg,
                            torch.from_numpy(rho_ref), torch.from_numpy(p_ref),
                            vgrid_to_torch(vg_r, CPU))
    assert_fields_close(dycore_state_to_numpy(out), expect, 2e-5)


def test_dyn_tendencies_plain_matches_pallas_kernel_directly():
    """The five dynamics fields from the plain version, from the same p′,
    against dyn_tendencies_pallas with its scalar dz and α_z = divdmp·dz²/dt
    (the port's per-level metric filled with dz)."""
    fields, rho_ref, p_ref, cfg_r, cfg = _case(2, 8, 16, 16, 0.05)
    s = dycore_state_to_torch(fields, CPU)
    p_pert = (dycore.moist_pressure(s.rhot, dycore.mixing_ratios(s))
              - torch.from_numpy(p_ref))
    alpha_h = cfg.divdmp * cfg.dx ** 2 / cfg.dt
    alpha_z = cfg.divdmp * cfg.dz ** 2 / cfg.dt
    expect = ref_pallas.dyn_tendencies_pallas(
        *(jnp.asarray(f) for f in fields[:5]), jnp.asarray(p_pert.numpy()),
        jnp.asarray(rho_ref), cfg.dx, cfg.dy, cfg.dz, cfg.kdiff4, alpha_h,
        alpha_z, block_y=8, interpret=True)
    vg = dycore.uniform_vgrid(8, cfg.dz, CPU)
    out = tendency.dyn_tendencies(s.rho, s.rhou, s.rhov, s.rhow, s.rhot,
                                  p_pert, torch.from_numpy(rho_ref), vg.dzc,
                                  vg.dzf, cfg.dx, cfg.dy, cfg.kdiff4,
                                  cfg.divdmp, cfg.dt)
    assert_fields_close([o.numpy() for o in out], expect, 2e-5,
                        names=dycore.DycoreState._fields[:5])


def test_kernel_wrapper_rejects_cpu_tensors():
    fields, rho_ref, _, _, cfg = _case(3, 4, 8, 8, 0.05)
    s = dycore_state_to_torch([f[None] for f in fields], CPU)
    vg = dycore.uniform_vgrid(4, cfg.dz, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        tendency.dyn_tendencies_kernel(
            s.rho, s.rhou, s.rhov, s.rhow, s.rhot, s.rho,
            torch.from_numpy(rho_ref), vg.dzc, vg.dzf, cfg.dx, cfg.dy,
            cfg.kdiff4, cfg.divdmp, cfg.dt)


def test_open_lateral_raises_only_on_the_gpu_path():
    """Both kernels take the open mode now (no wrapper refuses it); the
    kernels' lateral argument is 1 for 'open', 0 for 'periodic', and an
    unknown mode raises; on CPU tensors the plain versions take both."""
    assert not hasattr(stencil, "require_periodic")
    assert stencil.lateral_flag("open") == 1
    assert stencil.lateral_flag("periodic") == 0
    with pytest.raises(ValueError, match="lateral"):
        stencil.lateral_flag("closed")
    fields, rho_ref, p_ref, _, cfg = _case(4, 4, 8, 8, 0.05)
    out = dycore.tendencies(dycore_state_to_torch(fields, CPU),
                            dataclasses.replace(cfg, lateral="open"),
                            torch.from_numpy(rho_ref), torch.from_numpy(p_ref))
    assert all(bool(torch.isfinite(f).all()) for f in out)


@pytest.mark.parametrize("nz,ny,nx", [s[1:] for s in RAGGED_SHAPES])
def test_tendencies_at_ragged_shapes_match_reference(nz, ny, nx):
    """The shapes at which the card holds both kernels against these plain
    versions (gpu_check.RAGGED_SHAPES: axes narrower than a kernel tile
    and its halo, tiles cut by the edge), stretched levels, damping and ∇⁴
    on: the plain versions themselves agree with the reference there."""
    fields, rho_ref, p_ref, cfg_r, cfg = _case(5, nz, ny, nx, 0.05)
    vg_r = ref.make_vgrid(*stretched_levels(nz))
    expect = ref.tendencies(ref.DycoreState(*(jnp.asarray(f) for f in fields)),
                            cfg_r, jnp.asarray(rho_ref), jnp.asarray(p_ref),
                            vg_r)
    out = dycore.tendencies(dycore_state_to_torch(fields, CPU), cfg,
                            torch.from_numpy(rho_ref), torch.from_numpy(p_ref),
                            vgrid_to_torch(vg_r, CPU))
    assert_fields_close(dycore_state_to_numpy(out), expect, 2e-5)
