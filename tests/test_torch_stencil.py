"""Kernel #3's module (scale_letkf_torch/ops/stencil.py) on the CPU, where
its wrapper runs the plain version, against the reference's UD3 Pallas
kernel in interpret mode (ops/pallas_stencil.py adv_flux_divergence_pallas,
block_y 4, 8 and 16, as tests/test_pallas_stencil.py runs it), and against
the tracer tendencies of the reference's dycore.tendencies on stretched
levels. The Pallas kernel takes the mixing ratio φ and no hyperdiffusion:
the port is given q = φ with ρ = 1 (so q/ρ = φ exactly) and kdiff4 = 0.
Bounds: rtol/atol 1e-5 (tests/test_pallas_stencil.py:43) against the
kernel, 2e-5·max|reference| against dycore.tendencies.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scale_letkf_tpu.model import dycore as ref
from scale_letkf_tpu.ops.pallas_stencil import adv_flux_divergence_pallas
from scale_letkf_torch.io.convert import (
    dycore_config_from_dict, dycore_state_to_torch, vgrid_to_torch,
)
from scale_letkf_torch.model import dycore
from scale_letkf_torch.ops import stencil
from test_torch_dycore import CPU, random_state, stretched_levels

torch.set_num_threads(1)


def _port(phi, fx, fy, fw, dx, dy, dz):
    """The port's plain tracer tendency of one field φ with ρ = 1."""
    nz = phi.shape[0]
    t = [torch.from_numpy(np.asarray(a, np.float32))
         for a in (phi, fx, fy, fw)]
    out = stencil.adv_flux_divergence(
        t[0][None], torch.ones_like(t[0]), t[1], t[2], t[3],
        torch.full((nz, 1, 1), dz), dx, dy, 0.0)
    return out[0].numpy()


@pytest.mark.parametrize("block_y", [16, 8, 4])
def test_plain_matches_pallas_kernel(block_y):
    rng = np.random.default_rng(0)
    nz, ny, nx = 8, 16, 32
    phi, fx, fy = (rng.standard_normal((nz, ny, nx)).astype(np.float32)
                   for _ in range(3))
    fw = rng.standard_normal((nz + 1, ny, nx)).astype(np.float32)
    fw[0] = fw[-1] = 0.0
    expect = adv_flux_divergence_pallas(
        *(jnp.asarray(a) for a in (phi, fx, fy, fw)), 2000.0, 2000.0, 500.0,
        block_y=block_y, interpret=True)
    out = _port(phi, fx, fy, fw, 2000.0, 2000.0, 500.0)
    np.testing.assert_allclose(out, np.asarray(expect), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_upwind_selection_matches_pallas_kernel(sign):
    """Pure positive or negative uniform flow: UD3 picks the upwind
    stencil (tests/test_pallas_stencil.py:47-60)."""
    nz, ny, nx = 4, 8, 16
    i = np.mgrid[0:nz, 0:ny, 0:nx][2]
    phi = np.sin(2 * np.pi * i / nx).astype(np.float32)
    fx = np.full((nz, ny, nx), sign, np.float32)
    fy = np.zeros((nz, ny, nx), np.float32)
    fw = np.zeros((nz + 1, ny, nx), np.float32)
    expect = adv_flux_divergence_pallas(
        *(jnp.asarray(a) for a in (phi, fx, fy, fw)), 1.0, 1.0, 1.0,
        block_y=4, interpret=True)
    out = _port(phi, fx, fy, fw, 1.0, 1.0, 1.0)
    np.testing.assert_allclose(out, np.asarray(expect), rtol=1e-5, atol=1e-6)
    # the upwind side: for u > 0 the face value leans on the cell behind
    shifted = _port(np.roll(phi, 1, axis=-1), fx, fy, fw, 1.0, 1.0, 1.0)
    np.testing.assert_allclose(np.roll(out, 1, axis=-1), shifted, atol=1e-6)


@pytest.mark.parametrize("lateral", ["periodic", "open"])
def test_tracer_tendencies_on_stretched_levels_match_reference(lateral):
    """All NQ tracers at once, ρ varying and ∇⁴ on, against the tracer
    tendencies of dycore.tendencies (vmap over the tracers there)."""
    rng = np.random.default_rng(1)
    nz = 8
    fields, rho_ref, p_ref = random_state(rng, nz, 16, 16)
    cfg_r = ref.DycoreConfig(dx=2000.0, dy=2000.0, dz=500.0, dt=4.0,
                             kdiff4=1e-3, lateral=lateral)
    cfg = dycore_config_from_dict(dataclasses.asdict(cfg_r))
    vg_r = ref.make_vgrid(*stretched_levels(nz))
    with ref.lateral_bc(lateral):
        expect = np.asarray(ref.tendencies(
            ref.DycoreState(*(jnp.asarray(f) for f in fields)), cfg_r,
            jnp.asarray(rho_ref), jnp.asarray(p_ref), vg_r).rhoq)
    s = dycore_state_to_torch(fields, CPU)
    out = stencil.adv_flux_divergence_plain(
        s.rhoq, s.rho, s.rhou, s.rhov, s.rhow,
        vgrid_to_torch(vg_r, CPU).dzc, cfg.dx, cfg.dy, cfg.kdiff4,
        lateral).numpy()
    for q in range(expect.shape[0]):
        scale = np.abs(expect[q]).max()
        assert np.abs(out[q] - expect[q]).max() <= 2e-5 * scale, q


def test_batched_tracers_equal_per_member():
    """(members, NQ, ...) in one call equals each member's call exactly:
    the layout one kernel launch covers."""
    rng = np.random.default_rng(2)
    members = [dycore_state_to_torch(random_state(rng, 5, 8, 8)[0], CPU)
               for _ in range(3)]
    ens = dycore.DycoreState(*(torch.stack(f) for f in zip(*members)))
    dzc = torch.full((5, 1, 1), 500.0)
    out = stencil.adv_flux_divergence(ens.rhoq, ens.rho, ens.rhou, ens.rhov,
                                      ens.rhow, dzc, 2000.0, 2000.0, 1e-3)
    for m, s in enumerate(members):
        one = stencil.adv_flux_divergence(s.rhoq, s.rho, s.rhou, s.rhov,
                                          s.rhow, dzc, 2000.0, 2000.0, 1e-3)
        torch.testing.assert_close(out[m], one, rtol=0, atol=0)


def test_kernel_wrapper_rejects_cpu_tensors():
    q = torch.zeros((1, 6, 4, 8, 8))
    rho = torch.ones((1, 4, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        stencil.adv_flux_divergence_kernel(
            q, rho, rho, rho, torch.zeros((1, 5, 8, 8)),
            torch.ones(4), 1.0, 1.0)
