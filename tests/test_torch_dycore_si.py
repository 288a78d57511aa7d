"""The port's split-explicit core (scale_letkf_torch/model/dycore_si.py) on
its plain path (CPU tensors) against the reference's, from the same numpy
inputs.

- `_thomas_solve` against the reference's lax.scan solve, to 1e-5.
- Two `rk3_step_si` steps of the 18-km configuration coarsened to 16×12×8
  (its stretched levels, n_small = 10, dt = 30 s) from a balanced state
  with the config's qv profile and seeded ρθ and wind noise. The float32
  forecast amplifies rounding (p′ is the difference of two pressures near
  1e5 Pa, and the acoustic substeps carry its last bits into the winds), so
  per field the bound is 1e-4·max|increment of the reference run| plus
  twice the port's own rounding floor: the change of the port's result
  when its inputs are perturbed by one rounding (relative 2⁻²⁴·N(0,1)).
  The port must agree with the reference as closely as it agrees with
  itself.
- `acoustic_substeps` on CPU tensors is its plain version bit for bit and
  launches no kernel (the CUDA kernel's own checks, against the plain
  version on the card, are in tests/test_torch_cuda.py).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_tpu.model import dycore as ref
from scale_letkf_tpu.model import dycore_si as ref_si
from scale_letkf_torch.cli.main import load_config_and_grid
from scale_letkf_torch.io.convert import (
    dycore_state_to_numpy, dycore_state_to_torch, vgrid_to_torch,
)
from scale_letkf_torch import gpu_check
from scale_letkf_torch.model import dycore, dycore_si, ideal
from scale_letkf_torch.utils import kernels

torch.set_num_threads(1)
CPU = torch.device("cpu")
CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "18km_japan.toml")
COARSE = {"nx": 16, "ny": 12, "nz": 8}


def test_thomas_solve_matches_reference():
    rng = np.random.default_rng(0)
    n, m = 12, 5
    a = rng.uniform(-0.3, -0.1, (n, m))
    b = rng.uniform(2.0, 3.0, (n, m))
    c = rng.uniform(-0.3, -0.1, (n, m))
    x_true = rng.standard_normal((n, m))
    d = b * x_true
    d[1:] += a[1:] * x_true[:-1]
    d[:-1] += c[:-1] * x_true[1:]
    a[0] = 0.0
    c[-1] = 0.0
    args = [np.asarray(v, np.float32) for v in (a, b, c, d)]
    x_r = np.asarray(ref_si._thomas_solve(*(jnp.asarray(v) for v in args)))
    x = dycore_si._thomas_solve(*(torch.from_numpy(v) for v in args))
    np.testing.assert_allclose(x.numpy(), x_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.numpy(), x_true, rtol=1e-5, atol=1e-5)


def test_thomas_solve_along_levels_of_a_batch():
    """dim=-3 on (members, levels, y, x) equals the solve of each column."""
    rng = np.random.default_rng(1)
    shape = (2, 7, 3, 4)
    a, c = (torch.as_tensor(rng.uniform(-0.3, -0.1, shape)) for _ in "ac")
    b = torch.as_tensor(rng.uniform(2.0, 3.0, shape))
    d = torch.as_tensor(rng.standard_normal(shape))
    x = dycore_si._thomas_solve(a, b, c, d, dim=-3)
    for m in range(2):
        x_m = dycore_si._thomas_solve(*(t[m] for t in (a, b, c, d)), dim=0)
        torch.testing.assert_close(x[m], x_m, rtol=0, atol=0)


def _init(grid, dom):
    """float32 numpy fields: the balanced state of the grid's levels with
    the [domain] qv profile, ρθ noise of 0.5 K·ρ and 2 m/s winds."""
    qv = dom["qv_surface"] * np.exp(-grid.cz / 3000.0)
    s, rho_ref, p_ref = ideal.balanced_state(
        grid.nz, grid.ny, grid.nx, float(grid.fz[1] - grid.fz[0]),
        qv_prof=qv, cz=grid.cz)
    rng = np.random.default_rng(2)
    fields = [f.numpy().copy() for f in s]
    shape = fields[0].shape
    fields[1] += (2.0 * rng.standard_normal(shape) * fields[0]).astype(np.float32)
    fields[2] += (2.0 * rng.standard_normal(shape) * fields[0]).astype(np.float32)
    fields[4] += (0.5 * rng.standard_normal(shape) * fields[0]).astype(np.float32)
    return fields, rho_ref.numpy(), p_ref.numpy()


def _port_steps(fields, dycfg, vg, rho_ref, p_ref, zc, n_small, nsteps):
    split = dycore_si.SplitConfig(dtau=dycfg.dt / n_small)
    out = dycore_si.integrate_si(
        dycore_state_to_torch(fields, CPU), dycfg, split,
        torch.from_numpy(rho_ref), torch.from_numpy(p_ref),
        torch.from_numpy(zc), nsteps, n_small, vg)
    return dycore_state_to_numpy(out)


def test_rk3_step_si_matches_reference_on_coarsened_18km():
    cfg_r, grid_r, dycfg_r, dom = ref_load(CONFIG, COARSE)
    _, grid, dycfg, _ = load_config_and_grid(CONFIG, COARSE)
    assert dataclasses.asdict(dycfg) == {
        k: v for k, v in dataclasses.asdict(dycfg_r).items()
        if k != "advection"}
    n_small, nsteps = dom["n_small"], 2
    fields, rho_ref, p_ref = _init(grid, dom)
    zc = np.asarray(grid.cz, np.float32)
    vg_r = ref.make_vgrid(grid_r.cz, grid_r.fz)
    vg = vgrid_to_torch(vg_r, CPU)

    split_r = ref_si.SplitConfig(dtau=dycfg_r.dt / n_small)
    s = ref.DycoreState(*(jnp.asarray(f) for f in fields))
    for _ in range(nsteps):
        s = ref_si.rk3_step_si(s, dycfg_r, split_r, jnp.asarray(rho_ref),
                               jnp.asarray(p_ref), jnp.asarray(zc), n_small,
                               vg_r)
    expect = [np.asarray(f) for f in s]

    out = _port_steps(fields, dycfg, vg, rho_ref, p_ref, zc, n_small, nsteps)
    rng = np.random.default_rng(3)
    rounded = [(f * (1.0 + 2.0 ** -24 * rng.standard_normal(f.shape))
                ).astype(np.float32) for f in fields]
    out_rounded = _port_steps(rounded, dycfg, vg, rho_ref, p_ref, zc,
                              n_small, nsteps)
    for name, a, b, c, f0 in zip(dycore.DycoreState._fields, expect, out,
                                 out_rounded, fields):
        assert np.isfinite(b).all(), name
        scale = 1e-4 * np.abs(a - f0).max()
        floor = np.abs(c - b).max()
        err = np.abs(b - a).max()
        assert err <= scale + 2 * floor, (
            f"{name}: {err:.3e} > 1e-4·increment {scale:.3e} "
            f"+ 2·floor {floor:.3e}")


@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "batch"])
@pytest.mark.parametrize("metric", ["uniform", "stretched"])
@pytest.mark.parametrize("lateral", ["periodic", "open"])
def test_acoustic_substeps_cpu_takes_the_plain_path(lateral, metric, lead):
    """acoustic_substeps on CPU tensors is acoustic_substeps_plain bit for
    bit (a single member and a batch, both lateral modes, uniform and
    stretched levels), and launches no kernel."""
    start, s, slow, cfg, vg = gpu_check.acoustic_operands(
        lead, 12, 16, 20, CPU, lateral, metric)
    split = dycore_si.SplitConfig(dtau=cfg.dt / 4)
    kernels.reset_launches()
    out = dycore_si.acoustic_substeps(start, s, slow, cfg, split, 4, cfg.dt,
                                      vg)
    ref = dycore_si.acoustic_substeps_plain(start, s, slow, cfg, split, 4,
                                            cfg.dt, vg)
    assert kernels.LAUNCHES["acoustic_substep"] == 0
    for name, a, b in zip(dycore.DycoreState._fields, out, ref):
        assert torch.equal(a, b), name
        assert bool(torch.isfinite(a).all()), name
    assert not torch.equal(out.rhow, s.rhow)


def test_acoustic_substeps_kernel_refuses_cpu_tensors():
    start, s, slow, cfg, vg = gpu_check.acoustic_operands(
        (2,), 12, 16, 20, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        dycore_si.acoustic_substeps_kernel(
            start, s, slow, cfg, dycore_si.SplitConfig(dtau=0.5), 4, cfg.dt)
