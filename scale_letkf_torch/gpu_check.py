"""The analysis and the forecast of a coarsened configuration on the GPU
against the same runs on the CPU.

chip_smoke.py and tests/test_torch_cuda.py both run them. On the CPU the
kernels' wrappers run their plain versions, which the CPU tests hold
against the reference package.

- Analysis: the config coarsened to 24×20×4 with K = 20 (float32, so the
  solver is the CUDA kernel), seeded numpy inputs. Increments per variable
  must agree to 1e-4·max|Δ_v| + 2 ulp of max|field_v|, the tolerance of
  the CPU parity test of the whole slice.
- Forecast: the config coarsened to 32×24×12 (stretched levels, its core,
  substeps and dt) with K = 4 for 3 steps, from one synthetic ensemble
  (u0 = 10 m/s) made on the CPU; on the card every slow tendency runs the
  two stencil kernels. The float32 forecast amplifies rounding: p′ is the
  difference of two pressures near 1e5 Pa, and the acoustic substeps carry
  its last bits into the winds. Inputs perturbed by one rounding
  (relative 2⁻²⁴·N(0,1)) move the CPU run's winds by up to 6.4·1e-4 of
  their increments after 3 steps. So per field the bound is
  1e-4·max|increment| plus twice that rounding floor, measured in the same
  call: the card must agree with the CPU as closely as the CPU agrees with
  itself.
"""

from __future__ import annotations

import numpy as np
import torch

from scale_letkf_torch.cli.main import load_config_and_grid
from scale_letkf_torch.da.letkf import analyze
from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.state import V3D_ANAL_NAMES
from scale_letkf_torch.synthetic import (
    synthetic_conv_network, synthetic_ens_dycore_device, synthetic_gues,
)
from scale_letkf_torch.utils import kernels

COARSE = {"nx": 24, "ny": 20, "nz": 4}
MEMBERS = 20
COARSE_FCST = {"nx": 32, "ny": 24, "nz": 12}
MEMBERS_FCST = 4
STEPS_FCST = 3


def coarse_analysis_vs_cpu(device: torch.device, config: str,
                           seed: int = 0) -> dict:
    """Runs the coarsened analysis on `device` and on the CPU. Returns the
    worst |Δ increment| over its tolerance per variable (≤ 1 passes), the
    kernel launches on each device and whether the GPU analysis is finite."""
    cfg, grid, _, _ = load_config_and_grid(config, COARSE)
    cfg.ensemble.member = K = MEMBERS
    rng = np.random.default_rng(seed)
    gues = synthetic_gues(rng, K, grid.nz, grid.ny, grid.nx, grid.cz)
    obs = synthetic_conv_network(cfg, grid, rng, n_sonde=30, n_ps=60)
    ensval = (obs.dat[None] + rng.standard_normal((K, obs.nobs))
              * obs.err[None]).astype(np.float32)
    ctx = build_obs_context(obs, ensval, np.zeros(obs.nobs, np.int32), cfg,
                            grid)
    anal, launches = {}, {}
    for dev in (device, torch.device("cpu")):
        before = kernels.LAUNCHES["invsqrt_ns"]
        a, _ = analyze(torch.as_tensor(gues, device=dev), ctx, cfg, grid,
                       grid.calc_z(torch.zeros((grid.ny, grid.nx), device=dev)),
                       device=dev)
        anal[dev.type] = a.cpu().numpy()
        launches[dev.type] = kernels.LAUNCHES["invsqrt_ns"] - before
    err = {}
    for v, name in enumerate(V3D_ANAL_NAMES):
        inc = anal[device.type][:, v] - gues[:, v]
        inc_cpu = anal["cpu"][:, v] - gues[:, v]
        tol = (1e-4 * np.abs(inc_cpu).max()
               + 2 * np.spacing(np.abs(gues[:, v]).max()))
        err[name] = float(np.abs(inc - inc_cpu).max() / tol)
    return {"grid": "{nx}x{ny}x{nz}".format(**COARSE), "members": K,
            "levels": grid.nz, "kernel_launches": launches,
            "finite": bool(np.isfinite(anal[device.type]).all()),
            "max_err_over_tol": err}


def coarse_forecast_vs_cpu(device: torch.device, config: str,
                           seed: int = 0) -> dict:
    """Runs the coarsened forecast on `device` and twice on the CPU (from
    the inputs and from the inputs perturbed by one rounding). Returns the
    worst |Δ| over its tolerance per field (≤ 1 passes), the rounding floor,
    the launches of each stencil kernel on each device, the member batch
    and whether the GPU forecast is finite."""
    from scale_letkf_torch.cli.main import make_driver
    cfg, grid, dycfg, dom = load_config_and_grid(config, COARSE_FCST)
    cpu = torch.device("cpu")
    ens0, _, _ = synthetic_ens_dycore_device(seed, MEMBERS_FCST, grid, dom,
                                             cpu, u0=10.0)
    gen = torch.Generator().manual_seed(seed + 1)
    ens_rounded = type(ens0)(*(f * (1.0 + 2.0 ** -24 * torch.randn(
        f.shape, generator=gen)) for f in ens0))
    out, launches, batch = {}, {}, {}
    for key, dev, init in ((device.type, device, ens0), ("cpu", cpu, ens0),
                           ("cpu_rounded", cpu, ens_rounded)):
        driver = make_driver(cfg, grid, dycfg, dom, dev)
        before = dict(kernels.LAUNCHES)
        res = driver.forecast(type(init)(*(f.to(dev) for f in init)),
                              STEPS_FCST)
        out[key] = [f.cpu().numpy() for f in res]
        launches[key] = {k: kernels.LAUNCHES[k] - before[k]
                         for k in ("dyn_tendency", "adv_ud3")}
        batch[key] = driver.batch
    err, floor = {}, {}
    for name, a, b, c, f0 in zip(ens0._fields, out[device.type], out["cpu"],
                                 out["cpu_rounded"], ens0):
        scale = 1e-4 * np.abs(b - f0.numpy()).max()
        floor[name] = float(np.abs(c - b).max() / scale)
        err[name] = float(np.abs(a - b).max() / (scale * (1 + 2 * floor[name])))
    return {"grid": "{nx}x{ny}x{nz}".format(**COARSE_FCST),
            "members": MEMBERS_FCST, "steps": STEPS_FCST,
            "member_batch": batch, "kernel_launches": launches,
            "rounding_floor_over_1e-4_increment": floor,
            "finite": all(bool(np.isfinite(f).all())
                          for f in out[device.type]),
            "max_err_over_tol": err}
