"""Checks of the port on the GPU that chip_smoke.py and
tests/test_torch_cuda.py share: the two stencil kernels against their plain
versions at ragged and tiny shapes, and the analysis and the forecast of a
coarsened configuration on the GPU against the same runs on the CPU. On
the CPU the kernels' wrappers run their plain versions, which the CPU tests
hold against the reference package.

- Stencil kernels: random states (seeded numpy) at the shapes of
  RAGGED_SHAPES — tiles cut by the edge, axes narrower than a tile and its
  halo, so the periodic halo wraps more than once — with the uniform and
  the 18-km stretched metric, divdmp 0 / 0.05 and kdiff4 0 / 1e-3, and
  1 or 6 tracers. Bounds per field, relative to max|plain|: TOL_TENDENCY
  and TOL_STENCIL, the reference's bounds for its Pallas kernels against
  its XLA path (tests/test_pallas_tendency.py:53,
  tests/test_pallas_stencil.py:43).

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
- Cycle: CycleDriver.run_osse, 1 cycle of STEPS_CYCLE steps, at the
  forecast's coarsened sizes with K = 20 (so the analysis solver is the
  CUDA kernel too), from synthetic ensemble and nature states made on the
  CPU and a synthetic conventional network; the same bound as the forecast
  per field of the final ensemble and nature state, and the obs QC equal.
  Then the ensemble H(x) alone, on seeded analysis ensembles with
  hydrometeors (half zero, up to ~4 g/kg) and a mix of conventional and
  radar obs (a site at the domain's center, 20-200 km away): a 3-slot 4-D
  window (obsope_slots) and every METHOD_REF_CALC with and without the
  terminal velocity (obsope_ensemble). H(x) per element within 2e-5 of its
  range over the obs plus 4 float32 ulp of its largest magnitude (12 for
  PS), the bound of the CPU parity tests; QC equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scale_letkf_torch.cli.main import load_config_and_grid
from scale_letkf_torch.da.letkf import analyze
from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.da.obsope import (
    assign_slots, obsope_ensemble, obsope_slots,
)
from scale_letkf_torch.model import dycore
from scale_letkf_torch.obs.types import (
    ID_PS, ID_RADAR_REF, ID_RADAR_VR, OBELM_NAMES, TYP_PHARAD, Observations,
    uid_obs,
)
from scale_letkf_torch.ops import stencil, tendency
from scale_letkf_torch.state import (
    IA_Q0, NQ, NV3D, V3D_ANAL_NAMES, state_to_history, state_trans,
)
from scale_letkf_torch.synthetic import (
    smooth_noise, synthetic_conv_network, synthetic_ens_dycore_device,
    synthetic_gues,
)
from scale_letkf_torch.utils import kernels

TOL_TENDENCY = 2e-5
TOL_STENCIL = 1e-5
RAGGED_SHAPES = ((1, 2, 2, 2), (1, 3, 3, 5), (2, 5, 17, 70), (2, 12, 40, 64))
DX, DT = 18000.0, 30.0          # the 18-km configuration's dx = dy and dt
COARSE = {"nx": 24, "ny": 20, "nz": 4}
MEMBERS = 20
COARSE_FCST = {"nx": 32, "ny": 24, "nz": 12}
MEMBERS_FCST = 4
STEPS_FCST = 3
MEMBERS_CYCLE = 20
STEPS_CYCLE = 2
KERNELS = ("invsqrt_ns", "dyn_tendency", "adv_ud3")


def random_dyn_state(seed: int, B: int, nz: int, ny: int, nx: int,
                     device: torch.device, nq: int = 6):
    """Random states of the tests/test_pallas_tendency.py construction
    (numpy, seeded): a hydrostatic column with 1% noise, winds ≈ 5 m/s of
    both signs, ρw zero at the rigid faces, tracers ≈ 1e-3 of ρ. Returns
    (DycoreState, rho_ref, p_pert) with p′ from the moist pressure."""
    rng = np.random.default_rng(seed)
    theta = 300.0 + 10.0 * np.linspace(0, 1, nz)
    rho1d, p1d = dycore.hydrostatic_reference(theta, 500.0)
    shape = (B, nz, ny, nx)
    rho = rho1d[:, None, None] * (1.0 + 0.01 * rng.standard_normal(shape))
    rhow = 0.5 * rng.standard_normal((B, nz + 1, ny, nx))
    rhow[:, 0] = rhow[:, -1] = 0.0
    fields = (rho, 5.0 * rng.standard_normal(shape) * rho,
              5.0 * rng.standard_normal(shape) * rho, rhow,
              rho * theta[:, None, None]
              * (1 + 0.01 * rng.standard_normal(shape)),
              np.abs(1e-3 * rng.standard_normal((B, nq) + shape[1:]))
              * rho[:, None])
    s = dycore.DycoreState(*(torch.as_tensor(f, dtype=torch.float32,
                                             device=device) for f in fields))

    def col(a):
        return torch.as_tensor(np.asarray(a)[:, None, None],
                               dtype=torch.float32, device=device)

    p_pert = dycore.moist_pressure(s.rhot, dycore.mixing_ratios(s)) - col(p1d)
    return s, col(rho1d), p_pert


def metrics(nz: int, device: torch.device) -> dict:
    """The 18-km configuration's vertical metrics at nz levels: uniform
    300-m levels and its stretched levels (300 m × 1.04ᵏ)."""
    fz = np.concatenate([[0.0], np.cumsum(300.0 * 1.04 ** np.arange(nz))])
    return {"uniform": dycore.uniform_vgrid(nz, 300.0, device),
            "stretched": dycore.make_vgrid(0.5 * (fz[1:] + fz[:-1]), fz,
                                           device)}


def dyn_operands(s, rho_ref, p_pert, vg, divdmp: float, kdiff4: float):
    return (s.rho, s.rhou, s.rhov, s.rhow, s.rhot, p_pert, rho_ref, vg.dzc,
            vg.dzf, DX, DX, kdiff4, divdmp, DT)


def adv_operands(s, vg, kdiff4: float):
    return (s.rhoq, s.rho, s.rhou, s.rhov, s.rhow, vg.dzc, DX, DX, kdiff4)


def rel_errors(out, ref) -> list[float]:
    """Per field: max|kernel − plain| / max|plain|."""
    return [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(out, ref)]


def stencil_cases(B: int, nz: int, ny: int, nx: int, device: torch.device,
                  seed: int = 0):
    """Yields (kernel name, case label, tolerance, kernel function, plain
    function, operands) for every case of one shape: dyn_tendency under
    both metrics, divdmp 0 / 0.05 and kdiff4 0 / 1e-3; adv_ud3 with 1 and
    6 tracers under both metrics and kdiff4 0 / 1e-3."""
    s, rho_ref, p_pert = random_dyn_state(seed, B, nz, ny, nx, device)
    for metric, vg in metrics(nz, device).items():
        for divdmp in (0.0, 0.05):
            for kdiff4 in (0.0, 1e-3):
                yield ("dyn_tendency",
                       f"{metric}, divdmp {divdmp}, kdiff4 {kdiff4}",
                       TOL_TENDENCY, tendency.dyn_tendencies_kernel,
                       tendency.dyn_tendencies_plain,
                       dyn_operands(s, rho_ref, p_pert, vg, divdmp, kdiff4))
        for nq in (1, 6):
            sq = s._replace(rhoq=s.rhoq[:, :nq].contiguous())
            for kdiff4 in (0.0, 1e-3):
                yield ("adv_ud3", f"{metric}, nq {nq}, kdiff4 {kdiff4}",
                       TOL_STENCIL, stencil.adv_flux_divergence_kernel,
                       stencil.adv_flux_divergence_plain,
                       adv_operands(sq, vg, kdiff4))


def ragged_kernels_vs_plain(device: torch.device, kernel_name: str,
                            shapes=RAGGED_SHAPES, seed: int = 0) -> list:
    """Stencil kernel `kernel_name` against its plain version on every case
    of every shape of `shapes`, the kernel run twice (a race shows as a
    mismatch that comes and goes). Returns one row per case with the worst
    relative error over the fields and both runs (≤ tol passes)."""
    rows = []
    for shape in shapes:
        for name, label, tol, kernel, plain, args in stencil_cases(
                *shape, device, seed):
            if name != kernel_name:
                continue
            ref = plain(*args)
            ref = ref if isinstance(ref, tuple) else (ref,)
            errs = []
            for _ in range(2):
                out = kernel(*args)
                errs += rel_errors(out if isinstance(out, tuple) else (out,),
                                   ref)
            rows.append({"kernel": name, "shape": list(shape), "case": label,
                         "tol": tol, "rel_err": max(errs),
                         "finite": all(np.isfinite(errs))})
    return rows


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


def var_local_groups(cfg) -> int:
    """The analysis's var-local groups: each is one solver launch per level
    chunk."""
    return len(dict.fromkeys(
        tuple(col) for col in cfg.var_local.table(NV3D).T.tolist()))


def expected_launches(cfg, grid, steps: int, batches: int,
                      chunk: int) -> dict:
    """Launches of each kernel in one run_osse cycle on the card: 3 RK
    stages × steps × (the ensemble's member batches + the nature run's
    one) for both stencil kernels; levels × chunks per level × var-local
    groups for the solver."""
    fcst = 3 * steps * (batches + 1)
    return {"invsqrt_ns": grid.nz * -(-grid.ny * grid.nx // chunk)
            * var_local_groups(cfg),
            "dyn_tendency": fcst, "adv_ud3": fcst}


def osse_vs_cpu(device: torch.device, config: str, seed: int = 0) -> dict:
    """One run_osse cycle at the coarsened sizes on `device` and twice on
    the CPU (from the inputs and from the inputs perturbed by one
    rounding). Returns the worst |Δ| over its tolerance per field of the
    final ensemble and nature state (≤ 1 passes), the rounding floor, the
    launches of each kernel against the expected ones, whether the obs QC
    is equal and whether the run on `device` is finite."""
    from scale_letkf_torch.cli.main import make_driver
    cfg, grid, dycfg, dom = load_config_and_grid(config, COARSE_FCST)
    cfg.ensemble.member = K = MEMBERS_CYCLE
    cpu = torch.device("cpu")
    ens0, _, _ = synthetic_ens_dycore_device(seed, K, grid, dom, cpu,
                                             u0=10.0)
    nat, _, _ = synthetic_ens_dycore_device(seed + 1, 1, grid, dom, cpu,
                                            u0=10.0)
    truth0 = type(nat)(*(f[0] for f in nat))
    template = synthetic_conv_network(cfg, grid, np.random.default_rng(seed),
                                      n_sonde=30, n_ps=60)
    gen = torch.Generator().manual_seed(seed + 2)

    def rounded(s):
        return type(s)(*(f * (1.0 + 2.0 ** -24 * torch.randn(
            f.shape, generator=gen)) for f in s))

    runs = {}
    for key, dev, t0, e0 in (("device", device, truth0, ens0),
                             ("cpu", cpu, truth0, ens0),
                             ("cpu_rounded", cpu, rounded(truth0),
                              rounded(ens0))):
        driver = make_driver(cfg, grid, dycfg, dom, dev)
        before = dict(kernels.LAUNCHES)
        truth, ens, res = driver.run_osse(
            type(t0)(*(f.to(dev) for f in t0)),
            type(e0)(*(f.to(dev) for f in e0)), template, n_cycles=1,
            steps_per_cycle=STEPS_CYCLE, seed=seed)
        runs[key] = {
            "state": [f.cpu().numpy() for f in (*ens, *truth)],
            "qc": res.info["obsdep"].qc, "nobs": res.nobs[0],
            "launches": {k: kernels.LAUNCHES[k] - before[k]
                         for k in KERNELS},
            "expected": expected_launches(cfg, grid, STEPS_CYCLE,
                                          -(-K // driver.batch),
                                          res.info["diag"].chunk)}
    names = ([f"ens.{n}" for n in ens0._fields]
             + [f"nature.{n}" for n in truth0._fields])
    err, floor = {}, {}
    for name, a, b, c, f0 in zip(names, runs["device"]["state"],
                                 runs["cpu"]["state"],
                                 runs["cpu_rounded"]["state"],
                                 (*ens0, *truth0)):
        scale = 1e-4 * np.abs(b - f0.numpy()).max()
        floor[name] = float(np.abs(c - b).max() / scale)
        err[name] = float(np.abs(a - b).max() / (scale * (1 + 2 * floor[name])))
    return {"grid": "{nx}x{ny}x{nz}".format(**COARSE_FCST), "members": K,
            "steps": STEPS_CYCLE, "nobs": runs["device"]["nobs"],
            "kernel_launches": {k: runs[k]["launches"]
                                for k in ("device", "cpu")},
            "expected_launches": runs["device"]["expected"],
            "qc_equal": bool(np.array_equal(runs["device"]["qc"],
                                            runs["cpu"]["qc"])),
            "rounding_floor_over_1e-4_increment": floor,
            "finite": all(bool(np.isfinite(f).all())
                          for f in runs["device"]["state"]),
            "max_err_over_tol": err}


def hydrometeor_analysis(seed: int, K: int, grid, dom) -> torch.Tensor:
    """(K, NV3D, nz, ny, nx) analysis variables on the CPU: the synthetic
    restart ensemble (u0 = 10 m/s) with hydrometeors qc..qg of smoothed
    seeded noise, half zero, up to ~4 g/kg."""
    ens, _, _ = synthetic_ens_dycore_device(seed, K, grid, dom,
                                            torch.device("cpu"), u0=10.0)
    anal = state_trans(dycore.to_collocated(ens))
    rng = np.random.default_rng(seed)
    for v in range(IA_Q0 + 1, IA_Q0 + NQ):
        anal[:, v] = torch.from_numpy(np.maximum(smooth_noise(
            rng, (K, grid.nz, grid.ny, grid.nx)), 0.0) * 2e-3)
    return anal


def mixed_obs(cfg, grid, seed: int, n_radar: int = 200,
              dif_span: float = 0.0) -> Observations:
    """A synthetic conventional network (20 sondes, 40 PS) and radar
    reflectivity and radial velocity obs 20-200 km from a site at the
    domain's center, 300 m - 6 km high; dif uniform in ±dif_span."""
    rng = np.random.default_rng(seed)
    conv = synthetic_conv_network(cfg, grid, rng, n_sonde=20, n_ps=40)
    site = (grid.proj.basepoint_lon, grid.proj.basepoint_lat, 0.0)
    dist = rng.uniform(20e3, 200e3, n_radar)
    ang = rng.uniform(0.0, 2 * np.pi, n_radar)
    radar = Observations(
        elem=np.where(np.arange(n_radar) % 2 == 0, ID_RADAR_REF, ID_RADAR_VR),
        lon=site[0] + dist * np.sin(ang) / (111e3 * np.cos(np.radians(
            site[1]))),
        lat=site[1] + dist * np.cos(ang) / 111e3,
        lev=rng.uniform(300.0, 6e3, n_radar), dat=np.zeros(n_radar),
        err=np.ones(n_radar), typ=np.full(n_radar, TYP_PHARAD),
        dif=np.zeros(n_radar), meta=np.asarray(site))
    obs = Observations.concatenate([conv, radar])
    obs.dif = rng.uniform(-dif_span, dif_span, obs.nobs)
    return obs


def hx_vs_cpu(hx, hx_cpu, elem) -> dict:
    """One ensemble H(x) against the CPU's: whether the QC is equal and, per
    element of the obs the CPU passes, max|Δ| over 2e-5 of the element's
    range plus 4 float32 ulp of its largest magnitude (12 for PS)."""
    y, y_cpu = hx.ensval.cpu().numpy(), hx_cpu.ensval.numpy()
    good = hx_cpu.qc == 0
    err = {}
    for e in np.unique(elem[good]):
        m = good & (elem == e)
        a, b = y[:, m], y_cpu[:, m]
        tol = (2e-5 * np.ptp(b) + (12 if e == ID_PS else 4)
               * np.spacing(np.float32(np.abs(b).max())))
        err[OBELM_NAMES[int(uid_obs(e)[0])]] = float(np.abs(a - b).max()
                                                      / tol)
    return {"qc_equal": bool(np.array_equal(hx.qc, hx_cpu.qc)),
            "good_obs": int(good.sum()),
            "finite": bool(np.isfinite(y[:, good]).all()),
            "max_err_over_tol": err}


def hx_slots_vs_cpu(device: torch.device, config: str, seed: int = 0,
                    members: int = 4) -> dict:
    """obsope_slots on a 3-slot window (600-s slots, base 2; obs dif within
    ±1200 s, so some fall outside it) at the coarsened sizes, the history
    on the host as forecast_slots keeps it, on `device` against the CPU."""
    cfg, grid, _, dom = load_config_and_grid(config, COARSE_FCST)
    for k, v in dict(slot_start=1, slot_end=3, slot_base=2,
                     slot_tinterval=600.0).items():
        setattr(cfg.obsope, k, v)
    hist = torch.stack([hydrometeor_analysis(seed + 10 + s, members, grid,
                                             dom) for s in range(3)], dim=1)
    obs = mixed_obs(cfg, grid, seed, dif_span=1200.0)
    slots = assign_slots(obs.dif, cfg)
    out = {}
    for key, dev in (("device", device), ("cpu", torch.device("cpu"))):
        z = grid.calc_z(torch.zeros((grid.ny, grid.nx), device=dev))
        out[key] = obsope_slots(hist, obs, grid, cfg, z, None, slots)
    return {"slots": 3, "members": members, "nobs": obs.nobs,
            "outside_window": int(((slots < 1) | (slots > 3)).sum()),
            **hx_vs_cpu(out["device"], out["cpu"], obs.elem)}


def radar_hx_vs_cpu(device: torch.device, config: str, seed: int = 0,
                    members: int = 4) -> list:
    """Ensemble H(x) of the mixed obs with every METHOD_REF_CALC, with and
    without the terminal velocity, at the coarsened sizes on `device`
    against the CPU. One row per case."""
    cfg, grid, _, dom = load_config_and_grid(config, COARSE_FCST)
    anal = hydrometeor_analysis(seed, members, grid, dom)
    obs = mixed_obs(cfg, grid, seed + 1)
    fields, z = {}, {}
    for key, dev in (("device", device), ("cpu", torch.device("cpu"))):
        z[key] = grid.calc_z(torch.zeros((grid.ny, grid.nx), device=dev))
        fields[key] = state_to_history(anal.to(dev), z[key])
    rows = []
    for method in (1, 2, 3):
        for tv in (False, True):
            cfg.radar = dataclasses.replace(cfg.radar, method_ref_calc=method,
                                            use_terminal_velocity=tv)
            hx = {k: obsope_ensemble(fields[k], obs, grid, cfg, z[k])
                  for k in fields}
            rows.append({"method": method, "terminal_velocity": tv,
                         **hx_vs_cpu(hx["device"], hx["cpu"], obs.elem)})
    return rows


def coarse_cycle_vs_cpu(device: torch.device, config: str,
                        seed: int = 0) -> dict:
    """The coarsened cycle on `device` against the CPU: run_osse
    (osse_vs_cpu), the 4-D obs operator (hx_slots_vs_cpu) and radar H(x)
    with every reflectivity method (radar_hx_vs_cpu)."""
    return {"osse": osse_vs_cpu(device, config, seed),
            "slots": hx_slots_vs_cpu(device, config, seed),
            "radar": radar_hx_vs_cpu(device, config, seed)}


def cycle_check_passes(res: dict) -> bool:
    """Whether coarse_cycle_vs_cpu's result passes: finite, every kernel
    launched as expected on the device and never on the CPU, every error
    within its bound, the QC equal and radar obs assimilable."""
    osse = res["osse"]
    launches = osse["kernel_launches"]
    hx = [res["slots"], *res["radar"]]
    return (osse["finite"] and osse["qc_equal"]
            and launches["device"] == osse["expected_launches"]
            and not any(launches["cpu"].values())
            and all(e <= 1 for e in osse["max_err_over_tol"].values())
            and all(r["finite"] and r["qc_equal"] and r["good_obs"] > 0
                    and {"REF", "Vr"} <= set(r["max_err_over_tol"])
                    and all(e <= 1 for e in r["max_err_over_tol"].values())
                    for r in hx))
