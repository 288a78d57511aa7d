"""Checks of the port on the GPU that chip_smoke.py and
tests/test_torch_cuda.py share: the two stencil kernels against their plain
versions at ragged and tiny shapes, and the analysis and the forecast of a
coarsened configuration on the GPU against the same runs on the CPU. On
the CPU the kernels' wrappers run their plain versions, which the CPU tests
hold against the reference package.

- Stencil kernels: random states (seeded numpy) at the shapes of
  RAGGED_SHAPES — tiles cut by the edge, axes narrower than a tile and its
  halo, so the periodic halo wraps more than once and the open one clamps
  to an edge cell it shares with the other side — with the uniform and
  the 18-km stretched metric, divdmp 0 / 0.05 and kdiff4 0 / 1e-3, and
  1 or 6 tracers, in either lateral mode. Bounds per field, relative to
  max|plain|: TOL_TENDENCY and TOL_STENCIL, the reference's bounds for its
  Pallas kernels against its XLA path (tests/test_pallas_tendency.py:53,
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
- Physics modules: each scheme alone (Kessler and NSW6 on stretched
  levels, radiation, the surface layer, the PBL step, three physics-suite
  steps) on physics_state's small seeded states (3 members, 8 levels),
  at the bounds of tests/test_torch_physics.py — a returned state per field
  to 1e-4·max|increment| plus 4 ulp of max|field|, a diagnostic or
  tendency to 3e-5 of its largest magnitude plus 4 ulp — plus twice the
  CPU's own rounding floor, as the forecast's: the surface fluxes move by
  up to 2.4e-4 of their largest value when their inputs are rounded once
  (a bulk Richardson number of near-equal virtual temperatures).
- Physics paths: the physics-suite forecast of the 18-km configuration
  (nsw6, radiation every 10 physics steps, slab capacity 2e5) at 32×24
  columns and its 36 levels, K = 4, with Davies relaxation (3-cell buffer)
  toward per-member boundary data, two forecasts (7 steps, then 3) that
  thread the slab skin temperature; the Kessler forecast of
  configs/bda_1km_radar.toml at 24×24 columns and its 48 levels, K = 4,
  over its 30-s window (15 steps) from an ensemble with rain blobs; and a
  run_osse cycle of that radar configuration (K = 20, 5 steps) whose obs
  are radar reflectivity and radial velocity made by obsmake from the
  nature run's blobs. Bounds as the forecast's (1e-4·max|increment| plus
  twice the CPU's own rounding floor, per field and for the skin
  temperature), the obs QC equal.
- Physics on a process grid: the physics-suite and Kessler forecasts above
  run a second time on the card on make_mesh(2, 2, 2) (GRID), which must
  give the undecomposed card run's state and skin temperature bit for bit
  (and so meet the CPU at its bounds too); grid_cycle_on_device runs the
  coarsened cycle (osse_vs_cpu's inputs) undecomposed and on GRID on the
  card, which must agree exactly — final ensemble, nature run, means,
  spreads and O−B / O−A.
- The executors on a process grid: fused_grid_on_device runs two
  FusedCycle steps of fused_vs_cpu's inputs, the second from the first's
  analysis and inflation, undecomposed and on GRID on the card (bit-equal
  in each cycle, launches per block and share);
  nested_grid_cycle_on_device the coarsened cycle's parent with a 24 × 24
  open child at ratio 3 on GRID against its open-mode composition (the
  undecomposed child stepping with the halo step of the whole ensemble,
  halo_dynamics), bit-equal; terrain_grid_step_on_device one explicit-core
  step over hills() on make_mesh(1, 2, 2) against rk3_step_terrain,
  bit-equal (its overlap variant within TOL_TENDENCY);
  streamed_grid_on_device two StreamedCycle cycles of streamed_vs_cpu's
  composition undecomposed and on GRID on the card, and
  streamed_verb_vs_cpu the cycle --streamed verb with a [process] table,
  each bit-equal to its undecomposed run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scale_letkf_torch.cli.main import _global, load_config_and_grid
from scale_letkf_torch.da.letkf import analyze
from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.da.obsope import (
    assign_slots, obsope_ensemble, obsope_slots,
)
from scale_letkf_torch.model import dycore
from scale_letkf_torch.model.boundary import BoundaryData
from scale_letkf_torch.obs.types import (
    ID_PS, ID_RADAR_REF, ID_RADAR_VR, OBELM_NAMES, TYP_PHARAD, Observations,
    uid_obs,
)
from scale_letkf_torch.ops import stencil, tendency
from scale_letkf_torch.state import (
    IA_Q0, NQ, NV3D, V3D_ANAL_NAMES, state_to_history, state_trans,
)
from scale_letkf_torch.synthetic import (
    base_boundary, smooth_noise, synthetic_conv_network,
    synthetic_ens_dycore_device, synthetic_gues, synthetic_h08_network,
)
from scale_letkf_torch.utils import kernels

TOL_TENDENCY = 2e-5
TOL_STENCIL = 1e-5
RAGGED_SHAPES = ((1, 2, 2, 2), (1, 3, 3, 5), (2, 5, 17, 70), (2, 12, 40, 64))
DX, DT = 18000.0, 30.0          # the 18-km configuration's dx = dy and dt
COARSE = {"nx": 24, "ny": 20, "nz": 4}
MEMBERS = 20
COARSE_FCST = {"nx": 32, "ny": 24, "nz": 12}
COARSE_PHYS = {"nx": 32, "ny": 24}
COARSE_RADAR = {"nx": 24, "ny": 24}
MEMBERS_PHYS = 4
# the reference bench's physics suite of the 18-km production composition
# (scale_letkf_tpu/bench_fullsize.py _make_fullsize_driver)
PHYS_PROD = {"mp_scheme": "nsw6", "rad_interval": 10,
             "slab_capacity": 2.0e5}
RADAR_STEPS = 15        # configs/bda_1km_radar.toml's 30-s window at dt 2 s
RADAR_QR_BLOB = 2e-3
MEMBERS_FCST = 4
STEPS_FCST = 3
MEMBERS_CYCLE = 20
STEPS_CYCLE = 2
KERNELS = ("invsqrt_ns", "dyn_tendency", "adv_ud3")
GRID = (2, 2, 2)        # (member, dy, dx) blocks of the grid checks


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


def dyn_operands(s, rho_ref, p_pert, vg, divdmp: float, kdiff4: float,
                 lateral: str = "periodic"):
    return (s.rho, s.rhou, s.rhov, s.rhow, s.rhot, p_pert, rho_ref, vg.dzc,
            vg.dzf, DX, DX, kdiff4, divdmp, DT, lateral)


def adv_operands(s, vg, kdiff4: float, lateral: str = "periodic"):
    return (s.rhoq, s.rho, s.rhou, s.rhov, s.rhow, vg.dzc, DX, DX, kdiff4,
            lateral)


def rel_errors(out, ref) -> list[float]:
    """Per field: max|kernel − plain| / max|plain|."""
    return [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(out, ref)]


def stencil_cases(B: int, nz: int, ny: int, nx: int, device: torch.device,
                  seed: int = 0, lateral: str = "periodic"):
    """Yields (kernel name, case label, tolerance, kernel function, plain
    function, operands) for every case of one shape in one lateral mode:
    dyn_tendency under both metrics, divdmp 0 / 0.05 and kdiff4 0 / 1e-3;
    adv_ud3 with 1 and 6 tracers under both metrics and kdiff4 0 / 1e-3."""
    s, rho_ref, p_pert = random_dyn_state(seed, B, nz, ny, nx, device)
    for metric, vg in metrics(nz, device).items():
        for divdmp in (0.0, 0.05):
            for kdiff4 in (0.0, 1e-3):
                yield ("dyn_tendency",
                       f"{metric}, divdmp {divdmp}, kdiff4 {kdiff4}",
                       TOL_TENDENCY, tendency.dyn_tendencies_kernel,
                       tendency.dyn_tendencies_plain,
                       dyn_operands(s, rho_ref, p_pert, vg, divdmp, kdiff4,
                                    lateral))
        for nq in (1, 6):
            sq = s._replace(rhoq=s.rhoq[:, :nq].contiguous())
            for kdiff4 in (0.0, 1e-3):
                yield ("adv_ud3", f"{metric}, nq {nq}, kdiff4 {kdiff4}",
                       TOL_STENCIL, stencil.adv_flux_divergence_kernel,
                       stencil.adv_flux_divergence_plain,
                       adv_operands(sq, vg, kdiff4, lateral))


def ragged_kernels_vs_plain(device: torch.device, kernel_name: str,
                            shapes=RAGGED_SHAPES, seed: int = 0,
                            lateral: str = "periodic") -> list:
    """Stencil kernel `kernel_name` against its plain version on every case
    of every shape of `shapes` in one lateral mode, the kernel run twice (a
    race shows as a mismatch that comes and goes). Returns one row per case
    with the worst relative error over the fields and both runs (≤ tol
    passes)."""
    rows = []
    for shape in shapes:
        for name, label, tol, kernel, plain, args in stencil_cases(
                *shape, device, seed, lateral):
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
                         "lateral": lateral, "tol": tol, "rel_err": max(errs),
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


def expected_launches(cfg, grid, steps: int, batches: int, chunk: int,
                      blocks: int = 1, shares=None, nature: int = 1) -> dict:
    """Launches of each kernel in one run_osse cycle on the card: 3 RK
    stages × steps × (the ensemble's member batches + the nature run's
    `nature` batches, one; none in a streamed cycle) for both stencil
    kernels; levels × chunks per level × var-local groups for the solver.
    On a process grid every batch runs on each of `blocks` blocks (the
    nature run stays undecomposed, a batch of one), and the solver runs per
    share of the gridpoints: shares, the (points, chunk) of each
    (AnalysisDiag.share_chunks). Physics — Kessler or the suite, on a grid
    too — is plain PyTorch and adds no launch."""
    fcst = 3 * steps * (batches * blocks + nature)
    shares = shares or [(grid.ny * grid.nx, chunk)]
    return {"invsqrt_ns": sum(grid.nz * -(-n // c) for n, c in shares)
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


def grid_cycle_on_device(device: torch.device, config: str,
                         seed: int = 0) -> dict:
    """osse_vs_cpu's cycle (its coarsened sizes, K = MEMBERS_CYCLE, its
    seeded inputs) on `device`, undecomposed and on the GRID process grid:
    whether the grid's final ensemble and nature run, the guess and
    analysis means and spreads and the O−B / O−A tables equal the
    undecomposed run's bit for bit, the largest difference, and the grid
    run's launches against expected_launches for its blocks and shares."""
    from scale_letkf_torch.cli.main import make_driver
    cfg, grid, dycfg, dom = load_config_and_grid(config, COARSE_FCST)
    cfg.ensemble.member = K = MEMBERS_CYCLE
    ens0, _, _ = synthetic_ens_dycore_device(seed, K, grid, dom, device,
                                             u0=10.0)
    nat, _, _ = synthetic_ens_dycore_device(seed + 1, 1, grid, dom, device,
                                            u0=10.0)
    truth0 = type(nat)(*(f[0] for f in nat))
    template = synthetic_conv_network(cfg, grid, np.random.default_rng(seed),
                                      n_sonde=30, n_ps=60)
    runs = {}
    for key, c in (("undecomposed", cfg), ("grid", _on_grid(cfg))):
        driver = make_driver(c, grid, dycfg, dom, device)
        before = dict(kernels.LAUNCHES)
        truth, ens, res = driver.run_osse(truth0, ens0, template, n_cycles=1,
                                          steps_per_cycle=STEPS_CYCLE,
                                          seed=seed)
        info = res.info
        runs[key] = {
            "arrays": [f.cpu() for f in (*_global(driver, ens), *truth)]
            + [info[k].cpu() for k in ("gues_mean", "gues_sprd",
                                       "anal_mean", "anal_sprd")],
            "stats": [(st.nobs, st.rmse, st.bias) for st in (
                res.stats_gues[0], res.stats_anal[0])],
            "launches": {k: kernels.LAUNCHES[k] - before[k]
                         for k in KERNELS},
            "expected": expected_launches(
                cfg, grid, STEPS_CYCLE, -(-(K // GRID[0]) // driver.batch),
                info["diag"].chunk, blocks=int(np.prod(GRID)),
                shares=info["diag"].share_chunks)
            if key == "grid" else None}
    a, b = runs["grid"]["arrays"], runs["undecomposed"]["arrays"]
    return {"grid": "{nx}x{ny}x{nz}".format(**COARSE_FCST), "members": K,
            "mesh": list(GRID), "steps": STEPS_CYCLE,
            "bit_equal": all(torch.equal(x, y) for x, y in zip(a, b)),
            "stats_equal": runs["grid"]["stats"] == runs["undecomposed"][
                "stats"],
            "max_abs_diff": max(float((x - y).abs().max())
                                for x, y in zip(a, b)),
            "kernel_launches": runs["grid"]["launches"],
            "expected_launches": runs["grid"]["expected"]}


BATCH_CASES = ((20, 1000, 768), (50, 1000, 4096))   # (K, L, B)
SUB_BATCHES = (7, 48, 96, 500)
EIGH_CASES = ((8, 4096), (16, 4096))                  # (K, B), K ≤ 16


def batch_invariance(device: torch.device, seed: int = 0) -> dict:
    """Whether the LETKF core's products over the obs give each matrix the
    same bits whatever the batch it is in (a chunk of the undecomposed
    analysis, or a grid share): on seeded (B, L, K) perturbation blocks,
    departures and K×K matrices, n rows (n..2n, or the last n) of a product
    of those n matrices against the same rows of the product of all B,
    per product, counted
    in mismatching elements. 'gram' (HδXᵀ·HδX), 'dep_block' (Pa·(HδXᵀ·
    the DEP_COLUMNS-wide departure block), letkf_core's form) and 'apply'
    (letkf_core.weight_update, analyze_points' weight application: each
    point's K×K weights on the variables' perturbations) and 'rtps' (the
    RTPS path's per-variable factor and weight application, rtps_factor
    and rtps_update) must be 0; the forms they replaced are reported beside
    them: 'matvec' (Pa·(HδXᵀ·d) as matrix-vector products),
    'apply_einsum' and 'rtps_einsum' (per-variable weights through an
    einsum over (v, b, k), the factor's sums as reductions). Three more:
    'det' (the deterministic member's increment Σ_k Xb'_k·transmd_k of
    letkf_core.det_increment), 'apply_1' and 'apply_2' (weight_update of a
    var-local group of one and of two variables), and, in the EIGH_CASES
    rows, 'eigh' (the K ≤ 16 solver: letkf_core's eigenpairs, Pa and W of
    seeded symmetric positive-definite matrices); 'det_einsum' (the
    increment as an einsum over (v, b, k)) beside them."""
    from scale_letkf_torch.ops.letkf_core import (
        DEP_COLUMNS, det_increment, rtps_factor, rtps_update, solve_eigh,
        total_weight, weight_update)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for K, L, B in BATCH_CASES:
        a = torch.randn(B, L, K, device=device, generator=gen)
        d = torch.randn(B, L, device=device, generator=gen)
        p = torch.randn(B, K, K, device=device, generator=gen)

        def block(s):
            cols = d.new_zeros((s.stop - s.start, L, DEP_COLUMNS))
            cols[..., 0] = d[s]
            return (p[s] @ (a[s].transpose(-1, -2) @ cols))[..., 0]

        x = torch.randn(NV3D, B, K, device=device, generator=gen)
        infl = torch.rand(B, device=device, generator=gen) + 1.0

        def rtps(s, einsum=False):
            pao = p[s] @ p[s].transpose(-1, -2)
            beta, transm = infl[s] - 1.0, d[s, :K]
            if einsum:
                var_g = torch.sum(x[:, s] * x[:, s], dim=-1)
                pa_xb = (pao @ x[:, s][..., None])[..., 0]
                m = torch.sqrt(var_g * infl[s] / torch.sum(x[:, s] * pa_xb,
                                                           dim=-1))
                w = total_weight(p[s] * m[..., None, None], transm, beta)
                return torch.einsum("vbk,vbkm->vbm", x[:, s],
                                    w).transpose(0, 1)
            m = rtps_factor(pao, x[:, s], infl[s], 0.9)
            return rtps_update(x[:, s], p[s], transm, beta,
                               m).transpose(0, 1)

        prods = {
            "rtps": rtps,
            "rtps_einsum": lambda s: rtps(s, einsum=True),
            "gram": lambda s: a[s].transpose(-1, -2) @ a[s],
            "apply": lambda s: weight_update(x[:, s], p[s]).transpose(0, 1),
            "apply_1": lambda s: weight_update(x[:1, s], p[s]).transpose(
                0, 1),
            "apply_2": lambda s: weight_update(x[:2, s], p[s]).transpose(
                0, 1),
            "det": lambda s: det_increment(x[:, s], d[s, :K]).transpose(0, 1),
            "det_einsum": lambda s: torch.einsum(
                "vbk,bk->vb", x[:, s], d[s, :K]).transpose(0, 1),
            "apply_einsum": lambda s: torch.einsum(
                "vbk,bkm->vbm", x[:, s], p[s]).transpose(0, 1),
            "dep_block": block,
            "matvec": lambda s: (p[s] @ (a[s].transpose(-1, -2)
                                         @ d[s][..., None]))[..., 0]}
        out[f"K{K}_L{L}_B{B}"] = _sub_batch_mismatches(prods, B)
    for K, B in EIGH_CASES:
        q = torch.randn(B, K, K, device=device, generator=gen)
        gram = q @ q.transpose(-1, -2) + K * torch.eye(K, device=device)

        def eigh(s):
            eival, eivec, pao, trans = solve_eigh(gram[s], K - 1)
            return torch.cat([eival[..., None], eivec, pao, trans], dim=-1)

        out[f"K{K}_B{B}"] = _sub_batch_mismatches({"eigh": eigh}, B)
    return out


def _sub_batch_mismatches(prods: dict, B: int) -> dict:
    """Per product f (of a slice of the B matrices): the elements of f(s)
    unequal to the same rows of f(all B), for each SUB_BATCHES size of s."""
    subs = {n: slice(n, 2 * n) if 2 * n <= B else slice(B - n, B)
            for n in SUB_BATCHES}
    row = {}
    for name, f in prods.items():
        full = f(slice(0, B))
        row[name] = {n: int((f(s) != full[s]).sum()) for n, s in subs.items()}
    return row


BATCH_INVARIANT = ("gram", "dep_block", "apply", "apply_1", "apply_2",
                   "rtps", "det", "eigh")


def batch_invariance_passes(res: dict) -> bool:
    """Whether every product the analysis uses (BATCH_INVARIANT) gave each
    matrix the same bits in every sub-batch."""
    return all(v == 0 for row in res.values()
               for name in BATCH_INVARIANT if name in row
               for v in row[name].values())


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


# --- physics ---------------------------------------------------------------
PHYS_SHAPE = (3, 8, 6, 10)      # members, levels, y, x of physics_state
PHYS_FZ = np.concatenate([[0.0], np.cumsum(1000.0 * 1.1 ** np.arange(8))])
PHYS_CZ = 0.5 * (PHYS_FZ[1:] + PHYS_FZ[:-1])


def _qsat_liq_np(t, p):
    es = 610.78 * np.exp(17.269 * (t - 273.15) / (t - 35.86))
    return 0.622 * es / np.maximum(p - 0.378 * es, 1.0)


def physics_state(seed: int = 0, layered: bool = False):
    """Seeded states for the physics schemes: (DycoreState of float32 numpy
    arrays, members leading; skin temperature (members, ny, nx)). 8 levels
    of 1 km × 1.1ᵏ (ztop ≈ 11 km: warm and cold air), θ = 300 K + 4 K/km
    with 0.5-K noise, 0.2% density noise, winds ±3 m/s about (5, 0), qv
    60-110% of liquid saturation, each hydrometeor zero in half the cells
    and up to a few g/kg in the rest (qs below 0.6 or above 1.5 g/kg, away
    from the riming gate at 1 g/kg); the skin 1.5-6 K above or below the
    lowest level's air. layered: θ steps of 1-4 K between levels, up or
    down at random, and qv 80% of the base column's saturation, so stable
    and unstable interfaces both occur, each well away from neutral."""
    K, nz, ny, nx = PHYS_SHAPE
    rng = np.random.default_rng(seed)
    theta1d = 300.0 + 0.004 * PHYS_CZ
    rho1d, p1d = dycore.hydrostatic_reference(theta1d, 1000.0, cz=PHYS_CZ)
    shape = (K, nz, ny, nx)
    kappa = dycore.RD / dycore.CPDRY

    def col(a):
        return np.asarray(a)[:, None, None]

    theta = col(theta1d) + 0.5 * rng.standard_normal(shape)
    rho = col(rho1d) * (1.0 + 0.002 * rng.standard_normal(shape))
    qsat = _qsat_liq_np(col(theta1d * (p1d / 1.0e5) ** kappa), col(p1d))
    qv = rng.uniform(0.6, 1.1, shape) * qsat
    if layered:
        step = rng.uniform(1.0, 4.0, shape) * rng.choice([-1.0, 1.0], shape)
        theta = 300.0 + np.cumsum(step, axis=1)
        qv = 0.8 * qsat * np.ones(shape)

    def sparse(lo, hi):
        q = rng.uniform(lo, hi, shape)
        return np.where(rng.random(shape) < 0.5, 0.0, q)

    qs = sparse(0.2e-3, 0.6e-3)
    qs = np.where(rng.random(shape) < 0.5, qs, sparse(1.5e-3, 3e-3))
    q = np.stack([qv, sparse(1e-4, 2e-3), sparse(1e-4, 3e-3),
                  sparse(1e-4, 1e-3), qs, sparse(1e-4, 2e-3)], axis=1)
    rhow = 0.05 * rng.standard_normal((K, nz + 1, ny, nx)) * col(
        np.r_[rho1d, rho1d[-1]])
    rhow[:, 0] = rhow[:, -1] = 0.0
    s = dycore.DycoreState(
        rho=rho, rhou=rho * (5.0 + 3.0 * rng.standard_normal(shape)),
        rhov=rho * 3.0 * rng.standard_normal(shape), rhow=rhow,
        rhot=rho * theta, rhoq=q * rho[:, None])
    s = dycore.DycoreState(*(np.asarray(f, np.float32) for f in s))
    t1 = s.rhot[:, 0] / s.rho[:, 0] * (p1d[0] / 1.0e5) ** kappa
    dt = rng.uniform(1.5, 6.0, (K, ny, nx)) * rng.choice([-1.0, 1.0],
                                                         (K, ny, nx))
    return s, (t1 + dt).astype(np.float32)


def _ulp(a: np.ndarray) -> float:
    return float(np.spacing(np.float32(np.abs(a).max())))


def _over_tol(a, b, tol, alt) -> float:
    """max|a − b| / (tol + 2·max|alt − b|): alt, b's run from inputs
    perturbed by one rounding, adds twice that floor to the bound."""
    a, b, alt = (np.asarray(x, np.float64) for x in (a, b, alt))
    return float(np.abs(a - b).max() / (tol + 2 * np.abs(alt - b).max()))


def state_over_tol(out, init, ref, alt) -> float:
    """Worst field of |out − ref| over 1e-4·max|ref − init| + 4 ulp(max|ref|)
    plus twice the rounding floor."""
    return max(_over_tol(a, b, 1e-4 * np.abs(np.asarray(b, np.float64)
                                             - np.asarray(f0)).max()
                         + 4 * _ulp(b), c)
               for a, f0, b, c in zip(out, init, ref, alt))


def diag_over_tol(outs, refs, alts) -> float:
    """Worst output of |out − ref| over 3e-5·max|ref| + 4 ulp(max|ref|)
    plus twice the rounding floor."""
    return max(_over_tol(a, b, 3e-5 * np.abs(b).max() + 4 * _ulp(b), c)
               for a, b, c in zip(outs, refs, alts))


def physics_modules_vs_cpu(device: torch.device, seed: int = 0) -> dict:
    """Every physics scheme alone on physics_state's states, on `device`
    and twice on the CPU (the second from inputs perturbed by one rounding,
    relative 2⁻²⁴·N(0,1)): per scheme the worst |Δ| over its bound plus
    twice the CPU's own rounding floor (≤ 1 passes), and that floor over
    the bound. The surface layer gets its lowest-level inputs made once on
    the CPU, so both devices start from the same numbers."""
    from scale_letkf_torch.model import (
        microphysics6, pbl, physics, physics_suite, radiation, surface,
    )
    cpu = torch.device("cpu")
    dt = 30.0
    dz = float(PHYS_FZ[1] - PHYS_FZ[0])

    def sfc_inputs(s_np, tsfc_np):
        s = dycore.DycoreState(*(torch.as_tensor(f) for f in s_np))
        temp, p = physics.temperature(s, s.rhoq / s.rho.unsqueeze(-4))
        lev0 = [f[:, 0] for f in (s.rhou / s.rho, s.rhov / s.rho, temp,
                                  s.rhoq[:, 0] / s.rho, p, s.rho)]
        z1 = np.float32(PHYS_CZ[0])
        psfc = lev0[4] + lev0[5] * 9.81 * z1
        return [f.numpy() for f in lev0] + [np.asarray(z1), tsfc_np,
                                            psfc.numpy()]

    def kessler(s, tsfc, sfc, dev):
        vg = dycore.make_vgrid(PHYS_CZ, PHYS_FZ, dev)
        return (physics.kessler_step(s, dt, vg.dzc),)

    def nsw6(s, tsfc, sfc, dev):
        vg = dycore.make_vgrid(PHYS_CZ, PHYS_FZ, dev)
        return (microphysics6.nsw6_step(s, dt, vg.dzc),)

    def rad(s, tsfc, sfc, dev):
        return ((), radiation.radiation_step(s, dz, 0.5, 0.2, 0.98, tsfc))

    def sfc_(s, tsfc, sfc, dev):
        return ((), surface.surface_fluxes(*sfc))

    def pbl_(s, tsfc, sfc, dev):
        zc = torch.as_tensor(PHYS_CZ, dtype=torch.float32, device=dev)
        res = pbl.pbl_step(s, dt, dz, zc, tsfc)
        return res.state, res.sfc

    def suite(s, tsfc, sfc, dev):
        pcfg = physics_suite.PhysicsConfig(mp_scheme="nsw6", rad_interval=2,
                                           slab_capacity=2.0e5)
        zc = torch.as_tensor(PHYS_CZ, dtype=torch.float32, device=dev)
        ph = physics_suite.init_physics_state(s, dz, pcfg)
        for i, dt_i in enumerate((5 * dt, 5 * dt, 3 * dt)):
            s, ph = physics_suite.physics_step(s, ph, i, pcfg, dt_i, dz, zc)
        return s, ph

    def run(dev, fn, s_np, tsfc_np, sfc_np):
        def t(a):
            return torch.as_tensor(a, device=dev)
        out = fn(dycore.DycoreState(*map(t, s_np)), t(tsfc_np),
                 [t(a) for a in sfc_np], dev)
        return [[x.cpu().numpy() for x in part] for part in out]

    rng = np.random.default_rng(seed + 7)

    def rounded(a):
        return (a * (1.0 + 2.0 ** -24 * rng.standard_normal(np.shape(a)))
                ).astype(np.float32)

    err, floor = {}, {}
    for name, fn, layered in (("kessler", kessler, False),
                              ("nsw6", nsw6, False), ("radiation", rad, False),
                              ("surface", sfc_, False), ("pbl", pbl_, True),
                              ("physics_step", suite, False)):
        s_np, tsfc_np = physics_state(seed, layered)
        args = (s_np, tsfc_np, sfc_inputs(s_np, tsfc_np))
        got = run(device, fn, *args)
        want = run(cpu, fn, *args)
        alt = run(cpu, fn, type(s_np)(*map(rounded, s_np)),
                  rounded(tsfc_np), [rounded(a) for a in args[2]])
        err[name] = floor[name] = 0.0
        if got[0]:
            err[name] = state_over_tol(got[0], s_np, want[0], alt[0])
            floor[name] = state_over_tol(alt[0], s_np, want[0], want[0])
        if len(got) > 1:
            err[name] = max(err[name], diag_over_tol(got[1], want[1],
                                                     alt[1]))
            floor[name] = max(floor[name], diag_over_tol(alt[1], want[1],
                                                         want[1]))
    return {"max_err_over_tol": err, "rounding_floor_over_tol": floor}


def _rounded(s, gen):
    return type(s)(*(f * (1.0 + 2.0 ** -24 * torch.randn(
        f.shape, generator=gen)) for f in s))


def _err_floor(names, dev_out, cpu_out, cpu_rounded, init):
    """Per field: |Δ| / (1e-4·max|increment| · (1 + 2·floor)) and the floor,
    the rounded CPU run's change over 1e-4·max|increment|."""
    err, floor = {}, {}
    for name, a, b, c, f0 in zip(names, dev_out, cpu_out, cpu_rounded, init):
        scale = 1e-4 * np.abs(b - np.asarray(f0)).max()
        if scale == 0:      # a field the run leaves as it was (dry tracers)
            floor[name] = 0.0 if np.array_equal(c, b) else np.inf
            err[name] = 0.0 if np.array_equal(a, b) else np.inf
            continue
        floor[name] = float(np.abs(c - b).max() / scale)
        err[name] = float(np.abs(a - b).max() / (scale * (1 + 2 * floor[name])))
    return err, floor


def per_member_boundary(grid, dom, K: int, device) -> BoundaryData:
    """Per-member Davies targets: from the balanced base state (t0 = 0) to
    the base warmed by 0.1·(m + 1)% for member m with a 5 m/s wind (t1 =
    3600 s)."""
    base = base_boundary(grid, dom, device).state0
    s0 = dycore.DycoreState(*(f.expand((K,) + f.shape).contiguous()
                              for f in base))
    warm = torch.tensor([1.0 + 1e-3 * (m + 1) for m in range(K)],
                        device=device)[:, None, None, None]
    s1 = s0._replace(rhot=s0.rhot * warm, rhou=s0.rho * 5.0)
    return BoundaryData(s0, s1, 0.0, 3600.0)


def _on_grid(cfg):
    """cfg with the [process] grid GRID (make_driver builds it)."""
    cfg = dataclasses.replace(cfg, process=dataclasses.replace(
        cfg.process, mesh_member=GRID[0], mesh_y=GRID[1], mesh_x=GRID[2]))
    return cfg


def _grid_row(runs, steps: int, names) -> dict:
    """The card's grid run against its undecomposed run: bit-equal per
    array, the largest difference, and its launches against 3 stages ×
    steps × the GRID blocks (one batch each at these sizes)."""
    a, b = runs["device_grid"]["state"], runs["device"]["state"]
    blocks = int(np.prod(GRID))
    return {"mesh": list(GRID),
            "bit_equal": {n: bool(np.array_equal(x, y))
                          for n, x, y in zip(names, a, b)},
            "max_abs_diff": max(float(np.abs(x - y).max())
                                for x, y in zip(a, b)),
            "kernel_launches": runs["device_grid"]["launches"],
            "expected_launches": 3 * steps * blocks,
            "sections": runs["device_grid"]["sections"]}


def physics_forecast_vs_cpu(device: torch.device, config: str,
                            seed: int = 0) -> dict:
    """The 18-km physics-suite forecast with per-member Davies forcing at
    COARSE_PHYS, K = MEMBERS_PHYS: 7 steps from t0 = 0 then 3 from 210 s,
    on `device` and twice on the CPU (the second from inputs perturbed by
    one rounding), and on `device` again on the GRID process grid. Worst
    |Δ| over its bound per field of the final state and for the skin
    temperature after each forecast, the floors, the stencil kernels'
    launches, the timer's physics and boundary sections, and under `grid`
    the grid run against the undecomposed one on `device` (_grid_row: the
    state and both skin temperatures)."""
    from scale_letkf_torch.cli.main import make_driver
    cfg, grid, dycfg, dom = load_config_and_grid(config, COARSE_PHYS)
    dom = {**dom, "physics": PHYS_PROD, "bdy_width": 3}
    cpu = torch.device("cpu")
    ens0, _, _ = synthetic_ens_dycore_device(seed, MEMBERS_PHYS, grid, dom,
                                             cpu, u0=10.0, amp_theta=2.0)
    gen = torch.Generator().manual_seed(seed + 3)
    runs = {}
    for key, dev, init in (("device", device, ens0), ("cpu", cpu, ens0),
                           ("cpu_rounded", cpu, _rounded(ens0, gen)),
                           ("device_grid", device, ens0)):
        driver = make_driver(_on_grid(cfg) if key == "device_grid" else cfg,
                             grid, dycfg, dom, dev)
        driver.bdy = per_member_boundary(grid, dom, MEMBERS_PHYS, dev)
        before = dict(kernels.LAUNCHES)
        e1 = driver.forecast(type(init)(*(f.to(dev) for f in init)), 7)
        tsfc1 = _global(driver, driver.tsfc).cpu().numpy()
        e2 = _global(driver, driver.forecast(e1, 3, t0=210.0))
        runs[key] = {"state": [f.cpu().numpy() for f in e2],
                     "tsfc": [tsfc1, _global(driver, driver.tsfc)
                              .cpu().numpy()],
                     "launches": {k: kernels.LAUNCHES[k] - before[k]
                                  for k in ("dyn_tendency", "adv_ud3")},
                     "sections": {k: driver.timer.counts.get(k, 0) for k in
                                  ("forecast/physics", "forecast/boundary")
                                  + ("forecast/physics/halo",)
                                  * (key == "device_grid")}}
    for r in runs.values():
        r["state"] += r["tsfc"]
    err, floor = _err_floor(ens0._fields, runs["device"]["state"],
                            runs["cpu"]["state"], runs["cpu_rounded"]["state"],
                            ens0)
    names = (*ens0._fields, "tsfc1", "tsfc2")
    grid_row = _grid_row(runs, 10, names)
    from scale_letkf_torch.model.physics_suite import skin_temperature
    cold = skin_temperature(ens0).numpy()
    for i in range(2):
        e, f = _err_floor(("tsfc",), [runs["device"]["tsfc"][i]],
                          [runs["cpu"]["tsfc"][i]],
                          [runs["cpu_rounded"]["tsfc"][i]], [cold])
        err[f"tsfc{i + 1}"], floor[f"tsfc{i + 1}"] = e["tsfc"], f["tsfc"]
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}",
            "members": MEMBERS_PHYS, "steps": [7, 3],
            "kernel_launches": {k: runs[k]["launches"]
                                for k in ("device", "cpu")},
            "sections": runs["device"]["sections"],
            "rounding_floor_over_1e-4_increment": floor,
            "finite": all(bool(np.isfinite(f).all())
                          for f in runs["device"]["state"]),
            "max_err_over_tol": err, "grid": grid_row}


def kessler_forecast_vs_cpu(device: torch.device, config: str,
                            seed: int = 0) -> dict:
    """The radar configuration's Kessler forecast over its window
    (RADAR_STEPS) at COARSE_RADAR, K = MEMBERS_PHYS, from an ensemble with
    rain blobs, on `device` and twice on the CPU, and on `device` on the
    GRID process grid. Worst |Δ| over its bound per field, the floors, the
    stencil kernels' launches and under `grid` the grid run against the
    undecomposed one on `device` (_grid_row)."""
    from scale_letkf_torch.cli.main import make_driver
    cfg, grid, dycfg, dom = load_config_and_grid(config, COARSE_RADAR)
    cpu = torch.device("cpu")
    ens0, _, _ = synthetic_ens_dycore_device(
        seed, MEMBERS_PHYS, grid, dom, cpu, u0=5.0, qr_blob=RADAR_QR_BLOB)
    gen = torch.Generator().manual_seed(seed + 4)
    out, launches, sections = {}, {}, {}
    for key, dev, init in (("device", device, ens0), ("cpu", cpu, ens0),
                           ("cpu_rounded", cpu, _rounded(ens0, gen)),
                           ("device_grid", device, ens0)):
        driver = make_driver(_on_grid(cfg) if key == "device_grid" else cfg,
                             grid, dycfg, dom, dev)
        before = dict(kernels.LAUNCHES)
        res = _global(driver, driver.forecast(
            type(init)(*(f.to(dev) for f in init)), RADAR_STEPS))
        out[key] = [f.cpu().numpy() for f in res]
        launches[key] = {k: kernels.LAUNCHES[k] - before[k]
                         for k in ("dyn_tendency", "adv_ud3")}
        sections[key] = {k: driver.timer.counts.get(k, 0)
                         for k in ("forecast/physics", "forecast/halo")}
    err, floor = _err_floor(ens0._fields, out["device"], out["cpu"],
                            out["cpu_rounded"], ens0)
    grid_row = _grid_row({k: {"state": out[k], "launches": launches[k],
                              "sections": sections[k]} for k in out},
                         RADAR_STEPS, ens0._fields)
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}",
            "members": MEMBERS_PHYS, "steps": RADAR_STEPS,
            "kernel_launches": {k: launches[k] for k in ("device", "cpu",
                                                         "cpu_rounded")},
            "rounding_floor_over_1e-4_increment": floor,
            "finite": all(bool(np.isfinite(f).all()) for f in out["device"]),
            "max_err_over_tol": err, "grid": grid_row}


def radar_template(grid, dom: dict, seed: int, n: int = 400) -> Observations:
    """Radar reflectivity and radial velocity obs (alternating) 1-10 km
    from the configuration's radar site (radar_lon, radar_lat, radar_z),
    0.3-5 km high, values to be made by obsmake."""
    rng = np.random.default_rng(seed)
    site = (dom["radar_lon"], dom["radar_lat"], dom.get("radar_z", 0.0))
    dist = rng.uniform(1e3, 10e3, n)
    ang = rng.uniform(0.0, 2 * np.pi, n)
    return Observations(
        elem=np.where(np.arange(n) % 2 == 0, ID_RADAR_REF, ID_RADAR_VR),
        lon=site[0] + dist * np.sin(ang) / (111e3 * np.cos(np.radians(
            site[1]))),
        lat=site[1] + dist * np.cos(ang) / 111e3,
        lev=rng.uniform(300.0, 5e3, n), dat=np.zeros(n), err=np.ones(n),
        typ=np.full(n, TYP_PHARAD), dif=np.zeros(n), meta=np.asarray(site))


def radar_cycle_vs_cpu(device: torch.device, config: str,
                       seed: int = 0) -> dict:
    """One run_osse cycle of the radar configuration at COARSE_RADAR with
    K = MEMBERS_CYCLE, 5 steps (Kessler at step 5), from an ensemble and a
    nature run with rain blobs, the obs radar reflectivity and radial
    velocity that obsmake makes from the nature run (calc_ref_vr), on
    `device` and twice on the CPU. As osse_vs_cpu."""
    from scale_letkf_torch.cli.main import make_driver
    cfg, grid, dycfg, dom = load_config_and_grid(config, COARSE_RADAR)
    cfg.ensemble.member = K = MEMBERS_CYCLE
    cpu = torch.device("cpu")
    kw = {"u0": 5.0, "qr_blob": RADAR_QR_BLOB}
    ens0, _, _ = synthetic_ens_dycore_device(seed, K, grid, dom, cpu, **kw)
    nat, _, _ = synthetic_ens_dycore_device(seed + 1, 1, grid, dom, cpu, **kw)
    truth0 = type(nat)(*(f[0] for f in nat))
    template = radar_template(grid, dom, seed)
    gen = torch.Generator().manual_seed(seed + 5)
    runs, steps = {}, 5
    for key, dev, t0, e0 in (("device", device, truth0, ens0),
                             ("cpu", cpu, truth0, ens0),
                             ("cpu_rounded", cpu, _rounded(truth0, gen),
                              _rounded(ens0, gen))):
        driver = make_driver(cfg, grid, dycfg, dom, dev)
        before = dict(kernels.LAUNCHES)
        truth, ens, res = driver.run_osse(
            type(t0)(*(f.to(dev) for f in t0)),
            type(e0)(*(f.to(dev) for f in e0)), template, n_cycles=1,
            steps_per_cycle=steps, seed=seed)
        runs[key] = {
            "state": [f.cpu().numpy() for f in (*ens, *truth)],
            "qc": res.info["obsdep"].qc, "nobs": res.stats_gues[0].nobs,
            "launches": {k: kernels.LAUNCHES[k] - before[k]
                         for k in KERNELS},
            "expected": expected_launches(cfg, grid, steps,
                                          -(-K // driver.batch),
                                          res.info["diag"].chunk)}
    names = ([f"ens.{n}" for n in ens0._fields]
             + [f"nature.{n}" for n in truth0._fields])
    err, floor = _err_floor(names, runs["device"]["state"],
                            runs["cpu"]["state"], runs["cpu_rounded"]["state"],
                            (*ens0, *truth0))
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
            "steps": steps, "nobs_by_element": runs["device"]["nobs"],
            "kernel_launches": {k: runs[k]["launches"]
                                for k in ("device", "cpu")},
            "expected_launches": runs["device"]["expected"],
            "qc_equal": bool(np.array_equal(runs["device"]["qc"],
                                            runs["cpu"]["qc"])),
            "rounding_floor_over_1e-4_increment": floor,
            "finite": all(bool(np.isfinite(f).all())
                          for f in runs["device"]["state"]),
            "max_err_over_tol": err}


def coarse_physics_vs_cpu(device: torch.device, config: str,
                          radar_config: str, seed: int = 0) -> dict:
    """The physics checks on `device` against the CPU: every scheme alone,
    the 18-km physics-suite forecast with per-member Davies forcing, the
    radar configuration's Kessler forecast and its run_osse cycle."""
    return {"modules": physics_modules_vs_cpu(device, seed),
            "suite": physics_forecast_vs_cpu(device, config, seed),
            "kessler": kessler_forecast_vs_cpu(device, radar_config, seed),
            "radar_cycle": radar_cycle_vs_cpu(device, radar_config, seed)}


def physics_check_passes(res: dict) -> bool:
    """Whether coarse_physics_vs_cpu's result passes: every error within its
    bound, finite, the stencil kernels launched on the device (3 stages ×
    steps) and never on the CPU, every kernel of the radar cycle launched as
    expected, its QC equal and radar obs of both kinds assimilated; and
    each forecast's grid run bit-equal to the undecomposed one on the
    device, with its launches, its physics sections and the suite's PBL
    halo exchanges."""
    fc = [res["suite"], res["kessler"]]
    cyc = res["radar_cycle"]
    steps = [sum(res["suite"]["steps"]), res["kessler"]["steps"]]
    grids = [r["grid"] for r in fc]
    return (all(e <= 1 for e in res["modules"]["max_err_over_tol"].values())
            and all(r["finite"] and all(e <= 1 for e in
                                        r["max_err_over_tol"].values())
                    for r in (*fc, cyc))
            and all(all(n == 3 * st for n in r["kernel_launches"][
                "device"].values()) and not any(r["kernel_launches"][
                    "cpu"].values()) for r, st in zip(fc, steps))
            and all(all(g["bit_equal"].values()) and all(
                n == g["expected_launches"]
                for n in g["kernel_launches"].values()) for g in grids)
            and res["suite"]["sections"]["forecast/physics"] == 3
            and res["suite"]["sections"]["forecast/boundary"] == 10
            and grids[0]["sections"]["forecast/physics"] == 3
            and grids[0]["sections"]["forecast/physics/halo"] == 6
            and grids[1]["sections"]["forecast/physics"] == 3
            and cyc["qc_equal"]
            and cyc["kernel_launches"]["device"] == cyc["expected_launches"]
            and not any(cyc["kernel_launches"]["cpu"].values())
            and cyc["nobs_by_element"]["REF"] > 0
            and cyc["nobs_by_element"]["Vr"] > 0)


# --- terrain, topography and Himawari-8 -------------------------------------
COARSE_TERRAIN = {"nx": 32, "ny": 24}    # the 18-km configuration's levels
MEMBERS_TERRAIN = 4
STEPS_TERRAIN = 5
FLUX_MIN = 0.05           # |mass flux| the terrain test states keep from 0
BT_TOL = 2e-3             # K: H08 brightness temperatures, device vs CPU
# the production states' qv at most half the base column's saturation: the
# configuration's exponential profile is supersaturated over ice above
# ~8.5 km, and the physics suite's first step would deposit it as an ice
# cloud whose top (~70 hPa) puts every H08 obs above H08_LIMIT_LEV
PROD_RH_MAX = 0.5
PLEV_ADJACENT_SHARE = 0.01  # sensitive pressures allowed on a next level


def hills(ny: int, nx: int, amp: float = 300.0) -> np.ndarray:
    """Two Gaussian hills (float32 (ny, nx)), one cut by the domain's edge,
    so periodic and open stencils see different neighbours there."""
    j, i = np.mgrid[0:ny, 0:nx]
    h = (amp * np.exp(-(((i - 0.35 * nx) / 3.0) ** 2
                        + ((j - 0.5 * ny) / 2.5) ** 2))
         + 0.6 * amp * np.exp(-(((i - nx + 0.5) / 2.5) ** 2
                                + ((j - 1.0) / 2.0) ** 2)))
    return h.astype(np.float32)


def terrain_state(seed: int, B: int, cz, fz, topo: np.ndarray, dx: float,
                  dy: float):
    """B float32 numpy members over topo: a hydrostatic column with 1%
    noise, winds of either sign 1-6 m/s, tracers ≈ 1e-3 of ρ, and ρw set so
    that the contravariant ρW at every interior face is ±(0.1-0.5)·J plus
    the terrain-following part — every mass flux of the terrain tendency
    keeps away from zero, where UD3's upwind switch would flip on a last
    bit. Returns (fields, rho_ref, p_ref) as numpy float32."""
    from scale_letkf_torch.model.terrain import make_metrics
    rng = np.random.default_rng(seed)
    nz, (ny, nx) = len(cz), topo.shape
    theta = 300.0 + 10.0 * np.linspace(0, 1, nz)
    rho1d, p1d = dycore.hydrostatic_reference(theta, 500.0, cz=np.asarray(cz))
    shape = (B, nz, ny, nx)

    def wind():
        return rng.choice([-1.0, 1.0], shape) * (1.0 + 5.0 * rng.random(shape))

    rho = rho1d[:, None, None] * (1.0 + 0.01 * rng.standard_normal(shape))
    rhou, rhov = wind() * rho, wind() * rho
    rho, rhou, rhov = (np.asarray(a, np.float32) for a in (rho, rhou, rhov))
    m = make_metrics(torch.from_numpy(topo), cz, fz, dx, dy)
    gx_c = (0.5 * (m.gx_zf + torch.roll(m.gx_zf, 1, -1))).numpy()
    gy_c = (0.5 * (m.gy_zf + torch.roll(m.gy_zf, 1, -2))).numpy()
    rhou_c = 0.5 * (rhou + np.roll(rhou, 1, -1))
    rhov_c = 0.5 * (rhov + np.roll(rhov, 1, -2))
    big_w = (rng.choice([-1.0, 1.0], (B, nz - 1, ny, nx))
             * (0.1 + 0.4 * rng.random((B, nz - 1, ny, nx))))
    rhow = np.zeros((B, nz + 1, ny, nx))
    rhow[:, 1:-1] = (big_w * m.jac.numpy()
                     + gx_c[1:-1] * 0.5 * (rhou_c[:, 1:] + rhou_c[:, :-1])
                     + gy_c[1:-1] * 0.5 * (rhov_c[:, 1:] + rhov_c[:, :-1]))
    rhot = rho * theta[:, None, None] * (1 + 0.01 * rng.standard_normal(shape))
    rhoq = np.abs(1e-3 * rng.standard_normal((B, NQ) + shape[1:])) * rho[:, None]
    f32 = [np.asarray(a, np.float32)
           for a in (rho, rhou, rhov, rhow, rhot, rhoq)]
    return (f32, np.asarray(rho1d[:, None, None], np.float32),
            np.asarray(p1d[:, None, None], np.float32))


def production_driver(cfg, grid, dycfg, dom: dict, device: torch.device,
                      topo=None, bdy_width: int | None = None):
    """The reference bench's production composition
    (scale_letkf_tpu/bench_fullsize.py _make_fullsize_driver): the [domain]
    driver of make_driver — its reference column, core and substeps — with
    the physics suite PHYS_PROD, Davies relaxation toward the balanced base
    state (base_boundary, its qv capped at PROD_RH_MAX of saturation; the
    configuration's bdy_width unless given, and bdy_tau) and the topography
    `topo` (None: flat) through CycleDriver(topo=)."""
    from scale_letkf_torch.cli.main import make_driver
    from scale_letkf_torch.cycle import CycleDriver
    flat = make_driver(cfg, grid, dycfg, {**dom, "physics": PHYS_PROD},
                       device)
    return CycleDriver(grid, cfg, dycfg, flat.rho_ref, flat.p_ref, topo=topo,
                       phys_cfg=flat.phys_cfg, core=flat.core,
                       n_small=flat.n_small,
                       bdy=base_boundary(grid, dom, device, PROD_RH_MAX),
                       bdy_width=dom["bdy_width"] if bdy_width is None
                       else bdy_width, bdy_tau=dom["bdy_tau"])


def jacobian_mass(rho: torch.Tensor, jac: torch.Tensor,
                  dzc: torch.Tensor) -> float:
    """Σ J·ρ·dzc in float64: the terrain-following core's mass."""
    return float((rho.double() * jac.double() * dzc.double()).sum())


def _tend_err(names, dev_out, cpu_out, cpu_rounded, tol: float):
    """Per field: |Δ| / (tol·max|cpu| · (1 + 2·floor)) and the floor, the
    rounded CPU run's change over tol·max|cpu|."""
    err, floor = {}, {}
    for name, a, b, c in zip(names, dev_out, cpu_out, cpu_rounded):
        scale = tol * np.abs(b).max()
        floor[name] = float(np.abs(c - b).max() / scale)
        err[name] = float(np.abs(a - b).max() / (scale * (1 + 2 * floor[name])))
    return err, floor


def terrain_modules_vs_cpu(device: torch.device, config: str,
                           seed: int = 0) -> dict:
    """The terrain dynamics on `device` against the CPU (and the CPU from
    inputs rounded once): tendencies_terrain on terrain_state's members (2,
    12 of the 18-km configuration's stretched levels, 40×24 columns of 18 km,
    hills of 300 m) to TOL_TENDENCY·max|CPU| plus twice the CPU's floor;
    two rk3_step_si steps with metrics of the configuration coarsened to
    COARSE_TERRAIN (its 36 levels, hills of 500 m, K = MEMBERS_TERRAIN)
    as the forecast checks; both lateral modes. Then an unforced SI terrain
    forecast (STEPS_TERRAIN steps) on `device`: its Σ J·ρ·dzc change."""
    from scale_letkf_torch.model import dycore_si, terrain
    cfg, grid, dycfg, dom = load_config_and_grid(config, COARSE_TERRAIN)
    cpu = torch.device("cpu")
    names = dycore.DycoreState._fields
    out = {}
    nz, ny, nx = 12, 24, 40
    fz = np.concatenate([[0.0], np.cumsum(300.0 * 1.04 ** np.arange(nz))])
    cz = 0.5 * (fz[1:] + fz[:-1])
    topo_t = hills(ny, nx)
    fields, rho_ref, p_ref = terrain_state(seed, 2, cz, fz, topo_t, DX, DX)
    rounded = [(f * (1.0 + 2.0 ** -24 * np.random.default_rng(seed + 1)
                     .standard_normal(f.shape))).astype(np.float32)
               for f in fields]
    topo_s = hills(grid.ny, grid.nx, 500.0)
    ens0, *cols = synthetic_ens_dycore_device(seed, MEMBERS_TERRAIN, grid,
                                              dom, cpu, u0=10.0)
    gen = torch.Generator().manual_seed(seed + 2)
    ens_rounded = _rounded(ens0, gen)
    split = dycore_si.SplitConfig(dtau=dycfg.dt / dom["n_small"])
    for lateral in ("periodic", "open"):
        runs = {}
        cfg_t = dataclasses.replace(dycfg, dx=DX, dy=DX, dz=300.0,
                                    lateral=lateral)
        cfg_s = dataclasses.replace(dycfg, lateral=lateral)
        for key, dev, fs, e0 in (("device", device, fields, ens0),
                                 ("cpu", cpu, fields, ens0),
                                 ("cpu_rounded", cpu, rounded, ens_rounded)):
            s = dycore.DycoreState(*(torch.as_tensor(f, device=dev)
                                     for f in fs))
            m = terrain.make_metrics(torch.as_tensor(topo_t, device=dev),
                                     cz, fz, DX, DX)
            tend = terrain.tendencies_terrain(
                s, cfg_t, torch.as_tensor(rho_ref, device=dev),
                torch.as_tensor(p_ref, device=dev), m,
                dycore.make_vgrid(cz, fz, dev))
            ms = terrain.make_metrics(torch.as_tensor(topo_s, device=dev),
                                      grid.cz, grid.fz, grid.dx, grid.dy)
            step = dycore_si.integrate_si(
                type(e0)(*(f.to(dev) for f in e0)), cfg_s, split,
                *(c.to(dev) for c in cols),
                torch.as_tensor(grid.cz, dtype=torch.float32, device=dev), 2,
                dom["n_small"], dycore.make_vgrid(grid.cz, grid.fz, dev), ms)
            runs[key] = ([f.cpu().numpy() for f in tend],
                         [f.cpu().numpy() for f in step])
        e_t, f_t = _tend_err(names, *(runs[k][0] for k in (
            "device", "cpu", "cpu_rounded")), TOL_TENDENCY)
        e_s, f_s = _err_floor(names, *(runs[k][1] for k in (
            "device", "cpu", "cpu_rounded")), ens0)
        out[lateral] = {"tendencies": e_t, "tendencies_floor": f_t,
                        "si_steps": e_s, "si_steps_floor": f_s,
                        "finite": all(bool(np.isfinite(f).all()) for f in (
                            *runs["device"][0], *runs["device"][1]))}
    # Σ J·ρ·dzc of an unforced SI forecast over the hills, on the device
    ms = terrain.make_metrics(torch.as_tensor(topo_s, device=device),
                              grid.cz, grid.fz, grid.dx, grid.dy)
    vg = dycore.make_vgrid(grid.cz, grid.fz, device)
    s0 = type(ens0)(*(f.to(device) for f in ens0))
    s1 = dycore_si.integrate_si(
        s0, dycfg, split, *(c.to(device) for c in cols),
        torch.as_tensor(grid.cz, dtype=torch.float32, device=device),
        STEPS_TERRAIN, dom["n_small"], vg, ms)
    m0 = jacobian_mass(s0.rho, ms.jac, vg.dzc)
    out["mass"] = {"steps": STEPS_TERRAIN,
                   "jacobian_mass_rel_change":
                       abs(jacobian_mass(s1.rho, ms.jac, vg.dzc) - m0) / m0,
                   "max_abs_rhow": float(s1.rhow.abs().max())}
    return out


def topo_vs_cpu(device: torch.device, config: str, seed: int = 0) -> dict:
    """prepare_topo of a synthetic DEM raster (a 2-km Gaussian ridge with
    300-m seeded roughness and sea west of it, 0.02° spacing) onto the
    configuration coarsened to COARSE_TERRAIN, the smoothing on `device`
    and on the CPU: the same passes, the fields to 1e-5 of the highest."""
    from scale_letkf_torch.model.topo import prepare_topo
    _, grid, _, _ = load_config_and_grid(config, COARSE_TERRAIN)
    lon = grid.proj.basepoint_lon + np.arange(-4.0, 4.0, 0.02)
    lat = grid.proj.basepoint_lat + np.arange(-4.0, 4.0, 0.02)
    lo, la = np.meshgrid(lon, lat)
    elev = (2000.0 * np.exp(-(((lo - lon.mean()) / 1.0) ** 2
                              + ((la - lat.mean()) / 0.5) ** 2))
            + 300.0 * np.random.default_rng(seed).standard_normal(lo.shape))
    elev = np.where(lo < lon.mean() - 2.0, -50.0, elev)
    out = {k: prepare_topo(elev, lon, lat, grid, max_slope_ratio=0.01,
                           device=dev)
           for k, dev in (("device", device), ("cpu", torch.device("cpu")))}
    (got, n_dev), (want, n_cpu) = out["device"], out["cpu"]
    return {"grid": f"{grid.nx}x{grid.ny}", "passes": {"device": n_dev,
                                                       "cpu": n_cpu},
            "max_topo": float(want.max()),
            "max_err_over_tol": float(np.abs(got - want).max()
                                      / (1e-5 * want.max()))}


def _plev_check(got, want, cols) -> dict:
    """Sensitive pressures (..., nobs) of two devices: the share that
    differs, and whether each differing one is an adjacent level's pressure
    of its column cols (..., nobs, nz)."""
    diff = got != want
    adjacent = True
    for idx in zip(*np.nonzero(diff)):
        col = cols[idx]
        k = np.nonzero(col == want[idx])[0]
        adjacent &= bool(len(k)) and got[idx] in col[max(k[0] - 1, 0):k[0] + 2]
    return {"plev_differ_share": float(diff.mean()),
            "plev_differ_adjacent": bool(adjacent)}


def h08_hx_vs_cpu(device: torch.device, config: str, seed: int = 0,
                  members: int = 4) -> dict:
    """The H08 operator in the driver's H(x) (compute_hx_single with the
    sensitive pressure and clear-sky BT) on hydrometeor_analysis's
    ensemble over the 18-km configuration at COARSE_TERRAIN (its 36
    levels) with the synthetic topography, conventional obs beside an H08
    network (a profile every 3 cells), the configuration's channel gate and
    cloud threshold 2 K, on `device` against the CPU: QC equal, BT and
    clear-sky BT to BT_TOL K, the sensitive pressures equal but for a share
    of at most PLEV_ADJACENT_SHARE on an adjacent level (an argmax over
    weights that tie to the last bit)."""
    from scale_letkf_torch.da.obsope import compute_hx_single
    from scale_letkf_torch.obs.operators import itpl_2d_column
    from scale_letkf_torch.obs.types import ID_H08IR
    from scale_letkf_torch.synthetic import synthetic_topo
    cfg, grid, _, dom = load_config_and_grid(config, COARSE_TERRAIN)
    cfg.h08 = dataclasses.replace(cfg.h08, h08_cldsky_thrs=2.0)
    anal = hydrometeor_analysis(seed, members, grid, dom)
    topo = synthetic_topo(np.random.default_rng(7), grid.ny, grid.nx)
    obs = Observations.concatenate([
        synthetic_conv_network(cfg, grid, np.random.default_rng(seed),
                               n_sonde=20, n_ps=40),
        synthetic_h08_network(cfg, grid, spacing=3, margin=2)])
    res, cols = {}, None
    for key, dev in (("device", device), ("cpu", torch.device("cpu"))):
        t = torch.as_tensor(topo, device=dev)
        z = grid.calc_z(t)
        fields = state_to_history(anal.to(dev), z, t)
        res[key] = [a.cpu().numpy() for a in compute_hx_single(
            fields, obs, grid, cfg, z, with_aux=True)]
        if dev.type == "cpu":
            ri, rj = grid.lonlat_to_ij(obs.lon, obs.lat)
            cols = itpl_2d_column(fields["p"], torch.as_tensor(ri).float(),
                                  torch.as_tensor(rj).float()).numpy()
    (y, qc, lev, val2), (y_c, qc_c, lev_c, val2_c) = res["device"], res["cpu"]
    h = obs.elem == ID_H08IR
    good = (qc_c == 0) & h[None]
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": members,
            "h08_obs": int(h.sum()), "h08_good": int(good[0].sum()),
            "cloudy_share": float((y_c[good] < 0).mean()),
            "qc_equal": bool(np.array_equal(qc, qc_c)),
            "bt_max_abs_err_k": float(np.abs(y - y_c)[:, h].max()),
            "btclr_max_abs_err_k": float(np.abs(val2 - val2_c)[:, h].max()),
            "bt_tol_k": BT_TOL,
            "finite": bool(np.isfinite(y[:, h]).all()),
            **_plev_check(lev[:, h], lev_c[:, h], cols[:, h])}


def production_cycle_vs_cpu(device: torch.device, config: str,
                            seed: int = 0) -> dict:
    """The production composition coarsened: one run_osse cycle of
    STEPS_TERRAIN steps (physics once) of production_driver at
    COARSE_TERRAIN (the 36 levels; Davies over 3 cells), the synthetic
    topography (synthetic_topo, default_rng(7)), K = MEMBERS_CYCLE, from
    synthetic ensemble and nature states made on the CPU (qv capped at
    PROD_RH_MAX of saturation), and obsmake's
    conventional + H08 obs (the configuration's band 9), on `device` and
    twice on the CPU. The final states per field as the forecast checks,
    QC equal, O−B and O−A per obs to 2e-5 of the obs' range plus 4 ulp plus
    twice the CPU's own floor, the kernels' launches (#2 and #3 none: the
    slow tendencies are the terrain's)."""
    from scale_letkf_torch.obs.types import ID_H08IR
    from scale_letkf_torch.synthetic import synthetic_topo
    cfg, grid, dycfg, dom = load_config_and_grid(config, COARSE_TERRAIN)
    cfg.ensemble.member = K = MEMBERS_CYCLE
    cpu = torch.device("cpu")
    kw = {"u0": 10.0, "amp_theta": 2.0, "rh_max": PROD_RH_MAX}
    ens0, _, _ = synthetic_ens_dycore_device(seed, K, grid, dom, cpu, **kw)
    nat, _, _ = synthetic_ens_dycore_device(seed + 1, 1, grid, dom, cpu, **kw)
    truth0 = type(nat)(*(f[0] for f in nat))
    topo = synthetic_topo(np.random.default_rng(7), grid.ny, grid.nx)
    template = Observations.concatenate([
        synthetic_conv_network(cfg, grid, np.random.default_rng(seed),
                               n_sonde=30, n_ps=60),
        synthetic_h08_network(cfg, grid, spacing=4, margin=3)])
    gen = torch.Generator().manual_seed(seed + 6)
    runs = {}
    for key, dev, t0, e0 in (("device", device, truth0, ens0),
                             ("cpu", cpu, truth0, ens0),
                             ("cpu_rounded", cpu, _rounded(truth0, gen),
                              _rounded(ens0, gen))):
        driver = production_driver(cfg, grid, dycfg, dom, dev, topo=topo,
                                   bdy_width=3)
        before = dict(kernels.LAUNCHES)
        truth, ens, res = driver.run_osse(
            type(t0)(*(f.to(dev) for f in t0)),
            type(e0)(*(f.to(dev) for f in e0)), template, n_cycles=1,
            steps_per_cycle=STEPS_TERRAIN, seed=seed)
        dep = res.info["obsdep"]
        runs[key] = {
            "state": [f.cpu().numpy() for f in (*ens, *truth)],
            "qc": dep.qc, "omb": dep.omb, "oma": dep.oma, "elem": dep.elem,
            "dat": dep.dat, "nobs": res.stats_gues[0].nobs,
            "terrain": driver.metrics is not None,
            "launches": {k: kernels.LAUNCHES[k] - before[k]
                         for k in KERNELS}}
    names = ([f"ens.{n}" for n in ens0._fields]
             + [f"nature.{n}" for n in truth0._fields])
    err, floor = _err_floor(names, runs["device"]["state"],
                            runs["cpu"]["state"], runs["cpu_rounded"]["state"],
                            (*ens0, *truth0))
    d, c, r = runs["device"], runs["cpu"], runs["cpu_rounded"]
    good = c["qc"] == 0
    for key in ("omb", "oma"):
        for e in np.unique(c["elem"][good]):
            m = good & (c["elem"] == e)
            tol = (2e-5 * np.ptp(c["dat"][m]) + (12 if e == ID_PS else 4)
                   * np.spacing(np.float32(np.abs(c["dat"][m]).max()))
                   + 2 * np.abs(r[key][m] - c[key][m]).max())
            name = OBELM_NAMES[int(uid_obs(np.asarray([e]))[0])]
            err[f"{key}.{name}"] = float(np.abs(d[key][m] - c[key][m]).max()
                                         / tol)
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
            "steps": STEPS_TERRAIN, "terrain": d["terrain"],
            "nobs_by_element": d["nobs"],
            "h08_assimilated": int((good & (c["elem"] == ID_H08IR)).sum()),
            "kernel_launches": {k: runs[k]["launches"]
                                for k in ("device", "cpu")},
            "qc_equal": bool(np.array_equal(d["qc"], c["qc"])),
            "rounding_floor_over_1e-4_increment": floor,
            "finite": all(bool(np.isfinite(f).all()) for f in d["state"]),
            "max_err_over_tol": err}


def coarse_terrain_vs_cpu(device: torch.device, config: str,
                          seed: int = 0) -> dict:
    """The terrain and H08 checks on `device` against the CPU: the terrain
    dynamics alone and an unforced terrain forecast's mass, the pp step's
    smoothing, the H08 operator, and the coarsened production cycle."""
    return {"modules": terrain_modules_vs_cpu(device, config, seed),
            "topo": topo_vs_cpu(device, config, seed),
            "h08": h08_hx_vs_cpu(device, config, seed),
            "production": production_cycle_vs_cpu(device, config, seed)}


def terrain_check_passes(res: dict) -> bool:
    """Whether coarse_terrain_vs_cpu's result passes: every error within its
    bound and finite, Σ J·ρ·dzc kept to 1e-5, the same smoothing passes, the
    H08 QC equal with BTs within BT_TOL and the sensitive pressures as
    h08_hx_vs_cpu says, and the production cycle on terrain with QC equal,
    H08 obs assimilated and no launch of the stencil kernels (the solver's
    on the device only)."""
    mods, topo_r, h, prod = (res[k] for k in ("modules", "topo", "h08",
                                              "production"))
    launches = prod["kernel_launches"]
    return (all(r["finite"] and all(e <= 1 for part in ("tendencies",
                                                        "si_steps")
                                    for e in r[part].values())
                for r in (mods["periodic"], mods["open"]))
            and mods["mass"]["jacobian_mass_rel_change"] <= 1e-5
            and mods["mass"]["max_abs_rhow"] > 0
            and topo_r["passes"]["device"] == topo_r["passes"]["cpu"] > 0
            and topo_r["max_err_over_tol"] <= 1
            and h["finite"] and h["qc_equal"] and h["h08_good"] > 0
            and h["bt_max_abs_err_k"] <= BT_TOL
            and h["btclr_max_abs_err_k"] <= BT_TOL
            and h["plev_differ_adjacent"]
            and h["plev_differ_share"] <= PLEV_ADJACENT_SHARE
            and prod["terrain"] and prod["finite"] and prod["qc_equal"]
            and prod["h08_assimilated"] > 0
            and all(e <= 1 for e in prod["max_err_over_tol"].values())
            and launches["device"]["invsqrt_ns"] > 0
            and launches["device"]["dyn_tendency"] == 0
            and launches["device"]["adv_ud3"] == 0
            and not any(launches["cpu"].values()))


# --- the deterministic member, additive inflation, Jacobi, EFSO ------------
# The deterministic-member + additive-inflation analysis (INFL_ADD 0.1,
# shuffled, q ratio) at COARSE with K = MEMBERS; the letkf and cycle verbs
# on DET_VERB_CONFIG's small checkpoints (K = 20, so the solver is the CUDA
# kernel on the card); EFSO at COARSE_FCST with K = MEMBERS_CYCLE.
DET_VERB_CONFIG = """
[domain]
nx = 16
ny = 12
nz = 8
dx = 2000.0
dy = 2000.0
dz = 500.0
dt = 1.0
qv_surface = 0.008

[ensemble]
member = 20

[letkf]
infl_mul = 1.1
infl_add = 0.1
infl_add_shuffle = true

[letkf_obs]
hori_local = [6.0e3, {rest}]
""".format(rest=", ".join(["-1.0"] * 23))
DET_VERB_STEPS = 2
EFSO_HORI = 400.0e3     # HORI_LOCAL of the 18-km configuration's sondes
TOL_EFSO = 1e-5         # ΔJ, relative to max|ΔJ|


def _incr_over_tol(out, out_cpu, base, ulps=2) -> dict:
    """Per variable of (..., NV3D, nz, ny, nx) analyses from `base`:
    max|Δ − Δ_cpu| over 1e-4·max|Δ_cpu| + ulps ulp of max|base_v|."""
    err = {}
    for v, name in enumerate(V3D_ANAL_NAMES):
        inc = out[:, v] - base[:, v]
        inc_cpu = out_cpu[:, v] - base[:, v]
        tol = (1e-4 * np.abs(inc_cpu).max()
               + ulps * np.spacing(np.abs(base[:, v]).max()))
        err[name] = float(np.abs(inc - inc_cpu).max() / tol)
    return err


def coarse_det_addi_vs_cpu(device: torch.device, config: str,
                           seed: int = 0) -> dict:
    """The analysis with a deterministic member (another seed's synthetic
    member; its H(x) the obs plus half their error) and additive inflation
    (INFL_ADD 0.1, INFL_ADD_SHUFFLE with default_rng(seed + 3),
    INFL_ADD_Q_RATIO; a third seed's synthetic ensemble, kept on the host
    and uploaded a member at a time) at COARSE with K = MEMBERS, on `device`
    and on the CPU. Returns per variable the worst |Δ increment| over its
    tolerance (1e-4·max|Δ_v| + 2 ulp) of the ensemble and of the member
    (≤ 1 passes), the solver's launches and finiteness."""
    cfg, grid, _, _ = load_config_and_grid(config, COARSE)
    cfg.ensemble.member = K = MEMBERS
    cfg.letkf.infl_add = 0.1
    cfg.letkf.infl_add_shuffle = cfg.letkf.infl_add_q_ratio = True
    rng = np.random.default_rng(seed)
    shape = (grid.nz, grid.ny, grid.nx, grid.cz)
    gues = synthetic_gues(rng, K, *shape)
    det = synthetic_gues(np.random.default_rng(seed + 1), 1, *shape)
    addi = torch.from_numpy(synthetic_gues(np.random.default_rng(seed + 2),
                                           K, *shape))
    obs = synthetic_conv_network(cfg, grid, rng, n_sonde=30, n_ps=60)
    ensval = (obs.dat[None] + rng.standard_normal((K, obs.nobs))
              * obs.err[None]).astype(np.float32)
    ensval_det = (obs.dat + 0.5 * rng.standard_normal(obs.nobs)
                  * obs.err).astype(np.float32)
    ctx = build_obs_context(obs, ensval, np.zeros(obs.nobs, np.int32), cfg,
                            grid, ensval_det=ensval_det)
    out, launches = {}, {}
    for key, dev in (("device", device), ("cpu", torch.device("cpu"))):
        before = kernels.LAUNCHES["invsqrt_ns"]
        a, diag = analyze(
            torch.as_tensor(gues, device=dev), ctx, cfg, grid,
            grid.calc_z(torch.zeros((grid.ny, grid.nx), device=dev)),
            device=dev, gues_det=torch.as_tensor(det[0], device=dev),
            addi_ens=addi, rng=np.random.default_rng(seed + 3))
        out[key] = (a.cpu().numpy(), diag.anal_det.cpu().numpy()[None])
        launches[key] = kernels.LAUNCHES["invsqrt_ns"] - before
    err = {f"ens.{k}": v for k, v in _incr_over_tol(
        out["device"][0], out["cpu"][0], gues).items()}
    err.update({f"det.{k}": v for k, v in _incr_over_tol(
        out["device"][1], out["cpu"][1], det).items()})
    return {"grid": "{nx}x{ny}x{nz}".format(**COARSE), "members": K,
            "levels": grid.nz, "kernel_launches": launches,
            "det_moved": bool(np.abs(out["cpu"][1] - det).max() > 0),
            "finite": all(bool(np.isfinite(a).all()) for a in out["device"]),
            "max_err_over_tol": err}


def _verb_members(n: int, seed: int, grid) -> list:
    """n float32 numpy members of DET_VERB_CONFIG: the balanced state with
    its qv profile, a warm bubble, seeded wind and ρθ noise."""
    from scale_letkf_torch.model.ideal import add_warm_bubble, balanced_state
    dz = float(grid.fz[1] - grid.fz[0])
    s, _, _ = balanced_state(grid.nz, grid.ny, grid.nx, dz,
                             qv_prof=0.008 * np.exp(-grid.cz / 3000.0))
    s = add_warm_bubble(s, dz, grid.dx, grid.dy, amplitude=2.0)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = [a.numpy().copy() for a in s]
        f[1] += (2.0 * rng.standard_normal(f[1].shape) * f[0]).astype(
            np.float32)
        f[4] += (0.3 * rng.standard_normal(f[4].shape) * f[0]).astype(
            np.float32)
        out.append(dycore.DycoreState(*f))
    return out


def det_verbs_vs_cpu(device: torch.device, seed: int = 0) -> dict:
    """The letkf and cycle verbs with a deterministic member ('mdet' in the
    checkpoint) and additive inflation (the 'addi' files beside it) on
    DET_VERB_CONFIG's small checkpoints, run with --device on `device` and
    on the CPU, in a temporary directory: obsmake from a nature member,
    letkf, then cycle (1 cycle of DET_VERB_STEPS steps) — and the cycle
    once more on the CPU from an init perturbed by one rounding, whose
    distance is the cycle's rounding floor. Per restart field of the
    ensemble and the member: letkf within 1e-4·max|Δ| + 6 ulp, the cycle
    within 1e-4·max|Δ|·(1 + 2·floor) (≤ 1 passes); the solver's launches."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path
    from scale_letkf_torch.cli.main import main
    from scale_letkf_torch.da.obsmake import make_obs_network
    from scale_letkf_torch.grid import Grid
    from scale_letkf_torch.io import checkpoint
    from scale_letkf_torch.obs import io as obsio
    K = 20
    grid = Grid.uniform(nx=16, ny=12, nz=8, dx=2000.0, dy=2000.0, dz=500.0)
    members = _verb_members(2 * K + 2, seed, grid)

    def stack(ms):
        return dycore.DycoreState(*(np.stack(f) for f in zip(*ms)))

    err, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t = Path(tmp)
        (t / "exp.toml").write_text(DET_VERB_CONFIG)
        ens0, det0 = stack(members[:K]), members[K]
        gen = torch.Generator().manual_seed(seed)

        def rounded(s):
            return dycore.DycoreState(*(f.numpy() for f in _rounded(
                dycore.DycoreState(*(torch.from_numpy(f) for f in s)), gen)))
        for name, e, d in (("init", ens0, det0),
                           ("init_rounded", rounded(ens0), rounded(det0))):
            checkpoint.save_ensemble(t / name, e, basename="anal.@@@@",
                                     det=d)
            for m in range(K):
                checkpoint.save_member(
                    t / name / checkpoint.filename_replace_mem(
                        "addi.@@@@.npz", m), members[K + 1 + m])
        checkpoint.save_member(t / "nature.npz", members[2 * K + 1])
        obsio.write_obs(str(t / "template.dat"), make_obs_network(
            grid, np.random.default_rng(seed), n_profiles=15,
            levels_hpa=(900.0, 800.0)))
        cfg = ["--config", str(t / "exp.toml")]

        def run(*args, dev):
            before = kernels.LAUNCHES["invsqrt_ns"]
            with contextlib.redirect_stdout(io.StringIO()):
                main([*args, *cfg, "--device", dev])
            return kernels.LAUNCHES["invsqrt_ns"] - before

        run("obsmake", "--nature", str(t / "nature.npz"), "--obs-template",
            str(t / "template.dat"), "--out", str(t / "obs.dat"), "--seed",
            "5", dev="cpu")
        for key, dev in (("device", str(device)), ("cpu", "cpu")):
            launches[f"letkf.{key}"] = run(
                "letkf", "--gues", str(t / "init"), "--obs",
                str(t / "obs.dat"), "--anal", str(t / f"anal_{key}"),
                "--seed", "3", dev=dev)
        for key, dev, init in (("device", str(device), "init"),
                               ("cpu", "cpu", "init"),
                               ("cpu_rounded", "cpu", "init_rounded")):
            launches[f"cycle.{key}"] = run(
                "cycle", "--init", str(t / init), "--cycles", "1",
                "--steps-per-cycle", str(DET_VERB_STEPS), "--obs-pattern",
                str(t / "obs.dat"), "--out", str(t / f"cyc_{key}"), dev=dev)

        def load(d):
            ens, _, _ = checkpoint.load_ensemble(t / d)
            return [*ens, *checkpoint.load_det(t / d)]
        names = ([f"ens.{n}" for n in dycore.DycoreState._fields]
                 + [f"det.{n}" for n in dycore.DycoreState._fields])
        init = [*ens0, *det0]
        for name, a, b, f0 in zip(names, load("anal_device"),
                                  load("anal_cpu"), init):
            tol = (1e-4 * np.abs(b - f0).max()
                   + 6 * np.spacing(np.float32(np.abs(f0).max())))
            err[f"letkf.{name}"] = float(np.abs(a - b).max() / tol)
        cyc, floor = _err_floor(names, load("cyc_device"), load("cyc_cpu"),
                                load("cyc_cpu_rounded"), init)
        err.update({f"cycle.{k}": v for k, v in cyc.items()})
        det_moved = bool(np.abs(load("anal_cpu")[10] - init[10]).max() > 0)
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
            "cycle_steps": DET_VERB_STEPS, "kernel_launches": launches,
            "det_moved": det_moved,
            "rounding_floor_over_1e-4_increment": floor,
            "max_err_over_tol": err}


def jacobi_vs_cpu(device: torch.device, K: int, B: int = 512,
                  seed: int = 0) -> dict:
    """ops/eigh_jacobi.py on `device` against the CPU and against float64
    LAPACK on B LETKF-shaped float32 Grams (hᵀh over 40 obs + (K-1)·I):
    eigenvalues relative to their largest, reconstruction V·diag(w)·Vᵀ
    relative to max|A| (tests/test_eigh_jacobi.py's float32 bounds: 2e-4
    and 5e-5)."""
    from scale_letkf_torch.ops.eigh_jacobi import eigh_jacobi
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, 40, K))
    a = (np.einsum("blk,blj->bkj", h, h) + (K - 1) * np.eye(K)).astype(
        np.float32)
    w_ref = np.linalg.eigh(a.astype(np.float64))[0]
    res = {"K": K, "B": B}
    for key, dev in (("device", device), ("cpu", torch.device("cpu"))):
        w, v = (x.cpu().double().numpy() for x in eigh_jacobi(
            torch.as_tensor(a, device=dev)))
        rec = np.einsum("bik,bk,bjk->bij", v, w, v)
        res[key] = {"eigval_rel_err": float(np.abs(w - w_ref).max()
                                            / np.abs(w_ref).max()),
                    "recon_rel_err": float(np.abs(rec - a).max()
                                           / np.abs(a).max()),
                    "w": w}
    res["device_vs_cpu_eigval"] = float(
        np.abs(res["device"].pop("w") - res["cpu"].pop("w")).max()
        / np.abs(w_ref).max())
    res["passes"] = all(
        r["eigval_rel_err"] <= 2e-4 and r["recon_rel_err"] <= 5e-5
        for r in (res["device"], res["cpu"])) and \
        res["device_vs_cpu_eigval"] <= 2e-4
    return res


def efso_inputs(seed: int, K: int, nz: int, ny: int, nx: int,
                nobs: int = 200) -> dict:
    """Seeded numpy EFSO inputs: centred perturbations, an error field, obs
    at fractional indices with innovations, error variances and analysis
    obs perturbations, and a mean wind for advected localization."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    pert = rng.standard_normal((K, NV3D, nz, ny, nx)).astype(f32)
    pert -= pert.mean(axis=0, keepdims=True)
    return dict(
        ri=rng.uniform(0, nx - 1, nobs).astype(f32),
        rj=rng.uniform(0, ny - 1, nobs).astype(f32),
        rk=rng.uniform(0, nz - 1, nobs).astype(f32),
        dep=rng.standard_normal(nobs).astype(f32),
        rdiag=rng.uniform(0.5, 2.0, nobs).astype(f32),
        hdxa=rng.standard_normal((nobs, K)).astype(f32),
        pert=pert, err=rng.standard_normal((NV3D, nz, ny, nx)).astype(f32),
        u=(10.0 + rng.standard_normal((nz, ny, nx))).astype(f32),
        v=rng.standard_normal((nz, ny, nx)).astype(f32))


def coarse_efso_vs_cpu(device: torch.device, config: str,
                       seed: int = 0) -> dict:
    """efso_impact at COARSE_FCST's grid of the configuration (18-km
    cells) with K = MEMBERS_CYCLE and HORI_LOCAL EFSO_HORI, without and
    with advected localization (600 s) and vertical localization (2
    cells), on `device` against the CPU: max|ΔJ − ΔJ_cpu| over
    TOL_EFSO·max|ΔJ_cpu| (≤ 1 passes)."""
    from scale_letkf_torch.da.efso import efso_impact
    _, grid, _, _ = load_config_and_grid(config, COARSE_FCST)
    inp = efso_inputs(seed, MEMBERS_CYCLE, grid.nz, grid.ny, grid.nx)
    err = {}
    for case, kw in (("plain", {}),
                     ("advected", {"adv_time": 600.0,
                                   "vert_scale_cells": 2.0})):
        dj = {}
        for key, dev in (("device", device), ("cpu", torch.device("cpu"))):
            t = {k: torch.as_tensor(v, device=dev) for k, v in inp.items()}
            adv = ({"u_adv": t["u"], "v_adv": t["v"]} if kw else {})
            dj[key] = efso_impact(
                t["ri"], t["rj"], t["rk"], t["dep"], t["rdiag"], t["hdxa"],
                t["pert"], t["err"], grid, EFSO_HORI, **adv, **kw
            ).cpu().numpy()
        err[case] = float(np.abs(dj["device"] - dj["cpu"]).max()
                          / (TOL_EFSO * np.abs(dj["cpu"]).max()))
    return {"grid": "{nx}x{ny}x{nz}".format(**COARSE_FCST),
            "members": MEMBERS_CYCLE, "finite": bool(np.isfinite(
                dj["device"]).all()), "max_err_over_tol": err}


def h08_fit_vs_cpu(device: torch.device, steps: int = 600) -> dict:
    """obs/h08_calibrate.fit (the default 64 profiles, float64) on `device`
    and on the CPU: the fitted coefficients' largest relative difference
    (rtol 1e-3, the parity tests' bound, passes) and the BT misfit before
    and after."""
    from scale_letkf_torch.obs.h08_calibrate import fit
    out = {key: fit(steps=steps, device=dev) for key, dev in (
        ("device", device), ("cpu", torch.device("cpu")))}
    (f, st), (fc, _) = out["device"], out["cpu"]
    rel = max(float(np.abs(np.asarray(f[k]) / np.asarray(fc[k]) - 1).max())
              for k in ("k_wv", "k_fix", "wv_p_exp"))
    return {"steps": steps, "coef_max_rel_diff": rel,
            "bt_rmse_before_K": st["bt_rmse_before_K"],
            "bt_rmse_after_K": st["bt_rmse_after_K"],
            "passes": rel <= 1e-3
            and st["bt_rmse_after_K"] < st["bt_rmse_before_K"]}


def det_check_passes(res: dict) -> bool:
    """Whether the det_small results pass: the deterministic + additive
    analysis and the verbs within their bounds, finite, the member moved,
    the solver launched on the device and never on the CPU."""
    ana, verbs = res["analysis"], res["verbs"]
    lv = verbs["kernel_launches"]
    return (ana["finite"] and ana["det_moved"]
            and all(e <= 1 for e in ana["max_err_over_tol"].values())
            and ana["kernel_launches"]["cpu"] == 0
            and verbs["det_moved"]
            and all(e <= 1 for e in verbs["max_err_over_tol"].values())
            and lv["letkf.cpu"] == lv["cycle.cpu"] == 0)


# --- the full-size executors -------------------------------------------------
# Coarsened copies of the streamed, tiled and resident executors and of the
# cycle --streamed verb, each on the card and twice on the CPU (the second
# from inputs perturbed by one rounding, where a forecast is in the path).
# Bounds per analysis variable and element: 1e-4·max|Δ| + 2 ulp of max|x|,
# plus twice the CPU's own rounding floor, plus one bfloat16 spacing of the
# analysis perturbation x′ (≤ 2⁻⁷·|x′|), which the tiles carry in bfloat16
# and a last-bit difference may round the other way. K = MEMBERS (20), so
# the analysis solver is the CUDA kernel on the card.
EXEC_ROWS = 8
EXEC_BATCH = 10
EXEC_STEPS = 2
EXEC_CALL = 1            # ResidentCycle's max_steps_per_call, below the steps
EXEC_SLOTS = {"slot_start": 1, "slot_end": 3, "slot_base": 2}


def _vars_over_tol(out, out_cpu, base, alt=None, pert=None) -> dict:
    """Per analysis variable of (K, NV3D, ...) arrays: the worst |Δ − Δ_cpu|
    over its bound — 1e-4·max|Δ_cpu| + 2 ulp of max|base|, + 2·max|alt −
    out_cpu| (alt: the rounded CPU run), + 2⁻⁷·|pert| per element."""
    err = {}
    for v, name in enumerate(V3D_ANAL_NAMES):
        a, b, f0 = out[:, v], out_cpu[:, v], base[:, v]
        tol = (1e-4 * np.abs(b - f0).max()
               + 2 * np.spacing(np.float32(np.abs(f0).max()))
               + (0.0 if alt is None else 2 * np.abs(alt[:, v] - b).max()))
        if pert is not None:
            tol = tol + 2.0 ** -7 * np.abs(pert[:, v])
        err[name] = float(np.max(np.abs(a - b) / np.maximum(tol, 1e-30)))
    return err


def _launches(before: dict) -> dict:
    return {k: kernels.LAUNCHES[k] - before[k] for k in KERNELS}


def tiled_vs_cpu(device: torch.device, config: str, seed: int = 0) -> dict:
    """analyze_tiled (plain and pipelined) of coarse_analysis_vs_cpu's
    inputs in tiles of EXEC_ROWS rows on `device` against the CPU: the
    worst error over its bound per variable, whether the pipelined stream
    equals the plain one bit for bit, and the solver's launches (levels ×
    chunks over all tiles × var-local groups on the card)."""
    from scale_letkf_torch.da.letkf_tiled import analyze_tiled
    cfg, grid, _, _ = load_config_and_grid(config, COARSE)
    cfg.ensemble.member = K = MEMBERS
    rng = np.random.default_rng(seed)
    gues = synthetic_gues(rng, K, grid.nz, grid.ny, grid.nx, grid.cz)
    obs = synthetic_conv_network(cfg, grid, rng, n_sonde=30, n_ps=60)
    ensval = (obs.dat[None] + rng.standard_normal((K, obs.nobs))
              * obs.err[None]).astype(np.float32)
    ctx = build_obs_context(obs, ensval, np.zeros(obs.nobs, np.int32), cfg,
                            grid)
    z = grid.calc_z(torch.zeros((grid.ny, grid.nx))).numpy()
    out, launches, stats = {}, {}, {}
    for key, dev, pipe in (("device", device, False),
                           ("device_pipelined", device, True),
                           ("cpu", torch.device("cpu"), False)):
        before = dict(kernels.LAUNCHES)
        out[key], _, stats[key] = analyze_tiled(
            gues, ctx, cfg, grid, z, tile_rows=EXEC_ROWS, pipeline=pipe,
            device=dev)
        launches[key] = _launches(before)["invsqrt_ns"]
    pert = out["cpu"] - out["cpu"].mean(axis=0)
    tiles = stats["device"]["tiles"]
    return {"grid": "{nx}x{ny}x{nz}".format(**COARSE), "members": K,
            "tiles": tiles, "tile_rows": stats["device"]["tile_rows"],
            "kernel_launches": launches,
            "expected_launches": grid.nz * stats["device"]["chunks"]
            * var_local_groups(cfg),
            "pipeline_bit_equal": bool(np.array_equal(
                out["device"], out["device_pipelined"])),
            "finite": bool(np.isfinite(out["device"]).all()),
            "max_err_over_tol": {
                **_vars_over_tol(out["device"], out["cpu"], gues, pert=pert),
                **{f"pipelined.{k}": v for k, v in _vars_over_tol(
                    out["device_pipelined"], out["cpu"], gues,
                    pert=pert).items()}}}


def _exec_case(config: str, seed: int, topo: bool, slots: bool,
               over: dict | None = None, K: int = MEMBERS):
    """(cfg, grid, dycfg, dom, ensemble, obs) of the coarsened 18-km
    executors' runs: COARSE_FCST (or `over`) with K members, the physics
    suite, Davies forcing (3-cell buffer); a nature member's obsmake of the
    synthetic conventional network, spread over EXEC_SLOTS' three slots
    (two steps apart) with `slots`."""
    from scale_letkf_torch.da.obsmake import obsmake
    from scale_letkf_torch.model.dycore import to_collocated
    cfg, grid, dycfg, dom = load_config_and_grid(config, over or COARSE_FCST)
    cfg.ensemble.member = K
    dom = {**dom, "physics": PHYS_PROD, "bdy_width": 3}
    if slots:
        for k, v in EXEC_SLOTS.items():
            setattr(cfg.obsope, k, v)
        cfg.obsope.slot_tinterval = 2 * dycfg.dt
    else:
        cfg.obsope.slot_end = cfg.obsope.slot_start
    cpu = torch.device("cpu")
    ens, _, _ = synthetic_ens_dycore_device(seed, K + 1, grid, dom, cpu,
                                            u0=10.0, amp_theta=2.0,
                                            rh_max=PROD_RH_MAX)
    nat = type(ens)(*(f[0] for f in ens))
    ens = type(ens)(*(f[1:].numpy() for f in ens))
    topo_t = torch.as_tensor(hills(grid.ny, grid.nx) if topo
                             else np.zeros((grid.ny, grid.nx)),
                             dtype=torch.float32)
    z_full = grid.calc_z(topo_t)
    tmpl = synthetic_conv_network(cfg, grid, np.random.default_rng(seed),
                                  n_sonde=40, n_ps=80)
    obs = obsmake(state_to_history(state_trans(to_collocated(nat)), z_full,
                                   topo_t),
                  tmpl, grid, cfg, z_full, np.random.default_rng(seed + 1))
    if slots:
        times = (np.arange(1, 4) - 2) * 2 * dycfg.dt
        obs.dif = np.random.default_rng(seed + 2).choice(times, obs.nobs)
    return cfg, grid, dycfg, dom, ens, obs


def _exec_driver(cfg, grid, dycfg, dom, device, topo: bool, per_member: bool,
                 mesh=None):
    from scale_letkf_torch.cli.main import make_driver
    from scale_letkf_torch.cycle import CycleDriver
    flat = make_driver(cfg, grid, dycfg, dom, device)
    d = CycleDriver(grid, cfg, dycfg, flat.rho_ref, flat.p_ref,
                    topo=hills(grid.ny, grid.nx) if topo else None,
                    phys_cfg=flat.phys_cfg, core=flat.core,
                    n_small=flat.n_small, mesh=mesh,
                    bdy=(per_member_boundary(grid, dom, cfg.ensemble.member,
                                             device)
                         if per_member else base_boundary(grid, dom,
                                                          device)),
                    bdy_width=dom["bdy_width"], bdy_tau=dom["bdy_tau"])
    return d


def _rounded_np(a, gen):
    return (a * (1.0 + 2.0 ** -24 * gen.standard_normal(a.shape))).astype(
        np.float32)


def streamed_vs_cpu(device: torch.device, config: str,
                    seed: int = 0) -> dict:
    """StreamedCycle with terrain (gpu_check.hills), the physics suite,
    per-member Davies forcing and a 3-slot 4-D window (EXEC_STEPS to the
    analysis, the window to 2·EXEC_STEPS) on `device` and twice on the
    CPU: the guess and the analysis per variable, the skin temperature,
    H(x) (max over its range), QC equal, and the launches (the terrain
    tendency is plain PyTorch, so only the solver launches)."""
    from scale_letkf_torch.da.bigcycle import StreamedCycle
    from scale_letkf_torch.state import IA_T
    cfg, grid, dycfg, dom, ens, obs = _exec_case(config, seed, True, True)
    gen = np.random.default_rng(seed + 5)
    alt = type(ens)(*(_rounded_np(f, gen) for f in ens))
    runs = {}
    for key, dev, e in (("device", device, ens),
                        ("cpu", torch.device("cpu"), ens),
                        ("cpu_rounded", torch.device("cpu"), alt)):
        d = _exec_driver(cfg, grid, dycfg, dom, dev, True, True)
        sc = StreamedCycle(d, member_batch=EXEC_BATCH, tile_rows=EXEC_ROWS)
        before = dict(kernels.LAUNCHES)
        gues, ensval, qc, t = sc.forecast_and_hx(e, EXEC_STEPS, obs)
        g0 = gues.copy()
        anal, _, _, st = sc.analysis(gues, obs, ensval, qc)
        runs[key] = {"gues": g0, "anal": anal, "ensval": ensval, "qc": qc,
                     "tsfc": sc.tsfc_host, "launches": _launches(before),
                     "tiles": st["letkf_tiles"], "chunks": st["letkf_chunks"],
                     "batches": t["batches"]}
    dv, cp, rd = runs["device"], runs["cpu"], runs["cpu_rounded"]
    base = state_trans(dycore.to_collocated(dycore.DycoreState(
        *(torch.from_numpy(f) for f in ens)))).numpy()
    err = {f"gues.{k}": v for k, v in _vars_over_tol(
        dv["gues"], cp["gues"], base, rd["gues"]).items()}
    err.update({f"anal.{k}": v for k, v in _vars_over_tol(
        dv["anal"], cp["anal"], base, rd["anal"],
        cp["anal"] - cp["anal"].mean(axis=0)).items()})
    good = cp["qc"] == 0
    y, y_c, y_r = (r["ensval"][:, good] for r in (dv, cp, rd))
    err["hx"] = float(np.abs(y - y_c).max() / (
        2e-5 * np.ptp(y_c) + 2 * np.abs(y_r - y_c).max()))
    cold = base[:, IA_T, 0]
    err["tsfc"] = float(np.abs(dv["tsfc"] - cp["tsfc"]).max() / (
        1e-4 * np.abs(cp["tsfc"] - cold).max()
        + 2 * np.abs(rd["tsfc"] - cp["tsfc"]).max()))
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": MEMBERS,
            "steps": EXEC_STEPS, "slots": 3, "nobs": int(obs.nobs),
            "batches": dv["batches"], "tiles": dv["tiles"],
            "kernel_launches": {k: runs[k]["launches"]
                                for k in ("device", "cpu")},
            "expected_launches": {
                "invsqrt_ns": grid.nz * dv["chunks"] * var_local_groups(cfg),
                "dyn_tendency": 0, "adv_ud3": 0},
            "qc_equal": bool(np.array_equal(dv["qc"], cp["qc"])),
            "finite": bool(np.isfinite(dv["anal"]).all()),
            "max_err_over_tol": err}


def streamed_grid_on_device(device: torch.device, config: str,
                            seed: int = 0, shape=GRID,
                            member_batch: int = EXEC_BATCH,
                            pipeline: bool = False, cycles: int = 2,
                            over: dict | None = None,
                            members: int = MEMBERS) -> dict:
    """streamed_vs_cpu's composition (terrain, the physics suite,
    per-member Davies forcing, the 3-slot window; `over` and `members`
    replace its sizes) through StreamedCycle on `device`, undecomposed and
    on make_mesh(*shape) (`pipeline` on the grid), `cycles` cycles of
    EXEC_STEPS from the same obs, each resuming the last one's skin
    temperature and inflation: whether the grid run's restart ensembles,
    skin temperatures, inflation, O−A and O−B / O−A tables equal the
    undecomposed run's bit for bit, the largest difference per name,
    whether the driver's own skin temperature and boundary data were left
    as they were, and both runs' launches."""
    from scale_letkf_torch.da.bigcycle import StreamedCycle
    from scale_letkf_torch.parallel.mesh import make_mesh
    cfg, grid, dycfg, dom, ens, obs = _exec_case(config, seed, True, True,
                                                 over, members)
    runs = {}
    for key, mesh in (("undecomposed", None), ("grid", make_mesh(*shape))):
        d = _exec_driver(cfg, grid, dycfg, dom, device, True, True, mesh)
        bdy0 = d.bdy
        sc = StreamedCycle(d, member_batch=member_batch, tile_rows=EXEC_ROWS,
                           pipeline=pipeline and mesh is not None)
        before = dict(kernels.LAUNCHES)
        arrays, stats, e, infl = {}, [], ens, None
        for c in range(cycles):
            e, infl, rep = sc.cycle(e, obs, EXEC_STEPS, infl_field=infl)
            for n, f in zip(dycore.DycoreState._fields, e):
                arrays[f"{n}.{c}"] = np.array(f)
            arrays[f"tsfc.{c}"] = sc.tsfc_host.copy()
            arrays[f"oma.{c}"] = np.asarray(sc.last_oma)
            if infl is not None:
                arrays[f"infl.{c}"] = np.asarray(torch.as_tensor(infl).cpu())
            stats += [(st.nobs, st.rmse, st.bias) for st in (
                rep["stats_gues"], rep["stats_anal"])]
        runs[key] = {"arrays": arrays, "stats": stats,
                     "launches": _launches(before),
                     "batches": rep["batches"],
                     "untouched": d.tsfc is None and d.bdy is bdy0}
    a, b = runs["grid"]["arrays"], runs["undecomposed"]["arrays"]
    dist = {n: float(np.abs(a[n] - b[n]).max()) for n in b}
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": members,
            "mesh": list(shape), "cycles": cycles, "steps": EXEC_STEPS,
            "pipeline": pipeline, "batches": runs["grid"]["batches"],
            "bit_equal": a.keys() == b.keys() and all(
                np.array_equal(a[n], b[n]) for n in b),
            "distance": dist,
            "stats_equal": runs["grid"]["stats"] == runs["undecomposed"][
                "stats"],
            "driver_untouched": runs["grid"]["untouched"],
            "kernel_launches": runs["grid"]["launches"],
            "expected_launches": runs["undecomposed"]["launches"]}


def resident_vs_cpu(device: torch.device, config: str,
                    seed: int = 0) -> dict:
    """ResidentCycle over flat ground with the physics suite and shared
    Davies forcing, EXEC_STEPS steps in calls of EXEC_CALL (a segment
    boundary inside the window), on `device` and twice on the CPU: the
    analysis members per variable, the skin temperature, the per-obs O−B
    and O−A (within 2e-5 of their range, twice the floor, and one
    bfloat16 spacing of the members' H(x) perturbations, which the stored
    deviations carry), and the launches of all three kernels."""
    from scale_letkf_torch.da.resident import ResidentCycle, ResidentEnsemble
    from scale_letkf_torch.state import IA_T
    cfg, grid, dycfg, dom, ens, obs = _exec_case(config, seed, False, False)
    base = state_trans(dycore.to_collocated(dycore.DycoreState(
        *(torch.from_numpy(f) for f in ens)))).numpy()
    gen = np.random.default_rng(seed + 6)
    runs = {}
    for key, dev, a0 in (("device", device, base),
                         ("cpu", torch.device("cpu"), base),
                         ("cpu_rounded", torch.device("cpu"),
                          _rounded_np(base, gen))):
        d = _exec_driver(cfg, grid, dycfg, dom, dev, False, False)
        rc = ResidentCycle(d, member_batch=EXEC_BATCH, tile_rows=EXEC_ROWS,
                           max_steps_per_call=EXEC_CALL)
        re = ResidentEnsemble.from_host_gues(a0, device=dev)
        before = dict(kernels.LAUNCHES)
        rep = rc.cycle(re, obs, EXEC_STEPS)
        runs[key] = {"anal": re.to_host_gues(), "tsfc": re.tsfc.cpu().numpy(),
                     "dep": rc.last_ctx.dep, "oma": rc.last_oma,
                     "hdxb": rc.last_ctx.hdxb,
                     "qc": rc.last_ctx.qc, "launches": _launches(before),
                     "batches": rep["batches"], "tiles": rep["letkf_tiles"],
                     "chunks": rep["letkf_chunks"],
                     "h2d_bytes": rep["h2d_bytes"],
                     "d2h_bytes": rep["d2h_bytes"]}
    dv, cp, rd = runs["device"], runs["cpu"], runs["cpu_rounded"]
    err = _vars_over_tol(dv["anal"], cp["anal"], base, rd["anal"],
                         cp["anal"] - cp["anal"].mean(axis=0))
    good = cp["qc"] == 0
    # a flip of one bfloat16 rounding in each member's stored deviation
    # moves the mean's H(x) by at most 2⁻⁷ of the largest member H(x)
    # perturbation, per obs
    flip = 2.0 ** -7 * np.abs(cp["hdxb"][good]).max(axis=1)
    for k in ("dep", "oma"):
        a, b, c = (r[k][good] for r in (dv, cp, rd))
        err[k] = float(np.max(np.abs(a - b) / (
            2e-5 * np.ptp(b) + 2 * np.abs(c - b).max() + flip)))
    cold = base[:, IA_T, 0]
    err["tsfc"] = float(np.abs(dv["tsfc"] - cp["tsfc"]).max() / (
        1e-4 * np.abs(cp["tsfc"] - cold).max()
        + 2 * np.abs(rd["tsfc"] - cp["tsfc"]).max()))
    fcst = 3 * EXEC_STEPS * dv["batches"]
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": MEMBERS,
            "steps": EXEC_STEPS, "max_steps_per_call": EXEC_CALL,
            "batches": dv["batches"], "tiles": dv["tiles"],
            "kernel_launches": {k: runs[k]["launches"]
                                for k in ("device", "cpu")},
            "expected_launches": {
                "invsqrt_ns": grid.nz * dv["chunks"] * var_local_groups(cfg),
                "dyn_tendency": fcst, "adv_ud3": fcst},
            "h2d_bytes": dv["h2d_bytes"], "d2h_bytes": dv["d2h_bytes"],
            "qc_equal": bool(np.array_equal(dv["qc"], cp["qc"])),
            "finite": bool(np.isfinite(dv["anal"]).all()),
            "max_err_over_tol": err}


STREAMED_VERB_CONFIG = DET_VERB_CONFIG.replace(
    "infl_add = 0.1\ninfl_add_shuffle = true\n", "")
GRID_TABLE = """
[process]
mesh_member = {}
mesh_y = {}
mesh_x = {}
""".format(*GRID)


def streamed_verb_vs_cpu(device: torch.device, seed: int = 0) -> dict:
    """The cycle --streamed verb (--member-batch 5, --tile-rows 4, 1 cycle
    of DET_VERB_STEPS steps) on DET_VERB_CONFIG's small checkpoint without
    its member and additive inflation, with --device on `device` and on
    the CPU, and on the CPU from an init perturbed by one rounding: per
    restart field, the worst |Δ| over 1e-4·max|Δ|·(1 + 2·floor) plus one
    bfloat16 spacing (2⁻⁷) of the field's largest member perturbation;
    the solver's launches. The verb runs on `device` a second time with
    the GRID_TABLE [process] table (each batch forecast on the grid): its
    fields against the CPU at the same bounds ('grid.' rows), and its
    largest difference from the undecomposed run on `device`
    (grid_distance, 0 when bit-equal)."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path
    from scale_letkf_torch.cli.main import main
    from scale_letkf_torch.da.bigcycle import stream_batch
    from scale_letkf_torch.parallel.mesh import make_mesh
    from scale_letkf_torch.da.obsmake import make_obs_network
    from scale_letkf_torch.grid import Grid
    from scale_letkf_torch.io import checkpoint
    from scale_letkf_torch.obs import io as obsio
    K = 20
    grid = Grid.uniform(nx=16, ny=12, nz=8, dx=2000.0, dy=2000.0, dz=500.0)
    members = _verb_members(K + 1, seed, grid)
    ens0 = dycore.DycoreState(*(np.stack(f) for f in zip(*members[:K])))
    gen = np.random.default_rng(seed)
    launches, outs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t = Path(tmp)
        (t / "exp.toml").write_text(STREAMED_VERB_CONFIG)
        (t / "grid.toml").write_text(STREAMED_VERB_CONFIG + GRID_TABLE)
        checkpoint.save_ensemble(t / "init", ens0, basename="anal.@@@@")
        checkpoint.save_ensemble(t / "init_rounded", dycore.DycoreState(
            *(_rounded_np(f, gen) for f in ens0)), basename="anal.@@@@")
        checkpoint.save_member(t / "nature.npz", members[K])
        obsio.write_obs(str(t / "template.dat"), make_obs_network(
            grid, np.random.default_rng(seed), n_profiles=15,
            levels_hpa=(900.0, 800.0)))
        cfg = ["--config", str(t / "exp.toml")]
        with contextlib.redirect_stdout(io.StringIO()):
            main(["obsmake", *cfg, "--nature", str(t / "nature.npz"),
                  "--obs-template", str(t / "template.dat"), "--out",
                  str(t / "obs.dat"), "--seed", "5", "--device", "cpu"])
        for key, dev, init, toml in (
                ("device", str(device), "init", "exp.toml"),
                ("device_grid", str(device), "init", "grid.toml"),
                ("cpu", "cpu", "init", "exp.toml"),
                ("cpu_rounded", "cpu", "init_rounded", "exp.toml")):
            before = dict(kernels.LAUNCHES)
            with contextlib.redirect_stdout(io.StringIO()):
                main(["cycle", "--config", str(t / toml), "--init",
                      str(t / init), "--cycles",
                      "1", "--steps-per-cycle", str(DET_VERB_STEPS),
                      "--obs-pattern", str(t / "obs.dat"), "--out",
                      str(t / key), "--streamed", "--member-batch", "5",
                      "--tile-rows", "4", "--device", dev])
            launches[key] = _launches(before)
            outs[key] = checkpoint.load_ensemble(t / key)
    err = {}
    for i, name in enumerate(dycore.DycoreState._fields):
        b, c, f0 = (outs["cpu"][0][i], outs["cpu_rounded"][0][i], ens0[i])
        tol = (1e-4 * np.abs(b - f0).max() * (1 + 2 * np.abs(c - b).max()
                                              / (1e-4 * np.abs(b - f0).max()))
               + 2.0 ** -7 * np.abs(b - b.mean(axis=0)).max())
        for pre, key in (("", "device"), ("grid.", "device_grid")):
            err[pre + name] = float(np.abs(outs[key][0][i] - b).max() / tol)
    dev, grd = outs["device"], outs["device_grid"]
    # the grid verb: the undecomposed run's solver launches, and each
    # stencil kernel 3 stages × steps on every block of every batch (one
    # inner batch at this size)
    fcst = 3 * DET_VERB_STEPS * int(np.prod(GRID)) * (K // stream_batch(
        K, 5, make_mesh(*GRID)))
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
            "steps": DET_VERB_STEPS, "mesh": list(GRID),
            "kernel_launches": {k: launches[k] for k in (
                "device", "device_grid", "cpu")},
            "meta": dev[2], "grid_meta": grd[2],
            "grid_expected_launches": {
                "invsqrt_ns": launches["device"]["invsqrt_ns"],
                "dyn_tendency": fcst, "adv_ud3": fcst},
            "grid_distance": max(float(np.abs(a - b).max())
                                 for a, b in zip(grd[0], dev[0])),
            "grid_aux_equal": sorted(grd[1]) == sorted(dev[1]) and all(
                np.array_equal(grd[1][k], dev[1][k]) for k in dev[1]),
            "max_err_over_tol": err}


def executors_vs_cpu(device: torch.device, config: str,
                     seed: int = 0) -> dict:
    """The executor checks above: four on `device` against the CPU, and
    the streamed cycle on GRID against its undecomposed run on `device`."""
    return {"tiled": tiled_vs_cpu(device, config, seed),
            "streamed": streamed_vs_cpu(device, config, seed),
            "streamed_grid": streamed_grid_on_device(device, config, seed),
            "resident": resident_vs_cpu(device, config, seed),
            "verb": streamed_verb_vs_cpu(device, seed)}


def executors_check_passes(res: dict) -> bool:
    """Whether executors_vs_cpu passes: every error within its bound, QC
    equal, finite, the pipelined tiles equal to the plain ones, each
    kernel launched on the card as expected and never on the CPU, the
    streamed cycle on the grid and the verb with [process] at distance 0
    from their undecomposed runs."""
    ok = all(e <= 1 for r in res.values()
             for e in r.get("max_err_over_tol", {}).values())
    g = res["streamed_grid"]
    ok = ok and (g["bit_equal"] and not any(g["distance"].values())
                 and g["stats_equal"] and g["driver_untouched"]
                 and g["kernel_launches"] == g["expected_launches"])
    t, s, r, v = (res[k] for k in ("tiled", "streamed", "resident", "verb"))
    ok = ok and t["finite"] and s["finite"] and r["finite"]
    ok = ok and s["qc_equal"] and r["qc_equal"] and t["pipeline_bit_equal"]
    ok = ok and (t["kernel_launches"]["device"]
                 == t["kernel_launches"]["device_pipelined"]
                 == t["expected_launches"]) and t["kernel_launches"]["cpu"] == 0
    for x in (s, r):
        ok = ok and x["kernel_launches"]["device"] == x["expected_launches"]
        ok = ok and not any(x["kernel_launches"]["cpu"].values())
    ok = ok and v["kernel_launches"]["device"]["invsqrt_ns"] > 0
    ok = ok and (v["kernel_launches"]["device_grid"]
                 == v["grid_expected_launches"])
    ok = ok and not any(v["kernel_launches"]["cpu"].values())
    ok = ok and v["grid_distance"] == 0 and v["grid_aux_equal"]
    return ok and v["meta"] == v["grid_meta"] == {"cycles": 1,
                                                  "streamed": True}


# --- one-way nesting and the fused cycle (nested_small, fused_small) -------
# tests/test_cli_nested.py's experiment (16×16×6 parent at 3 km, a ratio-2
# 16×16×6 child at dt 1 s, K = 4), the child's lateral boundaries open, so
# on the card its slow tendencies run kernels #2 and #3 in the open mode
NEST_VERB_CONFIG = """
[domain]
nx = 16
ny = 16
nz = 6
dx = 3000.0
dy = 3000.0
dz = 500.0
dt = 2.0

[nest]
i0 = 4.0
j0 = 4.0
ratio = 2
nx = 16
ny = 16
nz = 6
dz = 500.0
dt = 1.0
bdy_width = 4
bdy_tau = 60.0
lateral = "open"

[ensemble]
member = 4

[letkf]
infl_mul = 1.05

[letkf_obs]
hori_local = [9.0e3, {rest}]

[obs_error]
t = 0.1
u = 0.1
v = 0.1
""".format(rest=", ".join(["-1.0"] * 23))
NEST_VERB_STEPS = 4


def _nest_verb_inputs(t, seed: int) -> None:
    """tests/test_cli_nested.py's inputs made by the port on the CPU in
    directory t: the parent init (a warm bubble, K perturbed members), the
    child init (parent_to_child of it), both again rounded once, and one
    cycle's obs in each domain from the nature run advanced
    NEST_VERB_STEPS steps."""
    from scale_letkf_torch.cli.main import make_driver, make_nested
    from scale_letkf_torch.da.obsmake import make_obs_network, obsmake
    from scale_letkf_torch.io import checkpoint
    from scale_letkf_torch.model.ideal import (
        add_warm_bubble, balanced_state, perturb_ensemble)
    from scale_letkf_torch.model.nesting import parent_to_child
    from scale_letkf_torch.obs import io as obsio
    cpu = torch.device("cpu")
    cfg, grid, dycfg, dom = load_config_and_grid(str(t / "exp.toml"))
    parent = make_driver(cfg, grid, dycfg, dom, cpu)
    child, geom, _ = make_nested(cfg, grid, dycfg, dom, cpu)
    s0, _, _ = balanced_state(grid.nz, grid.ny, grid.nx, 500.0)
    s0 = add_warm_bubble(s0, 500.0, grid.dx, grid.dy, amplitude=2.0,
                         center=(grid.nx * grid.dx / 2,
                                 grid.ny * grid.dy / 2, 1.5e3),
                         radius=(9e3, 9e3, 1.2e3))
    allp = perturb_ensemble(torch.Generator().manual_seed(seed), s0,
                            cfg.ensemble.member + 1, amplitude=0.5)
    truth = dycore.DycoreState(*(f[0] for f in allp))
    p_ens = dycore.DycoreState(*(f[1:] for f in allp))
    cshape = (child.grid.nz, child.grid.ny, child.grid.nx)
    c_ens = parent_to_child(p_ens, geom, cshape, grid.cz, child.grid.cz)
    gen = torch.Generator().manual_seed(seed + 1)
    for name, e in (("init", p_ens), ("cinit", c_ens),
                    ("init_rounded", _rounded(p_ens, gen)),
                    ("cinit_rounded", _rounded(c_ens, gen))):
        checkpoint.save_ensemble(t / name, e, basename="anal.@@@@")
    rng = np.random.default_rng(seed)
    truth = parent.forecast_one(truth, NEST_VERB_STEPS)
    nf = state_to_history(state_trans(dycore.to_collocated(truth)),
                          parent.z_full, parent.topo)
    obsio.write_obs(str(t / "obs0.dat"), obsmake(
        nf, make_obs_network(grid, rng, n_profiles=12,
                             levels_hpa=(950.0, 850.0)),
        grid, cfg, parent.z_full, rng))
    ctruth = parent_to_child(truth, geom, cshape, grid.cz, child.grid.cz)
    cnf = state_to_history(state_trans(dycore.to_collocated(ctruth)),
                           child.z_full, child.topo)
    obsio.write_obs(str(t / "cobs0.dat"), obsmake(
        cnf, make_obs_network(child.grid, rng, n_profiles=8,
                              levels_hpa=(950.0, 850.0)),
        child.grid, cfg, child.z_full, rng))


def nested_verb_vs_cpu(device: torch.device, seed: int = 0) -> dict:
    """The cycle verb with a [nest] section (NEST_VERB_CONFIG, the child
    open) on `device` and on the CPU, and once more on the CPU from both
    inits rounded once, in a temporary directory: one cycle of
    NEST_VERB_STEPS parent steps. Per restart field of the parent's and the
    child's analysis: |Δ| within 1e-4·max|Δ|·(1 + 2·floor) (≤ 1 passes);
    the stencil kernels' launches on each device."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path
    from scale_letkf_torch.cli.main import main
    from scale_letkf_torch.io import checkpoint
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = Path(tmp)
        (t / "exp.toml").write_text(NEST_VERB_CONFIG)
        _nest_verb_inputs(t, seed)
        for key, dev, sfx in (("device", str(device), ""),
                              ("cpu", "cpu", ""),
                              ("cpu_rounded", "cpu", "_rounded")):
            before = dict(kernels.LAUNCHES)
            with contextlib.redirect_stdout(io.StringIO()):
                main(["cycle", "--config", str(t / "exp.toml"), "--init",
                      str(t / f"init{sfx}"), "--cycles", "1",
                      "--steps-per-cycle", str(NEST_VERB_STEPS),
                      "--obs-pattern", str(t / "obs{cycle}.dat"),
                      "--nest-init", str(t / f"cinit{sfx}"),
                      "--nest-obs-pattern", str(t / "cobs{cycle}.dat"),
                      "--out", str(t / f"out_{key}"), "--device", dev])
            launches[key] = _launches(before)

        def load(d):
            parent, _, _ = checkpoint.load_ensemble(t / d)
            child, _, _ = checkpoint.load_ensemble(t / d / "nest")
            return [*parent, *child]
        names = ([f"parent.{n}" for n in dycore.DycoreState._fields]
                 + [f"child.{n}" for n in dycore.DycoreState._fields])
        init = [*checkpoint.load_ensemble(t / "init")[0],
                *checkpoint.load_ensemble(t / "cinit")[0]]
        out = load("out_device")
        err, floor = _err_floor(names, out, load("out_cpu"),
                                load("out_cpu_rounded"), init)
    return {"config": "tests/test_cli_nested.py's, child open",
            "steps": NEST_VERB_STEPS, "kernel_launches": launches,
            "finite": all(bool(np.isfinite(f).all()) for f in out),
            "rounding_floor_over_1e-4_increment": floor,
            "max_err_over_tol": err}


def dbz_template(fields: dict, template: Observations, grid, cfg,
                 z_full: torch.Tensor,
                 rng: np.random.Generator) -> Observations:
    """A fixed radar network valued from history fields and preprocessed as
    the fused cycle takes it (synthetic.obs_from_truth's values): H(x) plus
    noise at the obs errors, reflectivity to linear Z with the gates below
    the echo floor (QC_REF_LOW) weak echoes at half MIN_RADAR_REF, then
    preprocess_radar_obs (dBZ and the ref-zero relabelling). Gates whose
    operator QC failed otherwise are dropped."""
    from scale_letkf_torch.da.letkf_obs import preprocess_radar_obs
    from scale_letkf_torch.da.obsope import compute_hx_single
    from scale_letkf_torch.obs.types import QC_GOOD, QC_REF_LOW
    y, qc = compute_hx_single(fields, template, grid, cfg, z_full)
    y, qc = y.cpu().numpy().astype(np.float64), qc.cpu().numpy()
    keep = (qc == QC_GOOD) | (qc == QC_REF_LOW)
    obs = template.select(keep)
    dat = y[keep] + rng.standard_normal(int(keep.sum())) * obs.err
    ref = obs.elem == ID_RADAR_REF
    dat[ref] = 10.0 ** (dat[ref] / 10.0)
    dat[ref & (qc[keep] == QC_REF_LOW)] = 0.5 * cfg.radar.min_radar_ref
    obs.dat = dat
    return preprocess_radar_obs(obs, cfg)


def fused_launches(cfg, grid, steps: int, batches: int, chunk: int) -> dict:
    """Launches of each kernel in one FusedCycle step on the card: as
    expected_launches without a nature run."""
    out = expected_launches(cfg, grid, steps, batches, chunk)
    fcst = 3 * steps * batches
    return {**out, "dyn_tendency": fcst, "adv_ud3": fcst}


def fused_vs_cpu(device: torch.device, config: str, seed: int = 0) -> dict:
    """One FusedCycle step (RADAR_STEPS forecast steps + the assimilation)
    of the radar configuration at COARSE_RADAR with K = MEMBERS_CYCLE, on
    `device` and twice on the CPU (the second from inputs rounded once):
    the ensemble with rain blobs, the fixed network radar_template's 400
    REF and VR gates valued from the nature run at the window's end
    (dbz_template), the obs values the template's. Per restart field: |Δ| within
    1e-4·max|Δ|·(1 + 2·floor); nobs_used, O−B and O−A, and the kernels'
    launches on each device."""
    from scale_letkf_torch.cli.main import make_driver
    from scale_letkf_torch.da.fastcycle import FusedCycle
    cfg, grid, dycfg, dom = load_config_and_grid(config, COARSE_RADAR)
    cfg.ensemble.member = K = MEMBERS_CYCLE
    cpu = torch.device("cpu")
    kw = {"u0": 5.0, "qr_blob": RADAR_QR_BLOB}
    ens0, _, _ = synthetic_ens_dycore_device(seed, K, grid, dom, cpu, **kw)
    nat, _, _ = synthetic_ens_dycore_device(seed + 1, 1, grid, dom, cpu, **kw)
    d_cpu = make_driver(cfg, grid, dycfg, dom, cpu)
    truth = d_cpu.forecast_one(type(nat)(*(f[0] for f in nat)), RADAR_STEPS)
    template = dbz_template(
        state_to_history(state_trans(dycore.to_collocated(truth)),
                         d_cpu.z_full, d_cpu.topo),
        radar_template(grid, dom, seed), grid, cfg, d_cpu.z_full,
        np.random.default_rng(seed))
    gen = torch.Generator().manual_seed(seed + 6)
    runs = {}
    for key, dev, e0 in (("device", device, ens0), ("cpu", cpu, ens0),
                         ("cpu_rounded", cpu, _rounded(ens0, gen))):
        driver = make_driver(cfg, grid, dycfg, dom, dev)
        fc = FusedCycle(driver, template, RADAR_STEPS)
        before = dict(kernels.LAUNCHES)
        ens, _, diag = fc.step(type(e0)(*(f.to(dev) for f in e0)),
                               torch.as_tensor(fc.template.dat,
                                               dtype=torch.float32,
                                               device=dev),
                               fc.initial_inflation())
        runs[key] = {"state": [f.cpu().numpy() for f in ens],
                     "nobs_used": int(diag["nobs_used"]),
                     "omb": float(diag["omb_rmse"]),
                     "oma": float(diag["oma_rmse"]),
                     "launches": _launches(before),
                     "expected": fused_launches(cfg, grid, RADAR_STEPS,
                                                -(-K // driver.batch),
                                                diag["chunk"])}
    err, floor = _err_floor(ens0._fields, runs["device"]["state"],
                            runs["cpu"]["state"],
                            runs["cpu_rounded"]["state"], ens0)
    dev_, cpu_ = runs["device"], runs["cpu"]
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
            "steps": RADAR_STEPS, "template_obs": int(template.nobs),
            "nobs_used": {"device": dev_["nobs_used"],
                          "cpu": cpu_["nobs_used"]},
            "omb": {"device": dev_["omb"], "cpu": cpu_["omb"]},
            "oma": {"device": dev_["oma"], "cpu": cpu_["oma"]},
            "kernel_launches": {k: runs[k]["launches"]
                                for k in ("device", "cpu")},
            "expected_launches": dev_["expected"],
            "finite": all(bool(np.isfinite(f).all()) for f in dev_["state"]),
            "rounding_floor_over_1e-4_increment": floor,
            "max_err_over_tol": err}


def nesting_fused_vs_cpu(device: torch.device, radar_config: str,
                         seed: int = 0) -> dict:
    """nested_verb_vs_cpu and fused_vs_cpu together."""
    return {"nested_verb": nested_verb_vs_cpu(device, seed),
            "fused": fused_vs_cpu(device, radar_config, seed)}


def nesting_fused_check_passes(res: dict) -> bool:
    """Whether nesting_fused_vs_cpu's result passes: every error within its
    bound, finite, the stencil kernels launched on the device and never on
    the CPU, the fused step's launches as expected on the device, its
    nobs_used equal on both and O−A below O−B."""
    nv, fu = res["nested_verb"], res["fused"]
    ok_err = all(e <= 1 for r in (nv, fu)
                 for e in r["max_err_over_tol"].values())
    nv_l = nv["kernel_launches"]
    fu_l = fu["kernel_launches"]
    return (ok_err and nv["finite"] and fu["finite"]
            and all(nv_l["device"][k] > 0 and nv_l["cpu"][k] == 0
                    for k in ("dyn_tendency", "adv_ud3"))
            and fu_l["device"] == fu["expected_launches"]
            and not any(fu_l["cpu"].values())
            and fu["nobs_used"]["device"] == fu["nobs_used"]["cpu"] > 0
            and fu["oma"]["device"] < fu["omb"]["device"])


# --- the executors on the process grid --------------------------------------
NEST_GRID = {"nx": 24, "ny": 24, "ratio": 3, "i0": 12.0, "j0": 8.0,
             "dt": 10.0, "n_small": 10, "bdy_width": 4, "bdy_tau": 120.0}
NEST_GRID_STEPS = 2      # parent steps; the child's 6 cover the same window


def _fused_inputs(device: torch.device, config: str, seed: int):
    """fused_vs_cpu's inputs on `device`: the radar configuration at
    COARSE_RADAR with K = MEMBERS_CYCLE (its cfg, grid, dycfg, dom), the
    ensemble with rain blobs, the nature member, and the radar template's
    gates valued from the nature run at the window's end (dbz_template)."""
    from scale_letkf_torch.cli.main import make_driver
    cfg, grid, dycfg, dom = load_config_and_grid(config, COARSE_RADAR)
    cfg.ensemble.member = MEMBERS_CYCLE
    kw = {"u0": 5.0, "qr_blob": RADAR_QR_BLOB}
    ens0, _, _ = synthetic_ens_dycore_device(seed, MEMBERS_CYCLE, grid, dom,
                                             device, **kw)
    nat, _, _ = synthetic_ens_dycore_device(seed + 1, 1, grid, dom, device,
                                            **kw)
    truth0 = type(nat)(*(f[0] for f in nat))
    driver = make_driver(cfg, grid, dycfg, dom, device)
    truth = driver.forecast_one(truth0, RADAR_STEPS)
    template = dbz_template(
        state_to_history(state_trans(dycore.to_collocated(truth)),
                         driver.z_full, driver.topo),
        radar_template(grid, dom, seed), grid, cfg, driver.z_full,
        np.random.default_rng(seed))
    return (cfg, grid, dycfg, dom), ens0, truth0, template


FUSED_GRID_CYCLES = 2


def fused_grid_on_device(device: torch.device, config: str,
                         seed: int = 0, cycles: int = FUSED_GRID_CYCLES
                         ) -> dict:
    """`cycles` FusedCycle steps (RADAR_STEPS forecast steps + the
    assimilation, each from the last one's analysis and inflation) of
    fused_vs_cpu's inputs on `device`, undecomposed and on the GRID process
    grid: whether the grid's analysis ensemble, inflation, obs counts, O−B /
    O−A (by group too) and guess and analysis means equal the undecomposed
    steps' bit for bit in every cycle, the largest difference, and the grid
    steps' launches against 3 stages × steps × batches × blocks for #2 and
    #3 and levels × chunks × var-local groups over its shares for #1 in
    each cycle."""
    from scale_letkf_torch.cli.main import make_driver
    from scale_letkf_torch.da.fastcycle import FusedCycle
    (cfg, grid, dycfg, dom), ens0, _, template = _fused_inputs(
        device, config, seed)
    runs = {}
    for key, c in (("undecomposed", cfg), ("grid", _on_grid(cfg))):
        driver = make_driver(c, grid, dycfg, dom, device)
        fc = FusedCycle(driver, template, RADAR_STEPS)
        dat = torch.as_tensor(fc.template.dat, dtype=torch.float32,
                              device=device)
        before = dict(kernels.LAUNCHES)
        ens, infl, arrays = ens0, fc.initial_inflation(), {}
        expected = {k: 0 for k in KERNELS}
        for cyc in range(cycles):
            ens, infl, diag = fc.step(ens, dat, infl)
            if key == "grid":
                expected["invsqrt_ns"] += expected_launches(
                    cfg, grid, RADAR_STEPS, 0, 0,
                    shares=diag["chunk"])["invsqrt_ns"]
                for k in ("dyn_tendency", "adv_ud3"):
                    expected[k] += (3 * RADAR_STEPS * int(np.prod(GRID))
                                    * -(-(MEMBERS_CYCLE // GRID[0])
                                        // driver.batch))
            arrays.update({f"c{cyc}.{k}": v for k, v in {
                **{f"ens.{n}": f for n, f in zip(
                    ens0._fields, _global(driver, ens))}, "infl": infl,
                **{k: diag[k] for k in ("nobs_used", "omb_rmse", "oma_rmse",
                                        "nobs_per_level", "gues_mean",
                                        "anal_mean")},
                **{f"{k}.{n}": diag[k][n] for k in ("omb_by_group",
                                                    "oma_by_group")
                   for n in sorted(diag[k])}}.items()})
        runs[key] = {
            "arrays": {k: v.cpu() for k, v in arrays.items()},
            "launches": _launches(before),
            "expected": None if key == "undecomposed" else expected,
            "nobs_used": int(diag["nobs_used"])}
    a, b = runs["grid"]["arrays"], runs["undecomposed"]["arrays"]
    diff = {k: float((a[k].double() - b[k].double()).abs().max()) for k in a}
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members":
            MEMBERS_CYCLE, "mesh": list(GRID), "steps": RADAR_STEPS,
            "cycles": cycles, "template_obs": int(template.nobs),
            "nobs_used": runs["grid"]["nobs_used"],
            "bit_equal": all(torch.equal(a[k], b[k]) for k in a),
            "max_abs_diff": {k: v for k, v in diff.items() if v},
            "kernel_launches": runs["grid"]["launches"],
            "expected_launches": runs["grid"]["expected"]}


def _nest_grid_child(cfg, grid, dycfg, dom, device: torch.device):
    """The nested grid cycle's child driver (NEST_GRID): a ratio-3 open
    child on the parent's levels with the SI core, as chip_smoke.py's
    nested cycle composes its child, on the parent's [process] grid."""
    from scale_letkf_torch.cli.main import make_driver
    from scale_letkf_torch.grid import Grid
    n = NEST_GRID
    cgrid = Grid(nx=n["nx"], ny=n["ny"], nz=grid.nz, dx=grid.dx / n["ratio"],
                 dy=grid.dy / n["ratio"], cz=grid.cz, fz=grid.fz,
                 proj=grid.proj)
    cdycfg = dataclasses.replace(dycfg, dx=cgrid.dx, dy=cgrid.dy, dt=n["dt"],
                                 lateral="open")
    cdom = {**dom, "core": "si", "n_small": n["n_small"],
            "bdy_width": n["bdy_width"], "bdy_tau": n["bdy_tau"]}
    return make_driver(cfg, cgrid, cdycfg, cdom, device)


def halo_dynamics(driver, mesh) -> None:
    """Replace an undecomposed CycleDriver's dynamics step by the halo
    step of the whole ensemble on `mesh` (the grid's dynamics; physics,
    boundary forcing and schedule stay the undecomposed ones): what a grid that
    decomposes the domain is held to exactly in the open lateral mode,
    whose halo step is the reference's own, not the global open step."""
    from scale_letkf_torch.model.dycore_si import SplitConfig
    from scale_letkf_torch.parallel import halo
    dc = driver.dycfg
    if driver.core == "si":
        def step(s):
            return halo.rk3_step_si_halo_ens(
                s, dc, SplitConfig(dtau=dc.dt / driver.n_small),
                driver.rho_ref, driver.p_ref, driver.z_centers, mesh,
                driver.n_small, driver.vg)
    else:
        def step(s):
            return halo.rk3_step_halo_ens(s, dc, driver.rho_ref, driver.p_ref,
                                          driver.z_centers, mesh, driver.vg)
    driver._dyn_step = step


def nested_grid_cycle_on_device(device: torch.device, config: str,
                                seed: int = 0) -> dict:
    """grid_cycle_on_device's parent (its coarsened sizes, K =
    MEMBERS_CYCLE, its seeded ensemble) and the NEST_GRID child (open,
    24 × 24, ratio 3, the parent's ensemble interpolated) through
    NestedCycleDriver, one cycle of NEST_GRID_STEPS parent steps, on
    `device` on the GRID process grid and undecomposed with the child's
    dynamics the halo step of the whole ensemble on GRID (halo_dynamics:
    the open mode's composition). Obs: obsmake of the nature run at the
    window's end in each domain. Whether both analyses and the O−B / O−A
    tables are equal, and the largest difference."""
    from scale_letkf_torch.cli.main import make_driver
    from scale_letkf_torch.da.obsmake import obsmake
    from scale_letkf_torch.model.nesting import NestGeometry, parent_to_child
    from scale_letkf_torch.nested import NestedCycleDriver
    from scale_letkf_torch.parallel.mesh import make_mesh
    cfg, grid, dycfg, dom = load_config_and_grid(config, COARSE_FCST)
    cfg.ensemble.member = K = MEMBERS_CYCLE
    ens0, _, _ = synthetic_ens_dycore_device(seed, K, grid, dom, device,
                                             u0=10.0)
    nat, _, _ = synthetic_ens_dycore_device(seed + 1, 1, grid, dom, device,
                                            u0=10.0)
    geom = NestGeometry(i0=NEST_GRID["i0"], j0=NEST_GRID["j0"],
                        ratio=NEST_GRID["ratio"])
    parent = make_driver(cfg, grid, dycfg, dom, device)
    child = _nest_grid_child(cfg, grid, dycfg, dom, device)
    cshape = (child.grid.nz, child.grid.ny, child.grid.nx)
    c_ens0 = parent_to_child(ens0, geom, cshape, grid.cz, child.grid.cz)
    truth = parent.forecast_one(type(nat)(*(f[0] for f in nat)),
                                NEST_GRID_STEPS)
    rng = np.random.default_rng(seed)
    obs = []
    for d, t in ((parent, truth), (child, parent_to_child(
            truth, geom, cshape, grid.cz, child.grid.cz))):
        obs.append(obsmake(
            state_to_history(state_trans(dycore.to_collocated(t)), d.z_full,
                             d.topo),
            synthetic_conv_network(cfg, d.grid, rng, n_sonde=20, n_ps=40),
            d.grid, cfg, d.z_full, rng))
    steps_child = NEST_GRID_STEPS * int(round(dycfg.dt / NEST_GRID["dt"]))
    runs = {}
    for key, c in (("undecomposed", cfg), ("grid", _on_grid(cfg))):
        parent = make_driver(c, grid, dycfg, dom, device)
        child = _nest_grid_child(c, grid, dycfg, dom, device)
        if key == "undecomposed":
            halo_dynamics(child, make_mesh(*GRID))
        p_a, c_a, info = NestedCycleDriver(parent, child, geom).cycle(
            ens0, c_ens0, obs[0], obs[1], NEST_GRID_STEPS, steps_child)
        runs[key] = {
            "arrays": [f.cpu() for f in (*_global(parent, p_a),
                                         *_global(child, c_a))],
            "stats": [(st.nobs, st.rmse, st.bias) for dom_ in ("parent",
                                                               "child")
                      for st in (info[dom_]["stats_gues"],
                                 info[dom_]["stats_anal"])],
            "bracket_sections": parent.timer.counts.get("nest_bracket")}
    a, b = runs["grid"]["arrays"], runs["undecomposed"]["arrays"]
    return {"parent": "{nx}x{ny}x{nz}".format(**COARSE_FCST),
            "child": f"{NEST_GRID['nx']}x{NEST_GRID['ny']}, ratio "
                     f"{NEST_GRID['ratio']}, open", "members": K,
            "mesh": list(GRID), "parent_steps": NEST_GRID_STEPS,
            "child_steps": steps_child,
            "nobs": [int(o.nobs) for o in obs],
            "bit_equal": all(torch.equal(x, y) for x, y in zip(a, b)),
            "stats_equal": runs["grid"]["stats"] == runs["undecomposed"][
                "stats"],
            "max_abs_diff": max(float((x - y).abs().max())
                                for x, y in zip(a, b)),
            "bracket_sections": runs["grid"]["bracket_sections"]}


def terrain_grid_step_on_device(device: torch.device, config: str,
                                seed: int = 0) -> dict:
    """One explicit-core step (dt 1 s) of terrain_state's MEMBERS_TERRAIN
    members over hills() on the configuration's levels at COARSE_TERRAIN,
    on `device`: model/terrain.py rk3_step_terrain of the whole domain, and
    parallel/halo.py rk3_step_blocks on make_mesh(1, 2, 2) with each
    block's extended metrics, halo 'explicit' and 'explicit_overlap'.
    Whether the explicit grid step equals the undecomposed one bit for
    bit, the largest differences, and the overlap variant's largest
    difference over TOL_TENDENCY of each field's largest increment."""
    from scale_letkf_torch.model.terrain import make_metrics, rk3_step_terrain
    from scale_letkf_torch.parallel import halo
    from scale_letkf_torch.parallel.mesh import make_mesh
    _, grid, dycfg, _ = load_config_and_grid(config, COARSE_TERRAIN)
    topo = hills(grid.ny, grid.nx)
    fields, rr, pr = terrain_state(seed, MEMBERS_TERRAIN, grid.cz, grid.fz,
                                   topo, grid.dx, grid.dy)
    s = dycore.DycoreState(*(torch.as_tensor(f, device=device)
                             for f in fields))
    rr, pr = (torch.as_tensor(a, device=device) for a in (rr, pr))
    cfg1 = dataclasses.replace(dycfg, dt=1.0)
    vg = dycore.make_vgrid(grid.cz, grid.fz, device)
    zc = torch.as_tensor(np.asarray(grid.cz), dtype=torch.float32,
                         device=device)
    m = make_metrics(torch.as_tensor(topo, device=device), grid.cz, grid.fz,
                     grid.dx, grid.dy)
    want = rk3_step_terrain(s, cfg1, rr, pr, zc, m, vg)
    mesh = make_mesh(1, 2, 2)
    sh = mesh.shard_ensemble(s)
    m_ext = halo.extended_metrics(mesh, m, True)
    got = {}
    for h in ("explicit", "explicit_overlap"):
        out = halo.rk3_step_blocks(mesh, sh.blocks, cfg1, rr, pr, zc, vg,
                                   overlap=h == "explicit_overlap",
                                   metrics=m_ext)
        got[h] = mesh.gather_ensemble(sh._replace(blocks=out))
    names = dycore.DycoreState._fields
    over = {n: float((o - w).abs().max())
            / max(TOL_TENDENCY * float((w - f).abs().max()), 1e-30)
            for n, o, w, f in zip(names, got["explicit_overlap"], want, s)}
    return {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members":
            MEMBERS_TERRAIN, "mesh": [1, 2, 2], "dt": 1.0,
            "bit_equal": all(torch.equal(x, y)
                             for x, y in zip(got["explicit"], want)),
            "max_abs_diff": {n: float((x - y).abs().max())
                             for n, x, y in zip(names, got["explicit"],
                                                want)},
            "overlap_over_tol": over,
            "rhow_moved": float((want.rhow - s.rhow).abs().max())}
