#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the three hand-written CUDA kernels from scale_letkf_torch/csrc,
checks each against its plain PyTorch version, and drives the port's
three paths once each at the full size of the 18-km Japan configuration
(configs/18km_japan.toml, unchanged: 480×360×36 stretched levels, K = 50):
the ensemble forecast (split-explicit core, dt 30 s, 10 acoustic substeps,
2 steps), the LETKF analysis (the synthetic conventional network of ~24k
obs) and the DA cycle that joins them (CycleDriver.run_osse):

  1. device         — the card, and nvidia-smi's name and power limit
  2. build          — nvcc builds of the three kernels, all started
                      together (seconds, ptxas reports, and each kernel's
                      SASS instruction count and opcode mix by cuobjdump);
                      fails if invsqrt_ns holds no tensor-core HMMA
  3. random         — invsqrt_ns kernel vs plain on B = 4096 random
                      LETKF-shaped Grams at K = 20, 50, 100, cond 1e2-1e4,
                      and against float64 eigh on a few of them
  4. tendency       — dyn_tendency kernel vs plain on random states at
                      480×360×36, batch 4, uniform and 18-km metrics,
                      divdmp 0 and 0.05; then at the ragged and tiny
                      shapes of gpu_check.RAGGED_SHAPES (both metrics,
                      divdmp 0/0.05, kdiff4 0/1e-3)
  5. stencil        — adv_ud3 kernel vs plain on all 6 tracers of the same
                      states, kdiff4 0 and 1e-3; then at the ragged shapes
                      with 1 and 6 tracers
  6. forecast       — synthetic restart ensemble made on the card →
                      make_driver → CycleDriver.forecast (2 steps), with
                      timer sections, member batch, peak memory, kernel
                      launches, finiteness and mass conservation
  7. forecast_real  — both stencil kernels vs plain on the operands of one
                      launch of phase 6 (the main path's shapes)
  8. forecast_small — the coarsened forecast on the card against the CPU
  9. slice          — restart generated on the card → state_trans →
                      build_obs_context → analyze → state_trans_inv, with
                      timer sections, chunk size, peak memory and launches
 10. real           — invsqrt_ns kernel vs plain on the Gram matrices of
                      one level chunk of phase 9
 11. small          — the coarsened analysis on the card against the CPU
 12. cycle          — restart ensemble and nature run made on the card →
                      make_driver → CycleDriver.run_osse, one cycle of 2
                      steps: nature forecast, ensemble forecast, obsmake
                      from the nature run, H(x), build_obs_context,
                      analyze, state_trans_inv, O−A monitor; with timer
                      sections, obs kept, launches of all three kernels,
                      peak memory, O−B / O−A RMSE, RMSE against the nature
                      run and spreads; then the nature run's obsmake twice
                      more, timed (a first-call cost shows as the gap)
 13. cycle_real     — every kernel vs plain on the operands of phase 12:
                      invsqrt_ns on one level chunk of the cycle's Grams,
                      the stencil kernels at the ensemble forecast's member
                      batch and at the nature run's batch of one
 14. cycle_small    — the coarsened cycle on the card against the CPU, the
                      4-D obs operator on a 3-slot window and radar H(x)
                      with every reflectivity method

Each phase prints one JSON line; any failed check raises, so the script
exits non-zero. Every kernel-vs-plain check runs the kernel twice and holds
both runs to the bound (invsqrt_ns, which has no atomics, must also give
bit-identical runs). Kernel and plain versions are timed with CUDA events,
in turns (plain, kernel, kernel, plain), after a warm-up. The line before
the last lists every kernel of the main path, the cycle, which runs all
three: route, source, the TPU kernel it replaces, its launches in phase 12
(each path's own beside them), its error and time against the plain
version on phase 12's operands (phase 13; for the stencil kernels the mean
over the two batch sizes weighted by their launches, so launches × ms is
the kernel's time in the cycle, each size under `shapes`), and its bound:
the larger of the bytes it must move over 3.35 TB/s and its operations
over the rate of the units that do them, computed from those operands —
67 TFLOP/s FP32 for the stencils, and for invsqrt_ns's 3xTF32 tensor-core
products three TF32 passes at 495 TFLOP/s, with its FP32 bound beside it
as bound_fp32_ms. The last line is {"ok": true, "device": {...}}. Without
a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

CONFIG = Path(__file__).resolve().parent / "configs" / "18km_japan.toml"
SEED = 0
RANDOM_B = 4096
# Kernel vs plain, relative to max|isq|. The kernel runs the plain version's
# algorithm with 3xTF32 tensor-core products; their emulation on the CPU
# (tests/test_torch_invsqrt_tf32.py, 8 matrices a case) differed from the
# plain FP32 version by at most 2.4e-6, 1.5e-5 and 1.5e-4 at cond 1e2, 1e3
# and 1e4 (K = 20, 50, 100), so 1e-4 holds up to cond 1e3 and 1e-3 at 1e4.
TOL_RANDOM = {1e2: 1e-4, 1e3: 1e-4, 1e4: 1e-3}
TOL_REAL = 1e-4
# Kernel vs float64 eigh, relative to max|isq|: the bounds of
# tests/test_torch_invsqrt.py and tests/test_torch_invsqrt_tf32.py
TOL_F64 = {1e2: 2e-5, 1e3: 1e-4, 1e4: 1e-3}
# Stencil kernels vs plain: gpu_check.TOL_TENDENCY (2e-5) and TOL_STENCIL
# (1e-5) per field, relative to max|plain|.
STENCIL_BATCH = 4
FCST_STEPS = 2
FCST_U0 = 10.0
CYCLE_STEPS = 2
# The cycle's ensemble and nature run: ρθ noise of amplitude CYCLE_AMP_THETA
# K (the forecast phase's is 0.5 K; a standard deviation of 0.375 of it)
# smoothed by CYCLE_SMOOTH_PASSES 1-2-1 passes along x, y and z (σ ≈ 5.7
# cells ≈ 100 km), so that the obs, ~16 cells apart, see correlated errors
CYCLE_AMP_THETA = 4.0
CYCLE_SMOOTH_PASSES = 64
KERNELS = ("invsqrt_ns", "dyn_tendency", "adv_ud3")
REPLACES = {
    "invsqrt_ns": "scale_letkf_tpu/ops/invsqrt.py:183",
    "dyn_tendency": "scale_letkf_tpu/ops/pallas_tendency.py:257",
    "adv_ud3": "scale_letkf_tpu/ops/pallas_stencil.py:111",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() on the current stream (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(a, areg, reps: int = 5) -> dict:
    """Kernel and plain versions on the same operands: errors relative to
    max|isq| of the plain version, whether two kernel runs are
    bit-identical, and both times in turns."""
    from scale_letkf_torch.ops.invsqrt import invsqrt_ns_kernel, invsqrt_ns_plain
    isq_k, inv_k = invsqrt_ns_kernel(a, areg)
    isq_2, inv_2 = invsqrt_ns_kernel(a, areg)
    isq_p, inv_p = invsqrt_ns_plain(a, areg)
    torch.cuda.synchronize()
    same = bool(torch.equal(isq_k, isq_2) and torch.equal(inv_k, inv_2))
    del isq_2, inv_2
    scale = float(isq_p.abs().max())
    err = float((isq_k - isq_p).abs().max())
    err_inv = float((inv_k - inv_p).abs().max()) / float(inv_p.abs().max())
    finite = bool(torch.isfinite(isq_k).all() and torch.isfinite(inv_k).all())

    def plain():
        invsqrt_ns_plain(a, areg)

    def kern():
        invsqrt_ns_kernel(a, areg)

    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kern, reps)
    k2 = cuda_ms(kern, reps)
    p2 = cuda_ms(plain, reps)
    return {"max_abs_err": err, "rel_err": err / scale, "rel_err_inv": err_inv,
            "finite": finite, "bit_identical_runs": same,
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}


def random_grams(K: int, cond: float, B: int, gen, device):
    """tests/test_invsqrt.py's LETKF-shaped Grams hᵀh·scale/40 + (K-1)·I,
    scale set for the target condition number (Marchenko–Pastur edge of
    hᵀh/40), and B/64 rows of C = s·I (the zero-obs case)."""
    lam = (1.0 + (K / 40.0) ** 0.5) ** 2
    scale = (cond - 1.0) * (K - 1) / lam
    h = torch.randn((B, 40, K), generator=gen, device=device)
    c = (h.transpose(1, 2) @ h) * (scale / 40.0)
    c.diagonal(dim1=1, dim2=2).add_(K - 1.0)
    smin = torch.full((B,), K - 1.0, device=device)
    n_id = B // 64
    s = (K - 1) / 1.25
    c[:n_id] = s * torch.eye(K, device=device)
    smin[:n_id] = s
    return c, smin, n_id


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": line, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})


def sass_mix(lib: Path) -> dict:
    """Static SASS of each kernel in a built library (cuobjdump -sass):
    {kernel: {"instructions": n, opcode: count, ...}}, the opcode without
    its modifiers (MUFU.RCP counts as MUFU), NOPs left out."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib}: {res.stderr}")
    mix, fn = {}, None
    for ln in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = mix.setdefault(m.group(1), Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                     ln)
        if m and fn is not None and m.group(1) != "NOP":
            fn[m.group(1)] += 1
    return {name: {"instructions": sum(c.values()), **dict(c.most_common())}
            for name, c in mix.items()}


def phase_build():
    from scale_letkf_torch.utils import kernels
    t0 = time.perf_counter()
    libs = kernels.build_all(KERNELS)
    wall = time.perf_counter() - t0
    for name in KERNELS:
        log = kernels.BUILD_LOG[name]
        ptxas = [ln.strip() for ln in log["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        sass = sass_mix(libs[name])
        emit({"phase": "build", "kernel": name, "seconds": wall,
              "nvcc_seconds": log["seconds"], "ptxas": ptxas, "sass": sass})
        # the solver's products must run on the tensor cores: an FMA-only
        # build of it does not pass
        if name == "invsqrt_ns" and not (sass and all(
                mix.get("HMMA", 0) > 0 for mix in sass.values())):
            raise AssertionError(f"invsqrt_ns SASS holds no HMMA: {sass}")


def phase_random(device):
    from scale_letkf_torch.ops.invsqrt import invsqrt_ns_kernel, ns_operands
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    for K in (20, 50, 100):
        for cond, tol in TOL_RANDOM.items():
            c, smin, n_id = random_grams(K, cond, RANDOM_B, gen, device)
            a, areg, cn = ns_operands(c, smin)
            r = kernel_vs_plain(a, areg)
            # measured condition and the kernel's error against float64
            # eigh on a few of the random (non-identity) matrices
            sub = c[n_id:n_id + 8].double().cpu().numpy()
            w, v = np.linalg.eigh(sub)
            isq_ref = np.einsum("bik,bk,bjk->bij", v, 1.0 / np.sqrt(w), v)
            z, _ = invsqrt_ns_kernel(a[n_id:n_id + 8].contiguous(),
                                     areg[n_id:n_id + 8].contiguous())
            isq_k = (z[:, :K, :K] * torch.rsqrt(cn[n_id:n_id + 8])[:, None, None]
                     ).double().cpu().numpy()
            # the C = s·I rows must come out exactly s^{-1/2}·I (to 1e-6)
            zi, _ = invsqrt_ns_kernel(a[:n_id].contiguous(),
                                      areg[:n_id].contiguous())
            isq_i = zi[:, :K, :K] * torch.rsqrt(cn[:n_id])[:, None, None]
            s = (K - 1) / 1.25
            eye_err = float((isq_i - torch.eye(K, device=device) / s ** 0.5
                             ).abs().max()) * s ** 0.5
            row = {"K": K, "cond_target": cond,
                   "cond_measured": float(np.median(w[:, -1] / w[:, 0])),
                   "tol": tol, "err_vs_f64": float(
                       np.abs(isq_k - isq_ref).max() / np.abs(isq_ref).max()),
                   "identity_rel_err": eye_err, **r}
            emit({"phase": "random", **row})
            if not (r["finite"] and r["bit_identical_runs"]
                    and r["rel_err"] <= tol and eye_err <= 1e-6
                    and row["err_vs_f64"] <= TOL_F64[cond]):
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version or with float64: {row}")


def phase_slice(device, capture):
    from scale_letkf_torch.cli.main import load_config_and_grid
    from scale_letkf_torch.da.letkf import analyze
    from scale_letkf_torch.da.letkf_obs import build_obs_context
    from scale_letkf_torch.ops import invsqrt as invsqrt_mod
    from scale_letkf_torch.ops.obs_select import bucket_sort_backend
    from scale_letkf_torch.state import (
        NV3D, V3D_ANAL_NAMES, state_trans, state_trans_inv, ensemble_spread)
    from scale_letkf_torch.synthetic import (
        synthetic_conv_network, synthetic_gues_device)
    from scale_letkf_torch.utils import kernels
    from scale_letkf_torch.utils.timing import Timer

    cfg, grid, _, _ = load_config_and_grid(str(CONFIG))
    K = cfg.ensemble.member
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    timer = Timer(device)
    with timer.section("generate_restart"):
        restart = state_trans_inv(synthetic_gues_device(
            SEED, K, nz, ny, nx, grid.cz, device))
    rng = np.random.default_rng(SEED)
    obs = synthetic_conv_network(cfg, grid, rng)
    # synthetic H(x): obs value plus member noise at the obs error
    ensval = (obs.dat[None, :] + rng.standard_normal((K, obs.nobs))
              * obs.err[None, :]).astype(np.float32)
    z_full = grid.calc_z(torch.zeros((ny, nx), device=device))
    n_groups = len(dict.fromkeys(
        tuple(col) for col in cfg.var_local.table(NV3D).T.tolist()))

    # the first kernel launch of the main path keeps a copy of its operands
    # (one level chunk of real Grams) for phase 5
    launch = invsqrt_mod.invsqrt_ns_kernel

    def recording(a, areg, *args):
        if not capture:
            capture["a"], capture["areg"] = a.clone(), areg.clone()
        return launch(a, areg, *args)

    invsqrt_mod.invsqrt_ns_kernel = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with timer.section("state_trans"):
            gues = state_trans(restart)
            del restart
        with timer.section("build_obs_context"):
            ctx = build_obs_context(obs, ensval, np.zeros(obs.nobs, np.int32),
                                    cfg, grid)
        with timer.section("analyze"):
            anal, diag = analyze(gues, ctx, cfg, grid, z_full, device=device,
                                 timer=timer)
        with timer.section("state_trans_inv"):
            restart_a = state_trans_inv(
                anal, positive_definite_q=cfg.letkf.positive_definite_q,
                positive_definite_qhyd=cfg.letkf.positive_definite_qhyd)
        torch.cuda.synchronize()
    finally:
        invsqrt_mod.invsqrt_ns_kernel = launch
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES["invsqrt_ns"]
    peak = torch.cuda.max_memory_allocated(device)

    n_chunks = -(-ny * nx // diag.chunk)
    expected = nz * n_chunks * n_groups
    finite = bool(torch.isfinite(anal).all() and torch.isfinite(restart_a).all())
    incr, sprd_g, sprd_a = {}, {}, {}
    for v, name in enumerate(V3D_ANAL_NAMES):
        incr[name] = float((anal[:, v] - gues[:, v]).abs().max())
        sprd_g[name] = float(ensemble_spread(gues[:, v]).mean())
        sprd_a[name] = float(ensemble_spread(anal[:, v]).mean())
    analyze_s = timer.records["analyze"]
    res = {"phase": "slice", "config": CONFIG.name,
           "grid": f"{nx}x{ny}x{nz}", "members": K, "nobs": int(obs.nobs),
           "bucket_sort": bucket_sort_backend(),
           "wall_s": wall, "analyze_s": analyze_s,
           "gridpoints_per_s": nz * ny * nx / analyze_s,
           "sections_s": dict(timer.records),
           "section_counts": dict(timer.counts),
           "chunk": diag.chunk, "chunks_per_level": n_chunks,
           "groups": n_groups, "kernel_launches": launches,
           "expected_launches": expected,
           "peak_mem_gb": peak / 2 ** 30,
           "mean_local_obs_per_level": diag.nobs_per_level.tolist(),
           "finite": finite, "max_abs_increment": incr,
           "mean_spread_gues": sprd_g, "mean_spread_anal": sprd_a}
    emit(res)
    if not finite:
        raise AssertionError("analysis is not finite")
    if launches != expected or launches == 0:
        raise AssertionError(f"{launches} kernel launches, expected {expected}")
    if not all(incr[n] > 0 for n in ("U", "V", "T", "PRES")):
        raise AssertionError(f"zero increments: {incr}")
    if not all(sprd_a[n] < sprd_g[n] for n in V3D_ANAL_NAMES):
        raise AssertionError("analysis spread not below guess spread")
    return res


def check_invsqrt(a, areg, phase: str) -> dict:
    """invsqrt_ns kernel vs plain on one level chunk of real Grams, timed,
    with its roofline on these operands; emits the row as `phase`."""
    B, kp = int(a.shape[0]), int(a.shape[-1])
    r = kernel_vs_plain(a, areg)
    # reads a and areg, writes C^{-1/2} and C^{-1}, all (B, kp, kp); the
    # products take three TF32 tensor-core passes each
    r.update(roofline(4 * nbytes(a), NS_PRODUCTS * 2.0 * kp ** 3 * B,
                      r["ms"], TF32_FLOP_PER_S / 3))
    row = {"phase": phase, "kernel": "invsqrt_ns", "B": B, "kp": kp,
           "tol": TOL_REAL, **r}
    emit(row)
    if not (r["finite"] and r["bit_identical_runs"]
            and r["rel_err"] <= TOL_REAL):
        raise AssertionError(f"kernel disagrees on real Grams: {row}")
    return row


def phase_real(capture):
    return check_invsqrt(capture["a"], capture["areg"], "real")


def phase_small(device):
    """The coarsened 18-km analysis on the card (kernel path) against the
    same analysis on the CPU (scale_letkf_torch/gpu_check.py)."""
    from scale_letkf_torch.gpu_check import coarse_analysis_vs_cpu
    res = coarse_analysis_vs_cpu(device, str(CONFIG), SEED)
    emit({"phase": "small", **res})
    if not (res["finite"] and res["kernel_launches"]["cuda"] == res["levels"]
            and all(e <= 1 for e in res["max_err_over_tol"].values())):
        raise AssertionError(f"GPU analysis disagrees with the CPU one: {res}")


def phase_cycle(device):
    """The DA cycle at full size: CycleDriver.run_osse, one cycle of
    CYCLE_STEPS steps, from synthetic ensemble and nature states made on the
    card and the synthetic conventional network (obsmake gives the obs
    their values from the nature run). Returns the phase's row and the
    operands of the path's kernels for phase cycle_real: one level chunk of
    the analysis's Grams (copied at kernel #1's first launch), the final
    ensemble at the forecast's member batch and the final nature state as a
    batch of one, with the driver's reference column and metric."""
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.da.obsmake import obsmake
    from scale_letkf_torch.gpu_check import expected_launches
    from scale_letkf_torch.model.dycore import to_collocated
    from scale_letkf_torch.ops import invsqrt as invsqrt_mod
    from scale_letkf_torch.state import (
        V3D_ANAL_NAMES, state_to_history, state_trans)
    from scale_letkf_torch.synthetic import (
        synthetic_conv_network, synthetic_ens_dycore_device)
    from scale_letkf_torch.utils import kernels

    cfg, grid, dycfg, dom = load_config_and_grid(str(CONFIG))
    K = cfg.ensemble.member
    t0 = time.perf_counter()
    kw = {"u0": FCST_U0, "amp_theta": CYCLE_AMP_THETA,
          "smooth_passes": CYCLE_SMOOTH_PASSES}
    ens0, _, _ = synthetic_ens_dycore_device(SEED, K, grid, dom, device, **kw)
    nat, _, _ = synthetic_ens_dycore_device(SEED + 1, 1, grid, dom, device,
                                            **kw)
    # handed to run_osse with no reference kept here, so that each
    # ensemble is freed once the next one exists
    states = [type(nat)(*(f[0] for f in nat)), ens0]
    del nat, ens0
    template = synthetic_conv_network(cfg, grid, np.random.default_rng(SEED))
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    driver = make_driver(cfg, grid, dycfg, dom, device)

    launch = invsqrt_mod.invsqrt_ns_kernel
    grams: dict = {}

    def recording(a, areg, *args):
        if not grams:
            grams["a"], grams["areg"] = a.clone(), areg.clone()
        return launch(a, areg, *args)

    invsqrt_mod.invsqrt_ns_kernel = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        truth, ens, res = driver.run_osse(
            states.pop(0), states.pop(0), template, n_cycles=1,
            steps_per_cycle=CYCLE_STEPS, seed=SEED)
        torch.cuda.synchronize()
    finally:
        invsqrt_mod.invsqrt_ns_kernel = launch
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    info = res.info

    # the section obsmake again, twice, on the final nature state: whether
    # its time in the run is a cost of the first call in the process
    obsmake_repeat_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        obsmake(state_to_history(state_trans(to_collocated(truth)),
                                 driver.z_full, driver.topo),
                template, grid, cfg, driver.z_full,
                np.random.default_rng(SEED))
        torch.cuda.synchronize()
        obsmake_repeat_s.append(time.perf_counter() - t1)

    batches = -(-K // driver.batch)
    expected = expected_launches(cfg, grid, CYCLE_STEPS, batches,
                                 info["diag"].chunk)
    finite = all(bool(torch.isfinite(f).all()) for f in (*ens, *truth)) \
        and all(bool(torch.isfinite(info[k]).all()) for k in (
            "gues_mean", "gues_sprd", "anal_mean", "anal_sprd"))
    sprd_g = {n: float(info["gues_sprd"][v].mean())
              for v, n in enumerate(V3D_ANAL_NAMES)}
    sprd_a = {n: float(info["anal_sprd"][v].mean())
              for v, n in enumerate(V3D_ANAL_NAMES)}
    st_g, st_a = res.stats_gues[0], res.stats_anal[0]
    omb = {n: r for n, r in st_g.rmse.items() if st_g.nobs[n]}
    oma = {n: r for n, r in st_a.rmse.items() if st_a.nobs[n]}
    row = {"phase": "cycle", "config": CONFIG.name,
           "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
           "cycles": 1, "steps_per_cycle": CYCLE_STEPS, **kw,
           "generate_s": generate_s, "wall_s": wall,
           "sections_s": dict(driver.timer.records),
           "section_counts": dict(driver.timer.counts),
           "obsmake_repeat_s": obsmake_repeat_s,
           "template_obs": int(template.nobs), "obs_kept": res.nobs[0],
           "nobs_by_element": st_g.nobs,
           "member_batch": driver.batch, "batches": batches,
           "chunk": info["diag"].chunk,
           "chunks_per_level": -(-grid.ny * grid.nx // info["diag"].chunk),
           "kernel_launches": {k: launches[k] for k in KERNELS},
           "expected_launches": expected, "peak_mem_gb": peak / 2 ** 30,
           "omb_rmse": omb, "oma_rmse": oma,
           "rmse_vs_nature_gues": res.rmse_gues[0],
           "rmse_vs_nature_anal": res.rmse_anal[0],
           "mean_spread_gues": sprd_g, "mean_spread_anal": sprd_a,
           "finite": finite,
           "note": "spread and O-A < O-B are required of T, PRES and PS: "
                   "the perturbations are in rho-theta only, so U, V and W "
                   "carry the little spread 2 steps give them and may sit "
                   "flat"}
    emit(row)
    if not finite:
        raise AssertionError("the cycle's forecast or analysis is not finite")
    if row["kernel_launches"] != expected:
        raise AssertionError(f"kernel launches {row['kernel_launches']}, "
                             f"expected {expected}")
    if not row["peak_mem_gb"] < 80:
        raise AssertionError(f"peak memory {row['peak_mem_gb']:.2f} GB")
    if not all(sprd_a[n] < sprd_g[n] for n in ("T", "PRES")):
        raise AssertionError("analysis spread not below guess spread")
    if not all(oma[n] < omb[n] for n in ("T", "PS")):
        raise AssertionError(f"O-A RMSE above O-B RMSE: {oma} vs {omb}")
    operands = {"grams": (grams["a"], grams["areg"]),
                "ensemble": type(ens)(*(f[:driver.batch] for f in ens)),
                "nature": type(truth)(*(f[None] for f in truth)),
                "column": (driver.rho_ref, driver.p_ref, driver.vg, dycfg)}
    return row, operands


def phase_cycle_real(cy, operands) -> dict:
    """Every kernel of the cycle against its plain version on the cycle's
    own operands (phase_cycle): kernel #1 on one level chunk of its Grams;
    #2 and #3 at the ensemble forecast's member batch and at the nature
    run's batch of one. Returns per kernel one row for the path: the
    per-launch mean of the time, the plain version's time, the bytes and
    the operations over the shapes the cycle launched it at (weighted by
    those launches, so launches × ms is the kernel's time in the cycle), the
    roofline of that mean launch and the worst error; `shapes` lists each."""
    rho_ref, p_ref, vg, dycfg = operands["column"]
    rows = {"invsqrt_ns": check_invsqrt(*operands["grams"], "cycle_real")}
    rows["invsqrt_ns"]["shapes"] = [{"B": rows["invsqrt_ns"]["B"],
                                     "launches": cy["kernel_launches"][
                                         "invsqrt_ns"]}]
    per_stage = 3 * cy["steps_per_cycle"]
    parts = {"dyn_tendency": [], "adv_ud3": []}
    for label, n in (("ensemble", per_stage * cy["batches"]),
                     ("nature", per_stage)):
        s = operands[label]
        dyn, adv = stencil_operands(s, rho_ref, p_ref, vg, dycfg)
        for name, row in (("dyn_tendency", check_dyn(dyn, f"cycle {label}")),
                          ("adv_ud3", check_adv(adv, f"cycle {label}"))):
            emit({"phase": "cycle_real", "kernel": name, "run": label,
                  "batch": int(s.rho.shape[0]), "launches": n, **row})
            parts[name].append((n, int(s.rho.shape[0]), row))
        del dyn, adv
    for name, ps in parts.items():
        n = sum(k for k, _, _ in ps)

        def mean(key):
            return sum(k * r[key] for k, _, r in ps) / n

        ms = mean("ms")
        rows[name] = {"max_abs_err": max(r["max_abs_err"] for _, _, r in ps),
                      "ms": ms, "plain_ms": mean("plain_ms"),
                      **roofline(mean("bytes"), mean("flops"), ms),
                      "shapes": [{"batch": b, "launches": k, "ms": r["ms"],
                                  "plain_ms": r["plain_ms"],
                                  "bound_ms": r["bound_ms"]}
                                 for k, b, r in ps]}
    return rows


def phase_cycle_small(device):
    """The coarsened cycle on the card against the CPU: run_osse, the 4-D
    obs operator and radar H(x) (scale_letkf_torch/gpu_check.py)."""
    from scale_letkf_torch.gpu_check import coarse_cycle_vs_cpu, cycle_check_passes
    res = coarse_cycle_vs_cpu(device, str(CONFIG), SEED)
    emit({"phase": "cycle_small", **res})
    if not cycle_check_passes(res):
        raise AssertionError(f"GPU cycle disagrees with the CPU one: {res}")


def timed_turns(kernel, plain, reps: int = 5) -> dict:
    """Kernel and plain version timed in turns (plain, kernel, kernel,
    plain) with CUDA events, each called once first as a warm-up."""
    kernel()
    plain()
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}


def field_errors(out, ref, names) -> dict:
    """Per field: max|Δ| and max|Δ| / max|plain|."""
    res = {}
    for name, a, b in zip(names, out, ref):
        err = float((a - b).abs().max())
        res[name] = {"max_abs_err": err,
                     "rel_err": err / max(float(b.abs().max()), 1e-30)}
    return res


def random_dyn_state(gen, B: int, nz: int, ny: int, nx: int, device):
    """tests/test_pallas_tendency.py's random states on the card: a
    hydrostatic column with 1% noise, winds ≈ 5 m/s, ρw zero at the rigid
    faces, tracers ≈ 1e-3 of ρ. Returns (DycoreState, rho_ref, p_ref)."""
    from scale_letkf_torch.model.dycore import (
        DycoreState, hydrostatic_reference)
    theta = 300.0 + 10.0 * np.linspace(0, 1, nz)
    rho1d, p1d = hydrostatic_reference(theta, 500.0)

    def col(a):
        return torch.as_tensor(np.asarray(a, np.float32)[:, None, None],
                               device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    rho = col(rho1d) * (1.0 + 0.01 * randn(B, nz, ny, nx))
    rhow = 0.5 * randn(B, nz + 1, ny, nx)
    rhow[:, 0] = 0.0
    rhow[:, -1] = 0.0
    s = DycoreState(
        rho=rho, rhou=5.0 * randn(B, nz, ny, nx) * rho,
        rhov=5.0 * randn(B, nz, ny, nx) * rho, rhow=rhow,
        rhot=rho * col(theta) * (1.0 + 0.01 * randn(B, nz, ny, nx)),
        rhoq=(1e-3 * randn(B, 6, nz, ny, nx)).abs_() * rho[:, None])
    return s, col(rho1d), col(p1d)


def stencil_operands(s, rho_ref, p_ref, vg, dycfg, divdmp=None):
    """The two kernels' operands as dycore.tendencies forms them: p′ in plain
    torch, the metric per level."""
    from scale_letkf_torch.model.dycore import mixing_ratios, moist_pressure
    p_pert = moist_pressure(s.rhot, mixing_ratios(s)) - p_ref
    dyn = (s.rho, s.rhou, s.rhov, s.rhow, s.rhot, p_pert, rho_ref, vg.dzc,
           vg.dzf, dycfg.dx, dycfg.dy, dycfg.kdiff4,
           dycfg.divdmp if divdmp is None else divdmp, dycfg.dt)
    adv = (s.rhoq, s.rho, s.rhou, s.rhov, s.rhow, vg.dzc, dycfg.dx,
           dycfg.dy, dycfg.kdiff4)
    return dyn, adv


# Roofline of one NVIDIA H100 SXM (NVIDIA's data sheet): HBM rate, the FP32
# rate outside the tensor cores (the stencil kernels compute in FP32 FMA),
# and the dense TF32 tensor-core rate (invsqrt_ns: 3xTF32 products)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# Operations per output point, counted from the plain versions' expressions
# (an IEEE division counted as one; the ∇⁴ terms 13 each): dyn_tendency
# 224 with ∇⁴ on its four fields, 172 without; adv_ud3 62 per tracer point
# with ∇⁴, 49 without. invsqrt_ns: 3 products per Newton–Schulz iteration
# (18 + 2), the re-anchor and Z·Z, each 2·kp³.
DYN_FLOPS = {True: 224, False: 172}
ADV_FLOPS = {True: 62, False: 49}
NS_PRODUCTS = 3 * (18 + 2) + 2


def roofline(nbytes: float, flops: float, ms: float,
             flop_per_s: float = FP32_FLOP_PER_S) -> dict:
    """The least time the card could take for work that moves nbytes and
    does flops at flop_per_s, which of the two sets it, and the kernel's
    share of it; bound_fp32_ms is the same bound at the FP32 rate."""
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flop_per_s * 1e3
    bound = max(mem_ms, ops_ms)
    return {"bound_ms": bound,
            "bound_fp32_ms": max(mem_ms, flops / FP32_FLOP_PER_S * 1e3),
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "bound_share": bound / ms,
            "gb_per_s": nbytes / ms / 1e6, "tflops": flops / ms / 1e9}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def check_twice(kernel, plain, args, tol, label, names) -> dict:
    """kernel vs plain on one operand tuple: the kernel run twice (a race
    shows as a mismatch that comes and goes), both runs held to tol per
    field relative to max|plain|; then both timed in turns."""
    ref = plain(*args)
    ref = ref if isinstance(ref, tuple) else (ref,)
    runs = []
    for _ in range(2):
        out = kernel(*args)
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        runs.append((field_errors(out, ref, names),
                     all(bool(torch.isfinite(o).all()) for o in out)))
        del out
    del ref
    errs = {n: max(r[0][n]["rel_err"] for r in runs) for n in names}
    row = {"fields": runs[0][0], "rel_err_runs": [
               max(e["rel_err"] for e in r[0].values()) for r in runs],
           "finite": all(r[1] for r in runs), "tol": tol,
           "max_abs_err": max(e["max_abs_err"] for r in runs
                              for e in r[0].values()),
           "rel_err": max(errs.values()),
           **timed_turns(lambda: kernel(*args), lambda: plain(*args))}
    if not (row["finite"] and row["rel_err"] <= tol):
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"({label}): {row}")
    return row


def check_dyn(args, label) -> dict:
    """dyn_tendency kernel vs plain on one operand tuple, timed, with its
    roofline on these operands."""
    from scale_letkf_torch.gpu_check import TOL_TENDENCY
    from scale_letkf_torch.ops.tendency import (
        dyn_tendencies_kernel, dyn_tendencies_plain)
    row = check_twice(dyn_tendencies_kernel, dyn_tendencies_plain, args,
                      TOL_TENDENCY, f"dyn_tendency, {label}",
                      ("rho", "rhou", "rhov", "rhow", "rhot"))
    rho, rhow, kdiff4 = args[0], args[3], args[11]
    moved = nbytes(*args) + 4 * nbytes(rho) + nbytes(rhow)
    row.update(roofline(moved, DYN_FLOPS[kdiff4 != 0] * rho.numel(),
                        row["ms"]))
    return row


def check_adv(args, label) -> dict:
    """adv_ud3 kernel vs plain on one operand tuple, timed, with its
    roofline on these operands."""
    from scale_letkf_torch.gpu_check import TOL_STENCIL
    from scale_letkf_torch.ops.stencil import (
        adv_flux_divergence_kernel, adv_flux_divergence_plain)
    row = check_twice(adv_flux_divergence_kernel, adv_flux_divergence_plain,
                      args, TOL_STENCIL, f"adv_ud3, {label}", ("q",))
    q, kdiff4 = args[0], args[8]
    row.update(roofline(nbytes(*args) + nbytes(q),
                        ADV_FLOPS[kdiff4 != 0] * q.numel(), row["ms"]))
    return row


def phase_ragged(device, kernel: str, phase: str):
    """One stencil kernel against its plain version at the ragged and tiny
    shapes of gpu_check.RAGGED_SHAPES."""
    from scale_letkf_torch.gpu_check import ragged_kernels_vs_plain
    rows = ragged_kernels_vs_plain(device, kernel)
    for row in rows:
        emit({"phase": phase, **row})
    bad = [r for r in rows if not (r["finite"] and r["rel_err"] <= r["tol"])]
    if bad:
        raise AssertionError(f"{kernel} disagrees with its plain version at "
                             f"ragged shapes: {bad}")


def metrics_18km(device):
    """(dycfg, {'uniform': VGrid, 'stretched': VGrid}, grid) of the 18-km
    configuration: its own stretched levels, and uniform levels of its
    lowest thickness."""
    from scale_letkf_torch.cli.main import load_config_and_grid
    from scale_letkf_torch.model.dycore import make_vgrid, uniform_vgrid
    _, grid, dycfg, _ = load_config_and_grid(str(CONFIG))
    return dycfg, {"uniform": uniform_vgrid(grid.nz, dycfg.dz, device),
                   "stretched": make_vgrid(grid.cz, grid.fz, device)}, grid


def phase_tendency(device):
    dycfg, vgs, grid = metrics_18km(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    s, rho_ref, p_ref = random_dyn_state(gen, STENCIL_BATCH, grid.nz,
                                         grid.ny, grid.nx, device)
    for metric, vg in vgs.items():
        for divdmp in (0.0, 0.05):
            dyn, _ = stencil_operands(s, rho_ref, p_ref, vg, dycfg, divdmp)
            row = check_dyn(dyn, f"{metric}, divdmp {divdmp}")
            emit({"phase": "tendency", "metric": metric, "divdmp": divdmp,
                  "batch": STENCIL_BATCH,
                  "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", **row})
    phase_ragged(device, "dyn_tendency", "tendency")
    return s


def phase_stencil(device, s):
    dycfg, vgs, grid = metrics_18km(device)
    for metric, vg in vgs.items():
        for kdiff4 in (0.0, dycfg.kdiff4):
            args = (s.rhoq, s.rho, s.rhou, s.rhov, s.rhow, vg.dzc, dycfg.dx,
                    dycfg.dy, kdiff4)
            row = check_adv(args, f"{metric}, kdiff4 {kdiff4}")
            emit({"phase": "stencil", "metric": metric, "kdiff4": kdiff4,
                  "batch": STENCIL_BATCH, "tracers": int(s.rhoq.shape[1]),
                  "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", **row})
    phase_ragged(device, "adv_ud3", "stencil")


def phase_forecast(device):
    """The forecast slice at full size. Returns the phase's row and a copy of
    the first member batch of the forecast (the main path's kernel shapes,
    with the flow of two steps) for phase forecast_real."""
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.synthetic import synthetic_ens_dycore_device
    from scale_letkf_torch.utils import kernels

    cfg, grid, dycfg, dom = load_config_and_grid(str(CONFIG))
    K = cfg.ensemble.member
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    t0 = time.perf_counter()
    ens, _, _ = synthetic_ens_dycore_device(SEED, K, grid, dom, device,
                                            u0=FCST_U0)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    driver = make_driver(cfg, grid, dycfg, dom, device)
    dzc = torch.as_tensor(np.diff(grid.fz), dtype=torch.float64,
                          device=device)[:, None, None]

    def mass(rho):
        return sum(float((rho[m].double() * dzc).sum())
                   for m in range(rho.shape[0]))

    mass0 = mass(ens.rho)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = driver.forecast(ens, FCST_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in ("dyn_tendency", "adv_ud3")}
    peak = torch.cuda.max_memory_allocated(device)

    batches = -(-K // driver.batch)
    expected = 3 * FCST_STEPS * batches
    finite = all(bool(torch.isfinite(f).all()) for f in out)
    mass1 = mass(out.rho)
    mass_rel = abs(mass1 - mass0) / mass0
    incr = {name: float((a - b).abs().max())
            for name, a, b in zip(out._fields, out, ens)}
    fcst_s = driver.timer.records["forecast"]
    pts = nz * ny * nx
    res = {"phase": "forecast", "config": CONFIG.name,
           "grid": f"{nx}x{ny}x{nz}", "members": K, "steps": FCST_STEPS,
           "core": driver.core, "n_small": driver.n_small, "dt": dycfg.dt,
           "u0": FCST_U0, "generate_s": generate_s, "wall_s": wall,
           "forecast_s": fcst_s,
           "member_steps_per_s": K * FCST_STEPS / fcst_s,
           "gridpoint_steps_per_s": K * pts * FCST_STEPS / fcst_s,
           "sections_s": dict(driver.timer.records),
           "section_counts": dict(driver.timer.counts),
           "member_batch": driver.batch, "batches": batches,
           "peak_mem_gb": peak / 2 ** 30, "kernel_launches": launches,
           "expected_launches": expected, "finite": finite,
           "mass_rel_change": mass_rel, "max_abs_increment": incr}
    emit(res)
    if not finite:
        raise AssertionError("forecast is not finite")
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected} each")
    if not incr["rhow"] > 0:
        raise AssertionError("the forecast's ρw is zero")
    if not mass_rel <= 1e-5:
        raise AssertionError(f"mass changed by {mass_rel:.3e} (> 1e-5)")
    sample = type(out)(*(f[:driver.batch].clone() for f in out))
    del ens, out
    return res, (sample, driver.rho_ref, driver.p_ref, driver.vg, dycfg)


def phase_forecast_real(sample) -> dict:
    s, rho_ref, p_ref, vg, dycfg = sample
    dyn, adv = stencil_operands(s, rho_ref, p_ref, vg, dycfg)
    rows = {"dyn_tendency": check_dyn(dyn, "forecast batch"),
            "adv_ud3": check_adv(adv, "forecast batch")}
    for name, row in rows.items():
        emit({"phase": "forecast_real", "kernel": name,
              "batch": int(s.rho.shape[0]), **row})
    return rows


def phase_forecast_small(device):
    """The coarsened 18-km forecast on the card (kernel path) against the
    same forecast on the CPU (scale_letkf_torch/gpu_check.py)."""
    from scale_letkf_torch.gpu_check import coarse_forecast_vs_cpu
    res = coarse_forecast_vs_cpu(device, str(CONFIG), SEED)
    emit({"phase": "forecast_small", **res})
    cuda = res["kernel_launches"]["cuda"]
    expected = 3 * res["steps"]
    if not (res["finite"] and all(n == expected for n in cuda.values())
            and all(e <= 1 for e in res["max_err_over_tol"].values())):
        raise AssertionError(f"GPU forecast disagrees with the CPU one: {res}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the GPU smoke run cannot run here",
              file=sys.stderr)
        return 1
    from scale_letkf_torch.utils.device import require_cuda
    device = require_cuda()
    # run as a caller that chose TF32 for float32 products: the analysis and
    # the kernels' plain versions must pin full FP32 themselves, or the
    # phases that compare them see TF32-sized errors
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    phase_random(device)
    s = phase_tendency(device)
    phase_stencil(device, s)
    del s
    fc, sample = phase_forecast(device)
    phase_forecast_real(sample)
    del sample
    phase_forecast_small(device)
    torch.cuda.empty_cache()
    capture: dict = {}
    sl = phase_slice(device, capture)
    phase_real(capture)
    del capture
    phase_small(device)
    torch.cuda.empty_cache()
    cy, operands = phase_cycle(device)
    cy_rows = phase_cycle_real(cy, operands)
    del operands
    torch.cuda.empty_cache()
    phase_cycle_small(device)
    # the kernels line is this slice's main path, the cycle, which runs all
    # three: its launches, and times on its own operands (phase cycle_real);
    # launches_by_path: each path's own run, counts reset before it
    for name in KERNELS:
        cy_rows[name]["launches"] = cy["kernel_launches"][name]
        cy_rows[name]["launches_by_path"] = {
            "forecast": fc["kernel_launches"].get(name, 0),
            "analysis": sl["kernel_launches"] if name == "invsqrt_ns" else 0,
            "cycle": cy["kernel_launches"][name]}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    # no single PyTorch call computes any of the three functions (no matrix
    # inverse square root, no such stencil), so library_ms is null
    keys = ("launches", "launches_by_path", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_fp32_ms", "bound_by", "bound_share",
            "gb_per_s", "tflops", "shapes")
    emit({"kernels": [{"name": name, "route": "cuda",
                       "source": f"scale_letkf_torch/csrc/{name}.cu",
                       "replaces": REPLACES[name],
                       **{k: cy_rows[name][k] for k in keys},
                       "library_ms": None}
                      for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
