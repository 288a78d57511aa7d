#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the four hand-written CUDA kernels from scale_letkf_torch/csrc,
checks each against its plain PyTorch version (the stencil kernels in both
lateral modes, the acoustic substep kernel at the radar cell's and the
18-km shapes), and drives the port's paths once each at full size: at
the size of the 18-km Japan configuration (configs/18km_japan.toml,
unchanged: 480×360×36 stretched levels, K = 50)
the ensemble forecast (split-explicit core, dt 30 s, 10 acoustic substeps,
2 steps), the LETKF analysis (the synthetic conventional network of ~24k
obs), the DA cycle that joins them (CycleDriver.run_osse) and the physics
cycle (the same with the physics suite and Davies boundary forcing, 6
steps), and the production cycle (the physics cycle over the reference
bench's synthetic topography, with conventional and Himawari-8 obs); and
the radar configuration's forecast (configs/bda_1km_radar.toml, unchanged:
192×192×48, K = 50, Kessler physics) over its 30-s window; the physics
cycle, the radar forecast and the fused radar cycle on a (2, 2, 2)
process grid of blocks, each held exactly to its undecomposed run; the
executors, the nested and the fused cycles; and the OSSE impact experiment
of the full-size benches (a shallow bench_fullsize.bench_osse_impact):

  1. device         — the card, and nvidia-smi's name and power limit
  2. build          — nvcc builds of the five kernels, all started
                      together (seconds, ptxas reports, and each kernel's
                      SASS instruction count and opcode mix by cuobjdump);
                      fails if invsqrt_ns holds no tensor-core HMMA
  3. random         — invsqrt_ns kernel vs plain on B = 4096 random
                      LETKF-shaped Grams at K = 20, 50, 100, cond 1e2-1e4,
                      and against float64 eigh on a few of them
  4. tendency       — dyn_tendency kernel vs plain on random states at
                      480×360×36, batch 4, uniform and 18-km metrics,
                      divdmp 0 and 0.05; the same in the open lateral mode
                      with kdiff4 0 and 1e-3, each row with the kernel's
                      times in both modes on the same operands; then at
                      the ragged and tiny shapes of gpu_check.RAGGED_SHAPES
                      (both metrics, divdmp 0/0.05, kdiff4 0/1e-3), both
                      lateral modes
  5. stencil        — adv_ud3 kernel vs plain on all 6 tracers of the same
                      states, kdiff4 0 and 1e-3, both lateral modes (the
                      open rows with both modes' times); then at the ragged
                      shapes with 1 and 6 tracers, both modes
 51. acoustic       — the acoustic substep kernel vs the plain substep loop
                      on a stage of 4 substeps (random_dyn_state, its slow
                      tendencies) at the radar cell's 100 × 48 × 128 × 128
                      (stretched levels) and the 18-km 10 × 36 × 360 × 480
                      (uniform): bit_equal per field, then both timed in
                      turns at 4 and 8 substeps; a middle substep's time
                      (the difference over 4) against its bound
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
                      peak memory (each forecast's and the analysis's, and
                      the forecast's fields a member), O−B / O−A RMSE, RMSE
                      against the nature
                      run and spreads; then the nature run's obsmake twice
                      more, timed (a first-call cost shows as the gap)
 13. cycle_real     — every kernel vs plain on the operands of phase 12:
                      invsqrt_ns on one level chunk of the cycle's Grams,
                      the stencil kernels at the ensemble forecast's member
                      batch and at the nature run's batch of one
 14. cycle_small    — the coarsened cycle on the card against the CPU, the
                      4-D obs operator on a 3-slot window and radar H(x)
                      with every reflectivity method
 15. physics_cycle  — phase 12 with the reference bench's production
                      physics suite (nsw6, radiation every 10 physics steps,
                      PBL, slab of capacity 2e5) and Davies relaxation
                      (bdy_width 10, bdy_tau 600) toward the balanced base
                      state, 6 steps (two physics steps at phys_interval
                      5), flat topography; adds the physics and boundary
                      sections and the skin temperature's mean and range
                      before and after, which must have moved
 16. physics_real   — every kernel vs plain on the operands of phase 15, as
                      phase 13
 17. radar_forecast — the radar configuration unchanged: restart ensemble
                      with rain and cloud blobs made on the card → make_driver
                      → CycleDriver.forecast over the 15-step window (three
                      Kessler steps); sections, batch, peak memory,
                      launches; qr ≥ 0 everywhere and every Kessler step
                      moved qc or qr
 18. radar_real     — both stencil kernels vs plain on one launch's
                      operands of phase 17 (the 192×192×48 grid)
 19. physics_small  — each physics scheme alone, the coarsened physics-suite
                      forecast with per-member boundary data, the radar
                      Kessler forecast and a radar cycle (obs from the blobs
                      by calc_ref_vr) on the card against the CPU
 20. production_cycle — phase 15 over the reference bench's synthetic
                      topography, PROD_STEPS steps (synthetic_topo,
                      default_rng(7): 12 Gaussian
                      hills up to 400 m, tapered over 12 cells) through
                      CycleDriver(topo=), so every forecast, the nature run
                      included, runs the SI core with terrain metrics (the
                      slow tendency kernel #5: kernels #2 and #3 are not
                      launched, asserted); the states' qv capped at half
                      the base column's saturation; obs the conventional
                      network and an H08 network (all ten bands of a
                      profile every 8 cells inside the 10-cell buffer, the
                      configuration's band 9 assimilated). Adds O−B / O−A
                      for H08, which must fall with T's and PS's, and the
                      largest |ρw| over the hills and over flat ground in
                      this run and in a flat run of the same nature state:
                      the terrain's own part of ρw must be largest over the
                      hills
 21. production_real — invsqrt_ns vs plain on one level chunk of phase 20's
                      Grams
 22. terrain_tendency — at full width, on phase 20's final ensemble (batch
                      10) and nature state (batch 1): kernel #5
                      (tendencies_terrain on the card) bit-equal to
                      tendencies_terrain_plain in two launches a call, and
                      timed against it and against dycore.tendencies (p′,
                      then kernels #2 and #3) on the same states, with the
                      byte bound of each and its share; flat metrics must
                      give dycore.tendencies' result
 23. terrain_small  — the terrain dynamics, an unforced terrain forecast's
                      Σ J·ρ·dzc, the pp step's smoothing, H08 H(x) and a
                      coarsened production cycle with H08 on the card
                      against the CPU
 24. det_cycle      — the configuration with det_run and INFL_ADD 0.1: one
                      cycle of 2 steps through CycleDriver as the cycle
                      verb composes it — nature run and obsmake, ensemble
                      forecast, forecast_one of the deterministic member
                      (the ensemble construction with seed 3), and the
                      analysis with it and the additive-inflation source
                      (that construction with seed 2, in pinned host
                      memory); sections, peak memory by stage, launches
                      (#2 and #3 at 3 × steps × (batches + nature + the
                      member)); the member moved and finite, its O−A below
                      its O−B for T and PS, member 0's additive increment
                      equal to 0.1·(addi − mean(addi)) within float32
                      rounding, the peak within the cycle phase's plus one
                      source ensemble
 25. det_real       — every kernel vs plain on the operands of phase 24, as
                      phase 13 (the nature state standing for the nature
                      run's and the member's batches of one)
 26. efso           — efso_impact at full width on phase 24's analysis
                      (perturbations 50 × 11 × 36 × 360 × 480, ē = analysis
                      mean − nature, HORI_LOCAL 400 km, eft 0), timed, and
                      a coarsened copy on the card against the CPU
 27. det_small      — the coarsened deterministic + additive analysis and
                      the letkf and cycle verbs with 'mdet' and 'addi'
                      files on the card against the CPU
 28. jacobi         — the ported Jacobi eigensolver against
                      torch.linalg.eigh on one 18-km level of K = 8 and 16
                      Grams (B = 172,800): times and errors against float64
                      eigh, and the solver 'auto' takes at K ≤ 16
 29. h08_calibrate  — the H08 band-model fit (H08_FIT_STEPS Adam steps) on
                      the card against the CPU fit, the misfit after below
                      the misfit before
 30. streamed_cycle — the configuration's 7-slot 4-D window (slot_base 4)
                      through StreamedCycle, its slot interval cut from
                      3600 to 150 s (5 steps: the analysis at step 15, the
                      window's end at 30, against 720 and 1080 as
                      shipped), the physics cycle's composition, member
                      batches of 10, analysis tiles of 40 rows; the ensemble
                      made on the card and brought to the host as analysis
                      variables and their restart, the obs the conventional
                      network spread over the 7 slots with values from the
                      nature run (obs_from_truth). Phase table, obs per
                      slot, peak device memory (below the in-core cycle's
                      48.9 GiB) and host RSS, bytes and rates each way,
                      launches (#1 levels × tiles × chunks, #2 and #3 3 ×
                      30 × batches), O−B / O−A (T and PS must fall on the
                      analysis-time slot's obs; the whole window's beside
                      them), spreads, seconds a member-step and the shipped
                      window extrapolated from it
 31. streamed_real  — invsqrt_ns vs plain on phase 30's first tile's Grams
                      (B = 19,200)
 32. resident_cycle — phase 30's analysis-variable ensemble, obs and driver
                      through ResidentCycle (6.84 GB of bfloat16 deviations
                      on the card): launches, peak, the bytes the cycle
                      moved across the host link, and the reference's
                      yardstick against phase 30 — each member's H(x)
                      within 0.2 of the ensemble spread, O−B and O−A RMSE
                      within 10% — with the analysis mean's distance to
                      phase 30's over the analysis spread
 33. radar_cycle    — configs/bda_1km_radar.toml as shipped through
                      StreamedCycle (15 steps, tiles of 48 rows): the radar
                      forecast's rain-blob ensemble and nature member, the
                      synthetic PAWR volume (~888k REF and VR obs) with
                      values from the nature run; ≥ 800k obs into the
                      analysis, O−A below O−B for REF
 47. mesh_radar_cycle — the main path of this slice, run right after
                      phase 33 on its inputs (its blob ensemble on the
                      host, its ~888k-obs volume): StreamedCycle on
                      CycleDriver(mesh=make_mesh(2, 2, 2)), batches of 10
                      members (5 a block) sharded over 8 blocks of 96 × 96
                      columns and forecast on the grid (halo exchanges,
                      Kessler on every block), gathered for H(x) and the
                      download, the tiled analysis undecomposed; the
                      restart ensemble, inflation, obs used, O−A and the
                      O−B / O−A tables held exactly to phase 33's; wall
                      time and phase table beside phase 33's, the grid's
                      sections, peak, and launches against
                      gpu_check.expected_launches (no nature run)
 48. mesh_streamed_real — every kernel vs plain on phase 47's own
                      operands: #2 and #3 on its first forecast's first
                      extended block (5 × 48 × 104 × 104), #1 on its first
                      tile's Grams
 34. executors_small — the coarsened tiled analysis (plain and pipelined),
                      StreamedCycle (terrain, physics, per-member Davies,
                      4-D slots), ResidentCycle and the cycle --streamed
                      verb on the card against the CPU; that StreamedCycle
                      over two cycles and the verb with a [process] table,
                      each on make_mesh(2, 2, 2), bit-equal to their
                      undecomposed runs on the card
 35. nested_cycle   — the main path of the nesting slice: the 18-km
                      configuration as phase 12 composes it (the parent,
                      K = 50) and a 240 × 240 × 36 child of 6-km cells at
                      (i0, j0) = (200, 140) with open lateral boundaries
                      (SI core, dt 10 s, Davies over 10 cells at 120 s)
                      through NestedCycleDriver, one cycle of 6 parent and
                      18 child steps; the child's ensemble parent_to_child
                      of the parent's, its 700 sondes valued from
                      parent_to_child of the nature run. Sections of both
                      domains (the bracket's interpolation under
                      nest_bracket), launches of each stage (#2 and #3 in
                      the open mode in the child), peak memory (< 80 GB),
                      O−B / O−A for T and PS in both domains (O−A below);
                      then the same child forecast with bdy_width 0: the
                      forced ring's ρ, ρθ and horizontal momentum must each
                      be nearer parent_to_child of the parent's forecast
 36. nested_real    — #2 and #3 vs plain in the open mode on one child
                      launch's operands (both modes' times), #1 on the
                      child's first Grams
 37. fused_radar_cycle — configs/bda_1km_radar.toml as shipped through
                      FusedCycle.run_osse, one cycle of its 15-step window
                      (2 until the OSSE phase took their time; the grid's
                      second cycle is held at the coarsened size by
                      gpu_check.fused_grid_on_device):
                      the radar cycle's blob ensemble and nature member,
                      the synthetic PAWR volume (888,000 gates) valued from
                      the nature run and preprocessed to dBZ, every gate in
                      the buckets; per cycle seconds, obs used, O−B / O−A
                      for REF (O−A below) and Vr; launches, peak, chunk,
                      and the synchronising calls of the run under
                      torch.cuda.set_sync_debug_mode('warn'), by site,
                      beside phase 33's seconds; the acoustic kernel's
                      launches, one a substep of each member batch and of
                      the nature run
 45. mesh_fused_radar_cycle — the main path of this slice, run right
                      after phase 37 on its inputs (its seeded blob
                      ensemble and nature member, its dBZ template — kept
                      — and its noise seed): FusedCycle on
                      CycleDriver(mesh=make_mesh(2, 2, 2)), one cycle, 8
                      blocks of 25 members × 96 × 96 columns; each member
                      slab gathered for H(x), the worst QC, the mean of
                      H(x) and the min-member count over all 50 members in
                      member order, the analysis on the 8 shares of the
                      ensemble transpose; the final ensemble, nature run
                      and inflation and per cycle obs used, O−B / O−A by
                      group and the errors against the truth held exactly
                      to phase 37's (kept on the host); seconds per cycle,
                      sections on the device's clock (forecast/halo,
                      obsope/gather, das_letkf/transpose), synchronising
                      calls by site, peak, and launches against
                      gpu_check.expected_launches for 8 blocks and 8
                      shares with the nature run's batch of one
 46. mesh_fused_real — every kernel vs plain on phase 45's own operands:
                      #1 on the first share's first level chunk of Grams
                      (4,608 of them), #2 and #3 on the final nature state
                      as a batch of one at 192 × 192
 49. osse_impact    — bench_fullsize.bench_osse_impact at its own width
                      (18-km configuration coarsened to 240×180×36 at 36
                      km, K = 50, the production composition, 400 sondes +
                      800 PS) with its depth cut (OSSE_*: 2 spin-up
                      steps, 2 cycles of 2; batches of 50, tiles of 90
                      rows): the ensemble, the no-DA control and the truth
                      under its stronger sun on ResidentCycle; the T RMSE
                      of guess, analysis and control and the guess spread,
                      finite, the analysis below its guess in each cycle,
                      the second cycle's guess below the control;
                      launches (#1 as every analysis's levels × chunks ×
                      groups, #2 and #3 idle over terrain) and peak
 50. osse_real      — invsqrt_ns vs plain on phase 49's first Grams
 38. nested_small   — the cycle verb with a [nest] section (the child
                      open) at tests/test_cli_nested.py's size on the card
                      against the CPU
 39. fused_small    — one FusedCycle step of the coarsened radar
                      configuration on the card against the CPU
 40. mesh_cycle     — the main path of the multi-device slice, run after
                      phase 16: phase 15's composition and seeded inputs
                      (the production physics suite, Davies toward the
                      base state, 6 steps, two physics steps) through
                      CycleDriver(mesh=make_mesh(2, 2, 2)) with halo
                      'explicit', 8 blocks of 25 members × 180 × 240
                      columns all in this process on the card (extended
                      to 188 × 248 for the slow tendencies, kernels #2
                      and #3 periodic on each): the forecast's member
                      batches step every block together with halo
                      exchanges and run the suite on every block (the
                      PBL's one-column halo, each block's skin
                      temperature), the analysis gathers each member slab
                      and its skin temperature for H(x) and runs the
                      ensemble transpose; sections (forecast/halo,
                      forecast/acoustic/halo, forecast/physics/halo,
                      obsope/gather, das_letkf/transpose,
                      das_letkf/collect), launches against
                      gpu_check.expected_launches for 8 blocks and 8
                      shares, peak beside phase 15's; the guess and
                      analysis means and spreads, the O−B / O−A tables
                      and the skin temperature held exactly to phase 15's
                      (kept on the host)
 41. mesh_real      — every kernel vs plain on phase 40's operands: #1 on
                      a share's first Grams, #2 and #3 (periodic) on one
                      extended block at the member batch and on the
                      nature run's batch of one
 42. mesh_checks    — on phase 40's final blocks: one explicit-core step
                      with halo 'explicit_overlap' against 'explicit', and
                      init_distributed in a world of one (NCCL) whose
                      global_device_mesh(1, 2, 2) of 4 local blocks steps
                      bit-equal to make_mesh(1, 2, 2); and phase 12's
                      composition coarsened (32×24×12, K = 20) on
                      make_mesh(2, 2, 2), bit-equal to its undecomposed
                      run on the card; the nested grid cycle (that parent
                      and a 24 × 24 open child, ratio 3) bit-equal to its
                      open-mode composition; one explicit-core step over
                      hills on make_mesh(1, 2, 2) bit-equal to the
                      undecomposed terrain step
 43. mesh_radar_forecast — phase 17 on make_mesh(2, 2, 2), run after
                      phase 18: the radar configuration as shipped, 8
                      blocks of 25 members × 96 × 96 columns (104 × 104
                      extended), Kessler on every block; sections
                      (forecast/physics, forecast/halo), launches, Kessler
                      calls and peak; the final ensemble held exactly to
                      phase 17's (kept on the card)
 44. mesh_radar_real — #2 and #3 vs plain on one extended radar block of
                      phase 43 at its member batch

The phases run in the order 1–5, 51, 6–16, 40–42, 17, 18, 43, 44, 19–33, 47,
48, 34–37, 45, 46, 38, 39, 49, 50. Each
phase prints one JSON line, with its seconds since the script's start as
at_s (the smoke's timeline); any failed check raises, so the script
exits non-zero. Every kernel-vs-plain check runs the kernel twice and holds
both runs to the bound (invsqrt_ns, which has no atomics, must also give
bit-identical runs). Kernel and plain versions are timed with CUDA events,
in turns (plain, kernel, kernel, plain), after a warm-up. The line before
the last lists every kernel: route, source, the TPU kernel it replaces,
its launches in phase 40, the grid's physics cycle, which runs all three
(each path's own beside them under launches_by_path, counts reset before
each — the production cycle's: #1 only), its error and time against the
plain version on phase 40's operands (phase 41; the radar grid's block
under `radar_block`, phase 44; phase 24's under
`det_cycle`, phase 25; #1 on phase 30's tile under
`streamed_tile`; for the stencil kernels the mean
over the two batch sizes weighted by their launches, so launches × ms is
the kernel's time in the cycle, each size under `shapes`; the physics
cycle's times under `physics_cycle`, the radar grid's under `radar_grid`,
#1 on the production cycle's Grams under `production_grams`, each kernel
on the nested child's operands under `child_grid` — #2 and #3 in the open
mode, with both modes' times —, each kernel on the fused grid cycle's
operands under `fused_grid`, phase 46, and on the streamed grid cycle's
under `streamed_grid`, phase 48, and #1 on the OSSE's Grams under
`osse_grams`, phase 50), and its bound:
the larger of the bytes it must move over 3.35 TB/s and its operations
over the rate of the units that do them, computed from those operands —
67 TFLOP/s FP32 for the stencils, and for invsqrt_ns's 3xTF32 tensor-core
products three TF32 passes at 495 TFLOP/s, with its FP32 bound beside it
as bound_fp32_ms. The acoustic substep kernel's entry (it replaces no TPU
kernel) gives its launches in phase 37 and phase 51's numbers at the
radar cell's shape, both shapes' under `shapes`. The last line is
{"ok": true, "device": {...}}. Without
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
RADAR_CONFIG = CONFIG.parent / "bda_1km_radar.toml"
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
# the physics cycle: 6 steps, so physics runs twice at phys_interval 5
# (after step 5 and after the remainder; 10 steps until the smoke needed
# the time for the grid's cycle)
PHYS_STEPS = 6
# the production cycle's depth, cut from PHYS_STEPS to make room for the
# streamed radar grid cycle: its checks (launches, finiteness, O−A below
# O−B, the terrain's part of ρw over the hills) do not rest on depth
PROD_STEPS = 2
# the production cycle (PHYS_STEPS too): the H08 network's spacing and
# margin (cells); the hills and flat ground of the |ρw| check (topography
# above HILL_M and below FLAT_M metres)
H08_SPACING = 8
H08_MARGIN = 10
HILL_M = 100.0
FLAT_M = 1.0
KERNELS = ("invsqrt_ns", "dyn_tendency", "adv_ud3")
REPLACES = {
    "invsqrt_ns": "scale_letkf_tpu/ops/invsqrt.py:183",
    "dyn_tendency": "scale_letkf_tpu/ops/pallas_tendency.py:257",
    "adv_ud3": "scale_letkf_tpu/ops/pallas_stencil.py:111",
}
# the acoustic substep kernel replaces no TPU kernel (the reference's
# substeps are plain XLA); its shapes: the radar cell's 100 members at 48
# stretched levels (150 m × 1.03ᵏ) of 128 × 128 columns, and the 18-km
# configuration's member batch, 10 × 36 × 360 × 480 at uniform levels
ACOUSTIC = "acoustic_substep"
ACOUSTIC_SHAPES = {"radar_cell": ((100, 48, 128, 128), "stretched", 100.0),
                   "18km": ((10, 36, 360, 480), "uniform", 18000.0)}
ACOUSTIC_REPS = 3
# the terrain tendency kernel (#5) replaces no TPU kernel either (the
# reference's terrain tendency is plain XLA); phase terrain_tendency holds
# and times it
TERRAIN = "terrain_tendency"


# the script's start on the host clock (main); each phase line carries its
# seconds since then as at_s, the smoke's timeline
T_START: list[float] = []


def emit(obj) -> None:
    if T_START and "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START[0]}
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
    libs = kernels.build_all((*KERNELS, ACOUSTIC, TERRAIN))
    wall = time.perf_counter() - t0
    for name in (*KERNELS, ACOUSTIC, TERRAIN):
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


def phase_cycle(device, phase: str = "cycle", steps: int = CYCLE_STEPS,
                physics: bool = False, production: bool = False,
                keep: dict | None = None):
    """The DA cycle at full size: CycleDriver.run_osse, one cycle of `steps`
    steps, from synthetic ensemble and nature states made on the card and
    the synthetic conventional network (obsmake gives the obs their values
    from the nature run). physics: the physics cycle — the configuration's
    driver with the reference bench's production physics suite
    (gpu_check.PHYS_PROD) and Davies relaxation (the configuration's
    bdy_width and bdy_tau) toward the balanced base state (base_boundary);
    its row adds the skin temperature's domain mean and range before (the
    cold start) and after, requires that it moved, and adds the fields a
    member of one dynamics step, physics step and relaxation alone
    (stage_fields). Either row carries the peak memory of the nature run,
    the forecast and what follows it (watch_peaks) and the forecast's
    working set in fields a member. Returns the phase's
    row and the operands of the path's kernels for the kernel-vs-plain
    phase: one level chunk of the analysis's Grams (copied at kernel #1's
    first launch), the final ensemble at the forecast's member batch and
    the final nature state as a batch of one, with the driver's reference
    column and metric.

    production: the physics cycle's driver over the reference bench's
    synthetic topography (gpu_check.production_driver, CycleDriver(topo=)),
    the states' qv capped at gpu_check.PROD_RH_MAX of saturation, and an H08
    network beside the conventional one; kernels #2 and #3 must not launch,
    O−A must fall below O−B for H08 too, and the row adds the largest |ρw|
    over hills and flat ground, here and in a flat run of the same nature
    state; the operands add the driver's terrain metrics and the first ten
    members of the final ensemble.

    keep: a dict that receives, on the host, the analysis's guess and
    analysis means and spreads, its O−B / O−A tables and, with physics,
    the final skin temperature (what phase mesh_cycle holds its decomposed
    run to)."""
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.da.obsmake import obsmake
    from scale_letkf_torch.gpu_check import (
        PHYS_PROD, PROD_RH_MAX, expected_launches, production_driver)
    from scale_letkf_torch.model.dycore import to_collocated
    from scale_letkf_torch.obs.types import Observations
    from scale_letkf_torch.model.physics_suite import skin_temperature
    from scale_letkf_torch.ops import invsqrt as invsqrt_mod
    from scale_letkf_torch.state import (
        V3D_ANAL_NAMES, state_to_history, state_trans)
    from scale_letkf_torch.synthetic import (
        base_boundary, synthetic_conv_network, synthetic_ens_dycore_device,
        synthetic_h08_network, synthetic_topo)
    from scale_letkf_torch.utils import kernels

    cfg, grid, dycfg, dom = load_config_and_grid(str(CONFIG))
    physics = physics or production
    if physics:
        dom = {**dom, "physics": PHYS_PROD}
    K = cfg.ensemble.member
    t0 = time.perf_counter()
    kw = {"u0": FCST_U0, "amp_theta": CYCLE_AMP_THETA,
          "smooth_passes": CYCLE_SMOOTH_PASSES}
    if production:
        kw["rh_max"] = PROD_RH_MAX
    ens0, _, _ = synthetic_ens_dycore_device(SEED, K, grid, dom, device, **kw)
    nat, _, _ = synthetic_ens_dycore_device(SEED + 1, 1, grid, dom, device,
                                            **kw)
    tsfc0 = skin_temperature(ens0) if physics else None
    # handed to run_osse with no reference kept here, so that each
    # ensemble is freed once the next one exists
    states = [type(nat)(*(f[0] for f in nat)), ens0]
    # the nature state's start, for the flat run of the |ρw| check
    nat0 = type(nat)(*(f[0].clone() for f in nat)) if production else None
    del nat, ens0
    template = synthetic_conv_network(cfg, grid, np.random.default_rng(SEED))
    if production:
        template = Observations.concatenate([template, synthetic_h08_network(
            cfg, grid, spacing=H08_SPACING, margin=H08_MARGIN)])
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    topo = (synthetic_topo(np.random.default_rng(7), grid.ny, grid.nx)
            if production else None)
    if production:
        driver = production_driver(cfg, grid, dycfg, dom, device, topo=topo)
        if driver.metrics is None:
            raise AssertionError("the production driver has no terrain "
                                 "metrics")
    else:
        driver = make_driver(cfg, grid, dycfg, dom, device)
    if physics and not production:
        driver.bdy = base_boundary(grid, dom, device)

    launch = invsqrt_mod.invsqrt_ns_kernel
    grams: dict = {}

    def recording(a, areg, *args):
        if not grams:
            grams["a"], grams["areg"] = a.clone(), areg.clone()
        return launch(a, areg, *args)

    invsqrt_mod.invsqrt_ns_kernel = recording
    peaks = watch_peaks(driver, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        truth, ens, res = driver.run_osse(
            states.pop(0), states.pop(0), template, n_cycles=1,
            steps_per_cycle=steps, seed=SEED)
        torch.cuda.synchronize()
    finally:
        invsqrt_mod.invsqrt_ns_kernel = launch
        del driver.forecast, driver.forecast_one
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # the analysis and the rest after the forecast: the peak since the
    # forecast's watch last reset it
    peaks["after_forecast_gb"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    peak = max(peaks[k] for k in ("nature_gb", "forecast_gb",
                                  "after_forecast_gb")) * 2 ** 30
    # the forecast's working set a member: its peak above what it began
    # with and its output ensemble (the size of the one it returns), in
    # nz·ny·nx float32 fields — what FORECAST_FIELDS_PER_MEMBER must cover
    field = grid.nz * grid.ny * grid.nx * 4
    peaks["forecast_fields_per_member"] = (
        (peaks["forecast_gb"] - peaks["forecast_start_gb"]) * 2 ** 30
        - nbytes(*ens)) / (driver.batch * field)
    info = res.info
    if keep is not None:
        keep.update({k: info[k].cpu() for k in (
            "gues_mean", "gues_sprd", "anal_mean", "anal_sprd")},
            stats_gues=res.stats_gues[0], stats_anal=res.stats_anal[0],
            peak_mem_gb=peak / 2 ** 30, wall_s=wall,
            tsfc=driver.tsfc.cpu() if physics else None)

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
    expected = expected_launches(cfg, grid, steps, batches,
                                 info["diag"].chunk)
    if production:
        from scale_letkf_torch.model.terrain import TERRAIN_LAUNCHES
        # the terrain tendency is kernel #5: the stencil kernels idle
        expected.update(terrain_tendency=TERRAIN_LAUNCHES
                        * expected["dyn_tendency"], dyn_tendency=0, adv_ud3=0)
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
    row = {"phase": phase, "config": CONFIG.name,
           "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
           "cycles": 1, "steps_per_cycle": steps, **kw,
           "generate_s": generate_s, "wall_s": wall,
           "sections_s": dict(driver.timer.records),
           "section_counts": dict(driver.timer.counts),
           "obsmake_repeat_s": obsmake_repeat_s,
           "template_obs": int(template.nobs), "obs_kept": res.nobs[0],
           "nobs_by_element": st_g.nobs,
           "member_batch": driver.batch, "batches": batches,
           "chunk": info["diag"].chunk,
           "chunks_per_level": -(-grid.ny * grid.nx // info["diag"].chunk),
           "kernel_launches": {k: launches[k] for k in expected},
           "expected_launches": expected, "peak_mem_gb": peak / 2 ** 30,
           "peak_by_step": peaks,
           "omb_rmse": omb, "oma_rmse": oma,
           "rmse_vs_nature_gues": res.rmse_gues[0],
           "rmse_vs_nature_anal": res.rmse_anal[0],
           "mean_spread_gues": sprd_g, "mean_spread_anal": sprd_a,
           "finite": finite,
           "note": "spread and O-A < O-B are required of T, PRES and PS: "
                   "the perturbations are in rho-theta only, so U, V and W "
                   "carry the little spread a few steps give them and may "
                   "sit flat"}
    if physics:
        tsfc = driver.tsfc
        row.update(physics=PHYS_PROD, bdy_width=dom["bdy_width"],
                   bdy_tau=dom["bdy_tau"],
                   tsfc_before={"mean": float(tsfc0.mean()),
                                "min": float(tsfc0.min()),
                                "max": float(tsfc0.max())},
                   tsfc_after={"mean": float(tsfc.mean()),
                               "min": float(tsfc.min()),
                               "max": float(tsfc.max())},
                   tsfc_max_abs_change=float((tsfc - tsfc0).abs().max()))
        finite = finite and bool(torch.isfinite(tsfc).all())
        row["finite"] = finite
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
    checked = ("T", "PS", "H08") if production else ("T", "PS")
    if not all(n in omb and oma[n] < omb[n] for n in checked):
        raise AssertionError(f"O-A RMSE above O-B RMSE: {oma} vs {omb}")
    if production:
        counts = driver.timer.counts
        if not counts.get("forecast/tendencies") == 3 * steps * batches:
            raise AssertionError(f"terrain tendencies not counted: {counts}")
        row.update(terrain_rhow(driver, truth, nat0, topo, steps, cfg, grid,
                                dycfg, dom, device))
        emit({"phase": phase, **{k: row[k] for k in (
            "rhow_terrain_run", "rhow_flat_run", "rhow_terrain_part")}})
        part = row["rhow_terrain_part"]
        if not part["hills"] > part["flat_ground"]:
            raise AssertionError(f"the terrain's part of rho-w is not "
                                 f"largest over the hills: {part}")
    if physics:
        row["stage_fields_per_member"] = stage_fields(
            driver, dycfg, dom, type(ens)(*(f[:driver.batch] for f in ens)))
        emit({"phase": phase, "stage_fields_per_member":
              row["stage_fields_per_member"], "member_batch": driver.batch})
        counts = driver.timer.counts
        n_phys = -(-steps // min(driver.phys_interval, steps))
        if not (counts.get("forecast/physics") == n_phys * batches
                and counts.get("forecast/boundary") == steps * batches):
            raise AssertionError(f"physics or boundary sections missing: "
                                 f"{counts}")
        if not row["tsfc_max_abs_change"] > 0:
            raise AssertionError("the skin temperature did not move")
    operands = {"grams": (grams["a"], grams["areg"]),
                "ensemble": type(ens)(*(f[:driver.batch] for f in ens)),
                "nature": type(truth)(*(f[None] for f in truth)),
                "column": (driver.rho_ref, driver.p_ref, driver.vg, dycfg)}
    if production:
        operands["metrics"] = driver.metrics
        operands["ensemble10"] = type(ens)(*(f[:10] for f in ens))
    return row, operands


def terrain_rhow(driver, truth, nat0, topo, steps, cfg, grid, dycfg, dom,
                 device) -> dict:
    """The largest |ρw| over the hills (topography above HILL_M) and over
    flat ground (below FLAT_M) of the production run's final nature state,
    of a flat run (gpu_check.production_driver without topography) of the
    same start nat0 for the same steps, and of their difference — the
    terrain's own part, which must be largest over the hills."""
    from scale_letkf_torch.gpu_check import production_driver
    flat = production_driver(cfg, grid, dycfg, dom, device, topo=None)
    truth_flat = flat.forecast_one(nat0, steps)
    hills = torch.as_tensor(topo > HILL_M, device=device)
    ground = torch.as_tensor(topo < FLAT_M, device=device)

    def peaks(rhow):
        col = rhow.abs().amax(dim=0)
        return {"hills": float(col[hills].max()),
                "flat_ground": float(col[ground].max())}
    return {"hill_cells": int(hills.sum()), "flat_cells": int(ground.sum()),
            "topo_max_m": float(topo.max()),
            "rhow_terrain_run": peaks(truth.rhow),
            "rhow_flat_run": peaks(truth_flat.rhow),
            "rhow_terrain_part": peaks(truth.rhow - truth_flat.rhow)}


def watch_peaks(driver, device) -> dict:
    """Wraps driver.forecast and driver.forecast_one (instance attributes,
    deleted afterwards) to record the peak device memory of each call and
    what was allocated when it began (GiB, the last call of each), and
    resets the peak after each call, so that the peak read at the end is
    that of what followed the last forecast (the analysis)."""
    peaks = {}
    for name, key in (("forecast", "forecast"), ("forecast_one", "nature")):
        fn = getattr(driver, name)

        def wrapped(*args, _fn=fn, _key=key, **kw):
            torch.cuda.synchronize()
            peaks[f"{_key}_start_gb"] = torch.cuda.memory_allocated(
                device) / 2 ** 30
            torch.cuda.reset_peak_memory_stats(device)
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            peaks[f"{_key}_gb"] = torch.cuda.max_memory_allocated(
                device) / 2 ** 30
            torch.cuda.reset_peak_memory_stats(device)
            return out

        setattr(driver, name, wrapped)
    return peaks


def stage_fields(driver, dycfg, dom, s) -> dict:
    """Peak device memory of one dynamics step (with the driver's terrain
    metrics, if any), one physics step (radiation recomputed) and one
    Davies relaxation of the member batch s, above what
    is allocated before each (s and the radiation cache included), in
    member-sized fields (nz·ny·nx float32) per member: what
    cycle.FORECAST_FIELDS_PER_MEMBER has to cover."""
    from scale_letkf_torch.model.boundary import (
        apply_boundary_relaxation, interp_boundary, relaxation_weight)
    from scale_letkf_torch.model.dycore_si import SplitConfig, rk3_step_si
    from scale_letkf_torch.model.physics_suite import (
        PhysicsState, physics_step, skin_temperature)
    B = s.rho.shape[0]
    per = B * s.rho[0].numel() * s.rho.element_size()
    tsfc = skin_temperature(s)
    phys = PhysicsState(tsfc, torch.zeros_like(s.rhot),
                        torch.zeros_like(tsfc))
    weight = relaxation_weight(s.rho.shape[-2], s.rho.shape[-1],
                               dom["bdy_width"], dom["bdy_tau"],
                               device=s.rho.device)
    stages = {
        "dynamics": lambda: rk3_step_si(
            s, dycfg, SplitConfig(dtau=dycfg.dt / driver.n_small),
            driver.rho_ref, driver.p_ref, driver.z_centers, driver.n_small,
            driver.vg, driver.metrics),
        "physics": lambda: physics_step(
            s, phys, 0, driver.phys_cfg, 5 * dycfg.dt, driver.dz_phys,
            driver.z_centers),
        "boundary": lambda: apply_boundary_relaxation(
            s, interp_boundary(driver.bdy, dycfg.dt), weight, dycfg.dt)}
    res = {}
    for name, fn in stages.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        res[name] = (torch.cuda.max_memory_allocated() - base) / per
        del out
    return res


def phase_cycle_real(cy, operands, phase: str = "cycle_real",
                     singles: int = 1) -> dict:
    """Every kernel of the cycle against its plain version on the cycle's
    own operands (phase_cycle): kernel #1 on one level chunk of its Grams;
    #2 and #3 at the ensemble forecast's member batch and at the nature
    run's batch of one (the nature state stands for the `singles` forecasts
    of one member the path runs). Returns per kernel one row for the path: the
    per-launch mean of the time, the plain version's time, the bytes and
    the operations over the shapes the cycle launched it at (weighted by
    those launches, so launches × ms is the kernel's time in the cycle), the
    roofline of that mean launch and the worst error; `shapes` lists each."""
    rho_ref, p_ref, vg, dycfg = operands["column"]
    rows = {"invsqrt_ns": check_invsqrt(*operands["grams"], phase)}
    rows["invsqrt_ns"]["shapes"] = [{"B": rows["invsqrt_ns"]["B"],
                                     "launches": cy["kernel_launches"][
                                         "invsqrt_ns"]}]
    per_stage = 3 * cy["steps_per_cycle"]
    parts = {"dyn_tendency": [], "adv_ud3": []}
    for label, n in (("ensemble", per_stage * cy["batches"]),
                     ("nature", per_stage * singles)):
        s = operands[label]
        dyn, adv = stencil_operands(s, rho_ref, p_ref, vg, dycfg)
        for name, row in (("dyn_tendency", check_dyn(dyn, f"{phase} {label}")),
                          ("adv_ud3", check_adv(adv, f"{phase} {label}"))):
            emit({"phase": phase, "kernel": name, "run": label,
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


def phase_radar_forecast(device):
    """The radar configuration's forecast at full size: configs/
    bda_1km_radar.toml unchanged (192×192×48 stretched, K = 50, dt 2 s, 4
    substeps, Kessler every 5 steps on the per-level thickness) over its
    30-s window, RADAR_STEPS steps, from a restart ensemble made on the card
    with rain and cloud blobs (gpu_check.RADAR_QR_BLOB at the peak) and a
    10 m/s wind. Each Kessler call is wrapped to record how far it moved
    qc and qr and the least qr it left. Returns the phase's row, a copy
    of the first member batch of the forecast (the stencil kernels'
    operands on the radar grid) with the driver's column and metric, and
    the final ensemble (what phase mesh_radar_forecast is held to)."""
    from scale_letkf_torch import cycle as cycle_mod
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.gpu_check import RADAR_QR_BLOB, RADAR_STEPS
    from scale_letkf_torch.synthetic import synthetic_ens_dycore_device
    from scale_letkf_torch.utils import kernels

    cfg, grid, dycfg, dom = load_config_and_grid(str(RADAR_CONFIG))
    K = cfg.ensemble.member
    t0 = time.perf_counter()
    ens, _, _ = synthetic_ens_dycore_device(SEED, K, grid, dom, device,
                                            u0=FCST_U0, qr_blob=RADAR_QR_BLOB)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    driver = make_driver(cfg, grid, dycfg, dom, device)
    kessler = cycle_mod.kessler_step
    calls = []

    def recording(s, dt, dz):
        out = kessler(s, dt, dz)
        calls.append({"dt": dt, "max_abs_dqc": float(
            (out.rhoq[:, 1] - s.rhoq[:, 1]).abs().max()),
            "max_abs_dqr": float((out.rhoq[:, 2] - s.rhoq[:, 2]).abs().max()),
            "min_qr": float((out.rhoq[:, 2] / out.rho).min())})
        return out

    cycle_mod.kessler_step = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        out = driver.forecast(ens, RADAR_STEPS)
        torch.cuda.synchronize()
    finally:
        cycle_mod.kessler_step = kessler
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in ("dyn_tendency", "adv_ud3")}
    peak = torch.cuda.max_memory_allocated(device)
    batches = -(-K // driver.batch)
    expected = 3 * RADAR_STEPS * batches
    finite = all(bool(torch.isfinite(f).all()) for f in out)
    qr = out.rhoq[:, 2] / out.rho
    fcst_s = driver.timer.records["forecast"]
    row = {"phase": "radar_forecast", "config": RADAR_CONFIG.name,
           "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
           "steps": RADAR_STEPS, "dt": dycfg.dt, "n_small": driver.n_small,
           "phys_interval": driver.phys_interval, "qr_blob": RADAR_QR_BLOB,
           "u0": FCST_U0, "generate_s": generate_s, "wall_s": wall,
           "forecast_s": fcst_s,
           "member_steps_per_s": K * RADAR_STEPS / fcst_s,
           "sections_s": dict(driver.timer.records),
           "section_counts": dict(driver.timer.counts),
           "member_batch": driver.batch, "batches": batches,
           "peak_mem_gb": peak / 2 ** 30, "kernel_launches": launches,
           "expected_launches": expected, "kessler_calls": calls,
           "qr_min": float(qr.min()), "qr_max": float(qr.max()),
           "finite": finite}
    emit(row)
    if not finite:
        raise AssertionError("the radar forecast is not finite")
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected} each")
    n_phys = -(-RADAR_STEPS // driver.phys_interval) * batches
    if len(calls) != n_phys:
        raise AssertionError(f"{len(calls)} Kessler steps, expected {n_phys}")
    if not row["qr_min"] >= 0 or any(c["min_qr"] < 0 for c in calls):
        raise AssertionError(f"negative rain: {row['qr_min']}")
    if not all(c["max_abs_dqc"] > 0 or c["max_abs_dqr"] > 0 for c in calls):
        raise AssertionError(f"a Kessler step changed neither qc nor qr: "
                             f"{calls}")
    sample = type(out)(*(f[:driver.batch].clone() for f in out))
    del ens, qr
    return row, (sample, driver.rho_ref, driver.p_ref, driver.vg, dycfg), out


def phase_radar_real(sample, phase: str = "radar_real") -> dict:
    """Both stencil kernels vs plain on one launch's operands of the radar
    forecast (192×192×48, the forecast's member batch), or of its grid
    (phase mesh_radar_real: one 104×104 extended block)."""
    s, rho_ref, p_ref, vg, dycfg = sample
    dyn, adv = stencil_operands(s, rho_ref, p_ref, vg, dycfg)
    rows = {"dyn_tendency": check_dyn(dyn, f"{phase} batch"),
            "adv_ud3": check_adv(adv, f"{phase} batch")}
    for name, row in rows.items():
        emit({"phase": phase, "kernel": name,
              "batch": int(s.rho.shape[0]), **row})
    return rows


def phase_physics_small(device):
    """The physics schemes alone, the coarsened physics-suite forecast with
    per-member Davies forcing, the radar configuration's Kessler forecast
    and its radar cycle, on the card against the CPU
    (scale_letkf_torch/gpu_check.py coarse_physics_vs_cpu)."""
    from scale_letkf_torch.gpu_check import (
        coarse_physics_vs_cpu, physics_check_passes)
    res = coarse_physics_vs_cpu(device, str(CONFIG), str(RADAR_CONFIG), SEED)
    emit({"phase": "physics_small", **res})
    if not physics_check_passes(res):
        raise AssertionError(f"GPU physics disagrees with the CPU: {res}")


def phase_terrain_tendency(operands) -> list:
    """Kernel #5 (tendencies_terrain on the card) against
    tendencies_terrain_plain and against dycore.tendencies (plain p′, then
    kernels #2 and #3) on the production cycle's final ensemble (its first
    ten members) and nature state (a batch of one), at full width, the
    moist pressure handed in as the SI stage hands it: the kernel must give
    the plain path's fields bit for bit in TERRAIN_LAUNCHES launches; the
    three are timed in turns, each with its byte bound (every input read
    once, every output written once) and its share of it; the terrain
    tendency on flat metrics must give dycore.tendencies' result (the
    kernels' bounds, TOL_TENDENCY and TOL_STENCIL)."""
    from scale_letkf_torch.gpu_check import TOL_STENCIL, TOL_TENDENCY
    from scale_letkf_torch.model import dycore, terrain
    from scale_letkf_torch.utils import kernels
    rho_ref, p_ref, vg, dycfg = operands["column"]
    m = operands["metrics"]
    # the metrics of flat topography: J = 1, no slopes
    flat = terrain.TerrainMetrics(torch.ones_like(m.jac),
                                  *(torch.zeros_like(f) for f in m[1:]))
    rows = []
    for label, s in (("ensemble", operands["ensemble10"]),
                     ("nature", operands["nature"])):
        s = type(s)(*(f.contiguous() for f in s))
        p = dycore.moist_pressure(s.rhot, dycore.mixing_ratios(s))

        def run_kernel(metrics=m):
            return terrain.tendencies_terrain(s, dycfg, rho_ref, p_ref,
                                              metrics, vg, p)

        def run_plain():
            return terrain.tendencies_terrain_plain(s, dycfg, rho_ref, p_ref,
                                                    m, vg, p)

        def run_flat():
            return dycore.tendencies(s, dycfg, rho_ref, p_ref, vg, p)

        kernels.reset_launches()
        got = run_kernel()
        launches = kernels.LAUNCHES["terrain_tendency"]
        want = run_plain()
        bit_equal = {n: bool(torch.equal(a, b))
                     for n, a, b in zip(s._fields, got, want)}
        del got, want
        want, got = run_flat(), run_kernel(flat)
        errs = {n: float((a - b).abs().max()) / float(b.abs().max())
                for n, a, b in zip(s._fields, got, want)}
        tols = {n: TOL_STENCIL if n == "rhoq" else TOL_TENDENCY
                for n in s._fields}
        del want, got
        t = timed_turns(run_kernel, run_plain)
        f = timed_turns(run_flat, run_kernel)
        state = nbytes(*s)
        bound = (2 * state + nbytes(p, *m)) / HBM_BYTES_PER_S * 1e3
        row = {"phase": "terrain_tendency", "run": label,
               "batch": int(s.rho.shape[0]),
               "kernel_launches": launches,
               "expected_launches": terrain.TERRAIN_LAUNCHES,
               "bit_equal": bit_equal,
               "terrain_kernel_ms": t["ms"], "terrain_ms": t["plain_ms"],
               "terrain_kernel_ms_runs": t["ms_runs"] + f["plain_ms_runs"],
               "terrain_ms_runs": t["plain_ms_runs"],
               "kernels_ms": f["ms"], "kernels_ms_runs": f["ms_runs"],
               "terrain_over_kernel": t["plain_ms"] / t["ms"],
               "terrain_kernel_over_kernels": t["ms"] / f["ms"],
               "terrain_bound_ms": bound,
               "terrain_kernel_bound_share": bound / t["ms"],
               "terrain_bound_share": bound / t["plain_ms"],
               "kernels_bound_ms": (2 * state + nbytes(p, rho_ref, p_ref))
               / HBM_BYTES_PER_S * 1e3,
               "flat_metrics_rel_err": errs, "tol": tols}
        row["kernels_bound_share"] = row["kernels_bound_ms"] / f["ms"]
        emit(row)
        rows.append(row)
        if launches != terrain.TERRAIN_LAUNCHES:
            raise AssertionError(f"kernel #5 launched {launches} times a "
                                 f"call: {row}")
        if not all(bit_equal.values()):
            raise AssertionError(f"kernel #5 is not the plain terrain "
                                 f"tendency bit for bit: {row}")
        if not all(errs[n] <= tols[n] for n in s._fields):
            raise AssertionError(f"the terrain tendency on flat metrics is "
                                 f"not dycore.tendencies: {row}")
    return rows


def phase_terrain_small(device):
    """The terrain dynamics, an unforced terrain forecast's mass, the pp
    step's smoothing, H08 H(x) and the coarsened production cycle on the
    card against the CPU (scale_letkf_torch/gpu_check.py)."""
    from scale_letkf_torch.gpu_check import (
        coarse_terrain_vs_cpu, terrain_check_passes)
    res = coarse_terrain_vs_cpu(device, str(CONFIG), SEED)
    emit({"phase": "terrain_small", **res})
    if not terrain_check_passes(res):
        raise AssertionError(f"GPU terrain or H08 disagrees with the CPU: "
                             f"{res}")


# the deterministic-member cycle: INFL_ADD, and the seeds of the synthetic
# ensemble construction that gives the additive-inflation source and the
# deterministic member
DET_INFL_ADD = 0.1
ADDI_SEED = 2
DET_SEED = 3
ADDI_BATCH = 5          # members converted to analysis variables at once
EFSO_REPS = 3
JACOBI_KS = (8, 16)
JACOBI_B = 480 * 360    # one level of the 18-km grid
JACOBI_REPS = 3


def _det_departures(driver, state, obs, obsdep, cfg):
    """O−B or O−A of one member (a DycoreState) against the analysis's
    preprocessed obs values, per monitored group."""
    from scale_letkf_torch.da.monitor import monit_dep
    from scale_letkf_torch.da.obsope import compute_hx_single
    from scale_letkf_torch.model.dycore import to_collocated
    from scale_letkf_torch.state import state_to_history, state_trans
    y, _ = compute_hx_single(
        state_to_history(state_trans(to_collocated(state)), driver.z_full,
                         driver.topo), obs, driver.grid, cfg, driver.z_full)
    dep = obsdep.dat - y.cpu().numpy().astype(np.float64)
    st = monit_dep(obsdep.elem, dep, obsdep.qc)
    return {n: r for n, r in st.rmse.items() if st.nobs[n]}


def phase_det_cycle(device, cycle_peak_gb: float):
    """The deterministic-member cycle at full size: the 18-km configuration
    unchanged but for ensemble.det_run = True and letkf.infl_add =
    DET_INFL_ADD; one cycle of CYCLE_STEPS steps, each stage through
    CycleDriver as the cycle verb composes it: the nature run and obsmake,
    the ensemble forecast, forecast_one of the deterministic member, and
    CycleDriver.analysis(ens, obs, det=det, addi_ens=addi). The ensemble
    and nature states are phase_cycle's; the additive-inflation source is
    that construction with seed ADDI_SEED, converted to analysis variables
    on the card ADDI_BATCH members at a time into pinned host memory, from
    which the analysis uploads one member at a time; the deterministic
    member is the construction with seed DET_SEED.

    Checks: every kernel launched as expected (#2 and #3 at 3 × steps ×
    (ensemble batches + nature + the member)); finite ensemble and member;
    the member moved, and its O−A below its O−B for T and PS, as the
    ensemble mean's; member 0's additive increment (after − before the stage, captured
    around apply_additive_inflation) equal to INFL_ADD·(addi_j − mean) in
    float64 within float32 rounding: 1 ulp of the result, the member-order
    float32 mean's K·ulp of max|addi| times INFL_ADD, and 1e-6 of the
    increment; the peak device memory within the cycle phase's plus one
    source ensemble. Returns the row, the states EFSO takes (the analysis
    ensemble, the nature state, the analysis info, the obs and the driver)
    and the operands of the path's kernels, as phase_cycle's (one level
    chunk of the Grams, the final ensemble at the member batch and the
    nature state as a batch of one)."""
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.da import inflation
    from scale_letkf_torch.da.obsmake import obsmake
    from scale_letkf_torch.gpu_check import expected_launches
    from scale_letkf_torch.model.dycore import DycoreState, to_collocated
    from scale_letkf_torch.ops import invsqrt as invsqrt_mod
    from scale_letkf_torch.state import (
        NV3D, V3D_ANAL_NAMES, state_to_history, state_trans)
    from scale_letkf_torch.synthetic import (
        synthetic_conv_network, synthetic_ens_dycore_device)
    from scale_letkf_torch.utils import kernels

    cfg, grid, dycfg, dom = load_config_and_grid(str(CONFIG))
    cfg.ensemble.det_run = True
    cfg.letkf.infl_add = DET_INFL_ADD
    K, steps = cfg.ensemble.member, CYCLE_STEPS
    kw = {"u0": FCST_U0, "amp_theta": CYCLE_AMP_THETA,
          "smooth_passes": CYCLE_SMOOTH_PASSES}
    t0 = time.perf_counter()
    src, _, _ = synthetic_ens_dycore_device(ADDI_SEED, K, grid, dom, device,
                                            **kw)
    addi = torch.empty((K, NV3D, grid.nz, grid.ny, grid.nx),
                       dtype=torch.float32, pin_memory=True)
    for b0 in range(0, K, ADDI_BATCH):
        addi[b0:b0 + ADDI_BATCH].copy_(state_trans(to_collocated(
            DycoreState(*(f[b0:b0 + ADDI_BATCH] for f in src)))))
    del src
    torch.cuda.empty_cache()
    ens0, _, _ = synthetic_ens_dycore_device(SEED, K, grid, dom, device, **kw)
    nat, _, _ = synthetic_ens_dycore_device(SEED + 1, 1, grid, dom, device,
                                            **kw)
    det0, _, _ = synthetic_ens_dycore_device(DET_SEED, 1, grid, dom, device,
                                             **kw)
    truth = DycoreState(*(f[0] for f in nat))
    det = DycoreState(*(f[0] for f in det0))
    ens = [ens0]
    del nat, det0, ens0
    template = synthetic_conv_network(cfg, grid, np.random.default_rng(SEED))
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    driver = make_driver(cfg, grid, dycfg, dom, device)

    apply = inflation.apply_additive_inflation
    probe: dict = {}

    def recording(anal, add_ens, infl_add, **kwa):
        probe["before"] = anal[0].clone()
        probe["shuffle"] = kwa.get("shuffle")
        out = apply(anal, add_ens, infl_add, **kwa)
        probe["after"] = anal[0].clone()
        return out

    launch = invsqrt_mod.invsqrt_ns_kernel
    grams: dict = {}

    def recording_grams(a, areg, *args):
        if not grams:
            grams["a"], grams["areg"] = a.clone(), areg.clone()
        return launch(a, areg, *args)

    peaks = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        out = fn()
        torch.cuda.synchronize()
        peaks[f"{name}_gb"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        return out

    inflation.apply_additive_inflation = recording
    invsqrt_mod.invsqrt_ns_kernel = recording_grams
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with driver.timer.section("nature"):
            truth = stage("nature", lambda: driver.forecast_one(truth, steps))
        with driver.timer.section("obsmake"):
            truth_anal = state_trans(to_collocated(truth))
            obs = obsmake(state_to_history(truth_anal, driver.z_full,
                                           driver.topo), template, grid, cfg,
                          driver.z_full, np.random.default_rng(SEED))
        ens.append(stage("forecast", lambda: driver.forecast(ens.pop(),
                                                             steps)))
        with driver.timer.section("det_forecast"):
            det = stage("det_forecast", lambda: driver.forecast_one(det,
                                                                    steps))
        anal, info = stage("analysis", lambda: driver.analysis(
            ens.pop(), obs, det=det, addi_ens=addi,
            rng=np.random.default_rng(SEED)))
    finally:
        inflation.apply_additive_inflation = apply
        invsqrt_mod.invsqrt_ns_kernel = launch
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
    batches = -(-K // driver.batch)
    expected = expected_launches(cfg, grid, steps, batches,
                                 info["diag"].chunk)
    for k in ("dyn_tendency", "adv_ud3"):
        expected[k] += 3 * steps          # the deterministic member

    # member 0's additive increment against float64
    j = int(probe["shuffle"][0]) if probe["shuffle"] is not None else 0
    mean64 = torch.zeros(addi.shape[1:], dtype=torch.float64, device=device)
    for m in range(K):
        mean64 += addi[m].to(device).double()
    mean64 /= K
    want = DET_INFL_ADD * (addi[j].to(device).double() - mean64)
    # the analysis hands the stage its gridpoints flattened
    got = (probe["after"].double() - probe["before"].double()).reshape(
        want.shape)
    addi_err = {}
    for v, n in enumerate(V3D_ANAL_NAMES):
        tol = (float(torch.finfo(torch.float32).eps)
               * (float(probe["after"][v].abs().max())
                  + DET_INFL_ADD * K * float(addi[:, v].abs().max()))
               + 1e-6 * float(want[v].abs().max()))
        diff = float((got[v] - want[v]).abs().max())
        addi_err[n] = diff / tol if tol > 0 else (0.0 if diff == 0 else
                                                   float("inf"))
    del mean64, want, got, probe

    det_a = info["det"]
    finite = (all(bool(torch.isfinite(f).all()) for f in (*anal, *det_a))
              and all(bool(torch.isfinite(info[k]).all()) for k in (
                  "anal_mean", "anal_sprd")))
    det_change = float((det_a.rhot - det.rhot).abs().max())
    obsdep = info["obsdep"]
    det_omb = _det_departures(driver, det, obs, obsdep, cfg)
    det_oma = _det_departures(driver, det_a, obs, obsdep, cfg)
    st_g, st_a = info["stats_gues"], info["stats_anal"]
    omb = {n: r for n, r in st_g.rmse.items() if st_g.nobs[n]}
    oma = {n: r for n, r in st_a.rmse.items() if st_a.nobs[n]}
    sprd_g = {n: float(info["gues_sprd"][v].mean())
              for v, n in enumerate(V3D_ANAL_NAMES)}
    sprd_a = {n: float(info["anal_sprd"][v].mean())
              for v, n in enumerate(V3D_ANAL_NAMES)}
    peak = max(v for k, v in peaks.items())
    addi_gb = nbytes(addi) / 2 ** 30
    row = {"phase": "det_cycle", "config": CONFIG.name,
           "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
           "cycles": 1, "steps_per_cycle": steps, "det_run": True,
           "infl_add": DET_INFL_ADD, "addi_seed": ADDI_SEED,
           "det_seed": DET_SEED, "addi_on": "host (pinned)",
           "generate_s": generate_s, "wall_s": wall,
           "sections_s": dict(driver.timer.records),
           "section_counts": dict(driver.timer.counts),
           "obs_kept": int(obs.nobs), "member_batch": driver.batch,
           "batches": batches, "chunk": info["diag"].chunk,
           "kernel_launches": launches, "expected_launches": expected,
           "peak_mem_gb": peak, "peak_by_stage": peaks,
           "addi_source_gb": addi_gb, "cycle_peak_gb": cycle_peak_gb,
           "omb_rmse": omb, "oma_rmse": oma,
           "det_omb_rmse": det_omb, "det_oma_rmse": det_oma,
           "det_max_abs_change_rhot": det_change,
           "mean_spread_gues": sprd_g, "mean_spread_anal": sprd_a,
           "addi_member": j, "addi_err_over_tol": addi_err,
           "finite": finite}
    emit(row)
    if not finite:
        raise AssertionError("the deterministic cycle is not finite")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected}")
    if not det_change > 0:
        raise AssertionError("the deterministic member did not move")
    for label, b, a in (("member", det_omb, det_oma), ("mean", omb, oma)):
        if not all(n in b and a[n] < b[n] for n in ("T", "PS")):
            raise AssertionError(f"{label} O-A above O-B: {a} vs {b}")
    if not all(e <= 1 for e in addi_err.values()):
        raise AssertionError(f"additive increment off: {addi_err}")
    if not peak <= cycle_peak_gb + addi_gb:
        raise AssertionError(f"peak {peak:.2f} GiB above the cycle's "
                             f"{cycle_peak_gb:.2f} + {addi_gb:.2f}")
    del addi
    operands = {"grams": (grams["a"], grams["areg"]),
                "ensemble": type(anal)(*(f[:driver.batch] for f in anal)),
                "nature": type(truth)(*(f[None] for f in truth)),
                "column": (driver.rho_ref, driver.p_ref, driver.vg, dycfg)}
    return row, {"ens": anal, "truth": truth, "info": info, "obs": obs,
                 "driver": driver, "cfg": cfg}, operands


def phase_efso(device, st: dict) -> dict:
    """EFSO at full size on the deterministic cycle's analysis, with no
    forecast from it (eft = 0): the analysis ensemble's perturbations in
    analysis variables (K × 11 × 36 × 360 × 480), ē = analysis mean −
    nature, the analysis ensemble's H(x) perturbations at the obs QC kept,
    their O−B and error variances, HORI_LOCAL gpu_check.EFSO_HORI (400 km),
    no vertical localization, obs levels by phys2ijk on the mean pressure
    (0 for surface obs). efso_impact timed with CUDA events (EFSO_REPS
    calls after a warm-up), with its peak memory; then the coarsened
    comparison with the CPU (gpu_check.coarse_efso_vs_cpu)."""
    from scale_letkf_torch.da.efso import efso_impact
    from scale_letkf_torch.da.obsope import compute_hx_single
    from scale_letkf_torch.gpu_check import EFSO_HORI, coarse_efso_vs_cpu
    from scale_letkf_torch.model.dycore import DycoreState, to_collocated
    from scale_letkf_torch.obs.operators import phys2ijk
    from scale_letkf_torch.state import (
        IA_P, NV3D, state_to_history, state_trans)
    driver, info, cfg = st["driver"], st["info"], st["cfg"]
    grid, z, topo = driver.grid, driver.z_full, driver.topo
    ens = st.pop("ens")
    K = ens.rho.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pert = torch.empty((K, NV3D, grid.nz, grid.ny, grid.nx), device=device)
    for b0 in range(0, K, ADDI_BATCH):
        pert[b0:b0 + ADDI_BATCH] = state_trans(to_collocated(
            DycoreState(*(f[b0:b0 + ADDI_BATCH] for f in ens))))
    del ens
    good = info["obsdep"].qc == 0
    obs = st["obs"].select(good)
    y = torch.cat([compute_hx_single(
        state_to_history(pert[b0:b0 + ADDI_BATCH], z, topo), obs, grid, cfg,
        z)[0] for b0 in range(0, K, ADDI_BATCH)])          # (K, nobs)
    hdxa = (y - y.mean(dim=0)).T.contiguous()
    mean = pert.mean(dim=0)
    pert -= mean
    err = mean - state_trans(to_collocated(st["truth"]))
    ri, rj = (torch.as_tensor(a, dtype=torch.float32, device=device)
              for a in grid.lonlat_to_ij(obs.lon, obs.lat))
    elem = torch.as_tensor(obs.elem, device=device)
    rk, _ = phys2ijk(mean[IA_P], elem, ri, rj,
                     torch.as_tensor(obs.lev, dtype=torch.float32,
                                     device=device))
    rk = torch.where(elem > 9999, 0.0, rk)
    dep = torch.as_tensor(info["obsdep"].omb[good], dtype=torch.float32,
                          device=device)
    rdiag = torch.as_tensor(obs.err ** 2, dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def run():
        return efso_impact(ri, rj, rk, dep, rdiag, hdxa, pert, err, grid,
                           EFSO_HORI)

    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    dj = run()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated(device) / 2 ** 30
    work_gb = (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30
    ms = cuda_ms(run, EFSO_REPS)
    row = {"phase": "efso", "grid": f"{grid.nx}x{grid.ny}x{grid.nz}",
           "members": K, "pert_gb": nbytes(pert) / 2 ** 30,
           "hori_local_m": EFSO_HORI, "eft_s": 0.0, "nobs": int(obs.nobs),
           "setup_s": setup_s, "ms": ms, "reps": EFSO_REPS,
           "peak_mem_gb": peak_gb, "working_set_gb": work_gb,
           "finite": bool(torch.isfinite(dj).all()),
           "dj_sum": float(dj.sum()), "dj_negative_share":
           float((dj < 0).float().mean())}
    del pert, hdxa, err, dj
    torch.cuda.empty_cache()
    row["small"] = coarse_efso_vs_cpu(device, str(CONFIG), SEED)
    emit(row)
    if not (row["finite"] and row["small"]["finite"] and all(
            e <= 1 for e in row["small"]["max_err_over_tol"].values())):
        raise AssertionError(f"EFSO failed: {row}")
    return row


def phase_det_small(device):
    """The coarsened deterministic + additive analysis and the letkf and
    cycle verbs with 'mdet' and 'addi' files on the card against the CPU
    (scale_letkf_torch/gpu_check.py)."""
    from scale_letkf_torch.gpu_check import (
        coarse_det_addi_vs_cpu, det_check_passes, det_verbs_vs_cpu)
    res = {"analysis": coarse_det_addi_vs_cpu(device, str(CONFIG), SEED),
           "verbs": det_verbs_vs_cpu(device, SEED)}
    emit({"phase": "det_small", **res})
    if not (det_check_passes(res)
            and res["analysis"]["kernel_launches"]["device"] > 0
            and res["verbs"]["kernel_launches"]["letkf.device"] > 0):
        raise AssertionError(f"GPU deterministic member or additive "
                             f"inflation disagrees with the CPU: {res}")


def phase_jacobi(device) -> dict:
    """The ported Jacobi eigensolver against torch.linalg.eigh on batched
    LETKF-shaped float32 Grams (hᵀh over 40 obs · (K−1)/40 + (K−1)·I) at
    K in JACOBI_KS with B = one 18-km level (480 × 360): both timed in turns
    with CUDA events, each one's eigenvalue error (relative to max|λ|),
    reconstruction error (relative to max|A|) and transform error
    (W = V·sqrt((K−1)/Λ)·Vᵀ, relative to max|W|) against float64 eigh of the
    same Grams; the float32 bounds of tests/test_eigh_jacobi.py (2e-4,
    5e-5) must hold for the Jacobi. 'eigh' is the solver's own call
    (letkf_core._eigh: EIGH_MAX_BATCH matrices a call); whether
    torch.linalg.eigh takes the whole batch at once is recorded (cuSOLVER
    refused it in this phase's first run). Returns the faster solver per K
    beside letkf_core.AUTO_SMALL_K_SOLVER, 'auto''s choice at K ≤ 16; and
    gpu_check.jacobi_vs_cpu at both K."""
    from scale_letkf_torch.gpu_check import jacobi_vs_cpu
    from scale_letkf_torch.ops.eigh_jacobi import eigh_jacobi
    from scale_letkf_torch.ops.letkf_core import (
        AUTO_SMALL_K_SOLVER, EIGH_MAX_BATCH, _eigh)
    from scale_letkf_torch.utils.device import full_fp32
    B = JACOBI_B
    rows = {}
    for K in JACOBI_KS:
        gen = torch.Generator(device).manual_seed(SEED + K)
        h = torch.randn((B, 40, K), generator=gen, device=device)
        with full_fp32():
            a = (h.transpose(1, 2) @ h) * ((K - 1) / 40.0)
        del h
        a.diagonal(dim1=1, dim2=2).add_(K - 1.0)
        w64, v64 = _eigh(a.double())
        wt64 = (v64 * torch.sqrt((K - 1) / w64)[:, None, :]) @ v64.mT

        def errors(w, v):
            w, v = w.double(), v.double()
            rec = (v * w[:, None, :]) @ v.mT
            wt = (v * torch.sqrt((K - 1) / w)[:, None, :]) @ v.mT
            return {"eigval_rel_err": float((w - w64).abs().max()
                                            / w64.abs().max()),
                    "recon_rel_err": float((rec - a.double()).abs().max()
                                           / a.abs().max()),
                    "transform_rel_err": float((wt - wt64).abs().max()
                                               / wt64.abs().max())}
        err_j = errors(*eigh_jacobi(a))
        try:
            torch.linalg.eigh(a)
            torch.cuda.synchronize()
            eigh_error = None
        except RuntimeError as e:
            eigh_error = str(e).split("\n")[0][:200]

        def eig():
            return _eigh(a)
        err_e = errors(*eig())
        del w64, v64, wt64

        def jac():
            eigh_jacobi(a)
        e1 = cuda_ms(eig, JACOBI_REPS)
        j1 = cuda_ms(jac, JACOBI_REPS)
        j2 = cuda_ms(jac, JACOBI_REPS)
        e2 = cuda_ms(eig, JACOBI_REPS)
        rows[K] = {"K": K, "B": B, "jacobi_ms": (j1 + j2) / 2,
                   "eigh_ms": (e1 + e2) / 2, "jacobi_ms_runs": [j1, j2],
                   "eigh_ms_runs": [e1, e2],
                   "eigh_full_batch_error": eigh_error,
                   "eigh_max_batch": EIGH_MAX_BATCH,
                   "jacobi_err": err_j, "eigh_err": err_e,
                   "faster": "jacobi" if j1 + j2 < e1 + e2 else "eigh",
                   "vs_cpu": jacobi_vs_cpu(device, K)}
        emit({"phase": "jacobi", **rows[K]})
        del a
        if not (err_j["eigval_rel_err"] <= 2e-4
                and err_j["recon_rel_err"] <= 5e-5
                and rows[K]["vs_cpu"]["passes"]):
            raise AssertionError(f"Jacobi off at K = {K}: {rows[K]}")
    res = {"phase": "jacobi", "auto_small_k_solver": AUTO_SMALL_K_SOLVER,
           "faster_by_k": {K: r["faster"] for K, r in rows.items()}}
    emit(res)
    return res


# Adam steps of the smoke's H08 fit (the calibration's own run takes 600):
# cut for the smoke's time; the card and the CPU take the same steps
H08_FIT_STEPS = 300


def phase_h08_calibrate(device):
    """The H08 band-model calibration's fit (H08_FIT_STEPS Adam steps, 64
    profiles, float64) on the card against the CPU fit, timed, and the BT
    misfit after below the misfit before (gpu_check.h08_fit_vs_cpu)."""
    from scale_letkf_torch.gpu_check import h08_fit_vs_cpu
    t0 = time.perf_counter()
    res = h08_fit_vs_cpu(device, H08_FIT_STEPS)
    emit({"phase": "h08_calibrate", "seconds": time.perf_counter() - t0,
          **res})
    if not res["passes"]:
        raise AssertionError(f"H08 calibration fit disagrees: {res}")


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
    torch, the metric per level, the lateral mode last."""
    from scale_letkf_torch.model.dycore import mixing_ratios, moist_pressure
    p_pert = moist_pressure(s.rhot, mixing_ratios(s)) - p_ref
    dyn = (s.rho, s.rhou, s.rhov, s.rhow, s.rhot, p_pert, rho_ref, vg.dzc,
           vg.dzf, dycfg.dx, dycfg.dy, dycfg.kdiff4,
           dycfg.divdmp if divdmp is None else divdmp, dycfg.dt,
           dycfg.lateral)
    adv = (s.rhoq, s.rho, s.rhou, s.rhov, s.rhow, vg.dzc, dycfg.dx,
           dycfg.dy, dycfg.kdiff4, dycfg.lateral)
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
    shapes of gpu_check.RAGGED_SHAPES, in both lateral modes."""
    from scale_letkf_torch.gpu_check import ragged_kernels_vs_plain
    rows = [row for lateral in ("periodic", "open")
            for row in ragged_kernels_vs_plain(device, kernel,
                                               lateral=lateral)]
    for row in rows:
        emit({"phase": phase, **row})
    bad = [r for r in rows if not (r["finite"] and r["rel_err"] <= r["tol"])]
    if bad:
        raise AssertionError(f"{kernel} disagrees with its plain version at "
                             f"ragged shapes: {bad}")


def mode_turns(kernel, args) -> dict:
    """The kernel on one operand tuple in the open mode and, the same
    operands, in the periodic mode, timed in turns (periodic, open, open,
    periodic) with CUDA events."""
    periodic = args[:-1] + ("periodic",)
    t = timed_turns(lambda: kernel(*args), lambda: kernel(*periodic))
    return {"open_ms": t["ms"], "periodic_ms": t["plain_ms"],
            "open_ms_runs": t["ms_runs"],
            "periodic_ms_runs": t["plain_ms_runs"],
            "open_over_periodic": t["ms"] / t["plain_ms"]}


def open_rows(device, s, rho_ref, p_ref, phase: str) -> None:
    """Kernel `phase` (tendency: #2, stencil: #3) in the open lateral mode
    against its plain version at 480×360×36 on the random states s, both
    metrics, kdiff4 0 and 1e-3 (and divdmp 0 and 0.05 for #2), each row
    with the kernel's times in both modes side by side (mode_turns)."""
    import dataclasses

    from scale_letkf_torch.ops.stencil import adv_flux_divergence_kernel
    from scale_letkf_torch.ops.tendency import dyn_tendencies_kernel
    dycfg, vgs, grid = metrics_18km(device)
    for metric, vg in vgs.items():
        for kdiff4 in (0.0, 1e-3):
            cfg = dataclasses.replace(dycfg, kdiff4=kdiff4, lateral="open")
            cases = ((0.0, 0.05) if phase == "tendency" else (None,))
            for divdmp in cases:
                dyn, adv = stencil_operands(s, rho_ref, p_ref, vg, cfg,
                                            divdmp)
                label = f"open, {metric}, divdmp {divdmp}, kdiff4 {kdiff4}"
                if phase == "tendency":
                    row = check_dyn(dyn, label)
                    row.update(mode_turns(dyn_tendencies_kernel, dyn))
                else:
                    row = check_adv(adv, label)
                    row.update(mode_turns(adv_flux_divergence_kernel, adv))
                emit({"phase": phase, "lateral": "open", "metric": metric,
                      "divdmp": divdmp, "kdiff4": kdiff4,
                      "batch": STENCIL_BATCH,
                      "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", **row})


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
            emit({"phase": "tendency", "lateral": "periodic",
                  "metric": metric, "divdmp": divdmp,
                  "batch": STENCIL_BATCH,
                  "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", **row})
    open_rows(device, s, rho_ref, p_ref, "tendency")
    phase_ragged(device, "dyn_tendency", "tendency")
    return s, rho_ref, p_ref


def phase_stencil(device, s, rho_ref, p_ref):
    dycfg, vgs, grid = metrics_18km(device)
    for metric, vg in vgs.items():
        for kdiff4 in (0.0, dycfg.kdiff4):
            args = (s.rhoq, s.rho, s.rhou, s.rhov, s.rhow, vg.dzc, dycfg.dx,
                    dycfg.dy, kdiff4)
            row = check_adv(args, f"{metric}, kdiff4 {kdiff4}")
            emit({"phase": "stencil", "lateral": "periodic",
                  "metric": metric, "kdiff4": kdiff4,
                  "batch": STENCIL_BATCH, "tracers": int(s.rhoq.shape[1]),
                  "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", **row})
    open_rows(device, s, rho_ref, p_ref, "stencil")
    phase_ragged(device, "adv_ud3", "stencil")


def acoustic_stage(device, shape, metric: str, dx: float):
    """The acoustic substeps' operands at full size on the card: a stage
    state of random_dyn_state, its slow tendencies (dycore.tendencies, #2
    and #3) and a start state one step of them earlier; dt 0.5 s and the
    metric at `metric` levels (stretched: 150 m × 1.03ᵏ, the radar cell's;
    uniform: 300 m)."""
    from scale_letkf_torch.model.dycore import (
        DycoreConfig, DycoreState, make_vgrid, tendencies, uniform_vgrid)
    B, nz, ny, nx = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    s, rho_ref, p_ref = random_dyn_state(gen, B, nz, ny, nx, device)
    cfg = DycoreConfig(dx=dx, dy=dx, dz=300.0, dt=0.5)
    if metric == "stretched":
        fz = np.concatenate([[0.0], np.cumsum(150.0 * 1.03 ** np.arange(nz))])
        vg = make_vgrid(0.5 * (fz[1:] + fz[:-1]), fz, device)
    else:
        vg = uniform_vgrid(nz, 300.0, device)
    slow = tendencies(s, cfg, rho_ref, p_ref, vg)
    start = DycoreState(*(a - cfg.dt * b for a, b in zip(s, slow)))
    return start, s, slow, cfg, vg


def phase_acoustic(device) -> dict:
    """The acoustic substep kernel against the plain substep loop at the
    radar cell's and the 18-km shapes: a stage of 4 substeps both ways
    (bit-equal expected), then both timed in turns at 4 and at 8 substeps.
    A middle substep's time is the difference over 4 (the first and the
    last launch also form and apply the deviations); its bound reads the
    five deviations, the five slow tendencies, c² and θ once and writes the
    five deviations once. Returns the kernels line's row."""
    from scale_letkf_torch.model.dycore import DycoreState
    from scale_letkf_torch.model.dycore_si import (
        SplitConfig, acoustic_substeps_kernel, acoustic_substeps_plain)
    from scale_letkf_torch.utils import kernels
    rows = {}
    for name, (shape, metric, dx) in ACOUSTIC_SHAPES.items():
        start, s, slow, cfg, vg = acoustic_stage(device, shape, metric, dx)

        def run(fn, n):
            return fn(start, s, slow, cfg, SplitConfig(dtau=cfg.dt / n), n,
                      cfg.dt, vg)

        before = kernels.LAUNCHES[ACOUSTIC]
        out = run(acoustic_substeps_kernel, 4)
        launches = kernels.LAUNCHES[ACOUSTIC] - before
        ref = run(acoustic_substeps_plain, 4)
        torch.cuda.synchronize()
        errs = field_errors(out, ref, DycoreState._fields)
        equal = {n: bool(torch.equal(a, b))
                 for n, a, b in zip(DycoreState._fields, out, ref)}
        finite = all(bool(torch.isfinite(o).all()) for o in out)
        del out, ref
        t = {n: timed_turns(lambda n=n: run(acoustic_substeps_kernel, n),
                            lambda n=n: run(acoustic_substeps_plain, n),
                            ACOUSTIC_REPS) for n in (4, 8)}
        ms = (t[8]["ms"] - t[4]["ms"]) / 4
        plain_ms = (t[8]["plain_ms"] - t[4]["plain_ms"]) / 4
        B, nz, ny, nx = shape
        n, nw = B * nz * ny * nx, B * (nz + 1) * ny * nx
        row = {"shape": list(shape), "metric": metric, "dx": dx,
               "launches": launches, "bit_equal": equal, "finite": finite,
               "fields": errs,
               "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "stage_ms": t[4]["ms"], "plain_stage_ms": t[4]["plain_ms"],
               "stage8_ms": t[8]["ms"], "plain_stage8_ms": t[8]["plain_ms"],
               "ms": ms, "plain_ms": plain_ms,
               **roofline(4 * (14 * n + 3 * nw), 0.0, ms)}
        del start, s, slow
        torch.cuda.empty_cache()
        emit({"phase": "acoustic", "case": name, **row})
        if not (finite and launches == 4
                and all(e["rel_err"] <= 1e-5 for e in errs.values())):
            raise AssertionError(f"acoustic kernel disagrees with its plain "
                                 f"version ({name}): {row}")
        rows[name] = row
    return rows


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


# --- the full-size executors: the member-streamed cycle, the tiled and the
# device-resident analyses ---------------------------------------------------
# configs/18km_japan.toml's 7-slot 4-D window (slot_base 4) with one cut of
# depth: slot_tinterval 3600 → 150 s (5 steps at dt 30 s), so the analysis
# falls at step 15 and the window ends at step 30 (1080 in the shipped run).
# Each slot segment is one physics-suite call, whose cadence is
# min(phys_interval, steps): 5 steps keep the shipped run's. Shallower
# windows fail phase resident_cycle's yardstick (each member's H(x) within
# 0.2 of the spread): the winds' spread, which the ρθ perturbations give
# them only through the steps, is too small — 0.374 of it at 60 s (12
# steps), 0.227 at 120 s (24), 0.112 at 150 s (30) on an NVIDIA H100 80GB
# HBM3 at 700.00 W.
STREAMED_SLOT_S = 150.0
STREAMED_BATCH = 10
# analysis tiles of 40 rows, 9 a level: a change of the cell's executor
# setting, not a depth cut (the cell was defined with 20-row tiles; 40
# since the OSSE phase needed the time). The tiled analysis's selections
# are launch-bound, so half the tiles take about half the time; the window,
# the obs and every check are the same, but the analysis times are not
# those of the 20-row cell
STREAMED_ROWS = 40
CELL_ROWS = 20
RADAR_ROWS = 48
RADAR_BATCH = 10
RADAR_OBS_TARGET = 1_000_000
SHIPPED_WINDOW_STEPS = 1080   # 6-h cycle + 3 slots of 1 h beyond, at 30 s
INCORE_PEAK_GB = 48.9         # the in-core cycle's peak (PERF.md §5)


def host_peak_gb() -> float:
    """The process's peak resident set size (GiB) so far."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def host_ensemble(ens) -> "object":
    """A device DycoreState ensemble copied to host numpy arrays (through
    pinned buffers)."""
    from scale_letkf_torch.utils.staging import Stager
    stager = Stager(ens.rho.device)
    out = type(ens)(*(np.empty(f.shape, np.float32) for f in ens))
    for f, o in zip(ens, out):
        for i0 in range(0, f.shape[0], STREAMED_BATCH):
            stager.download(f[i0:i0 + STREAMED_BATCH],
                            o[i0:i0 + STREAMED_BATCH])
    return out


def transfers(rep: dict) -> dict:
    """Bytes each way of a streamed report and their rates (GB/s over the
    blocking sections that moved them)."""
    up = rep["h2d_bytes"] + rep["letkf_h2d_bytes"] + rep["trans_inv_h2d_bytes"]
    down = (rep["d2h_bytes"] + rep["letkf_d2h_bytes"]
            + rep["trans_inv_d2h_bytes"])
    return {"h2d_gb": up / 1e9, "d2h_gb": down / 1e9,
            "fcst_upload_gb_per_s": rep["h2d_bytes"] / 1e9
            / max(rep["upload_s"], 1e-9),
            "fcst_download_gb_per_s": rep["d2h_bytes"] / 1e9
            / max(rep["download_s"], 1e-9),
            "letkf_gb_per_s": (rep["letkf_h2d_bytes"] + rep["letkf_d2h_bytes"])
            / 1e9 / max(rep["letkf_transfer_s"], 1e-9)}


def rmse_of(st) -> dict:
    return {n: r for n, r in st.rmse.items() if st.nobs[n]}


def center_slot_rmse(ex, obs, cfg) -> tuple[dict, dict]:
    """O−B and O−A RMSE of the obs of the analysis-time slot (SLOT_BASE)
    alone, from the executor's last obs context and O−A: the monitor's
    analysis is the analysis-time state, so the other slots' O−A also
    holds the nature run's change between their time and the analysis
    time; this subset is the time-consistent comparison."""
    from scale_letkf_torch.da.monitor import monit_dep
    from scale_letkf_torch.da.obsope import assign_slots
    ctx = ex.last_ctx
    m = assign_slots(obs.dif, cfg) == cfg.obsope.slot_base
    return (rmse_of(monit_dep(ctx.elem[m], ctx.dep[m], ctx.qc[m])),
            rmse_of(monit_dep(ctx.elem[m], ex.last_oma[m], ctx.qc[m])))


def record_analysis(ex, store: dict):
    """Wraps ex.analysis (an instance attribute) to keep the H(x) and QC it
    is given and, for a host ensemble (the streamed cycle), the domain-mean
    spreads of T and PRES of the guess and the analysis and the analysis
    mean and spread fields."""
    from scale_letkf_torch.state import V3D_ANAL_NAMES
    fn = ex.analysis

    def spreads(anal):
        x = torch.from_numpy(anal)
        return {n: float(x[:, v].std(dim=0).mean())
                for v, n in enumerate(V3D_ANAL_NAMES) if n in ("T", "PRES")}

    def wrapped(ens, obs, ensval, qc, *a, **kw):
        store["ensval"] = (ensval.cpu().numpy() if isinstance(
            ensval, torch.Tensor) else np.array(ensval))
        store["qc"] = np.array(qc)
        if isinstance(ens, np.ndarray):
            store["sprd_gues"] = spreads(ens)
        res = fn(ens, obs, ensval, qc, *a, **kw)
        if isinstance(ens, np.ndarray):
            store["sprd_anal"] = spreads(res[0])
            store["anal_mean"] = torch.from_numpy(res[0]).mean(dim=0)
            store["anal_sprd"] = torch.from_numpy(res[0]).std(dim=0)
        return res

    ex.analysis = wrapped


def streamed_inputs(device):
    """Phase streamed_cycle's inputs: the configuration with the cut slot
    interval, the physics cycle's driver (physics suite, Davies toward the
    balanced base state), the ensemble made on the card and brought down
    both as analysis variables (anal0, for the resident phase) and as their
    restart (ens_rt, for the streamed one), the nature member on the host
    and the conventional network spread over the 7 slots."""
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.gpu_check import PHYS_PROD
    from scale_letkf_torch.model.dycore import from_collocated, to_collocated
    from scale_letkf_torch.state import NV3D, state_trans, state_trans_inv
    from scale_letkf_torch.synthetic import (
        base_boundary, synthetic_conv_network, synthetic_ens_dycore_device)
    from scale_letkf_torch.utils.staging import Stager
    cfg, grid, dycfg, dom = load_config_and_grid(str(CONFIG))
    cfg.obsope.slot_tinterval = STREAMED_SLOT_S
    dom = {**dom, "physics": PHYS_PROD}
    K = cfg.ensemble.member
    kw = {"u0": FCST_U0, "amp_theta": CYCLE_AMP_THETA,
          "smooth_passes": CYCLE_SMOOTH_PASSES}
    t0 = time.perf_counter()
    ens, _, _ = synthetic_ens_dycore_device(SEED, K, grid, dom, device, **kw)
    nat, _, _ = synthetic_ens_dycore_device(SEED + 1, 1, grid, dom, device,
                                            **kw)
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    anal0 = np.empty((K, NV3D, nz, ny, nx), np.float32)
    ens_rt = type(ens)(*(np.empty((K,) + f.shape[1:], np.float32)
                         for f in ens))
    stager = Stager(device)
    b = STREAMED_BATCH
    for i0 in range(0, K, b):
        a = state_trans(to_collocated(type(ens)(*(f[i0:i0 + b]
                                                  for f in ens))))
        stager.download(a, anal0[i0:i0 + b])
        for dst, src in zip(ens_rt, from_collocated(state_trans_inv(a))):
            stager.download(src, dst[i0:i0 + b])
        del a
    del ens
    truth = host_ensemble(nat)
    del nat
    driver = make_driver(cfg, grid, dycfg, dom, device)
    driver.bdy = base_boundary(grid, dom, device)
    rng = np.random.default_rng(SEED)
    obs = synthetic_conv_network(cfg, grid, rng)
    o = cfg.obsope
    slot_times = (np.arange(o.slot_start, o.slot_end + 1)
                  - o.slot_base) * o.slot_tinterval
    obs.dif = rng.choice(slot_times, obs.nobs)
    torch.cuda.synchronize()
    return (cfg, grid, dycfg, dom, driver, anal0, ens_rt, truth, obs, rng,
            time.perf_counter() - t0)


def phase_streamed_cycle(device):
    """configs/18km_japan.toml's 7-slot 4-D window through StreamedCycle at
    full width (480×360×36, K = 50), the physics cycle's composition, the
    slot interval cut to STREAMED_SLOT_S: the nature run's H(x) makes the
    obs (obs_from_truth, its own one-member stream), then one cycle —
    member batches of STREAMED_BATCH up, segmented forecast with each
    slot's H(x), guess down, the tiled analysis in row tiles of
    STREAMED_ROWS, the O−A monitor, the restart down. Returns the row, the
    inputs the resident phase shares, and kernel #1's operands at the tile
    shape (its first launch)."""
    from scale_letkf_torch.da.bigcycle import (
        StreamedCycle, phase_table, slot_parts)
    from scale_letkf_torch.gpu_check import var_local_groups
    from scale_letkf_torch.ops import invsqrt as invsqrt_mod
    from scale_letkf_torch.synthetic import obs_from_truth
    from scale_letkf_torch.utils import kernels

    (cfg, grid, dycfg, dom, driver, anal0, ens_rt, truth, template, rng,
     generate_s) = streamed_inputs(device)
    K = cfg.ensemble.member
    o = cfg.obsope
    spb = int(round(o.slot_tinterval / dycfg.dt))      # steps a slot
    nsteps = spb * (o.slot_base - o.slot_start)        # the analysis time
    window = spb * (o.slot_end - o.slot_start)         # the window's end
    sc = StreamedCycle(driver, member_batch=STREAMED_BATCH,
                       tile_rows=STREAMED_ROWS)
    t0 = time.perf_counter()
    obs = obs_from_truth(sc, truth, template, nsteps, rng)
    torch.cuda.synchronize()
    obs_s = time.perf_counter() - t0
    parts, _ = slot_parts(obs, cfg, dycfg.dt, nsteps)
    store: dict = {}
    record_analysis(sc, store)
    launch = invsqrt_mod.invsqrt_ns_kernel
    grams: dict = {}

    def recording(a, areg, *args):
        if not grams:
            grams["a"], grams["areg"] = a.clone(), areg.clone()
        return launch(a, areg, *args)

    invsqrt_mod.invsqrt_ns_kernel = recording
    rss0 = host_peak_gb()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    # handed over with no reference kept here, so that the cycle frees it
    # once the guess exists
    ens_rt = [ens_rt]
    try:
        out, _, rep = sc.cycle(ens_rt.pop(), obs, nsteps)
        torch.cuda.synchronize()
    finally:
        invsqrt_mod.invsqrt_ns_kernel = launch
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    batches, tiles = rep["batches"], rep["letkf_tiles"]
    fcst = 3 * window * batches
    expected = {"invsqrt_ns": grid.nz * rep["letkf_chunks"]
                * var_local_groups(cfg),
                "dyn_tendency": fcst, "adv_ud3": fcst}
    st_g, st_a = rep["stats_gues"], rep["stats_anal"]
    omb_all, oma_all = rmse_of(st_g), rmse_of(st_a)
    omb, oma = center_slot_rmse(sc, obs, cfg)
    per_member_step = rep["fcst_s"] / (K * window)
    finite = (all(bool(np.isfinite(f).all()) for f in out)
              and bool(torch.isfinite(store["anal_mean"]).all()))
    sg, sa = store["sprd_gues"], store["sprd_anal"]
    row = {"phase": "streamed_cycle", "config": CONFIG.name,
           "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
           "slots": cfg.obsope.slot_end - cfg.obsope.slot_start + 1,
           "slot_base": cfg.obsope.slot_base,
           "reduced": {"slot_tinterval_s": [3600.0, STREAMED_SLOT_S],
                       "window_steps": [SHIPPED_WINDOW_STEPS, window]},
           "changed": {"tile_rows": [CELL_ROWS, STREAMED_ROWS]},
           "analysis_step": nsteps, "window_steps": window,
           "composition": "physics suite + Davies, flat",
           "member_batch": STREAMED_BATCH, "batches": batches,
           "tile_rows": rep["letkf_tile_rows"], "tiles": tiles,
           "chunks": rep["letkf_chunks"], "generate_s": generate_s,
           "obs_from_truth_s": obs_s, "wall_s": wall,
           "phase_table": phase_table(rep).splitlines()[1:],
           "timers": {k: v for k, v in rep.items()
                      if isinstance(v, (int, float))},
           "template_obs": int(template.nobs), "nobs": int(obs.nobs),
           "obs_per_slot": {int(pt): int(n) for pt, _, _, n in parts},
           "nobs_by_element": st_g.nobs,
           "peak_mem_gb": peak, "incore_peak_gb": INCORE_PEAK_GB,
           "host_peak_rss_gb_before": rss0,
           "host_peak_rss_gb": host_peak_gb(), **transfers(rep),
           "kernel_launches": launches, "expected_launches": expected,
           "omb_rmse_all_slots": omb_all, "oma_rmse_all_slots": oma_all,
           "omb_rmse": omb, "oma_rmse": oma,
           "rmse_note": "omb_rmse / oma_rmse: the analysis-time slot's "
                        "obs; all_slots: the whole window against the "
                        "analysis-time mean (the 3-D monitor)",
           "mean_spread_gues": sg, "mean_spread_anal": sa,
           "s_per_member_step": per_member_step,
           "fcst_full_window_extrapolated_s":
               per_member_step * K * SHIPPED_WINDOW_STEPS,
           "extrapolation": "fcst_s per member-step times K times the "
                            "shipped window's 1080 steps; not measured",
           "finite": finite}
    emit(row)
    if not finite:
        raise AssertionError("the streamed cycle is not finite")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected}")
    if not all(n in omb and oma[n] < omb[n] for n in ("T", "PS")):
        raise AssertionError(f"O-A RMSE above O-B RMSE: {oma} vs {omb}")
    if not all(sa[n] < sg[n] for n in ("T", "PRES")):
        raise AssertionError("analysis spread not below guess spread")
    if not peak < INCORE_PEAK_GB:
        raise AssertionError(f"peak memory {peak:.2f} GiB")
    del out
    shared = {"cfg": cfg, "driver": driver, "anal0": anal0, "obs": obs,
              "nsteps": nsteps, "store": store, "rep": rep,
              "window": window}
    return row, shared, (grams["a"], grams["areg"])


def phase_resident_cycle(device, shared: dict):
    """Phase streamed_cycle's inputs through ResidentCycle: the same
    analysis-variable ensemble (float32 mean and bfloat16 deviations on
    the card), driver, obs and window. Held to the streamed cycle by the
    reference's yardstick (tests/test_resident.py): each member's H(x)
    within 0.2 of the ensemble spread, O−B and O−A RMSE within 10%; the
    analysis mean against the streamed one reported relative to the
    analysis spread."""
    from scale_letkf_torch.da.bigcycle import phase_table
    from scale_letkf_torch.da.resident import ResidentCycle, ResidentEnsemble
    from scale_letkf_torch.gpu_check import var_local_groups
    from scale_letkf_torch.state import V3D_ANAL_NAMES
    from scale_letkf_torch.utils import kernels
    cfg, driver, obs = shared["cfg"], shared["driver"], shared["obs"]
    nsteps, window, s_store = shared["nsteps"], shared["window"], \
        shared["store"]
    K = cfg.ensemble.member
    t0 = time.perf_counter()
    re = ResidentEnsemble.from_host_gues(shared.pop("anal0"), batch=5,
                                         device=device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    dev_gb = re.dev.numel() * re.dev.element_size() / 1e9
    rc = ResidentCycle(driver, member_batch=STREAMED_BATCH,
                       tile_rows=STREAMED_ROWS)
    store: dict = {}
    record_analysis(rc, store)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    rep = rc.cycle(re, obs, nsteps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    srep = shared["rep"]
    fcst = 3 * window * rep["batches"]
    expected = {"invsqrt_ns": driver.grid.nz * rep["letkf_chunks"]
                * var_local_groups(cfg),
                "dyn_tendency": fcst, "adv_ud3": fcst}
    good = s_store["qc"] == 0
    y_s, y_r = s_store["ensval"][:, good], store["ensval"][:, good]
    sprd = y_s.std(axis=0)
    hx_ratio = float(np.max((np.abs(y_r - y_s) - 1e-3) / np.maximum(
        sprd[None], 1e-30)))
    rmse = {}
    for key in ("stats_gues", "stats_anal"):
        rs, rr = rmse_of(srep[key]), rmse_of(rep[key])
        rmse[key] = {n: [rs[n], rr[n], abs(rr[n] - rs[n]) / rs[n]]
                     for n in rs}
    # RMS over the domain of the difference of the analysis means over the
    # RMS of the streamed analysis spread (None where the spread is zero)
    sprd_rms = s_store["anal_sprd"].to(device).pow(2).mean(
        dim=(1, 2, 3)).sqrt()
    diff_rms = (re.mean - s_store["anal_mean"].to(device)).pow(2).mean(
        dim=(1, 2, 3)).sqrt()
    mean_vs_sprd = {n: (float(diff_rms[v] / sprd_rms[v])
                        if float(sprd_rms[v]) > 0 else None)
                    for v, n in enumerate(V3D_ANAL_NAMES)}
    finite = bool(torch.isfinite(re.mean).all()) and bool(
        torch.isfinite(re.dev.float()[:, :, 0]).all())
    row = {"phase": "resident_cycle", "config": CONFIG.name,
           "grid": f"{driver.grid.nx}x{driver.grid.ny}x{driver.grid.nz}",
           "members": K, "window_steps": window, "analysis_step": nsteps,
           "max_steps_per_call": rc.max_steps_per_call,
           "changed": {"tile_rows": [CELL_ROWS, STREAMED_ROWS]},
           "bf16_deviations_gb": dev_gb, "from_host_gues_s": upload_s,
           "wall_s": wall,
           "phase_table": phase_table(rep).splitlines()[1:],
           "timers": {k: v for k, v in rep.items()
                      if isinstance(v, (int, float))},
           "cycle_h2d_bytes": rep["h2d_bytes"],
           "cycle_d2h_bytes": rep["d2h_bytes"],
           "peak_mem_gb": peak, "kernel_launches": launches,
           "expected_launches": expected,
           "hx_diff_over_spread_max": hx_ratio,
           "rmse_streamed_resident_rel": rmse,
           "anal_mean_diff_rms_over_anal_spread_rms": mean_vs_sprd,
           "finite": finite}
    emit(row)
    if not finite:
        raise AssertionError("the resident cycle is not finite")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected}")
    if not hx_ratio <= 0.2:
        raise AssertionError(f"resident H(x) off the streamed one by "
                             f"{hx_ratio} of the spread")
    if not all(v[2] < 0.1 + 1e-3 / v[0] for r in rmse.values()
               for v in r.values()):
        raise AssertionError(f"O-B / O-A RMSE off by 10% or more: {rmse}")
    del re
    return row


def phase_radar_cycle(device, keep: dict | None = None):
    """configs/bda_1km_radar.toml as shipped (192×192×48, K = 50, Kessler,
    RTPS 0.9, the 30-s window of 15 steps) through StreamedCycle, analysis
    tiles of RADAR_ROWS rows: the radar forecast's rain-blob ensemble and a
    nature member made on the card, synthetic_radar_volume at
    RADAR_OBS_TARGET (~888k REF and VR obs) with its values from the
    nature run (obs_from_truth, dBZ → linear Z, weak echoes relabelled).
    keep: a dict that receives the host ensemble and the obs, and the
    cycle's restart, inflation, report and O−A (what phase
    mesh_radar_cycle holds its grid run to)."""
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.da.bigcycle import StreamedCycle, phase_table
    from scale_letkf_torch.gpu_check import (
        RADAR_QR_BLOB, RADAR_STEPS, var_local_groups)
    from scale_letkf_torch.synthetic import (
        obs_from_truth, synthetic_ens_dycore_device, synthetic_radar_volume)
    from scale_letkf_torch.utils import kernels
    cfg, grid, dycfg, dom = load_config_and_grid(str(RADAR_CONFIG))
    K = cfg.ensemble.member
    t0 = time.perf_counter()
    ens, _, _ = synthetic_ens_dycore_device(SEED, K, grid, dom, device,
                                            u0=FCST_U0, qr_blob=RADAR_QR_BLOB)
    nat, _, _ = synthetic_ens_dycore_device(SEED + 1, 1, grid, dom, device,
                                            u0=FCST_U0, qr_blob=RADAR_QR_BLOB)
    ens_host, truth = host_ensemble(ens), host_ensemble(nat)
    del ens, nat
    generate_s = time.perf_counter() - t0
    driver = make_driver(cfg, grid, dycfg, dom, device)
    sc = StreamedCycle(driver, member_batch=RADAR_BATCH, tile_rows=RADAR_ROWS)
    rng = np.random.default_rng(SEED)
    template = synthetic_radar_volume(cfg, dom, rng, RADAR_OBS_TARGET)
    t0 = time.perf_counter()
    obs = obs_from_truth(sc, truth, template, RADAR_STEPS, rng, radar=True,
                         cfg=cfg)
    torch.cuda.synchronize()
    obs_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, infl, rep = sc.cycle(ens_host, obs, RADAR_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    batches, tiles = rep["batches"], rep["letkf_tiles"]
    fcst = 3 * RADAR_STEPS * batches
    expected = {"invsqrt_ns": grid.nz * rep["letkf_chunks"]
                * var_local_groups(cfg),
                "dyn_tendency": fcst, "adv_ud3": fcst}
    st_g, st_a = rep["stats_gues"], rep["stats_anal"]
    omb, oma = rmse_of(st_g), rmse_of(st_a)
    finite = all(bool(np.isfinite(f).all()) for f in out)
    row = {"phase": "radar_cycle", "config": RADAR_CONFIG.name,
           "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
           "steps": RADAR_STEPS, "member_batch": RADAR_BATCH,
           "batches": batches, "tile_rows": rep["letkf_tile_rows"],
           "tiles": tiles, "chunks": rep["letkf_chunks"],
           "generate_s": generate_s, "obs_from_truth_s": obs_s,
           "wall_s": wall, "template_obs": int(template.nobs),
           "nobs": int(obs.nobs),
           "nobs_good": int(sum(st_g.nobs.values())),
           "nobs_by_element": st_g.nobs,
           "phase_table": phase_table(rep).splitlines()[1:],
           "timers": {k: v for k, v in rep.items()
                      if isinstance(v, (int, float))},
           "peak_mem_gb": peak, "host_peak_rss_gb": host_peak_gb(),
           **transfers(rep), "kernel_launches": launches,
           "expected_launches": expected, "omb_rmse": omb, "oma_rmse": oma,
           "finite": finite}
    emit(row)
    if not finite:
        raise AssertionError("the radar cycle is not finite")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected}")
    if not row["nobs"] >= 800_000:
        raise AssertionError(f"{row['nobs']} radar obs, expected 800k")
    if not ("REF" in omb and oma["REF"] < omb["REF"]):
        raise AssertionError(f"O-A RMSE above O-B RMSE: {oma} vs {omb}")
    if keep is not None:
        keep.update(ens_host=ens_host, obs=obs, out=out, infl=infl, rep=rep,
                    oma=sc.last_oma, nobs_used=int(sc.last_ctx.nobs),
                    wall_s=wall, peak_mem_gb=peak,
                    phase_table=row["phase_table"])
    return row


def _tables(rep) -> list:
    """The O−B and O−A tables of a streamed report, comparable tuples."""
    return [(st.nobs, st.rmse, st.bias)
            for st in (rep["stats_gues"], rep["stats_anal"])]


def phase_mesh_radar_cycle(device, kept: dict):
    """The member-streamed radar cycle on a grid: phase radar_cycle's
    inputs (its seeded blob ensemble on the host and its ~888k-obs volume,
    kept) through StreamedCycle on CycleDriver(mesh=make_mesh(2, 2, 2)),
    configs/bda_1km_radar.toml as shipped, batches of RADAR_BATCH members
    (5 a block) and analysis tiles of RADAR_ROWS rows: each batch is
    sharded over the 8 blocks (96 × 96 columns, 104 × 104 extended) and
    forecast on the grid (halo exchanges, Kessler on every block), gathered
    at the analysis time for H(x) and the download; the tiled analysis, the
    monitor and the inverse transform run undecomposed. Held exactly to
    phase radar_cycle (kept): the restart ensemble, the inflation, the obs
    used, the O−A and the O−B / O−A tables. Its wall time and phase table
    beside phase radar_cycle's, the grid's sections, the peak, and the
    launches against expected_launches (#2, #3 on every block of every
    inner batch, no nature run; #1 as phase radar_cycle's). Returns the row
    and the operands of phase mesh_streamed_real: the first forecast's
    first extended block at the block's batch, and kernel #1's first tile
    of Grams."""
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.da.bigcycle import StreamedCycle, phase_table
    from scale_letkf_torch.gpu_check import RADAR_STEPS, expected_launches
    from scale_letkf_torch.ops import invsqrt as invsqrt_mod
    from scale_letkf_torch.parallel import halo
    from scale_letkf_torch.utils import kernels

    cfg, grid, dycfg, dom = load_config_and_grid(str(RADAR_CONFIG))
    (cfg.process.mesh_member, cfg.process.mesh_y,
     cfg.process.mesh_x) = MESH
    K = cfg.ensemble.member
    driver = make_driver(cfg, grid, dycfg, dom, device)
    mesh = driver.mesh
    sc = StreamedCycle(driver, member_batch=RADAR_BATCH, tile_rows=RADAR_ROWS)
    sample: dict = {}
    forecast_blocks = driver._forecast_blocks

    def keeping(sh, *args):
        res = forecast_blocks(sh, *args)
        if not sample:
            first = {b: type(s)(*(f[:driver.batch].clone() for f in s))
                     for b, s in res[0].blocks.items()}
            sample["s"] = halo.extend_state(
                mesh, first, halo.HALO_W, dycfg.lateral == "periodic")[0]
        return res

    driver._forecast_blocks = keeping
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
        out, infl, rep = sc.cycle(kept["ens_host"], kept["obs"], RADAR_STEPS)
        torch.cuda.synchronize()
    finally:
        invsqrt_mod.invsqrt_ns_kernel = launch
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    batches = rep["batches"]
    inner = -(-(K // batches // MESH[0]) // driver.batch)
    expected = expected_launches(
        cfg, grid, RADAR_STEPS, batches * inner, 1, blocks=mesh.n_blocks,
        shares=[(rep["letkf_chunks"], 1)], nature=0)
    want = kept["out"]
    dist = {n: float(np.abs(a - b).max())
            for n, a, b in zip(type(want)._fields, out, want)}
    infl_equal = (infl is None and kept["infl"] is None) or bool(
        np.array_equal(np.asarray(infl), np.asarray(kept["infl"])))
    oma_equal = bool(np.array_equal(sc.last_oma, kept["oma"]))
    tables_equal = _tables(rep) == _tables(kept["rep"])
    finite = all(bool(np.isfinite(f).all()) for f in out)
    omb, oma = rmse_of(rep["stats_gues"]), rmse_of(rep["stats_anal"])
    row = {"phase": "mesh_radar_cycle", "config": RADAR_CONFIG.name,
           "mesh": list(MESH), "grid": f"{grid.nx}x{grid.ny}x{grid.nz}",
           "members": K, "steps": RADAR_STEPS,
           "block": f"{grid.nx // MESH[2]}x{grid.ny // MESH[1]}",
           "extended_block": f"{grid.nx // MESH[2] + 2 * halo.HALO_W}x"
                             f"{grid.ny // MESH[1] + 2 * halo.HALO_W}",
           "member_batch": RADAR_BATCH, "batches": batches,
           "block_batch": driver.batch, "inner_batches": inner,
           "tile_rows": rep["letkf_tile_rows"], "tiles": rep["letkf_tiles"],
           "chunks": rep["letkf_chunks"], "wall_s": wall,
           "radar_cycle_wall_s": kept["wall_s"],
           "phase_table": phase_table(rep).splitlines()[1:],
           "radar_cycle_phase_table": kept["phase_table"],
           "timers": {k: v for k, v in rep.items()
                      if isinstance(v, (int, float))},
           "sections_s": dict(driver.timer.records),
           "section_counts": dict(driver.timer.counts),
           "peak_mem_gb": peak, "radar_cycle_peak_gb": kept["peak_mem_gb"],
           "host_peak_rss_gb": host_peak_gb(), **transfers(rep),
           "kernel_launches": launches, "expected_launches": expected,
           "nobs_used": int(sc.last_ctx.nobs),
           "radar_cycle_nobs_used": kept["nobs_used"],
           "distance_to_radar_cycle": dist, "infl_equal": infl_equal,
           "oma_equal": oma_equal, "tables_equal": tables_equal,
           "omb_rmse": omb, "oma_rmse": oma, "finite": finite}
    emit(row)
    if not finite:
        raise AssertionError("the streamed radar grid cycle is not finite")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected}")
    if not (all(d == 0 for d in dist.values()) and infl_equal and oma_equal
            and tables_equal and row["nobs_used"] == kept["nobs_used"]):
        raise AssertionError(f"the streamed radar grid cycle is not the "
                             f"undecomposed one: {dist}")
    if not ("forecast/halo" in row["section_counts"]
            and "forecast/physics" in row["section_counts"]):
        raise AssertionError(f"grid sections missing: "
                             f"{row['section_counts']}")
    del out
    return row, ((sample["s"], driver.rho_ref, driver.p_ref, driver.vg,
                  dycfg), (grams["a"], grams["areg"]))


def phase_mesh_streamed_real(operands) -> dict:
    """Each kernel against its plain version on phase mesh_radar_cycle's
    own operands: #2 and #3 on one extended block at the block's batch
    (5 × 48 × 104 × 104), #1 on its first tile's Grams."""
    sample, (a, areg) = operands
    rows = phase_radar_real(sample, "mesh_streamed_real")
    rows["invsqrt_ns"] = check_invsqrt(a, areg, "mesh_streamed_real")
    return rows


def phase_executors_small(device):
    """Coarsened copies of the executors and the cycle --streamed verb on
    the card against the CPU, and the streamed cycle and the verb on the
    grid against their undecomposed runs on the card
    (scale_letkf_torch/gpu_check.py)."""
    from scale_letkf_torch.gpu_check import (
        executors_check_passes, executors_vs_cpu)
    res = executors_vs_cpu(device, str(CONFIG), SEED)
    emit({"phase": "executors_small", **res})
    if not executors_check_passes(res):
        raise AssertionError(f"the executors on the GPU disagree with the "
                             f"CPU: {res}")



# --- one-way nesting and the fused radar cycle -----------------------------
# The nested cycle's child: ratio 3 (6-km cells), 240 × 240 cells from the
# parent's fractional (i0, j0) = (200, 140), on the parent's 36 stretched
# levels (so the vertical step of parent_to_child is the identity), the SI
# core with 10 acoustic substeps at dt 10 s — 18 steps span the parent's 6
# steps of 30 s — open lateral boundaries and Davies relaxation over 10
# cells at 120 s; 700 sondes (and the generator's 2,000 PS reports) on the
# child grid, valued from parent_to_child of the nature run. The window is
# 3 minutes, not the 1 minute of the `cycle` phase's 2 steps: over 1 minute
# the linear-in-time bracket misses the parent's fast adjustment of these
# synthetic states (the parent at 30 s lies as far from the bracket's
# midpoint as the whole change), and relaxing toward it pulled the ring's
# ρ and ρθ further from the parent than the unforced child (PERF.md §6,
# PR 10); by 3 minutes the open boundary's own drift outweighs that.
NEST_PARENT_STEPS = 6
NEST_I0, NEST_J0, NEST_RATIO = 200.0, 140.0, 3
NEST_NX = NEST_NY = 240
NEST_DT = 10.0
NEST_N_SMALL = 10
NEST_STEPS = 18
NEST_BDY_WIDTH = 10
NEST_BDY_TAU = 120.0
NEST_SONDES = 700
# one cycle since the OSSE phase took its time (2 before, a depth cut):
# each cycle's checks, and the grid's distances, are the same in either; the
# grid's bit-equality over a second cycle, from an analysed state, is held
# at the coarsened size (gpu_check.fused_grid_on_device, two cycles, in
# tests/test_torch_cuda.py)
FUSED_CYCLES = 1


def nest_child(cfg, grid, dycfg, dom, device, bdy_width=NEST_BDY_WIDTH):
    """The nested cycle's child driver (NEST_* above), composed directly:
    make_nested would build an explicit-core child on uniform levels."""
    import dataclasses

    from scale_letkf_torch.cli.main import make_driver
    from scale_letkf_torch.grid import Grid
    cgrid = Grid(nx=NEST_NX, ny=NEST_NY, nz=grid.nz, dx=grid.dx / NEST_RATIO,
                 dy=grid.dy / NEST_RATIO, cz=grid.cz, fz=grid.fz,
                 proj=grid.proj)
    cdycfg = dataclasses.replace(dycfg, dx=cgrid.dx, dy=cgrid.dy, dt=NEST_DT,
                                 lateral="open")
    cdom = {**dom, "core": "si", "n_small": NEST_N_SMALL,
            "bdy_width": bdy_width, "bdy_tau": NEST_BDY_TAU}
    return make_driver(cfg, cgrid, cdycfg, cdom, device)


def ring_rms(state, target, width: int) -> dict:
    """RMS of state − target over the outer `width` cells of every member
    and level: of ρ, ρu, ρv, ρθ, and of the horizontal momentum vector
    (ρu, ρv)."""
    ny, nx = state.rho.shape[-2:]
    j = torch.arange(ny, device=state.rho.device)[:, None]
    i = torch.arange(nx, device=state.rho.device)[None, :]
    ring = torch.minimum(torch.minimum(j, ny - 1 - j),
                         torch.minimum(i, nx - 1 - i)) < width
    sq = {n: ((getattr(state, n) - getattr(target, n))[..., ring] ** 2)
          for n in ("rho", "rhou", "rhov", "rhot")}
    out = {n: float(torch.sqrt(v.mean())) for n, v in sq.items()}
    out["momentum"] = float(torch.sqrt((sq["rhou"] + sq["rhov"]).mean()))
    return out


def phase_nested_cycle(device):
    """The nested cycle at full width: the 18-km configuration as phase
    `cycle` composes it (the parent) and the 240 × 240 × 36 open child
    (nest_child) through NestedCycleDriver, one cycle of NEST_PARENT_STEPS
    parent steps;
    the parent's ensemble and nature run as phase cycle's, the child's
    ensemble parent_to_child of the parent's. Then the same child forecast
    with bdy_width 0 from the same start: the forced ring's ρ, ρθ and
    horizontal momentum must each be nearer the parent's forecast
    (parent_to_child) than the unforced one's (ring_rms). Returns
    the row and the operands of one child launch of each kernel."""
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.da.obsmake import obsmake
    from scale_letkf_torch.gpu_check import fused_launches
    from scale_letkf_torch.model.dycore import to_collocated
    from scale_letkf_torch.model.nesting import NestGeometry
    from scale_letkf_torch.nested import NestedCycleDriver
    from scale_letkf_torch.ops import invsqrt as invsqrt_mod
    from scale_letkf_torch.state import state_to_history, state_trans
    from scale_letkf_torch.synthetic import (
        synthetic_conv_network, synthetic_ens_dycore_device)
    from scale_letkf_torch.utils import kernels

    cfg, grid, dycfg, dom = load_config_and_grid(str(CONFIG))
    K = cfg.ensemble.member
    t0 = time.perf_counter()
    kw = {"u0": FCST_U0, "amp_theta": CYCLE_AMP_THETA,
          "smooth_passes": CYCLE_SMOOTH_PASSES}
    p_ens, _, _ = synthetic_ens_dycore_device(SEED, K, grid, dom, device,
                                              **kw)
    nat, _, _ = synthetic_ens_dycore_device(SEED + 1, 1, grid, dom, device,
                                            **kw)
    truth = type(nat)(*(f[0] for f in nat))
    del nat
    parent = make_driver(cfg, grid, dycfg, dom, device)
    child = nest_child(cfg, grid, dycfg, dom, device)
    geom = NestGeometry(i0=NEST_I0, j0=NEST_J0, ratio=NEST_RATIO)
    nest = NestedCycleDriver(parent, child, geom)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    c_ens = nest.p2c(p_ens)
    torch.cuda.synchronize()
    init_interp_s = time.perf_counter() - t1
    c_start = type(c_ens)(*(f.cpu() for f in c_ens))  # the unforced rerun's
    generate_s = time.perf_counter() - t0

    # nature run and obs of both domains
    truth = parent.forecast_one(truth, NEST_PARENT_STEPS)
    p_tmpl = synthetic_conv_network(cfg, grid, np.random.default_rng(SEED))
    p_obs = obsmake(state_to_history(state_trans(to_collocated(truth)),
                                     parent.z_full, parent.topo),
                    p_tmpl, grid, cfg, parent.z_full,
                    np.random.default_rng(SEED))
    c_tmpl = synthetic_conv_network(cfg, child.grid,
                                    np.random.default_rng(SEED + 1),
                                    n_sonde=NEST_SONDES)
    c_obs = obsmake(state_to_history(state_trans(to_collocated(
        nest.p2c(truth))), child.z_full, child.topo), c_tmpl, child.grid,
        cfg, child.z_full, np.random.default_rng(SEED + 1))
    del truth

    # per-stage launches, the child's forced ring, and one child launch's
    # operands of each kernel (its first Grams, its first batch)
    stages, ring, operands = {}, {}, {}
    launch = invsqrt_mod.invsqrt_ns_kernel

    def recording(a, areg, *args):
        if operands.get("record") and "grams" not in operands:
            operands["grams"] = (a.clone(), areg.clone())
        return launch(a, areg, *args)

    def counted(name, fn, after=None):
        def wrapped(*args, **kw):
            before = dict(kernels.LAUNCHES)
            operands["record"] = name == "child_analysis"
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stages[name] = {k: kernels.LAUNCHES[k] - before[k]
                            for k in KERNELS}
            operands["record"] = False
            if after is not None:
                after(out)
            return out
        return wrapped

    def child_done(out):
        ring["forced"] = ring_rms(out, child.bdy.state1, NEST_BDY_WIDTH)
        ring["target"] = type(out)(*(f.cpu() for f in child.bdy.state1))
        operands["ensemble"] = type(out)(*(f[:child.batch].clone()
                                           for f in out))

    parent.forecast = counted("parent_forecast", parent.forecast)
    child.forecast = counted("child_forecast", child.forecast, child_done)
    parent.analysis = counted("parent_analysis", parent.analysis)
    child.analysis = counted("child_analysis", child.analysis)
    invsqrt_mod.invsqrt_ns_kernel = recording
    states = [p_ens, c_ens]
    del p_ens, c_ens
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        p_a, c_a, info = nest.cycle(states.pop(0), states.pop(0), p_obs,
                                    c_obs, steps_parent=NEST_PARENT_STEPS,
                                    steps_child=NEST_STEPS)
        torch.cuda.synchronize()
    finally:
        invsqrt_mod.invsqrt_ns_kernel = launch
        for d in (parent, child):
            del d.forecast, d.analysis
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
    finite = all(bool(torch.isfinite(f).all()) for f in (*p_a, *c_a))
    del p_a, c_a

    # the same child forecast unforced (bdy_width 0), from the same start
    free = nest_child(cfg, grid, dycfg, dom, device, bdy_width=0)
    out = free.forecast(type(c_start)(*(f.to(device) for f in c_start)),
                        NEST_STEPS)
    ring["unforced"] = ring_rms(out, type(out)(*(
        f.to(device) for f in ring.pop("target"))), NEST_BDY_WIDTH)
    del out, c_start

    def rmse(st):
        return {n: r for n, r in st.rmse.items() if st.nobs[n]}
    dom_rows = {}
    for name, drv in (("parent", parent), ("child", child)):
        i = info[name]
        batches = -(-K // drv.batch)
        steps = NEST_PARENT_STEPS if name == "parent" else NEST_STEPS
        exp = fused_launches(cfg, drv.grid, steps, batches,
                             i["diag"].chunk)
        dom_rows[name] = {
            "grid": f"{drv.grid.nx}x{drv.grid.ny}x{drv.grid.nz}",
            "dx_km": drv.grid.dx / 1e3, "dt": drv.dycfg.dt,
            "lateral": drv.dycfg.lateral, "core": drv.core,
            "steps": steps, "member_batch": drv.batch, "batches": batches,
            "chunk": i["diag"].chunk, "nobs": i["stats_gues"].nobs,
            "omb_rmse": rmse(i["stats_gues"]),
            "oma_rmse": rmse(i["stats_anal"]),
            "sections_s": dict(drv.timer.records),
            "launches": {"forecast": stages[f"{name}_forecast"],
                         "analysis": stages[f"{name}_analysis"]},
            "expected_launches": exp}
    row = {"phase": "nested_cycle", "config": CONFIG.name, "members": K,
           "geometry": {"i0": NEST_I0, "j0": NEST_J0, "ratio": NEST_RATIO},
           "bdy_width": NEST_BDY_WIDTH, "bdy_tau": NEST_BDY_TAU,
           "generate_s": generate_s, "init_interp_s": init_interp_s,
           "wall_s": wall, "peak_mem_gb": peak, "kernel_launches": launches,
           "finite": finite, "boundary_ring_rms": ring, **dom_rows}
    emit(row)
    if not finite:
        raise AssertionError("the nested cycle is not finite")
    for name in ("parent", "child"):
        r = dom_rows[name]
        fc, an, exp = (r["launches"]["forecast"], r["launches"]["analysis"],
                       r["expected_launches"])
        if not (fc["dyn_tendency"] == fc["adv_ud3"] == exp["dyn_tendency"]
                and an["invsqrt_ns"] == exp["invsqrt_ns"]):
            raise AssertionError(f"{name} launches {r['launches']}, "
                                 f"expected {exp}")
        if not all(n in r["omb_rmse"] and r["oma_rmse"][n] < r["omb_rmse"][n]
                   for n in ("T", "PS")):
            raise AssertionError(f"{name} O-A above O-B: {r}")
    if not peak < 80:
        raise AssertionError(f"peak memory {peak:.2f} GiB")
    # mass, heat and horizontal momentum each nearer the parent when forced
    if not all(ring["forced"][n] < ring["unforced"][n]
               for n in ("rho", "rhot", "momentum")):
        raise AssertionError(f"the forced ring is not nearer the parent: "
                             f"{ring}")
    return row, {"grams": operands["grams"],
                 "ensemble": operands["ensemble"],
                 "column": (child.rho_ref, child.p_ref, child.vg,
                            child.dycfg)}


def phase_nested_real(operands) -> dict:
    """#2 and #3 against their plain versions in the open mode on the
    operands of one child launch (its first member batch after the
    forecast), with both modes' times; #1 on the child's first Grams."""
    s = operands["ensemble"]
    rho_ref, p_ref, vg, dycfg = operands["column"]
    from scale_letkf_torch.ops.stencil import adv_flux_divergence_kernel
    from scale_letkf_torch.ops.tendency import dyn_tendencies_kernel
    dyn, adv = stencil_operands(s, rho_ref, p_ref, vg, dycfg)
    rows = {"dyn_tendency": {**check_dyn(dyn, "child batch, open"),
                             **mode_turns(dyn_tendencies_kernel, dyn)},
            "adv_ud3": {**check_adv(adv, "child batch, open"),
                        **mode_turns(adv_flux_divergence_kernel, adv)}}
    for name, row in rows.items():
        emit({"phase": "nested_real", "kernel": name, "lateral": "open",
              "batch": int(s.rho.shape[0]),
              "grid": "x".join(str(n) for n in s.rho.shape[:0:-1]), **row})
    rows["invsqrt_ns"] = check_invsqrt(*operands["grams"], "nested_real")
    return rows


def phase_nested_small(device):
    """The cycle verb with a [nest] section (tests/test_cli_nested.py's
    experiment, the child open) on the card against the CPU, and the
    coarsened fused radar cycle (scale_letkf_torch/gpu_check.py)."""
    from scale_letkf_torch.gpu_check import (
        nesting_fused_check_passes, nesting_fused_vs_cpu)
    res = nesting_fused_vs_cpu(device, str(RADAR_CONFIG), SEED)
    emit({"phase": "nested_small", **res["nested_verb"]})
    emit({"phase": "fused_small", **res["fused"]})
    if not nesting_fused_check_passes(res):
        raise AssertionError(f"the nested verb or the fused cycle on the "
                             f"GPU disagrees with the CPU: {res}")


def fused_radar_inputs(device, grid, dom, K: int):
    """The fused radar cycles' seeded inputs on the card: the blob
    ensemble and the nature member (the radar cycle's construction)."""
    from scale_letkf_torch.gpu_check import RADAR_QR_BLOB
    from scale_letkf_torch.synthetic import synthetic_ens_dycore_device
    ens, _, _ = synthetic_ens_dycore_device(SEED, K, grid, dom, device,
                                            u0=FCST_U0, qr_blob=RADAR_QR_BLOB)
    nat, _, _ = synthetic_ens_dycore_device(SEED + 1, 1, grid, dom, device,
                                            u0=FCST_U0, qr_blob=RADAR_QR_BLOB)
    return type(nat)(*(f[0] for f in nat)), ens


def fused_series(series) -> dict:
    """run_osse's per-cycle numbers as host floats: obs used, O−B and O−A
    (by monitor group too), the errors against the nature run."""
    def per_cycle(t):
        return [float(x) for x in t]
    out = {k: per_cycle(series[k]) for k in ("nobs_used", "omb", "oma",
                                             "rmse_gues", "rmse_anal")}
    out["by_group"] = {n: {"omb": per_cycle(series["omb_by_group"][n]),
                           "oma": per_cycle(series["oma_by_group"][n])}
                       for n in series["omb_by_group"]}
    return out


def sync_sites(run):
    """run() under torch.cuda.set_sync_debug_mode('warn'): its result and
    the synchronising calls it made, counted by the line that made them."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                        if "synchroniz" in str(w.message))


def phase_fused_radar_cycle(device, radar_cycle_s: float,
                            keep: dict | None = None):
    """configs/bda_1km_radar.toml as shipped through FusedCycle.run_osse,
    FUSED_CYCLES cycles of its 15-step window: the radar cycle's blob
    ensemble and nature member, the synthetic PAWR volume valued from the
    nature run at the window's end and preprocessed to dBZ with the
    ref-zero relabelling (gpu_check.dbz_template); every gate of the
    template enters the buckets. Per cycle: seconds (CUDA events), nobs_used, O−B → O−A for
    REF and VR; launches, peak memory, the analysis chunk, and the
    synchronising calls of the whole run under
    torch.cuda.set_sync_debug_mode('warn'), by the line that made them.
    keep: receives the template and the outputs (on the host) that phase
    mesh_fused_radar_cycle is held to."""
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.da.fastcycle import FusedCycle
    from scale_letkf_torch.gpu_check import (
        RADAR_STEPS, dbz_template, fused_launches)
    from scale_letkf_torch.model.dycore import to_collocated
    from scale_letkf_torch.state import state_to_history, state_trans
    from scale_letkf_torch.synthetic import synthetic_radar_volume
    from scale_letkf_torch.utils import kernels
    cfg, grid, dycfg, dom = load_config_and_grid(str(RADAR_CONFIG))
    K = cfg.ensemble.member
    t0 = time.perf_counter()
    truth0, ens = fused_radar_inputs(device, grid, dom, K)
    driver = make_driver(cfg, grid, dycfg, dom, device)
    rng = np.random.default_rng(SEED)
    volume = synthetic_radar_volume(cfg, dom, rng, RADAR_OBS_TARGET)
    truth = driver.forecast_one(truth0, RADAR_STEPS)
    tmpl = dbz_template(
        state_to_history(state_trans(to_collocated(truth)), driver.z_full,
                         driver.topo), volume, grid, cfg, driver.z_full, rng)
    del truth
    fc = FusedCycle(driver, tmpl, RADAR_STEPS)
    in_buckets = sum(len(ct.obs_idx) for ct in fc.ctx.ctypes)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    states = [truth0, ens]
    del truth0, ens
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    (truth, ens, series), syncs = sync_sites(lambda: fc.run_osse(
        states.pop(0), states.pop(0), FUSED_CYCLES, seed=SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
    batches = -(-K // driver.batch)
    expected = {k: FUSED_CYCLES * v for k, v in fused_launches(
        cfg, grid, RADAR_STEPS, batches, series["chunk"]).items()}
    # + the nature run's batch of one each cycle
    for k in ("dyn_tendency", "adv_ud3"):
        expected[k] += FUSED_CYCLES * 3 * RADAR_STEPS
    # the acoustic kernel: one launch a substep of every member batch and
    # of the nature run
    ns = driver.n_small
    acoustic = {"launches": kernels.LAUNCHES[ACOUSTIC],
                "expected": FUSED_CYCLES * RADAR_STEPS * (batches + 1)
                * (max(1, ns // 3) + max(1, ns // 2) + ns)}
    finite = all(bool(torch.isfinite(f).all()) for f in (*ens, *truth))
    numbers = fused_series(series)
    groups = numbers["by_group"]
    if keep is not None:
        keep.update(template=tmpl, numbers=numbers, wall_s=wall,
                    seconds=series["seconds"], peak_mem_gb=peak,
                    sync_sites=dict(syncs), infl=series["infl"].cpu(),
                    ens=[f.cpu() for f in ens], truth=[f.cpu() for f in truth])
    row = {"phase": "fused_radar_cycle", "config": RADAR_CONFIG.name,
           "grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
           "steps": RADAR_STEPS, "cycles": FUSED_CYCLES,
           "volume_obs": int(volume.nobs), "template_obs": int(tmpl.nobs),
           "obs_in_buckets": in_buckets, "setup_s": setup_s,
           "wall_s": wall, "seconds": series["seconds"],
           "radar_cycle_s": radar_cycle_s, **numbers,
           "member_batch": driver.batch, "chunk": series["chunk"],
           "peak_mem_gb": peak, "kernel_launches": launches,
           "expected_launches": expected, "acoustic_launches": acoustic,
           "sync_calls": sum(syncs.values()),
           "sync_calls_per_cycle": sum(syncs.values()) / FUSED_CYCLES,
           "sync_sites": dict(syncs), "finite": finite}
    emit(row)
    if not finite:
        raise AssertionError("the fused radar cycle is not finite")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected}")
    if acoustic["launches"] != acoustic["expected"]:
        raise AssertionError(f"acoustic kernel launches {acoustic}")
    if not all(n > 0 for n in row["nobs_used"]):
        raise AssertionError(f"no obs used: {row['nobs_used']}")
    if not all(a < b for a, b in zip(groups["REF"]["oma"],
                                     groups["REF"]["omb"])):
        raise AssertionError(f"O-A above O-B for REF: {groups['REF']}")
    if not in_buckets == tmpl.nobs:
        raise AssertionError(f"{in_buckets} of {tmpl.nobs} obs in the "
                             f"buckets")
    return row


# --- the multi-device layer: the cycle on a process grid -------------------
MESH = (2, 2, 2)            # (member, dy, dx) blocks, all in this process
MESH_OVERLAP_MEMBERS = 2


def rounded_state(s, seed: int):
    """s with every value perturbed by one float32 rounding (relative
    2⁻²⁴·N(0, 1)), on its device."""
    gen = torch.Generator(device=s.rho.device).manual_seed(seed)
    return type(s)(*(f * (1.0 + 2.0 ** -24 * torch.randn(
        f.shape, generator=gen, device=f.device)) for f in s))


def mesh_run(device, cfg, grid, dycfg, dom, template, kw, rounded: bool,
             capture: dict | None = None, decomposed: bool = True,
             physics: bool = False):
    """One run_osse cycle from the cycle phase's seeded inputs (perturbed
    by one rounding when `rounded`): on the grid MESH (halo 'explicit',
    every block in this process on `device`), or undecomposed when not
    `decomposed`; CYCLE_STEPS of the cycle phase's composition, or with
    `physics` PHYS_STEPS of the physics cycle's (the production physics
    suite, Davies toward the base state). Returns (row of launches, peaks,
    seconds and member batch, driver, final nature state, final ensemble —
    Sharded on the grid — and result); capture receives kernel #1's first
    operands."""
    import dataclasses

    from scale_letkf_torch.cli.main import make_driver
    from scale_letkf_torch.gpu_check import PHYS_PROD
    from scale_letkf_torch.ops import invsqrt as invsqrt_mod
    from scale_letkf_torch.synthetic import (
        base_boundary, synthetic_ens_dycore_device)
    from scale_letkf_torch.utils import kernels
    (cfg.process.mesh_member, cfg.process.mesh_y,
     cfg.process.mesh_x) = MESH if decomposed else (1, 1, 1)
    dycfg = dataclasses.replace(dycfg,
                                halo="explicit" if decomposed else "gspmd")
    if physics:
        dom = {**dom, "physics": PHYS_PROD}
    K = cfg.ensemble.member
    ens0, _, _ = synthetic_ens_dycore_device(SEED, K, grid, dom, device, **kw)
    nat, _, _ = synthetic_ens_dycore_device(SEED + 1, 1, grid, dom, device,
                                            **kw)
    nat = type(nat)(*(f[0] for f in nat))
    if rounded:
        ens0, nat = rounded_state(ens0, SEED + 7), rounded_state(nat, SEED + 8)
    states = [nat, ens0]
    del nat, ens0
    driver = make_driver(cfg, grid, dycfg, dom, device)
    if physics:
        driver.bdy = base_boundary(grid, dom, device)
    launch = invsqrt_mod.invsqrt_ns_kernel

    def recording(a, areg, *args):
        if capture is not None and not capture:
            capture["a"], capture["areg"] = a.clone(), areg.clone()
        return launch(a, areg, *args)

    invsqrt_mod.invsqrt_ns_kernel = recording
    peaks = watch_peaks(driver, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        truth, ens, res = driver.run_osse(
            states.pop(0), states.pop(0), template, n_cycles=1,
            steps_per_cycle=PHYS_STEPS if physics else CYCLE_STEPS,
            seed=SEED)
        torch.cuda.synchronize()
    finally:
        invsqrt_mod.invsqrt_ns_kernel = launch
        del driver.forecast, driver.forecast_one
    wall = time.perf_counter() - t0
    peaks["after_forecast_gb"] = (torch.cuda.max_memory_allocated(device)
                                  / 2 ** 30)
    row = {"wall_s": wall, "kernel_launches": {
        k: kernels.LAUNCHES[k] for k in KERNELS}, "peak_by_step": peaks,
        "peak_mem_gb": max(peaks[k] for k in (
            "nature_gb", "forecast_gb", "after_forecast_gb")),
        "member_batch": driver.batch}
    return row, driver, truth, ens, res


def _range(t) -> dict:
    return {"mean": float(t.double().mean()), "min": float(t.min()),
            "max": float(t.max())}


def _mesh_exact(info, res, tsfc, kept) -> dict:
    """The grid's distance to the undecomposed run's outputs (kept, on the
    host): the largest |Δ| per analysis variable of the guess and analysis
    means and spreads, and of the skin temperature; and whether each O−B /
    O−A table (obs counts, bias, RMSE per group) is the same. Every
    distance must be 0 and every table equal."""
    from scale_letkf_torch.state import V3D_ANAL_NAMES
    out = {}
    for key in ("gues_mean", "gues_sprd", "anal_mean", "anal_sprd"):
        got, want = info[key].cpu(), kept[key]
        out[key] = {name: float((got[v] - want[v]).abs().max())
                    for v, name in enumerate(V3D_ANAL_NAMES)}
    out["tsfc"] = float((tsfc.cpu() - kept["tsfc"]).abs().max())
    for tag, k in (("omb", "stats_gues"), ("oma", "stats_anal")):
        st, want = getattr(res, k)[0], kept[k]
        out[f"{tag}_equal"] = (st.nobs == want.nobs and st.rmse == want.rmse
                               and st.bias == want.bias)
        out[f"{tag}_rmse"] = {n: r for n, r in st.rmse.items()
                              if st.nobs[n]}
    return out


def phase_mesh_cycle(device, kept: dict):
    """The main path of this slice: the physics cycle phase's composition
    (the 18-km configuration at full width, its seeded ensemble and nature
    run, the 24,400-report network, the production physics suite and
    Davies relaxation toward the base state, one run_osse cycle of
    PHYS_STEPS: two physics steps) through CycleDriver(mesh=make_mesh(2, 2,
    2)) with halo 'explicit': 8 blocks of 25 members × 180 × 240 columns,
    all in this process on the card. The forecast steps the blocks' member
    batches together with halo exchanges (kernels #2 and #3 periodic on
    every extended block), runs the suite on every block (the PBL's
    one-column halo exchanged) with each block's slab skin temperature;
    the analysis gathers each member slab and its skin temperature for
    H(x) and runs the ensemble transpose. Held exactly to the physics
    cycle phase's outputs (kept on the host): the guess and analysis means
    and spreads, the O−B / O−A tables and the final skin temperature.
    Returns the row, and the operands for phase mesh_real: kernel #1's
    first Grams, one extended block at the forecast's member batch, and
    the final blocks (for phase mesh_checks)."""
    import dataclasses

    from scale_letkf_torch.cli.main import load_config_and_grid
    from scale_letkf_torch.gpu_check import PHYS_PROD, expected_launches
    from scale_letkf_torch.parallel import halo
    from scale_letkf_torch.synthetic import synthetic_conv_network

    cfg, grid, dycfg, dom = load_config_and_grid(str(CONFIG))
    kw = {"u0": FCST_U0, "amp_theta": CYCLE_AMP_THETA,
          "smooth_passes": CYCLE_SMOOTH_PASSES}
    template = synthetic_conv_network(cfg, grid, np.random.default_rng(SEED))
    grams: dict = {}
    row, driver, truth, ens, res = mesh_run(device, cfg, grid, dycfg, dom,
                                            template, kw, False, grams,
                                            physics=True)
    info = res.info
    mesh = driver.mesh
    batches = -(-(cfg.ensemble.member // MESH[0]) // driver.batch)
    expected = expected_launches(cfg, grid, PHYS_STEPS, batches,
                                 info["diag"].chunk, blocks=mesh.n_blocks,
                                 shares=info["diag"].share_chunks)
    tsfc = mesh.gather_ensemble(driver.tsfc)
    exact = _mesh_exact(info, res, tsfc, kept)
    # one extended block's operands at the forecast's batch
    first = {b: type(s)(*(f[:driver.batch].clone() for f in s))
             for b, s in ens.blocks.items()}
    ext0 = halo.extend_state(mesh, first, halo.HALO_W,
                             dycfg.lateral == "periodic")[0]
    operands = {"grams": (grams["a"], grams["areg"]),
                "ensemble": ext0, "blocks": first,
                "nature": type(truth)(*(f[None] for f in truth)),
                "column": (driver.rho_ref, driver.p_ref, driver.vg,
                           dataclasses.replace(dycfg, lateral="periodic"))}
    sections, counts = dict(driver.timer.records), dict(driver.timer.counts)
    finite = (all(bool(torch.isfinite(f).all()) for s in ens.blocks.values()
                  for f in s)
              and all(bool(torch.isfinite(info[k]).all())
                      for k in ("anal_mean", "anal_sprd"))
              and bool(torch.isfinite(tsfc).all()))
    n_phys = -(-PHYS_STEPS // driver.phys_interval)
    row.update(
        phase="mesh_cycle", config=CONFIG.name, mesh=list(MESH),
        halo="explicit", grid=f"{grid.nx}x{grid.ny}x{grid.nz}",
        members=cfg.ensemble.member, physics=PHYS_PROD,
        bdy_width=dom["bdy_width"], bdy_tau=dom["bdy_tau"],
        block=f"{grid.nx // MESH[2]}x{grid.ny // MESH[1]}",
        extended_block=f"{grid.nx // MESH[2] + 2 * halo.HALO_W}x"
                       f"{grid.ny // MESH[1] + 2 * halo.HALO_W}",
        steps_per_cycle=PHYS_STEPS, batches=batches,
        block_batches=batches * mesh.n_blocks, expected_launches=expected,
        sections_s=sections, section_counts=counts,
        share_chunks=info["diag"].share_chunks,
        physics_cycle_wall_s=kept["wall_s"],
        physics_cycle_peak_mem_gb=kept["peak_mem_gb"],
        obs_kept=res.nobs[0], tsfc_after=_range(tsfc),
        physics_cycle_tsfc_after=_range(kept["tsfc"]),
        distance_to_physics_cycle=exact, finite=finite)
    emit(row)
    del ens, driver, truth
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError("the grid's cycle is not finite")
    if row["kernel_launches"] != expected:
        raise AssertionError(f"kernel launches {row['kernel_launches']}, "
                             f"expected {expected}")
    if not (counts.get("forecast/physics") == n_phys * batches
            and counts.get("forecast/physics/halo") == 2 * n_phys * batches
            and counts.get("forecast/boundary") == PHYS_STEPS * batches):
        raise AssertionError(f"physics, its halo or boundary sections "
                             f"missing: {counts}")
    if not row["peak_mem_gb"] < 80:
        raise AssertionError(f"peak memory {row['peak_mem_gb']:.2f} GB")
    distances = [exact["tsfc"]] + [d for k in ("gues_mean", "gues_sprd",
                                               "anal_mean", "anal_sprd")
                                   for d in exact[k].values()]
    if any(d != 0 for d in distances) or not (exact["omb_equal"]
                                              and exact["oma_equal"]):
        raise AssertionError("the grid's physics cycle is not the "
                             f"undecomposed one: {exact}")
    return row, operands


def phase_mesh_radar_forecast(device, want):
    """The radar configuration's forecast on a grid: configs/
    bda_1km_radar.toml as shipped (Kessler every 5 steps on the per-level
    thickness, RADAR_STEPS steps) through CycleDriver(mesh=make_mesh(2, 2,
    2)): 8 blocks of 25 members × 96 × 96 columns (104 × 104 extended),
    from phase radar_forecast's seeded ensemble; Kessler on every block.
    Held exactly to phase radar_forecast's final ensemble (`want`, on the
    card). Sections (forecast/physics, forecast/halo), launches, Kessler
    calls and peak; returns the row and one extended block's operands at
    the member batch (kernels #2 and #3 on the radar grid's blocks)."""
    from scale_letkf_torch import cycle as cycle_mod
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.gpu_check import RADAR_QR_BLOB, RADAR_STEPS
    from scale_letkf_torch.parallel import halo
    from scale_letkf_torch.synthetic import synthetic_ens_dycore_device
    from scale_letkf_torch.utils import kernels

    cfg, grid, dycfg, dom = load_config_and_grid(str(RADAR_CONFIG))
    (cfg.process.mesh_member, cfg.process.mesh_y,
     cfg.process.mesh_x) = MESH
    K = cfg.ensemble.member
    ens, _, _ = synthetic_ens_dycore_device(SEED, K, grid, dom, device,
                                            u0=FCST_U0, qr_blob=RADAR_QR_BLOB)
    driver = make_driver(cfg, grid, dycfg, dom, device)
    mesh = driver.mesh
    kessler = cycle_mod.kessler_step
    calls = []

    def counting(s, dt, dz):
        calls.append(dt)
        return kessler(s, dt, dz)

    cycle_mod.kessler_step = counting
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        out = driver.forecast(ens, RADAR_STEPS)
        torch.cuda.synchronize()
    finally:
        cycle_mod.kessler_step = kessler
    wall = time.perf_counter() - t0
    del ens
    launches = {k: kernels.LAUNCHES[k] for k in ("dyn_tendency", "adv_ud3")}
    peak = torch.cuda.max_memory_allocated(device)
    batches = -(-(K // MESH[0]) // driver.batch)
    expected = 3 * RADAR_STEPS * batches * mesh.n_blocks
    n_phys = -(-RADAR_STEPS // driver.phys_interval)
    first = {b: type(s)(*(f[:driver.batch].clone() for f in s))
             for b, s in out.blocks.items()}
    sample = halo.extend_state(mesh, first, halo.HALO_W, True)[0]
    del first
    full = mesh.gather_ensemble(out)
    del out
    dist = {n: float((a - b).abs().max())
            for n, a, b in zip(type(full)._fields, full, want)}
    finite = all(bool(torch.isfinite(f).all()) for f in full)
    del full
    counts = dict(driver.timer.counts)
    row = {"phase": "mesh_radar_forecast", "config": RADAR_CONFIG.name,
           "mesh": list(MESH), "grid": f"{grid.nx}x{grid.ny}x{grid.nz}",
           "members": K, "block": f"{grid.nx // MESH[2]}x{grid.ny // MESH[1]}",
           "extended_block": f"{grid.nx // MESH[2] + 2 * halo.HALO_W}x"
                             f"{grid.ny // MESH[1] + 2 * halo.HALO_W}",
           "steps": RADAR_STEPS, "wall_s": wall,
           "sections_s": dict(driver.timer.records), "section_counts": counts,
           "member_batch": driver.batch, "batches": batches,
           "block_batches": batches * mesh.n_blocks,
           "peak_mem_gb": peak / 2 ** 30, "kernel_launches": launches,
           "expected_launches": expected, "kessler_calls": len(calls),
           "distance_to_radar_forecast": dist, "finite": finite}
    emit(row)
    if not finite:
        raise AssertionError("the radar grid forecast is not finite")
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected} each")
    if not (len(calls) == n_phys * batches * mesh.n_blocks
            and counts.get("forecast/physics") == n_phys * batches):
        raise AssertionError(f"{len(calls)} Kessler calls, sections "
                             f"{counts}")
    if any(d != 0 for d in dist.values()):
        raise AssertionError(f"the radar grid forecast is not the "
                             f"undecomposed one: {dist}")
    return row, (sample, driver.rho_ref, driver.p_ref, driver.vg, dycfg)


def phase_mesh_checks(device, operands) -> dict:
    """Three checks. On the final blocks of phase mesh_cycle (members
    :MESH_OVERLAP_MEMBERS of each): one explicit-core step (dt 1 s, the
    core's own regime) with halo 'explicit_overlap' against 'explicit' on
    the (1, 2, 2) blocks of member slab 0, to gpu_check.TOL_TENDENCY of
    each field's largest increment; and init_distributed in a world of one
    (NCCL) with local_device_count 4, whose global_device_mesh(1, 2, 2)
    must give one SI step bit-equal to make_mesh(1, 2, 2)'s. And the flat
    cycle (the cycle phase's composition, no physics) coarsened
    (gpu_check.grid_cycle_on_device: 32×24×12, K = 20) on make_mesh(2, 2,
    2), bit-equal to the undecomposed run on the card, with its launches;
    with gpu_check.batch_invariance, the LETKF core's products over the
    obs giving each matrix the same bits in any batch of 7 or more. And
    two coarse grid executors: the nested grid cycle (gpu_check.
    nested_grid_cycle_on_device: that cycle's parent and a 24 × 24 open
    child at ratio 3, 2 parent and 6 child steps, on make_mesh(2, 2, 2))
    bit-equal to its open-mode composition, and one explicit-core step
    (dt 1 s) over gpu_check.terrain_state's hills on make_mesh(1, 2, 2)
    bit-equal to the undecomposed explicit terrain step (its overlap
    variant within TOL_TENDENCY)."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from scale_letkf_torch.gpu_check import (
        TOL_TENDENCY, batch_invariance, batch_invariance_passes,
        grid_cycle_on_device, nested_grid_cycle_on_device,
        terrain_grid_step_on_device)
    from scale_letkf_torch.model.dycore_si import SplitConfig
    from scale_letkf_torch.parallel import halo
    from scale_letkf_torch.parallel.distributed import (
        global_device_mesh, init_distributed)
    from scale_letkf_torch.parallel.mesh import make_mesh
    from scale_letkf_torch.cli.main import load_config_and_grid
    rho_ref, p_ref, vg, dycfg = operands["column"]
    grid = load_config_and_grid(str(CONFIG))[1]
    zc = torch.as_tensor(np.asarray(grid.cz), dtype=torch.float32,
                         device=device)
    sub = {b: type(s)(*(f[:MESH_OVERLAP_MEMBERS].contiguous() for f in s))
           for b, s in operands["blocks"].items() if b < 4}
    m122 = make_mesh(1, 2, 2)
    cfg1 = dataclasses.replace(dycfg, dt=1.0)
    outs = {}
    for h in ("explicit", "explicit_overlap"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[h] = halo.rk3_step_blocks(m122, sub, cfg1, rho_ref, p_ref, zc,
                                       vg, overlap=h == "explicit_overlap")
        torch.cuda.synchronize()
        outs[h + "_s"] = time.perf_counter() - t0
    overlap = {}
    for name, k in zip(type(sub[0])._fields, range(6)):
        incr = max(float((outs["explicit"][b][k] - sub[b][k]).abs().max())
                   for b in sub)
        err = max(float((outs["explicit_overlap"][b][k]
                         - outs["explicit"][b][k]).abs().max()) for b in sub)
        overlap[name] = err / max(TOL_TENDENCY * incr, 1e-30)
    del outs["explicit_overlap"]
    s_ = socket.socket()
    s_.bind(("127.0.0.1", 0))
    port = s_.getsockname()[1]
    s_.close()
    split = SplitConfig(dtau=dycfg.dt / 10)
    init_distributed(f"127.0.0.1:{port}", 1, 0, local_device_count=4)
    try:
        backend = dist.get_backend()
        gm = global_device_mesh(1, 2, 2)
        a = halo.rk3_step_si_blocks(gm, sub, dycfg, split, rho_ref, p_ref,
                                    zc, 10, vg)
    finally:
        dist.destroy_process_group()
    b_ = halo.rk3_step_si_blocks(m122, sub, dycfg, split, rho_ref, p_ref,
                                 zc, 10, vg)
    equal = all(torch.equal(x, y) for blk in a for x, y in zip(a[blk],
                                                                  b_[blk]))
    del a, b_, sub
    t0 = time.perf_counter()
    flat = grid_cycle_on_device(device, str(CONFIG), SEED)
    flat["seconds"] = time.perf_counter() - t0
    batch = batch_invariance(device, SEED)
    t0 = time.perf_counter()
    nested = nested_grid_cycle_on_device(device, str(CONFIG), SEED)
    nested["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    terrain = terrain_grid_step_on_device(device, str(CONFIG), SEED)
    terrain["seconds"] = time.perf_counter() - t0
    row = {"phase": "mesh_checks", "members": MESH_OVERLAP_MEMBERS,
           "flat_grid_cycle": flat, "batch_invariance": batch,
           "nested_grid_cycle": nested, "explicit_terrain_step": terrain,
           "overlap_over_tol": overlap,
           "explicit_s": outs["explicit_s"],
           "explicit_overlap_s": outs["explicit_overlap_s"],
           "backend": backend, "world": 1, "local_device_count": 4,
           "global_mesh_bit_equal": equal}
    emit(row)
    if not (all(v <= 1 for v in overlap.values()) and equal
            and backend == "nccl" and flat["bit_equal"]
            and batch_invariance_passes(batch)
            and flat["stats_equal"]
            and flat["kernel_launches"] == flat["expected_launches"]
            and nested["bit_equal"] and nested["stats_equal"]
            and terrain["bit_equal"] and terrain["rhow_moved"] > 0
            and all(v <= 1 for v in terrain["overlap_over_tol"].values())):
        raise AssertionError(f"grid checks failed: {row}")
    return row


def phase_mesh_fused_radar_cycle(device, kept: dict):
    """The fused cycle on the grid: phase fused_radar_cycle's inputs (its
    seeded blob ensemble and nature member, its dBZ template — kept — and
    its noise seed) through FusedCycle on CycleDriver(mesh=make_mesh(2, 2,
    2)), FUSED_CYCLES cycles of configs/bda_1km_radar.toml as shipped: 8
    blocks of 25 members × 96 × 96 columns on the card. The forecast steps
    the blocks with halo exchanges (#2, #3 periodic on 104 × 104 extended
    blocks), H(x) gathers each member slab, the worst QC, the mean of H(x)
    and the min-member count run over all 50 members in member order, and
    the analysis runs on the 8 shares of the ensemble transpose (#1). Held
    exactly to phase fused_radar_cycle's outputs (kept): the final
    ensemble, nature run and inflation; per cycle obs used, O−B and O−A
    (by group) and the errors against the truth. Per cycle seconds (CUDA
    events), the wall time, sections on the device's clock (no waits:
    forecast/halo, obsope/gather, das_letkf/transpose), the synchronising
    calls by site, the peak and the launches against expected_launches
    for the blocks and shares (the nature run's batch of one included).
    Returns the row and the path's own operands for phase mesh_fused_real:
    kernel #1's first Grams (the first share's first level chunk) and the
    final nature state as a batch of one (#2 and #3 at 192 × 192), with
    the driver's reference column and metric."""
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.da.fastcycle import FusedCycle
    from scale_letkf_torch.gpu_check import RADAR_STEPS, expected_launches
    from scale_letkf_torch.ops import invsqrt as invsqrt_mod
    from scale_letkf_torch.parallel import halo
    from scale_letkf_torch.utils import kernels
    cfg, grid, dycfg, dom = load_config_and_grid(str(RADAR_CONFIG))
    (cfg.process.mesh_member, cfg.process.mesh_y,
     cfg.process.mesh_x) = MESH
    K = cfg.ensemble.member
    t0 = time.perf_counter()
    states = list(fused_radar_inputs(device, grid, dom, K))
    driver = make_driver(cfg, grid, dycfg, dom, device)
    mesh = driver.mesh
    fc = FusedCycle(driver, kept["template"], RADAR_STEPS, timed=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launch, grams = invsqrt_mod.invsqrt_ns_kernel, {}

    def recording(a, areg, *args):
        if not grams:
            grams["a"], grams["areg"] = a.clone(), areg.clone()
        return launch(a, areg, *args)

    invsqrt_mod.invsqrt_ns_kernel = recording
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        (truth, ens, series), syncs = sync_sites(lambda: fc.run_osse(
            states.pop(0), states.pop(0), FUSED_CYCLES, seed=SEED))
        torch.cuda.synchronize()
    finally:
        invsqrt_mod.invsqrt_ns_kernel = launch
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    fc.timer.settle()
    launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
    batches = -(-(K // MESH[0]) // driver.batch)
    expected = {k: FUSED_CYCLES * v for k, v in expected_launches(
        cfg, grid, RADAR_STEPS, batches, 0, blocks=mesh.n_blocks,
        shares=series["chunk"]).items()}
    numbers = fused_series(series)
    full = mesh.gather_ensemble(ens)
    del ens
    names = type(full)._fields
    distance = {f"ens.{n}": float((a.cpu() - b).abs().max())
                for n, a, b in zip(names, full, kept["ens"])}
    distance.update({f"nature.{n}": float((a.cpu() - b).abs().max())
                     for n, a, b in zip(names, truth, kept["truth"])})
    distance["infl"] = float((series["infl"].cpu() - kept["infl"]).abs().max())
    finite = all(bool(torch.isfinite(f).all()) for f in (*full, *truth))
    nature = type(truth)(*(f[None].clone() for f in truth))
    del full, truth
    want = kept["numbers"]
    row = {"phase": "mesh_fused_radar_cycle", "config": RADAR_CONFIG.name,
           "mesh": list(MESH), "grid": f"{grid.nx}x{grid.ny}x{grid.nz}",
           "members": K, "block": f"{grid.nx // MESH[2]}x{grid.ny // MESH[1]}",
           "extended_block": f"{grid.nx // MESH[2] + 2 * halo.HALO_W}x"
                             f"{grid.ny // MESH[1] + 2 * halo.HALO_W}",
           "steps": RADAR_STEPS, "cycles": FUSED_CYCLES,
           "template_obs": int(kept["template"].nobs), "setup_s": setup_s,
           "wall_s": wall, "seconds": series["seconds"],
           "fused_radar_cycle_wall_s": kept["wall_s"],
           "fused_radar_cycle_seconds": kept["seconds"], **numbers,
           "sections_s": dict(fc.timer.records),
           "section_counts": dict(fc.timer.counts),
           "member_batch": driver.batch, "batches": batches,
           "block_batches": batches * mesh.n_blocks,
           "share_chunks": series["chunk"], "peak_mem_gb": peak,
           "fused_radar_cycle_peak_mem_gb": kept["peak_mem_gb"],
           "kernel_launches": launches, "expected_launches": expected,
           "sync_calls": sum(syncs.values()), "sync_sites": dict(syncs),
           "fused_radar_cycle_sync_sites": kept["sync_sites"],
           "distance_to_fused_radar_cycle": distance,
           "numbers_equal": numbers == want, "finite": finite}
    emit(row)
    if not finite:
        raise AssertionError("the grid's fused radar cycle is not finite")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected}")
    if any(d != 0 for d in distance.values()) or numbers != want:
        raise AssertionError("the grid's fused radar cycle is not the "
                             f"undecomposed one: {distance}, {numbers}, "
                             f"{want}")
    counts = row["section_counts"]
    if not (counts.get("forecast/halo") and counts.get("obsope/gather")
            and counts.get("das_letkf/transpose")):
        raise AssertionError(f"grid sections missing: {counts}")
    return row, {"grams": (grams["a"], grams["areg"]),
                 "nature": (nature, driver.rho_ref, driver.p_ref, driver.vg,
                            dycfg)}


def phase_mesh_fused_real(operands) -> dict:
    """Every kernel of the fused grid cycle against its plain version on
    that run's own operands (phase mesh_fused_radar_cycle): #1 on the
    first share's first level chunk of Grams, #2 and #3 on the nature
    run's batch of one at 192 × 192 (the blocks' extended 104 × 104 batch
    is phase mesh_radar_real's)."""
    rows = {"invsqrt_ns": check_invsqrt(*operands["grams"],
                                        "mesh_fused_real")}
    rows.update(phase_radar_real(operands["nature"], "mesh_fused_real"))
    return rows


# --- the OSSE impact experiment (scale_letkf_torch/bench_fullsize.py) -------
# bench_osse_impact at its own width (240×180×36, K = 50, the production
# composition, 400 sondes + 800 PS), its depth cut from 60 spin-up steps and
# 4 cycles of 60 steps to OSSE_SPINUP and OSSE_CYCLES of OSSE_STEPS; member
# batches of OSSE_BATCH (the bench's 2: launch-bound) and analysis tiles of
# OSSE_ROWS rows (its 12: 15 launch-bound tiles a level). Two cycles, so
# that the second cycle's guess, forecast from the first analysis, is held
# below the no-DA control's. Without a spin-up the first analysis is above
# its guess (0.5883 against 0.5879 K on an NVIDIA H100 80GB HBM3; the JAX
# package's too, at 48×36×36 on the CPU): the ensemble's first steps are
# its adjustment
OSSE_SPINUP = 2
OSSE_CYCLES = 2
OSSE_STEPS = 2
OSSE_BATCH = 50
OSSE_ROWS = 90
OSSE_SHIPPED = {"spinup_steps": 60, "n_cycles": 4, "steps_per_cycle": 60,
                "member_batch": 2, "tile_rows": 12}


def phase_osse_impact(device):
    """bench_fullsize.bench_osse_impact on the card, shallow (OSSE_*): the
    ensemble, the no-DA control and the truth under its stronger sun, each
    on ResidentCycle in the production composition (terrain: #2 and #3
    idle). Per cycle the T RMSE of the guess, analysis and control means
    against the truth below 11 km, and the guess spread; launches, peak
    memory. Checks: every curve value finite, the analysis below the guess
    every cycle, the guess below the control in every cycle after the first
    (the first cycle's guess is the control's), #1 launched levels × chunks
    × var-local groups in every analysis (#2, #3 not at all), peak below 80
    GB. Returns the row and the first Grams of #1 (phase osse_real)."""
    from scale_letkf_torch.bench_fullsize import bench_osse_impact
    from scale_letkf_torch.da import resident as resident_mod
    from scale_letkf_torch.gpu_check import var_local_groups
    from scale_letkf_torch.ops import invsqrt as invsqrt_mod
    from scale_letkf_torch.utils import kernels
    analyses, grams = [], {}
    analyze, launch = resident_mod.analyze_resident, invsqrt_mod.invsqrt_ns_kernel

    def counted(ens, ctx, cfg, grid, *args, **kw):
        stats = analyze(ens, ctx, cfg, grid, *args, **kw)
        analyses.append({"tiles": stats["tiles"], "chunks": stats["chunks"],
                         "levels": grid.nz, "groups": var_local_groups(cfg),
                         "nobs": int(ctx.nobs)})
        return stats

    def recording(a, areg, *args):
        if not grams:
            grams["a"], grams["areg"] = a.clone(), areg.clone()
        return launch(a, areg, *args)

    resident_mod.analyze_resident = counted
    invsqrt_mod.invsqrt_ns_kernel = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        res = bench_osse_impact(
            config=str(CONFIG), n_cycles=OSSE_CYCLES,
            steps_per_cycle=OSSE_STEPS, spinup_steps=OSSE_SPINUP,
            member_batch=OSSE_BATCH, tile_rows=OSSE_ROWS, device=device)
        torch.cuda.synchronize()
    finally:
        resident_mod.analyze_resident = analyze
        invsqrt_mod.invsqrt_ns_kernel = launch
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    launches = {k: kernels.LAUNCHES[k] for k in KERNELS}
    expected = {"invsqrt_ns": sum(a["levels"] * a["chunks"] * a["groups"]
                                  for a in analyses),
                "dyn_tendency": 0, "adv_ud3": 0}
    curves = ("rmse_gues", "rmse_anal", "rmse_ctrl", "spread_gues")
    finite = all(np.isfinite(res[k]).all() and len(res[k]) == OSSE_CYCLES
                 for k in curves)
    row = {"phase": "osse_impact", **res, "wall_s": wall,
           "reduced": {k: [v, {"spinup_steps": OSSE_SPINUP,
                               "n_cycles": OSSE_CYCLES,
                               "steps_per_cycle": OSSE_STEPS,
                               "member_batch": OSSE_BATCH,
                               "tile_rows": OSSE_ROWS}[k]]
                       for k, v in OSSE_SHIPPED.items()},
           "analyses": analyses, "peak_mem_gb": peak,
           "kernel_launches": launches, "expected_launches": expected,
           "anal_below_gues": [a < g for a, g in zip(res["rmse_anal"],
                                                     res["rmse_gues"])],
           "gues_below_ctrl": [g < c for g, c in zip(res["rmse_gues"],
                                                     res["rmse_ctrl"])],
           "finite": finite}
    emit(row)
    if not finite:
        raise AssertionError(f"the OSSE curves are not finite: {res}")
    if not all(row["anal_below_gues"]):
        raise AssertionError(f"an analysis above its guess: {res}")
    if not all(row["gues_below_ctrl"][1:]):
        raise AssertionError(f"a cycled guess not below the control: {res}")
    if launches != expected or not analyses:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected}")
    if not peak < 80:
        raise AssertionError(f"peak memory {peak:.2f} GiB")
    return row, (grams["a"], grams["areg"])


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
    T_START.append(t_start)
    phase_device()
    phase_build()
    phase_random(device)
    s, rho_ref, p_ref = phase_tendency(device)
    phase_stencil(device, s, rho_ref, p_ref)
    del s
    torch.cuda.empty_cache()
    acoustic_rows = phase_acoustic(device)
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
    del cy_rows
    torch.cuda.empty_cache()
    kept: dict = {}
    pc, operands = phase_cycle(device, "physics_cycle", PHYS_STEPS,
                               physics=True, keep=kept)
    pc_rows = phase_cycle_real(pc, operands, "physics_real")
    del operands
    torch.cuda.empty_cache()
    mc, operands = phase_mesh_cycle(device, kept)
    del kept
    mesh_rows = phase_cycle_real(
        {"kernel_launches": mc["kernel_launches"],
         "steps_per_cycle": PHYS_STEPS, "batches": mc["block_batches"]},
        operands, "mesh_real")
    phase_mesh_checks(device, operands)
    del operands
    torch.cuda.empty_cache()
    rf, sample, want = phase_radar_forecast(device)
    radar_rows = phase_radar_real(sample)
    del sample
    mr, sample = phase_mesh_radar_forecast(device, want)
    del want
    radar_block = phase_radar_real(sample, "mesh_radar_real")
    del sample
    torch.cuda.empty_cache()
    phase_physics_small(device)
    torch.cuda.empty_cache()
    pr, operands = phase_cycle(device, "production_cycle", PROD_STEPS,
                               production=True)
    prod_real = check_invsqrt(*operands["grams"], "production_real")
    phase_terrain_tendency(operands)
    del operands
    torch.cuda.empty_cache()
    phase_terrain_small(device)
    torch.cuda.empty_cache()
    dc, st, operands = phase_det_cycle(device, cy["peak_mem_gb"])
    dc_rows = phase_cycle_real(dc, operands, "det_real", singles=2)
    del operands
    phase_efso(device, st)
    del st
    torch.cuda.empty_cache()
    phase_det_small(device)
    phase_jacobi(device)
    phase_h08_calibrate(device)
    torch.cuda.empty_cache()
    sc, shared, tile_grams = phase_streamed_cycle(device)
    streamed_tile = check_invsqrt(*tile_grams, "streamed_real")
    del tile_grams
    torch.cuda.empty_cache()
    rs = phase_resident_cycle(device, shared)
    del shared
    torch.cuda.empty_cache()
    kept = {}
    rd = phase_radar_cycle(device, keep=kept)
    torch.cuda.empty_cache()
    ms, operands = phase_mesh_radar_cycle(device, kept)
    del kept
    streamed_rows = phase_mesh_streamed_real(operands)
    del operands
    torch.cuda.empty_cache()
    phase_executors_small(device)
    torch.cuda.empty_cache()
    nc, operands = phase_nested_cycle(device)
    nested_rows = phase_nested_real(operands)
    del operands
    torch.cuda.empty_cache()
    kept = {}
    fr = phase_fused_radar_cycle(device, rd["wall_s"], keep=kept)
    torch.cuda.empty_cache()
    mf, operands = phase_mesh_fused_radar_cycle(device, kept)
    del kept
    fused_rows = phase_mesh_fused_real(operands)
    del operands
    torch.cuda.empty_cache()
    phase_nested_small(device)
    torch.cuda.empty_cache()
    osse_row, osse_grams = phase_osse_impact(device)
    osse_real = check_invsqrt(*osse_grams, "osse_real")
    del osse_grams
    # the kernels line: launches of the grid's cycle (mesh_cycle), this
    # slice's main path, which runs all three, and the times on its own
    # operands (phase mesh_real: #1 on a share's Grams, #2 and #3 on an
    # extended block and on the nature run's batch of one); det_cycle: the
    # times on the deterministic cycle's operands (phase det_real), the
    # kernels line's until this slice; launches_by_path: each path's own
    # run, counts reset before it; physics_cycle: the times on the physics
    # cycle's operands (phase physics_real); production_grams: kernel #1 on
    # the production cycle's Grams (phase production_real); radar_grid: the
    # stencil kernels on the radar forecast's operands (phase radar_real);
    # child_grid: each kernel on one launch's operands of the nested
    # cycle's child — #2 and #3 in the open mode (phase nested_real);
    # fused_grid: each kernel on the fused grid cycle's own operands — #1
    # on a share's Grams, #2 and #3 on its nature run (phase
    # mesh_fused_real); osse_grams: kernel #1 on the OSSE's first Grams
    # (phase osse_real)
    timing = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "bound_share")
    for name in KERNELS:
        mesh_rows[name]["launches"] = mc["kernel_launches"][name]
        mesh_rows[name]["det_cycle"] = {k: dc_rows[name][k] for k in timing}
        mesh_rows[name]["launches_by_path"] = {
            "forecast": fc["kernel_launches"].get(name, 0),
            "analysis": sl["kernel_launches"] if name == "invsqrt_ns" else 0,
            "cycle": cy["kernel_launches"][name],
            "physics_cycle": pc["kernel_launches"][name],
            "radar_forecast": rf["kernel_launches"].get(name, 0),
            "production_cycle": pr["kernel_launches"][name],
            "det_cycle": dc["kernel_launches"][name],
            "streamed_cycle": sc["kernel_launches"][name],
            "resident_cycle": rs["kernel_launches"][name],
            "radar_cycle": rd["kernel_launches"][name],
            "nested_cycle": nc["kernel_launches"][name],
            "fused_radar_cycle": fr["kernel_launches"][name],
            "mesh_fused_radar_cycle": mf["kernel_launches"][name],
            "mesh_cycle": mc["kernel_launches"][name],
            "mesh_radar_forecast": mr["kernel_launches"].get(name, 0),
            "mesh_radar_cycle": ms["kernel_launches"][name],
            "osse_impact": osse_row["kernel_launches"][name]}
        dc_rows[name] = mesh_rows[name]
        dc_rows[name]["child_grid"] = {
            k: nested_rows[name][k] for k in timing + (
                ("open_ms", "periodic_ms") if name != "invsqrt_ns" else ())}
        dc_rows[name]["physics_cycle"] = {k: pc_rows[name][k]
                                          for k in timing}
        dc_rows[name]["streamed_grid"] = {
            **({"B": streamed_rows[name]["B"]} if name == "invsqrt_ns" else
               {"batch": ms["block_batch"],
                "extended_block": ms["extended_block"]}),
            "launches": ms["kernel_launches"][name],
            **{k: streamed_rows[name][k] for k in timing}}
        dc_rows[name]["fused_grid"] = {
            **({"B": fused_rows[name]["B"]} if name == "invsqrt_ns" else
               {"batch": 1, "grid": mf["grid"]}),
            **{k: fused_rows[name][k] for k in timing}}
        dc_rows[name]["radar_grid"] = (
            {k: radar_rows[name][k] for k in timing}
            if name in radar_rows else None)
        dc_rows[name]["radar_block"] = (
            {"batch": mr["member_batch"], "extended_block":
             mr["extended_block"], **{k: radar_block[name][k]
                                      for k in timing}}
            if name in radar_block else None)
        dc_rows[name]["production_grams"] = (
            {"B": prod_real["B"], **{k: prod_real[k] for k in timing}}
            if name == "invsqrt_ns" else None)
        dc_rows[name]["osse_grams"] = (
            {"B": osse_real["B"], **{k: osse_real[k] for k in timing}}
            if name == "invsqrt_ns" else None)
        dc_rows[name]["streamed_tile"] = (
            {"B": streamed_tile["B"], **{k: streamed_tile[k]
                                         for k in timing}}
            if name == "invsqrt_ns" else None)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    # no single PyTorch call computes any of the three functions (no matrix
    # inverse square root, no such stencil), so library_ms is null
    keys = ("launches", "launches_by_path", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_fp32_ms", "bound_by", "bound_share",
            "gb_per_s", "tflops", "shapes", "det_cycle", "physics_cycle",
            "radar_grid", "radar_block", "production_grams", "streamed_tile",
            "child_grid", "fused_grid", "streamed_grid", "osse_grams")
    # the acoustic kernel's row: its launches in the fused radar cycle
    # (phase 38) and phase acoustic's numbers at the radar cell's shape,
    # with both shapes'
    acoustic = {"name": ACOUSTIC, "route": "cuda",
                "source": f"scale_letkf_torch/csrc/{ACOUSTIC}.cu",
                "replaces": None,
                "launches": fr["acoustic_launches"]["launches"],
                **{k: acoustic_rows["radar_cell"][k]
                   for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "bound_share", "gb_per_s")},
                "shapes": acoustic_rows, "library_ms": None}
    emit({"kernels": [{"name": name, "route": "cuda",
                       "source": f"scale_letkf_torch/csrc/{name}.cu",
                       "replaces": REPLACES[name],
                       **{k: dc_rows[name][k] for k in keys},
                       "library_ms": None}
                      for name in KERNELS] + [acoustic]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
