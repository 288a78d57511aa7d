"""Full-size flagship-configuration benchmarks and the OSSE impact experiment.

Port of scale_letkf_tpu/bench_fullsize.py: each function keeps the
reference's name, parameters, defaults and result keys, and takes the device
last (`device`, CUDA by default; "cuda" without a card raises, there is no
fallback). Random numbers come from a torch.Generator seeded as the
reference seeds jax.random (other numbers), and from the same numpy
generator where the reference uses numpy (the same numbers). Peak device
memory (peak_hbm_gb) is torch.cuda.max_memory_allocated since the function
began; section times are synchronised wall times, kernel-sized work is timed
by CUDA events.

- bench_radar_analysis, bench_18km_analysis: the analysis at the shipped
  sizes (configs/bda_1km_radar.toml 192×192×48 with a ~1e6-gate phased-array
  volume; configs/18km_japan.toml 480×360×36 with a PREPBUFR-density
  network), K = 50, host ensembles through the host-streamed tiled executor
  (da/letkf_tiled.py);
- their _resident forms: the ensemble and its synthetic H(x) made on the
  card, the tiled analysis in place on the resident buffers
  (da/resident.py);
- bench_18km_cycle, bench_radar_cycle: one complete DA cycle at full size
  through the member-streamed executor (da/bigcycle.py) in the reference's
  production composition (SI core, terrain, the physics suite, Davies
  relaxation), obs drawn from an independent nature member;
- bench_18km_cycle_resident: the 18-km cycle over the full 6-h window and
  its 4-D slots on the resident executor, with a coarse SI-step roofline at
  the card's memory rate;
- bench_tendency_fused: the dynamics tendency and one SI step through the
  hand-written kernels #2 and #3 against the plain PyTorch path, on the
  same card tensors;
- bench_osse_impact: a multi-cycle OSSE against a no-DA control (the
  assimilation-impact curve).

The synthetic states measure the engine at full scale, not forecast skill.
Run from the repository root (the config paths are relative to it):

    python -m scale_letkf_torch.bench_fullsize <name> [--device cuda]

prints one JSON line; <name> is one of BENCHES' keys.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from scale_letkf_torch.synthetic import (
    base_columns as _host_profiles,
    obs_from_truth as _obs_from_truth,
    reference_pressure,
    synthetic_conv_network as _synthetic_conv_network,
    synthetic_ens_dycore as _synthetic_ens_dycore,
    synthetic_gues as _synthetic_gues,
    synthetic_radar_volume as _synthetic_radar_volume,
    synthetic_resident_gues as _synthetic_resident_gues,
    synthetic_topo as _synthetic_topo,
)

# HBM rate of one NVIDIA H100 SXM (NVIDIA's data sheet; chip_smoke.py's
# roofline uses the same number)
HBM_BYTES_PER_S = 3.35e12
# the composition of _make_fullsize_driver(production=True)
PRODUCTION = "si+stretch+terrain+physics_suite+davies_bdy"


def _device(device) -> torch.device:
    """The device of a bench: "cuda" (or a CUDA device) needs a card."""
    from scale_letkf_torch.utils.device import require_cuda
    device = torch.device(device)
    if device.type == "cuda":
        return require_cuda(device.index or 0)
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _device_mem_gb(device: torch.device):
    """Peak device memory (GiB) since the last _reset_peak; None on the CPU."""
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2 ** 30, 2)


def _load_cfg(path, overrides=None):
    from scale_letkf_torch.cli.main import load_config_and_grid
    return load_config_and_grid(path, domain_overrides=overrides)


def _z_flat(grid, device) -> torch.Tensor:
    return grid.calc_z(torch.zeros((grid.ny, grid.nx), dtype=torch.float32,
                                   device=device))


def _make_fullsize_driver(cfg, grid, dycfg, dom, rho_ref, p_ref,
                          production=True, seed=7, *, device):
    """CycleDriver of the reference's columns rho_ref, p_ref (nz, 1, 1),
    without make_driver's balanced state.

    production=True composes the reference's flagship configuration
    (common_mpi_scale.f90:833; config/example/config.main.hakushu:72-78):
    the [domain] core and substeps over synthetic_topo's hills (from
    default_rng(seed)), the physics suite ([physics] keys over nsw6,
    radiation every 10 physics steps, slab capacity 2e5; Kessler's scheme
    when use_physics) in place of use_physics, and Davies relaxation
    (bdy_width 8, bdy_tau 600 s unless [domain] sets them) toward the
    balanced base state, its qv profile uncapped (the scale_init parent-file
    stand-in)."""
    from scale_letkf_torch.cycle import CycleDriver
    from scale_letkf_torch.model.physics_suite import PhysicsConfig
    from scale_letkf_torch.synthetic import base_boundary

    topo = phys_cfg = bdy = None
    bdy_width = 0
    if production:
        rng = np.random.default_rng(seed)
        topo = _synthetic_topo(rng, grid.ny, grid.nx,
                               amp=dom.get("topo_amp", 400.0))
        phys = dict(dom.get("physics", {}))
        phys.setdefault("mp_scheme",
                        "kessler" if dom.get("use_physics") else "nsw6")
        phys.setdefault("rad_interval", 10)
        phys.setdefault("slab_capacity", 2.0e5)
        phys_cfg = PhysicsConfig(**phys)
        bdy = base_boundary(grid, dom, device)
        bdy_width = dom.get("bdy_width", 8)
    return CycleDriver(grid, cfg, dycfg,
                       torch.as_tensor(rho_ref, device=device),
                       torch.as_tensor(p_ref, device=device),
                       use_physics=False if production
                       else dom.get("use_physics", False),
                       topo=topo, phys_cfg=phys_cfg, bdy=bdy,
                       bdy_width=bdy_width,
                       bdy_tau=dom.get("bdy_tau", 600.0),
                       core=dom.get("core", "explicit"),
                       n_small=dom.get("n_small", 6))


def _ref_columns(grid, dom):
    """rho_ref, p_ref (nz, 1, 1) of the base columns (_host_profiles)."""
    theta, rho1d, _, _ = _host_profiles(grid, dom)
    return rho1d.reshape(-1, 1, 1), reference_pressure(theta, rho1d)


def _tiled_result(config, grid, K, nobs, wall_s, stats, device):
    return {
        "config": config, "grid": f"{grid.nx}x{grid.ny}x{grid.nz}",
        "members": K, "nobs": int(nobs), "analysis_s": round(wall_s, 1),
        "gridpoints_per_s": round(grid.nz * grid.ny * grid.nx
                                  / max(stats["compute_s"], 1e-9), 1),
        "compute_s": round(stats["compute_s"], 2),
        "transfer_s": round(stats["transfer_s"], 2),
        "compile_s": round(stats["compile_s"], 2),
        "tiles": stats["tiles"], "peak_hbm_gb": _device_mem_gb(device)}


def bench_radar_analysis(config="configs/bda_1km_radar.toml",
                         n_obs_target=1_000_000, seed=0, device="cuda"):
    """Full-size dense-radar analysis: the host K = 50 ensemble (3.9 GB)
    streamed through the card in 48-row tiles (the analysis working set at
    1-km localization over a ~888k-obs volume does not fit beside it).
    Returns a result dict."""
    from scale_letkf_torch.da.letkf_obs import build_obs_context
    from scale_letkf_torch.da.letkf_tiled import analyze_tiled

    device = _device(device)
    _reset_peak(device)
    cfg, grid, dycfg, dom = _load_cfg(config)
    K = cfg.ensemble.member
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    rng = np.random.default_rng(seed)

    t0 = time.time()
    gues_np = _synthetic_gues(rng, K, nz, ny, nx, np.asarray(grid.cz))
    gen_s = time.time() - t0

    obs = _synthetic_radar_volume(cfg, dom, rng, n_obs_target)
    dat = obs.dat
    # synthetic ensemble H(x): dat + spread-consistent noise (the bench
    # measures the analysis engine; obsope is measured by the cycles)
    t0 = time.time()
    ensval = (dat[None, :]
              + rng.standard_normal((K, len(dat))).astype(np.float32)
              * obs.err[None, :])
    ctx = build_obs_context(obs, ensval, np.zeros(len(dat), np.int32),
                            cfg, grid)
    prep_s = time.time() - t0

    t0 = time.time()
    anal, infl, stats = analyze_tiled(gues_np, ctx, cfg, grid,
                                      _z_flat(grid, device), tile_rows=48,
                                      device=device)
    wall_s = time.time() - t0
    assert np.isfinite(anal).all()
    return {**_tiled_result(config, grid, K, len(dat), wall_s, stats,
                            device),
            "nobs_good": int((ctx.qc == 0).sum()),
            "state_gen_s": round(gen_s, 1), "obs_prep_s": round(prep_s, 1)}


def bench_18km_analysis(config="configs/18km_japan.toml", seed=0,
                        tile_rows=20, device="cuda"):
    """Full-size 18-km analysis: the K = 50 480×360×36 host ensemble (13.7
    GB float32) streamed through the card in row tiles — the one-card
    counterpart of the reference's 48-rank domain decomposition."""
    from scale_letkf_torch.da.letkf_obs import build_obs_context
    from scale_letkf_torch.da.letkf_tiled import analyze_tiled

    device = _device(device)
    _reset_peak(device)
    cfg, grid, dycfg, dom = _load_cfg(config)
    K = cfg.ensemble.member
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    rng = np.random.default_rng(seed)

    t0 = time.time()
    gues_np = _synthetic_gues(rng, K, nz, ny, nx, np.asarray(grid.cz))
    gen_s = time.time() - t0

    obs = _synthetic_conv_network(cfg, grid, rng)
    nobs = obs.nobs
    ensval = (obs.dat[None, :] + rng.standard_normal((K, nobs))
              * obs.err[None, :]).astype(np.float32)
    t0 = time.time()
    ctx = build_obs_context(obs, ensval, np.zeros(nobs, np.int32), cfg, grid)
    prep_s = time.time() - t0

    t0 = time.time()
    anal, infl, stats = analyze_tiled(gues_np, ctx, cfg, grid,
                                      _z_flat(grid, device),
                                      tile_rows=tile_rows, device=device)
    wall_s = time.time() - t0
    return {**_tiled_result(config, grid, K, nobs, wall_s, stats, device),
            "state_gen_s": round(gen_s, 1), "obs_prep_s": round(prep_s, 1)}


def _ensval_noise(seed: int, shape, device: torch.device) -> torch.Tensor:
    """Standard normal noise of the synthetic ensemble H(x), made on the
    device from a torch.Generator seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def _bench_resident_analysis(config, obs, seed, tile_rows, extra=None, *,
                             device):
    """Shared body of the resident analysis benches: the ensemble made on
    the card in the float32-mean + bfloat16-deviation layout, the (K, nobs)
    synthetic H(x) made on the card (_ensval_noise, seeded seed + 1),
    and the tiled analysis reading and writing the resident buffers in
    place — no state crosses the host link. config: _load_cfg's tuple."""
    from scale_letkf_torch.da.letkf_obs import build_obs_context
    from scale_letkf_torch.da.resident import analyze_resident

    cfg, grid, dycfg, dom = config
    K = cfg.ensemble.member
    nz, ny, nx = grid.nz, grid.ny, grid.nx

    t0 = time.time()
    ens = _synthetic_resident_gues(seed, K, grid, device=device)
    _sync(device)
    gen_s = time.time() - t0

    t0 = time.time()
    nobs = obs.nobs
    dat_d = torch.as_tensor(np.asarray(obs.dat, np.float32), device=device)
    err_d = torch.as_tensor(np.asarray(obs.err, np.float32), device=device)
    ensval = _ensval_noise(seed + 1, (K, nobs), device).mul_(
        err_d[None]).add_(dat_d[None])
    ctx = build_obs_context(obs, ensval.cpu().numpy(),
                            np.zeros(nobs, np.int32), cfg, grid)
    del ensval
    prep_s = time.time() - t0

    t0 = time.time()
    stats = analyze_resident(ens, ctx, cfg, grid, _z_flat(grid, device),
                             tile_rows=tile_rows)
    wall_s = time.time() - t0
    assert bool(torch.isfinite(ens.mean).all())
    out = {
        "grid": f"{nx}x{ny}x{nz}", "members": K, "executor": "resident",
        "nobs": int(nobs), "nobs_good": int((ctx.qc == 0).sum()),
        "analysis_s": round(wall_s, 1),
        "gridpoints_per_s": round(nz * ny * nx
                                  / max(stats["compute_s"], 1e-9), 1),
        "compute_s": round(stats["compute_s"], 2),
        "transfer_s": 0.0,
        "compile_s": round(stats["compile_s"], 2),
        "tiles": stats["tiles"],
        "nobs_local_mean": round(stats["nobs_mean"], 1),
        "peak_hbm_gb": _device_mem_gb(device),
        "state_gen_s": round(gen_s, 1), "obs_prep_s": round(prep_s, 1),
    }
    if extra:
        out.update(extra)
    return out


def bench_radar_analysis_resident(config="configs/bda_1km_radar.toml",
                                  n_obs_target=1_000_000, seed=0,
                                  tile_rows=48, device="cuda"):
    """Full-size dense-radar analysis, device-resident executor."""
    device = _device(device)
    _reset_peak(device)
    loaded = _load_cfg(config)
    cfg, grid, dycfg, dom = loaded
    rng = np.random.default_rng(seed)
    obs = _synthetic_radar_volume(cfg, dom, rng, n_obs_target)
    return _bench_resident_analysis(loaded, obs, seed, tile_rows,
                                    extra={"config": config}, device=device)


def bench_18km_analysis_resident(config="configs/18km_japan.toml", seed=0,
                                 tile_rows=8, device="cuda"):
    """Full-size 18-km analysis, device-resident executor: the 13.7-GB
    float32 K = 50 ensemble held as 7.0 GB of float32 mean and bfloat16
    deviations."""
    device = _device(device)
    _reset_peak(device)
    loaded = _load_cfg(config)
    cfg, grid, dycfg, dom = loaded
    cfg.letkf.level_batch = 1
    rng = np.random.default_rng(seed)
    obs = _synthetic_conv_network(cfg, grid, rng)
    return _bench_resident_analysis(loaded, obs, seed, tile_rows,
                                    extra={"config": config}, device=device)


def _cycle_numbers(report: dict) -> dict:
    return {k: round(v, 2) for k, v in report.items()
            if isinstance(v, (int, float))}


def bench_18km_cycle(config="configs/18km_japan.toml", nsteps=10, seed=0,
                     member_batch=2, tile_rows=20, overrides=None,
                     n_sonde=700, n_ps=2000, members=None,
                     production=True, slots=False, pipeline=True,
                     device="cuda"):
    """ONE complete 18-km DA cycle at the shipped size — ensemble forecast,
    full-size H(x) and the tiled LETKF — through the member-streamed
    executor (da/bigcycle.py), in the production composition
    (_make_fullsize_driver) unless production=False (SI core on the
    stretched levels alone). slots=True spreads the obs over the
    configured LTIMESLOT window (slot-matched H(x) carries the integration
    past the analysis time, so nsteps should then reach the window's span).
    The forecast runs `nsteps` of the 720-step 6-h window (LCYCLE 21600 s at
    dt 30 s, config/2015summer_18km); the steady per-member-step cost is
    extrapolated to the whole window beside it."""
    from scale_letkf_torch.da.bigcycle import StreamedCycle, log, phase_table
    from scale_letkf_torch.model.dycore import DycoreState

    device = _device(device)
    _reset_peak(device)
    cfg, grid, dycfg, dom = _load_cfg(config, overrides)
    if members:
        cfg.ensemble.member = members
    K = cfg.ensemble.member
    if not slots:
        # a 3-D window for the budgeted bench
        cfg.obsope.slot_end = cfg.obsope.slot_start
    rng = np.random.default_rng(seed)

    t0 = time.time()
    ens, rho_ref, p_ref = _synthetic_ens_dycore(rng, K + 1, grid, dom)
    gen_s = time.time() - t0
    driver = _make_fullsize_driver(cfg, grid, dycfg, dom, rho_ref, p_ref,
                                   production=production, device=device)
    sc = StreamedCycle(driver, member_batch=member_batch,
                       tile_rows=tile_rows, pipeline=pipeline, verbose=True)

    truth = DycoreState(*(a[:1] for a in ens))
    ens = DycoreState(*(np.ascontiguousarray(a[1:]) for a in ens))
    obs = _synthetic_conv_network(cfg, grid, rng, n_sonde=n_sonde,
                                  n_ps=n_ps)
    if slots:
        o = cfg.obsope
        slot_times = (np.arange(o.slot_start, o.slot_end + 1)
                      - o.slot_base) * o.slot_tinterval
        obs.dif = rng.choice(slot_times, obs.nobs)
    obs = _obs_from_truth(sc, truth, obs, nsteps, rng)

    ens = [ens]           # handed over: the cycle frees it once guessed
    ens_a, infl, report = sc.cycle(ens.pop(), obs, nsteps)
    log(phase_table(report))
    window_steps = int(round(21600.0 / dycfg.dt))
    per_mem_step = report["fcst_s"] / (K * nsteps)
    sg = report.pop("stats_gues")
    sa = report.pop("stats_anal", None)
    out = {
        "config": config, "grid": f"{grid.nx}x{grid.ny}x{grid.nz}",
        "members": K, "nobs": int(obs.nobs),
        "nobs_good": int(sum(sg.nobs.values())),
        "composition": PRODUCTION if production else "si+stretch",
        "window_4d_slots": (f"{cfg.obsope.slot_start}..{cfg.obsope.slot_end}"
                            if slots else "single"),
        "steps_run": nsteps, "window_steps": window_steps,
        "s_per_member_step": round(per_mem_step, 4),
        "fcst_full_window_extrapolated_s": round(
            per_mem_step * K * window_steps, 1),
        "state_gen_s": round(gen_s, 1),
        "peak_hbm_gb": _device_mem_gb(device),
        **_cycle_numbers(report),
    }
    if sa is not None and sg.nobs.get("T"):
        out["omb_rmse_T"] = round(sg.rmse["T"], 4)
        out["oma_rmse_T"] = round(sa.rmse["T"], 4)
    return out


def bench_radar_cycle(config="configs/bda_1km_radar.toml", seed=0,
                      member_batch=10, tile_rows=48,
                      n_obs_target=1_000_000, overrides=None, members=None,
                      production=True, device="cuda"):
    """ONE complete dense-radar DA cycle at the shipped size: the whole
    30-s window (15 steps at dt 2 s, the reference's LCYCLE 30 s BDA regime,
    config/BDA_d3_100m_256p_bf40), H(x) of the ~888k-obs volume for every
    member and the 1-km-localization LETKF, through the member-streamed
    executor; production=True runs the full model composition, False the
    configuration's own (SI core, Kessler)."""
    from scale_letkf_torch.da.bigcycle import StreamedCycle, log, phase_table
    from scale_letkf_torch.model.dycore import DycoreState

    device = _device(device)
    _reset_peak(device)
    cfg, grid, dycfg, dom = _load_cfg(config, overrides)
    if members:
        cfg.ensemble.member = members
    K = cfg.ensemble.member
    rng = np.random.default_rng(seed)
    nsteps = int(round(30.0 / dycfg.dt))

    t0 = time.time()
    ens, rho_ref, p_ref = _synthetic_ens_dycore(rng, K + 1, grid, dom,
                                                qr_blob=2.0e-3)
    gen_s = time.time() - t0
    driver = _make_fullsize_driver(cfg, grid, dycfg, dom, rho_ref, p_ref,
                                   production=production, device=device)
    sc = StreamedCycle(driver, member_batch=member_batch,
                       tile_rows=tile_rows, verbose=True)

    truth = DycoreState(*(a[:1] for a in ens))
    ens = DycoreState(*(np.ascontiguousarray(a[1:]) for a in ens))
    obs = _synthetic_radar_volume(cfg, dom, rng, n_obs_target)
    obs = _obs_from_truth(sc, truth, obs, nsteps, rng, radar=True, cfg=cfg)

    ens = [ens]
    ens_a, infl, report = sc.cycle(ens.pop(), obs, nsteps)
    log(phase_table(report))
    sg = report.pop("stats_gues")
    sa = report.pop("stats_anal", None)
    out = {
        "config": config, "grid": f"{grid.nx}x{grid.ny}x{grid.nz}",
        "members": K, "nobs": int(obs.nobs),
        "nobs_good": int(sum(sg.nobs.values())),
        "composition": PRODUCTION if production else "si+stretch+kessler",
        "steps_run": nsteps, "window_steps": nsteps,
        "s_per_member_step": round(report["fcst_s"] / (K * nsteps), 4),
        "state_gen_s": round(gen_s, 1),
        "peak_hbm_gb": _device_mem_gb(device),
        **_cycle_numbers(report),
    }
    if sa is not None and sg.nobs.get("REF"):
        out["omb_rmse_REF"] = round(sg.rmse["REF"], 3)
        out["oma_rmse_REF"] = round(sa.rmse["REF"], 3)
    return out


def bench_18km_cycle_resident(config="configs/18km_japan.toml",
                              nsteps=720, slots=True, seed=0,
                              member_batch=2, tile_rows=8, members=None,
                              n_sonde=700, n_ps=2000, overrides=None,
                              device="cuda"):
    """The COMPLETE 18-km cycle over the whole 6-h window — all 720 steps
    (LCYCLE 21600 s at dt 30 s, config/2015summer_18km/config.nml.scale
    PARAM_TIME) per member batch — in the production composition on the
    resident executor (no state crosses the host link); with slots=True the
    full LTIMESLOT 4-D window (slot-matched H(x) carries the integration to
    nsteps + 3 h = 1080 steps). The obs are an independent one-member
    truth's H(x) plus noise. Timers block per batch; fcst_s extrapolates the
    steady batches (the first, which builds the kernels, left out).

    Also reports a coarse SI-step roofline: a LOWER-BOUND byte/FLOP model of
    one split-explicit step against the measured time per member-step, at
    the card's HBM rate (HBM_BYTES_PER_S)."""
    from scale_letkf_torch.da.monitor import monit_dep
    from scale_letkf_torch.da.obsope import assign_slots
    from scale_letkf_torch.da.resident import ResidentCycle

    device = _device(device)
    _reset_peak(device)
    cfg, grid, dycfg, dom = _load_cfg(config, overrides)
    if members:
        cfg.ensemble.member = members
    K = cfg.ensemble.member
    cfg.letkf.level_batch = 1
    if not slots:
        cfg.obsope.slot_end = cfg.obsope.slot_start
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid.nz, grid.ny, grid.nx

    rho_ref, p_ref = _ref_columns(grid, dom)
    driver = _make_fullsize_driver(cfg, grid, dycfg, dom, rho_ref, p_ref,
                                   production=True, device=device)

    obs = _synthetic_conv_network(cfg, grid, rng, n_sonde=n_sonde,
                                  n_ps=n_ps)
    if slots:
        o = cfg.obsope
        slot_times = (np.arange(o.slot_start, o.slot_end + 1)
                      - o.slot_base) * o.slot_tinterval
        obs.dif = rng.choice(slot_times, obs.nobs)

    t0 = time.time()
    truth = _synthetic_resident_gues(seed + 101, 1, grid, device=device)
    rc_t = ResidentCycle(driver, member_batch=1, tile_rows=tile_rows,
                         verbose=True)
    y_t, qc_t, _ = rc_t.forecast_and_hx(truth, nsteps, obs)
    y_t = y_t.cpu().numpy()[0]
    keep = qc_t == 0
    obs = obs.select(keep)
    obs.dat = y_t[keep] + rng.standard_normal(int(keep.sum())) * obs.err
    truth_s = time.time() - t0
    del truth, rc_t, y_t

    t0 = time.time()
    ens = _synthetic_resident_gues(seed, K, grid, device=device)
    _sync(device)
    gen_s = time.time() - t0

    rc = ResidentCycle(driver, member_batch=member_batch,
                       tile_rows=tile_rows, verbose=True)
    report = rc.cycle(ens, obs, nsteps)

    # the span integrated per member (slots run past the analysis time)
    o = cfg.obsope
    spb = int(round(o.slot_tinterval / dycfg.dt)) if slots else 0
    span = nsteps + max(0, (o.slot_end - o.slot_base) * spb) if slots \
        else nsteps
    per_mem_step = report["fcst_s"] / (K * span)

    # coarse SI-step roofline (LOWER BOUND byte/FLOP model): 11 float32
    # fields of state; per rk3_step_si 3 stages × (slow tendencies: read the
    # state, write the tendency = 2S) + the acoustic substeps (ns1 + ns2 +
    # ns3) × (5 deviation fields read and written ≈ 10/11 S) + the physics
    # (≈ 2S every phys_interval steps, amortized)
    S = 11 * nz * ny * nx * 4
    n_small = dom.get("n_small", 10)
    ns_total = max(1, n_small // 3) + max(1, n_small // 2) + n_small
    bytes_per_step = 3 * 2 * S + ns_total * (10 / 11) * S + 2 * S / 5
    # FLOPs: ~150 a point a stage (slow) + ~60 a point a substep (acoustic)
    pts = nz * ny * nx
    flops_per_step = 3 * 150 * pts + ns_total * 60 * pts
    peak_gbps = HBM_BYTES_PER_S / 1e9
    roofline = {
        "si_step_bytes_model_gb": round(bytes_per_step / 1e9, 3),
        "si_step_achieved_gbps": round(bytes_per_step / per_mem_step / 1e9,
                                       1),
        "si_step_achieved_gflops": round(flops_per_step / per_mem_step / 1e9,
                                         1),
        "h100_sxm_hbm_peak_gbps": peak_gbps,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "note": f"lower-bound traffic model; achieved_gbps/{peak_gbps:g} is "
                f"a bandwidth-utilization floor for the step",
    }

    sg = report.pop("stats_gues")
    sa = report.pop("stats_anal", None)
    out = {
        "config": config, "grid": f"{nx}x{ny}x{nz}", "members": K,
        "executor": "resident", "composition": PRODUCTION,
        "window_4d_slots": (f"{o.slot_start}..{o.slot_end}" if slots
                            else "single"),
        "nobs": int(obs.nobs), "nobs_good": int(sum(sg.nobs.values())),
        "steps_run": nsteps, "window_steps": 720,
        "window_span_steps_with_slots": span,
        "s_per_member_step": round(per_mem_step, 4),
        "truth_prep_s": round(truth_s, 1),
        "state_gen_s": round(gen_s, 1),
        "roofline": roofline,
        **_cycle_numbers(report),
    }
    if sa is not None and sg.nobs.get("T"):
        out["omb_rmse_T"] = round(sg.rmse["T"], 4)
        out["oma_rmse_T"] = round(sa.rmse["T"], 4)
    if slots and rc.last_ctx is not None:
        # the time-consistent impact metric: the obs of the analysis-time
        # slot (the 3-D O−A monitor mixes the time displacement of the
        # other slots in, as the reference's monitor does)
        ctx = rc.last_ctx
        sl = assign_slots(np.asarray(obs.dif), cfg)[:ctx.nobs]
        center = sl == cfg.obsope.slot_base
        sgc = monit_dep(ctx.elem[center], np.asarray(ctx.dep)[center],
                        ctx.qc[center])
        sac = monit_dep(ctx.elem[center], rc.last_oma[center],
                        ctx.qc[center])
        if sgc.nobs.get("T"):
            out["omb_rmse_T_centerslot"] = round(sgc.rmse["T"], 4)
            out["oma_rmse_T_centerslot"] = round(sac.rmse["T"], 4)
    return out


@contextlib.contextmanager
def _plain_stencils():
    """model/dycore.tendencies through the plain PyTorch versions of kernels
    #2 and #3 whatever the tensors' device, for the duration."""
    from scale_letkf_torch.model import dycore
    from scale_letkf_torch.ops.stencil import adv_flux_divergence_plain
    from scale_letkf_torch.ops.tendency import dyn_tendencies_plain
    saved = dycore.dyn_tendencies, dycore.adv_flux_divergence
    dycore.dyn_tendencies = dyn_tendencies_plain
    dycore.adv_flux_divergence = adv_flux_divergence_plain
    try:
        yield
    finally:
        dycore.dyn_tendencies, dycore.adv_flux_divergence = saved


def _seconds_per_call(fn, reps: int, device: torch.device) -> float:
    """Seconds a call of fn: on a card the mean over reps calls between two
    CUDA events (after one warm-up call), on the CPU the median of reps
    synchronised calls."""
    fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_tendency_fused(nz=48, ny=192, nx=256, reps=30, seed=0,
                         device="cuda"):
    """The dynamics tendency through the hand-written kernels against the
    plain PyTorch path on a radar-class grid: one dycore.tendencies call and
    one rk3_step_si step (4 acoustic substeps), each path on the same card
    tensors (the plain path: _plain_stencils), with the effective bandwidth
    of each against a minimum-traffic model.

    Keys keep the reference's names: `xla` is the plain PyTorch path (the
    reference's XLA roll path), `fused` the kernels #2 and #3 (its fused
    Pallas kernel). nx defaults to the reference's 256 so the work matches
    its; the Pallas kernel's 128-lane reason for it does not hold for the
    CUDA kernels, which take the radar configuration's 192 as well.

    Traffic model (LOWER BOUND, per tendencies call): read the 11
    prognostic fields once and write the 11 tendencies once. fused_max_rel_err
    is the largest max|kernel − plain| / max|plain| over the 11 tendencies,
    within 2e-5 (gpu_check's TOL_TENDENCY; kernel #3 alone is held to
    1e-5)."""
    from scale_letkf_torch.model.dycore import (
        DycoreConfig, DycoreState, hydrostatic_reference, tendencies)
    from scale_letkf_torch.model.dycore_si import SplitConfig, rk3_step_si
    from scale_letkf_torch.state import NQ

    device = _device(device)
    rng = np.random.default_rng(seed)
    theta = 300.0 + 30.0 * np.linspace(0, 1, nz)
    rho1d, p1d = hydrostatic_reference(theta, 500.0)
    rho = rho1d[:, None, None] * (
        1.0 + 0.01 * rng.standard_normal((nz, ny, nx)))
    rhot = rho * theta[:, None, None] * (
        1.0 + 0.01 * rng.standard_normal((nz, ny, nx)))
    rhow = 0.5 * rng.standard_normal((nz + 1, ny, nx))
    rhow[0] = rhow[-1] = 0.0

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    s = DycoreState(
        rho=dev(rho),
        rhou=dev(5.0 * rng.standard_normal((nz, ny, nx)) * rho),
        rhov=dev(5.0 * rng.standard_normal((nz, ny, nx)) * rho),
        rhow=dev(rhow), rhot=dev(rhot),
        rhoq=dev(np.abs(1e-3 * rng.standard_normal((NQ, nz, ny, nx)))
                 * rho))
    rref = dev(rho1d[:, None, None])
    pref = dev(p1d[:, None, None])
    zc = dev((np.arange(nz) + 0.5) * 500.0)

    cfg = DycoreConfig(dx=1000.0, dy=1000.0, dz=500.0, dt=2.0)
    split = SplitConfig(dtau=0.5)
    fb = 4 * nz * ny * nx                     # one float32 field
    ideal_bytes = 2 * (10 * fb + 4 * (nz + 1) * ny * nx)  # r+w 11 fields

    def tend():
        return tendencies(s, cfg, rref, pref)

    def step():
        return rk3_step_si(s, cfg, split, rref, pref, zc, 4)

    res = {"grid": f"{nz}x{ny}x{nx}", "nq": NQ,
           "ideal_traffic_mb": round(ideal_bytes / 1e6, 1)}
    with _plain_stencils():
        t_x = _seconds_per_call(tend, reps, device)
        out_x = tend()
        t_sx = _seconds_per_call(step, reps, device)
    t_p = _seconds_per_call(tend, reps, device)
    out_p = tend()
    t_sp = _seconds_per_call(step, reps, device)
    rel = max(float((a - b).abs().max()
                    / torch.clamp(a.abs().max(), min=1e-30))
              for a, b in zip(out_x, out_p))
    res["tendencies_xla_us"] = round(t_x * 1e6, 1)
    res["tendencies_xla_eff_gbps"] = round(ideal_bytes / t_x / 1e9, 1)
    res["tendencies_fused_us"] = round(t_p * 1e6, 1)
    res["tendencies_fused_eff_gbps"] = round(ideal_bytes / t_p / 1e9, 1)
    res["fused_max_rel_err"] = rel
    res["fused_speedup"] = round(t_x / t_p, 3)
    res["step_si_xla_ms"] = round(t_sx * 1e3, 3)
    res["step_si_fused_ms"] = round(t_sp * 1e3, 3)
    return res


def bench_osse_impact(config="configs/18km_japan.toml", members=50,
                      n_cycles=4, steps_per_cycle=60, spinup_steps=60,
                      seed=0, member_batch=2, tile_rows=12,
                      n_sonde=400, n_ps=800, overrides=None,
                      infl_mul=None, relax_alpha=None,
                      obs_err_scale=1.0, device="cuda"):
    """Multi-cycle OSSE with a no-DA control (the reference's verification
    layer, common_mpi_scale.f90:1481-1633): a spun-up ensemble cycles
    forecast and analysis against obs drawn from an independently drawn
    truth, while an identical control ensemble only forecasts. Returns the
    error-by-cycle curves — the T RMSE of the ensemble mean against the
    truth over the observed layer below 11 km, of the guess, the analysis
    and the control — and the guess's T spread: the assimilation-impact
    evidence a single cycle's O−B / O−A cannot give.

    Defaults: a 240×180×36 coarsened 18-km shape (overrides), K = 50, every
    system on the resident executor in the production composition. The
    truth runs under an unmodelled forcing (its radiation's mu0 0.65, the
    systems' 0.5) and starts 1 K warmer: the DA system must keep learning
    from the obs while the free-running control drifts."""
    from scale_letkf_torch.da.bigcycle import log
    from scale_letkf_torch.da.resident import ResidentCycle
    from scale_letkf_torch.state import IA_T, ensemble_mean, member_sum

    device = _device(device)
    if overrides is None:
        overrides = {"nx": 240, "ny": 180, "nz": 36,
                     "dx": 36000.0, "dy": 36000.0}
    cfg, grid, dycfg, dom = _load_cfg(config, overrides)
    cfg.ensemble.member = members
    cfg.letkf.level_batch = 1
    cfg.obsope.slot_end = cfg.obsope.slot_start      # 3-D cycles
    if infl_mul is not None:
        cfg.letkf.infl_mul = infl_mul
    if relax_alpha is not None:
        cfg.letkf.relax_alpha = relax_alpha
    K = members
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid.nz, grid.ny, grid.nx

    rho_ref, p_ref = _ref_columns(grid, dom)
    driver = _make_fullsize_driver(cfg, grid, dycfg, dom, rho_ref, p_ref,
                                   production=True, device=device)

    obs = _synthetic_conv_network(cfg, grid, rng, n_sonde=n_sonde,
                                  n_ps=n_ps)
    obs.err = obs.err * obs_err_scale

    strides = (1, 2, 4, 8)
    ens = _synthetic_resident_gues(seed, K, grid, smooth_strides=strides,
                                   device=device)
    ctrl = _synthetic_resident_gues(seed, K, grid, smooth_strides=strides,
                                    device=device)
    # the truth: an INDEPENDENT draw (the OSSE truth-draw rule) under an
    # UNMODELLED FORCING, a stronger sun in its physics — a persistent
    # balanced warming the DA system must keep learning from the obs while
    # the control drifts (a perfect-model twin shows no impact: the
    # idealized large-scale state has no chaotic error growth)
    truth = _synthetic_resident_gues(seed + 101, 1, grid, t_offset=1.0,
                                     smooth_strides=strides, device=device)
    dom_t = dict(dom)
    dom_t["physics"] = dict(dom.get("physics", {}), mu0=0.65)
    driver_t = _make_fullsize_driver(cfg, grid, dycfg, dom_t, rho_ref,
                                     p_ref, production=True, device=device)
    rc = ResidentCycle(driver, member_batch=member_batch,
                       tile_rows=tile_rows, verbose=True)
    rc_c = ResidentCycle(driver, member_batch=member_batch,
                         tile_rows=tile_rows)
    rc_t = ResidentCycle(driver_t, member_batch=1, tile_rows=tile_rows)

    # scored over the OBSERVED layer (below ~11 km: the sondes top out at
    # 200 hPa): the unmodelled forcing also heats the unconstrained
    # low-density stratosphere by tens of K, which no DA system could
    # correct and which would swamp the tropospheric signal
    zmask = torch.as_tensor(
        (np.asarray(grid.cz) < 11000.0).astype(np.float32),
        device=device)[:, None, None]
    zw = zmask / zmask.sum() / (ny * nx)

    def t_rmse(mean_a, ref_t, dev_t):
        tr = ref_t[IA_T] + dev_t[0, IA_T].float()
        return float(torch.sqrt(torch.sum(zw * (mean_a[IA_T] - tr) ** 2)))

    def t_spread(dev, K_):
        d = dev[:, IA_T].float()
        d = d - ensemble_mean(d)
        return float(torch.sqrt(torch.mean(member_sum(d * d) / (K_ - 1))))

    curve = {"rmse_gues": [], "rmse_anal": [], "rmse_ctrl": [],
             "spread_gues": []}

    t_total = time.time()
    # spin-up (all three systems; H(x) rides along unused)
    if spinup_steps > 0:
        rc.forecast_and_hx(ens, spinup_steps, obs)
        rc_c.forecast_and_hx(ctrl, spinup_steps, obs)
        rc_t.forecast_and_hx(truth, spinup_steps, obs)
    for c in range(n_cycles):
        y_t, qc_t, _ = rc_t.forecast_and_hx(truth, steps_per_cycle, obs)
        y_t = y_t.cpu().numpy()[0]
        good = qc_t == 0
        # obs positions fixed; values refreshed in place
        obs.dat[:] = np.where(
            good, y_t + rng.standard_normal(obs.nobs) * obs.err, obs.dat)

        ensval, qc_w, _ = rc.forecast_and_hx(ens, steps_per_cycle, obs)
        curve["rmse_gues"].append(t_rmse(ens.mean, truth.ref, truth.dev))
        curve["spread_gues"].append(t_spread(ens.dev, K))
        rc.analysis(ens, obs, ensval, np.where(good, qc_w, 99))
        del ensval
        curve["rmse_anal"].append(t_rmse(ens.mean, truth.ref, truth.dev))

        rc_c.forecast_and_hx(ctrl, steps_per_cycle, obs)
        curve["rmse_ctrl"].append(t_rmse(ctrl.mean, truth.ref, truth.dev))
        log(f"osse cycle {c}: gues={curve['rmse_gues'][-1]:.4f} "
            f"anal={curve['rmse_anal'][-1]:.4f} "
            f"ctrl={curve['rmse_ctrl'][-1]:.4f} "
            f"sprd={curve['spread_gues'][-1]:.4f}")

    return {
        "config": config, "grid": f"{nx}x{ny}x{nz}", "members": K,
        "executor": "resident", "composition": PRODUCTION,
        "n_cycles": n_cycles, "steps_per_cycle": steps_per_cycle,
        "spinup_steps": spinup_steps,
        "nobs": int(obs.nobs), "nobs_good": int(good.sum()),
        "infl_mul": cfg.letkf.infl_mul,
        "relax_alpha": cfg.letkf.relax_alpha,
        "total_s": round(time.time() - t_total, 1),
        **{k: [round(v, 4) for v in vs] for k, vs in curve.items()},
    }


BENCHES = {"radar": bench_radar_analysis,
           "18km": bench_18km_analysis,
           "radar_resident": bench_radar_analysis_resident,
           "18km_resident": bench_18km_analysis_resident,
           "radar_cycle": bench_radar_cycle,
           "18km_cycle": bench_18km_cycle,
           "18km_fullwindow": bench_18km_cycle_resident,
           "tendency_fused": bench_tendency_fused,
           "osse_impact": bench_osse_impact}


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(
        prog="python -m scale_letkf_torch.bench_fullsize",
        description="Run one full-size bench; print its result as one JSON "
                    "line.")
    ap.add_argument("name", nargs="?", default="radar", choices=list(BENCHES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: needs a card) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(BENCHES[args.name](device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
