"""Command-line programs of the port (the reference's executable layer):

  python -m scale_letkf_torch letkf   --config c.toml --gues DIR --obs F --anal DIR
  python -m scale_letkf_torch obsope  --config c.toml --gues DIR --obs F --out F
  python -m scale_letkf_torch obsmake --config c.toml --nature F --obs-template F --out F
  python -m scale_letkf_torch obssim  --config c.toml --state F --vars REF,VR --out F
  python -m scale_letkf_torch fcst    --config c.toml --init DIR --steps N --out DIR
  python -m scale_letkf_torch cycle   --config c.toml --init DIR --cycles N ...
  python -m scale_letkf_torch pp      --config c.toml --dem F --out topo.npz

each with --device cuda (the default: the hand-written kernels, and an
error without a GPU) or cpu (their plain versions).

Port of scale_letkf_tpu/cli/main.py: the experiment loader, the driver
factory and the verbs, with the reference's arguments. States are
checkpoint directories in the reference's format (io/checkpoint.py) and obs
the reference's binary formats (obs/io.py), so either package's output
loads in the other. A deterministic member in the checkpoint (the 'mdet'
file) is analysed by `letkf` and forecast and analysed every cycle by
`cycle` (DET_RUN_CYCLED), and INFL_ADD > 0 reads its source ensemble from
the INFL_ADD_IN_BASENAME files (`letkf --addi DIR`, else the guess or init
directory). `cycle --streamed` runs the member-streamed executor
(da/bigcycle.py: the ensemble in host memory, --member-batch, --tile-rows,
--pipeline). A [nest] section makes `cycle` run a one-way nested child
domain beside the parent (nested.py: --nest-init, --nest-obs-pattern; the
child saved under OUT/nest).

A [process] table (mesh_member, mesh_y, mesh_x) runs `fcst`, `letkf` and
`cycle` on a process grid (parallel/): every block in this process, or,
with the options before the verb,

  python -m scale_letkf_torch --coordinator HOST:PORT --num-processes N \
      --process-id RANK [--local-device-count B] cycle ...

spread over N processes of B blocks each (torch.distributed: NCCL with
--device cuda, gloo with --device cpu). Each process reads its own members'
restart files (and their part of a resumed skin temperature); the outputs
are gathered and process 0 writes them. Kessler (use_physics), a [physics]
section, terrain under either core and a [nest] section run on every grid
(the child on a grid of the same shape, each process reading its own
members of --nest-init). `cycle --streamed` forecasts each member batch on
the grid in one process, and refuses a world of several processes (the
stream keeps the whole ensemble in one process's host memory).
"""

from __future__ import annotations

import argparse
import sys
import tomllib

import numpy as np
import torch

from scale_letkf_torch.config import Config
from scale_letkf_torch.grid import Grid, Projection
from scale_letkf_torch.model.dycore import DycoreConfig


def load_config_and_grid(path: str, domain_overrides: dict | None = None):
    """(cfg, grid, dycfg, dom) from an experiment TOML: the config sections,
    the grid its [domain] section describes, the dynamical core's config,
    and the raw [domain] table. domain_overrides replaces [domain] keys
    (e.g. coarsened sizes)."""
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    dom = raw.pop("domain", {})
    nest = raw.pop("nest", None)
    if domain_overrides:
        dom.update(domain_overrides)
    if nest is not None:
        dom["nest"] = nest
    phys = raw.pop("physics", None)
    if phys is not None:
        dom["physics"] = phys
    cfg = Config.from_dict(raw)
    proj = Projection(**dom.get("projection", {}))
    sizes = dict(nx=dom.get("nx", 40), ny=dom.get("ny", 40),
                 nz=dom.get("nz", 30), dx=dom.get("dx", 2000.0),
                 dy=dom.get("dy", 2000.0))
    stretch = dom.get("dz_stretch", 1.0)
    if stretch != 1.0:
        grid = Grid.stretched(**sizes, dz0=dom.get("dz", 500.0),
                              stretch=stretch, proj=proj)
    else:
        grid = Grid.uniform(**sizes, dz=dom.get("dz", 500.0), proj=proj)
    dycfg = DycoreConfig(
        dx=grid.dx, dy=grid.dy, dz=float(grid.fz[1] - grid.fz[0]),
        dt=dom.get("dt", 1.0), ztop=grid.ztop,
        sponge_height=dom.get("sponge_height", 0.0),
        sponge_tau=dom.get("sponge_tau", 120.0),
        divdmp=dom.get("divdmp", 0.05), kdiff4=dom.get("kdiff4", 1.0e-3))
    return cfg, grid, dycfg, dom


def make_driver(cfg, grid, dycfg, dom, device: torch.device):
    """The forecast driver of the [domain] table on `device`: the balanced
    reference column (with the qv profile when qv_surface > 0), the core
    and its substeps, Kessler physics (use_physics), the physics suite of a
    [physics] section (its keys those of PhysicsConfig; others raise
    ValueError), either every phys_interval steps (default 5), Davies
    relaxation toward a boundary file (bdy_file, bdy_width, bdy_tau) and the
    topography of topo_file (an npz with key 'topo', as the pp verb writes
    it) and the process grid of [process] (process_grid)."""
    import dataclasses

    from scale_letkf_torch.cycle import CycleDriver
    from scale_letkf_torch.model.boundary import load_boundary
    from scale_letkf_torch.model.ideal import balanced_state
    from scale_letkf_torch.model.physics_suite import PhysicsConfig
    qv0 = dom.get("qv_surface", 0.0)
    qv_prof = (qv0 * np.exp(-grid.cz / dom.get("qv_scale_height", 3000.0))
               if qv0 > 0 else None)
    # one column: only the reference profiles are kept
    _, rho_ref, p_ref = balanced_state(
        grid.nz, 1, 1, float(grid.fz[1] - grid.fz[0]), qv_prof=qv_prof,
        cz=grid.cz, device=device)
    topo = np.load(dom["topo_file"])["topo"] if dom.get("topo_file") else None
    bdy = (load_boundary(dom["bdy_file"], device) if dom.get("bdy_file")
           else None)
    phys_cfg = None
    if "physics" in dom:
        valid = {f.name for f in dataclasses.fields(PhysicsConfig)}
        unknown = set(dom["physics"]) - valid
        if unknown:
            raise ValueError(f"unknown [physics] keys: {sorted(unknown)} "
                             f"(valid: {sorted(valid)})")
        phys_cfg = PhysicsConfig(**dom["physics"])
    return CycleDriver(grid, cfg, dycfg, rho_ref, p_ref,
                       use_physics=dom.get("use_physics", False),
                       phys_interval=dom.get("phys_interval", 5),
                       topo=topo, phys_cfg=phys_cfg,
                       mesh=process_grid(cfg),
                       core=dom.get("core", "explicit"),
                       n_small=dom.get("n_small", 6),
                       bdy=bdy, bdy_width=dom.get("bdy_width", 0),
                       bdy_tau=dom.get("bdy_tau", 300.0))


def process_grid(cfg):
    """The ProcessGrid of [process] (mesh_member, mesh_y, mesh_x): over the
    torch.distributed world when one is running, else every block in this
    process; None for a grid of one block."""
    pc = cfg.process
    if pc.mesh_member * pc.mesh_y * pc.mesh_x == 1:
        return None
    import torch.distributed as dist

    from scale_letkf_torch.parallel.distributed import global_device_mesh
    from scale_letkf_torch.parallel.mesh import make_mesh
    if dist.is_initialized():
        return global_device_mesh(pc.mesh_member, pc.mesh_y, pc.mesh_x)
    return make_mesh(pc.mesh_member, pc.mesh_y, pc.mesh_x)


def _writer() -> bool:
    """Whether this process writes the outputs (process 0 of a world)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _global(driver, ens):
    """The global ensemble of a driver's output, or its skin temperature
    (gathered on a grid)."""
    from scale_letkf_torch.parallel.mesh import Sharded
    return driver.mesh.gather_ensemble(ens) if isinstance(ens, Sharded) \
        else ens


def _resume_tsfc(driver, tsfc, device: torch.device):
    """A checkpoint's slab skin temperature (K, ny, nx) for the driver: the
    global field, or on a grid spread over processes this process's blocks
    from its own members' part (the ensemble's stage-in)."""
    from scale_letkf_torch.parallel.distributed import (
        ensemble_from_process_local)
    mesh = driver.mesh
    tsfc = np.asarray(tsfc, np.float32)
    if mesh is not None and mesh.world > 1:
        return ensemble_from_process_local(mesh, torch.as_tensor(
            tsfc[mesh.local_members(tsfc.shape[0])], device=device))
    return torch.as_tensor(tsfc, device=device)


def make_nested(cfg, grid, dycfg, dom, device: torch.device):
    """[nest] section → (child driver on `device`, NestGeometry,
    NestedCycleDriver). The child inherits the parent's DA config and its
    [process] grid; its domain is the [nest] geometry on uniform levels,
    its core the explicit one (reference: NUM_DOMAIN telescoping nests,
    common_nml.f90:56)."""
    from scale_letkf_torch.model.nesting import NestGeometry
    from scale_letkf_torch.nested import NestedCycleDriver
    n = dom["nest"]
    ratio = int(n.get("ratio", 3))
    cgrid = Grid.uniform(
        nx=n.get("nx", 24), ny=n.get("ny", 24), nz=n.get("nz", grid.nz),
        dx=grid.dx / ratio, dy=grid.dy / ratio,
        dz=n.get("dz", float(grid.fz[1] - grid.fz[0])),
        proj=Projection(**dom.get("projection", {})))
    cdycfg = DycoreConfig(
        dx=cgrid.dx, dy=cgrid.dy, dz=float(cgrid.fz[1] - cgrid.fz[0]),
        dt=n.get("dt", dycfg.dt / ratio), ztop=cgrid.ztop,
        sponge_height=n.get("sponge_height", dycfg.sponge_height),
        sponge_tau=n.get("sponge_tau", dycfg.sponge_tau),
        lateral=n.get("lateral", "periodic"))
    cdom = {"bdy_width": n.get("bdy_width", 4),
            "bdy_tau": n.get("bdy_tau", 120.0)}
    child = make_driver(cfg, cgrid, cdycfg, cdom, device)
    geom = NestGeometry(i0=float(n.get("i0", 0.0)),
                        j0=float(n.get("j0", 0.0)), ratio=ratio)
    return child, geom, NestedCycleDriver


def slot_steps_from_cfg(cfg, nsteps: int, dt: float) -> list[int] | None:
    """Step counts (from the forecast start) of the assimilation window's
    time slots (SLOT_START..SLOT_END, SLOT_BASE at the analysis time,
    common_nml.f90:89-92); None when the window is a single slot."""
    o = cfg.obsope
    if o.slot_end <= o.slot_start:
        return None
    spb = o.slot_tinterval / dt
    if abs(spb - round(spb)) > 1e-6:
        raise ValueError(
            f"slot_tinterval={o.slot_tinterval} must be a multiple of the "
            f"model dt={dt}")
    spb = int(round(spb))
    return [max(0, nsteps + (i - o.slot_base) * spb)
            for i in range(o.slot_start, o.slot_end + 1)]


def _device(args) -> torch.device:
    """--device; under torch.distributed with CUDA the card the process
    group bound (init_distributed)."""
    import torch.distributed as dist

    from scale_letkf_torch.utils.device import require_cuda
    if args.device != "cuda":
        return torch.device(args.device)
    return require_cuda(torch.cuda.current_device()
                        if dist.is_initialized() and torch.cuda.is_available()
                        else 0)


def _setup(args):
    """(cfg, grid, dycfg, dom, driver, device) of a verb's --config and
    --device."""
    device = _device(args)
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    return cfg, grid, dycfg, dom, make_driver(cfg, grid, dycfg, dom,
                                              device), device


def load_addi_ens(cfg, dirpath, device: torch.device):
    """The additive-inflation source ensemble in analysis variables on
    `device` (the INFL_ADD_IN_BASENAME read, common_mpi_scale.f90:
    1163-1202); None unless INFL_ADD > 0."""
    if cfg.letkf.infl_add <= 0:
        return None
    from scale_letkf_torch.io.checkpoint import load_ensemble
    from scale_letkf_torch.io.convert import dycore_state_to_torch
    from scale_letkf_torch.model.dycore import to_collocated
    from scale_letkf_torch.state import state_trans
    addi, _, _ = load_ensemble(dirpath,
                               basename=cfg.letkf.infl_add_in_basename)
    return state_trans(to_collocated(dycore_state_to_torch(addi, device)))


def _load_ens(path: str, device: torch.device, mesh=None):
    """(ensemble on `device`, deterministic member on `device` or None,
    aux, meta) of a checkpoint. On a grid spread over processes the
    ensemble is this process's blocks (a Sharded) from its own members'
    files alone, the reference's rank-addressed stage-in."""
    from scale_letkf_torch.io.checkpoint import (
        load_det, load_ensemble, manifest_members)
    from scale_letkf_torch.io.convert import dycore_state_to_torch
    from scale_letkf_torch.parallel.distributed import (
        ensemble_from_process_local)
    members = None
    if mesh is not None and mesh.world > 1:
        members = mesh.local_members(manifest_members(path))
    ens, aux, meta = load_ensemble(path, members=members)
    ens = dycore_state_to_torch(ens, device)
    if members is not None:
        ens = ensemble_from_process_local(mesh, ens)
    det = load_det(path)
    return (ens, None if det is None else dycore_state_to_torch(det, device),
            aux, meta)


def _load_state(path: str, driver):
    """One member file → its history fields on the driver's device."""
    from scale_letkf_torch.io.checkpoint import load_member
    from scale_letkf_torch.io.convert import dycore_state_to_torch
    from scale_letkf_torch.model.dycore import to_collocated
    from scale_letkf_torch.state import state_to_history, state_trans
    s = dycore_state_to_torch(load_member(path), driver.device)
    return state_to_history(state_trans(to_collocated(s)), driver.z_full,
                            driver.topo)


def read_obs_files(cfg, paths):
    """Observations of the files `paths`, each read in the format
    OBS_IN_FORMAT gives it in order (PREPBUFR past the list's end), or by
    its suffix (.radar, .h08)."""
    from scale_letkf_torch.obs import io as obsio
    from scale_letkf_torch.obs.types import Observations
    parts = []
    fmts = list(cfg.obsope.obs_in_format) + ["PREPBUFR"] * len(paths)
    for p, fmt in zip(paths, fmts):
        if fmt.upper() == "RADAR" or p.endswith(".radar"):
            parts.append(obsio.read_obs_radar(p))
        elif fmt.upper() == "HIMAWARI8" or p.endswith(".h08"):
            parts.append(obsio.read_obs_h08(p, cfg))
        else:
            parts.append(obsio.read_obs(p, cfg))
    return Observations.concatenate(parts)


def _print_stats(cfg, info, label=""):
    print(info["stats_gues"].format(f"O-B{label}"))
    print(info["stats_anal"].format(f"O-A{label}"))
    if cfg.monitor.departure_stat:
        # per-report-type × variable tables (monit_obs_mpi,
        # common_mpi_scale.f90:1481-1633)
        print(info["stats_gues_bytype"].format(f"O-B{label}"))
        print(info["stats_anal_bytype"].format(f"O-A{label}"))


def cmd_letkf(args):
    from scale_letkf_torch.da.obsope import assign_slots
    from scale_letkf_torch.io.checkpoint import (
        filename_replace_mem, load_history, manifest_members, save_ensemble)
    from scale_letkf_torch.obs import io as obsio
    cfg, grid, dycfg, dom, driver, device = _setup(args)
    ens, det, aux, meta = _load_ens(args.gues, device, driver.mesh)
    obs = read_obs_files(cfg, args.obs)
    precomputed = None
    if args.obsda:
        # OBSDA_IN path: per-member H(x) files from a separate obsope
        recs = [obsio.read_obs_da(filename_replace_mem(args.obsda, m),
                                  obs.nobs)
                for m in range(manifest_members(args.gues))]
        lev = (np.stack([r[4] for r in recs]).mean(axis=0)
               if len(recs[0]) > 4 else None)
        precomputed = (np.stack([r[2] for r in recs]),
                       np.stack([r[3] for r in recs]).max(axis=0), lev)
    # 4-D obsope: the per-slot history snapshots written by fcst
    hist = load_history(args.gues)
    ens_a, info = driver.analysis(
        ens, obs, infl_field=aux.get("infl"), det=det,
        precomputed_hx=precomputed,
        addi_ens=load_addi_ens(cfg, args.addi or args.gues, device),
        rng=np.random.default_rng(args.seed), hist_slots=hist,
        slots=assign_slots(obs.dif, cfg) if hist is not None else None)
    _print_stats(cfg, info)
    d = info["diag"]
    aux_out = {k: v for k, v in (("infl", d.infl_field),
                                 ("rtps", d.rtps_field),
                                 ("nobs", d.nobs_field)) if v is not None}
    # mean/spread outputs (GUES_SPRD_OUT/ANAL_SPRD_OUT semantics)
    for k in ("anal_mean", "anal_sprd", "gues_mean", "gues_sprd"):
        aux_out[k] = info[k]
    ens_a = _global(driver, ens_a)
    if not _writer():
        return
    save_ensemble(args.anal, ens_a, basename="anal.@@@@", aux=aux_out,
                  det=info["det"], meta={**meta, "step": "letkf"})
    if cfg.monitor.obsdep_out:
        base = f"{args.anal}/{cfg.monitor.obsdep_out_basename}"
        info["obsdep"].save(f"{base}.npz")
        info["obsdep"].save_binary(f"{base}.dat", dif=obs.dif)
    print(driver.timer.report())


def cmd_obsope(args):
    from scale_letkf_torch.da.obsope import (
        assign_slots, obsope_ensemble, obsope_slots)
    from scale_letkf_torch.io.checkpoint import (
        filename_replace_mem, load_history)
    from scale_letkf_torch.model.dycore import to_collocated
    from scale_letkf_torch.obs import io as obsio
    from scale_letkf_torch.obs.types import ID_H08IR
    from scale_letkf_torch.state import state_to_history, state_trans
    cfg, grid, dycfg, dom, driver, device = _setup(args)
    ens, _, _, _ = _load_ens(args.gues, device)
    obs = read_obs_files(cfg, args.obs)
    hist = load_history(args.gues)
    if hist is not None:
        # 4-D: each obs against its time slot's history snapshot
        hx = obsope_slots(hist, obs, grid, cfg, driver.z_full, driver.topo,
                          assign_slots(obs.dif, cfg))
    else:
        fields = state_to_history(state_trans(to_collocated(ens)),
                                  driver.z_full, driver.topo)
        hx = obsope_ensemble(fields, obs, grid, cfg, driver.z_full)
    ensval = hx.ensval.cpu().numpy()
    # the H08 build's trailing records: sensitive pressure, clear-sky BT
    has_h08 = bool(np.any(obs.elem == ID_H08IR))
    for m in range(ensval.shape[0]):
        obsio.write_obs_da(filename_replace_mem(args.out, m),
                           np.zeros(obs.nobs, np.int32),
                           np.arange(obs.nobs, dtype=np.int32),
                           ensval[m].astype(np.float32),
                           hx.qc.astype(np.int32),
                           lev=hx.lev if has_h08 else None,
                           val2=hx.val2 if has_h08 else None)
    print(f"obsope: {obs.nobs} obs x {ensval.shape[0]} members -> {args.out}")


def cmd_obsmake(args):
    from scale_letkf_torch.da.obsmake import obsmake
    from scale_letkf_torch.obs import io as obsio
    from scale_letkf_torch.obs.types import ID_H08IR, TYP_PHARAD
    cfg, grid, dycfg, dom, driver, device = _setup(args)
    fields = _load_state(args.nature, driver)
    template = read_obs_files(cfg, [args.obs_template])
    obs = obsmake(fields, template, grid, cfg, driver.z_full,
                  np.random.default_rng(args.seed))
    if obs.nobs and (obs.elem == ID_H08IR).all():
        obsio.write_obs_h08(args.out, obs)
    elif obs.nobs and (obs.typ == TYP_PHARAD).all():
        obsio.write_obs_radar(args.out, obs)
    else:
        obsio.write_obs(args.out, obs)
    print(f"obsmake: wrote {obs.nobs} obs -> {args.out}")


def cmd_obssim(args):
    from scale_letkf_torch.da.obssim import obssim, write_grads
    from scale_letkf_torch.obs.types import ELEM_UID, OBELM_NAMES
    cfg, grid, dycfg, dom, driver, device = _setup(args)
    name_to_id = {n.strip().upper(): e for n, e in zip(OBELM_NAMES, ELEM_UID)}
    elems = []
    for v in args.vars.split(","):
        key = v.strip().upper()
        if key not in name_to_id:
            sys.exit(f"error: unknown obssim variable '{v.strip()}' "
                     f"(valid: {', '.join(sorted(name_to_id))})")
        elems.append(name_to_id[key])
    radar = None
    if dom.get("radar_lon") is not None:
        radar = (dom["radar_lon"], dom.get("radar_lat"),
                 dom.get("radar_z", 0.0))
    out = obssim(_load_state(args.state, driver), elems, grid, cfg,
                 radar_lonlatz=radar)
    write_grads(args.out, [out[e] for e in elems if out[e].ndim == 3],
                [out[e] for e in elems if out[e].ndim == 2])
    print(f"obssim: wrote {len(elems)} vars -> {args.out}")


def cmd_pp(args):
    """Topography preprocessing (the scale-rm_pp_ens step): DEM raster →
    smoothed model-grid topography, written as an npz (key 'topo') for the
    [domain] topo_file key. The smoothing runs on --device."""
    from scale_letkf_torch.model.topo import prepare_topo, read_dem
    device = _device(args)
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    dem_kw = {}
    if args.dem_geometry:
        nlon, nlat, lon0, dlon, lat0, dlat = \
            [float(v) for v in args.dem_geometry.split(",")]
        dem_kw = dict(nlon=int(nlon), nlat=int(nlat), lon0=lon0, dlon=dlon,
                      lat0=lat0, dlat=dlat)
    elev, dlons, dlats = read_dem(args.dem, **dem_kw)
    topo, passes = prepare_topo(elev, dlons, dlats, grid,
                                max_slope_ratio=args.max_slope_ratio,
                                device=device)
    np.savez(args.out, topo=topo)
    print(f"pp: topo {topo.shape} min={topo.min():.1f} max={topo.max():.1f} "
          f"({passes} smoothing passes on {device}) -> {args.out}")


def cmd_fcst(args):
    from scale_letkf_torch.io.checkpoint import save_ensemble, save_history
    device = _device(args)
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    driver = make_driver(cfg, grid, dycfg, dom, device)
    ens, det, aux, meta = _load_ens(args.init, device, driver.mesh)
    slot_steps = slot_steps_from_cfg(cfg, args.steps, dycfg.dt)
    hist = None
    if slot_steps is not None:
        # 4-D window: per-slot history snapshots beside the gues
        ens, hist = driver.forecast_slots(ens, args.steps, slot_steps)
    else:
        ens = driver.forecast(ens, args.steps)
    if det is not None:
        det = driver.forecast_one(det, args.steps)
    ens = _global(driver, ens)
    if not _writer():
        return
    save_ensemble(args.out, ens, basename="gues.@@@@", aux=aux, det=det,
                  meta={**meta, "step": "fcst", "steps": args.steps})
    if hist is not None:
        save_history(args.out, hist,
                     slot_ids=list(range(cfg.obsope.slot_start,
                                         cfg.obsope.slot_end + 1)))
        print(f"fcst: wrote {hist.shape[1]} history slots")
    print(f"fcst: {args.steps} steps -> {args.out} (device {device}, "
          f"member batch {driver.batch})")
    print(driver.timer.report())


def _cycle_streamed(args, cfg, dom, driver):
    """cycle --streamed: the member-streamed executor (da/bigcycle.py),
    the ensemble in host memory, the slab skin temperature resumed from
    and saved to the checkpoint's aux; with a [process] table each member
    batch forecast on the driver's grid, in this one process."""
    from scale_letkf_torch.da.bigcycle import StreamedCycle, phase_table
    from scale_letkf_torch.io.checkpoint import (
        load_det, load_ensemble, save_ensemble)
    if ("nest" in dom or load_det(args.init) is not None
            or cfg.letkf.infl_add > 0):
        sys.exit("error: --streamed does not combine with [nest], "
                 "DET_RUN, or additive inflation yet")
    if driver.mesh is not None and driver.mesh.world > 1:
        sys.exit(f"error: --streamed runs in one process; the [process] "
                 f"grid spreads over {driver.mesh.world} (run cycle without "
                 f"--streamed there, or --streamed without --num-processes)")
    ens_host, aux, _ = load_ensemble(args.init)
    sc = StreamedCycle(driver, member_batch=args.member_batch,
                       tile_rows=args.tile_rows, pipeline=args.pipeline)
    if "tsfc" in aux:
        sc.tsfc_host = np.asarray(aux["tsfc"], np.float32)
    infl = aux.get("infl")
    for c in range(args.cycles):
        obs = read_obs_files(cfg, [args.obs_pattern.format(cycle=c)])
        ens_host, infl, rep = sc.cycle(ens_host, obs, args.steps_per_cycle,
                                       infl_field=infl)
        print(f"=== cycle {c} ===")
        print(rep["stats_gues"].format("O-B"))
        if "stats_anal" in rep:
            print(rep["stats_anal"].format("O-A"))
        print(phase_table(rep))
    aux_out = {"infl": infl} if infl is not None else {}
    if sc.tsfc_host is not None:
        aux_out["tsfc"] = sc.tsfc_host
    save_ensemble(args.out, ens_host, basename="anal.@@@@", aux=aux_out,
                  meta={"cycles": args.cycles, "streamed": True})


def _cycle_nested(args, cfg, grid, dycfg, dom, driver, device, ens, aux):
    """cycle with a [nest] section: the parent and the one-way nested
    child (nested.py) each cycle, the child over the same window at its
    own dt, its inflation threaded; the child saved under OUT/nest. ens:
    the parent's initial ensemble in a one-slot list, handed over. On a
    grid each process reads its own child members, and process 0 writes
    both gathered ensembles."""
    import os

    from scale_letkf_torch.io.checkpoint import save_ensemble
    child, geom, nested_driver = make_nested(cfg, grid, dycfg, dom, device)
    nested = nested_driver(driver, child, geom)
    steps_child = int(round(args.steps_per_cycle * dycfg.dt
                            / child.dycfg.dt))
    c_ens, _, c_aux, _ = _load_ens(args.nest_init, device, child.mesh)
    infl, c_infl = aux.get("infl"), c_aux.get("infl")
    # one-slot lists: pop() hands each ensemble to the cycle
    c_ens = [c_ens]
    for c in range(args.cycles):
        obs = read_obs_files(cfg, [args.obs_pattern.format(cycle=c)])
        c_obs = read_obs_files(cfg, [args.nest_obs_pattern.format(cycle=c)])
        p_anal, c_anal, ninfo = nested.cycle(
            ens.pop(), c_ens.pop(), obs, c_obs, args.steps_per_cycle,
            steps_child, infl_p=infl, infl_c=c_infl)
        ens.append(p_anal)
        c_ens.append(c_anal)
        del p_anal, c_anal
        info, c_info = ninfo["parent"], ninfo["child"]
        if info["diag"].infl_field is not None:
            infl = info["diag"].infl_field
        if c_info["diag"].infl_field is not None:
            c_infl = c_info["diag"].infl_field
        print(f"=== cycle {c} ===")
        print(info["stats_gues"].format("O-B"))
        print(info["stats_anal"].format("O-A"))
        print(c_info["stats_gues"].format("nest O-B"))
        print(c_info["stats_anal"].format("nest O-A"))
        del ninfo, info, c_info
    aux_out = {"infl": infl} if infl is not None else {}
    if driver.tsfc is not None:
        aux_out["tsfc"] = _global(driver, driver.tsfc)
    ens, c_ens = _global(driver, ens.pop()), _global(child, c_ens.pop())
    if _writer():
        save_ensemble(args.out, ens, basename="anal.@@@@", aux=aux_out,
                      meta={"cycles": args.cycles})
        save_ensemble(os.path.join(args.out, "nest"), c_ens,
                      basename="anal.@@@@",
                      aux={"infl": c_infl} if c_infl is not None else {},
                      meta={"cycles": args.cycles, "nest": True})
    print(driver.timer.report())


def cmd_cycle(args):
    from scale_letkf_torch.da.obsope import assign_slots
    from scale_letkf_torch.io.checkpoint import save_ensemble
    cfg, grid, dycfg, dom, driver, device = _setup(args)
    if args.streamed:
        return _cycle_streamed(args, cfg, dom, driver)
    # DET_RUN_CYCLED: a deterministic member in the initial checkpoint is
    # forecast and analysed (transmd weights) every cycle
    ens, det, aux, _ = _load_ens(args.init, device, driver.mesh)
    addi = load_addi_ens(cfg, args.init, device)
    # the one reference to the ensemble; pop() hands it to the step, which
    # frees it once the next one exists (CycleDriver.run_osse does the same)
    ens = [ens]
    if "nest" in dom:
        if not (args.nest_init and args.nest_obs_pattern):
            sys.exit("error: config has a [nest] section — pass both "
                     "--nest-init and --nest-obs-pattern (or remove [nest])")
        if (det is not None or addi is not None
                or slot_steps_from_cfg(cfg, args.steps_per_cycle,
                                       dycfg.dt) is not None):
            sys.exit("error: nested cycling does not combine with DET_RUN, "
                     "4-D slots, or additive inflation yet")
        if "tsfc" in aux:
            driver.tsfc = _resume_tsfc(driver, aux["tsfc"], device)
        return _cycle_nested(args, cfg, grid, dycfg, dom, driver, device,
                             ens, aux)
    rng = np.random.default_rng(0)
    if "tsfc" in aux:
        # resume the persisted slab skin temperature (physics-suite runs)
        driver.tsfc = _resume_tsfc(driver, aux["tsfc"], device)
    infl = aux.get("infl")
    slot_steps = slot_steps_from_cfg(cfg, args.steps_per_cycle, dycfg.dt)
    for c in range(args.cycles):
        hist = None
        if slot_steps is not None:
            fc, hist = driver.forecast_slots(ens.pop(), args.steps_per_cycle,
                                             slot_steps)
            ens.append(fc)
            del fc
        else:
            ens.append(driver.forecast(ens.pop(), args.steps_per_cycle))
        if det is not None:
            det = driver.forecast_one(det, args.steps_per_cycle)
        obs = read_obs_files(cfg, [args.obs_pattern.format(cycle=c)])
        anal, info = driver.analysis(
            ens.pop(), obs, infl_field=infl, det=det, addi_ens=addi, rng=rng,
            hist_slots=hist,
            slots=assign_slots(obs.dif, cfg) if hist is not None else None)
        ens.append(anal)
        del anal
        if det is not None:
            det = info["det"]
        if info["diag"].infl_field is not None:
            infl = info["diag"].infl_field
        print(f"=== cycle {c} ===")
        _print_stats(cfg, info)
        del info, hist
    aux_out = {"infl": infl} if infl is not None else {}
    if driver.tsfc is not None:
        aux_out["tsfc"] = _global(driver, driver.tsfc)
    ens = _global(driver, ens.pop())
    if _writer():
        save_ensemble(args.out, ens, basename="anal.@@@@", aux=aux_out,
                      det=det, meta={"cycles": args.cycles})
    print(driver.timer.report())


def _add_device(q):
    q.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (the hand-written kernels; "
                        "fails without a GPU) or 'cpu' (their plain "
                        "versions)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="scale_letkf_torch")
    # the multi-process runtime (the reference's MPI launcher layer,
    # common_mpi_scale.f90:367-512), given BEFORE the verb:
    #   python -m scale_letkf_torch --coordinator host:1234 \
    #       --num-processes 4 --process-id $RANK cycle ...
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0; starts torch.distributed "
                        "so that the [process] grid spans every process")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--local-device-count", type=int, default=None,
                   help="grid blocks each process holds (1 when omitted): "
                        "several blocks may share one device")
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("letkf", help="LETKF analysis step")
    q.add_argument("--config", required=True)
    q.add_argument("--gues", required=True)
    q.add_argument("--obs", nargs="+", required=True)
    q.add_argument("--anal", required=True)
    q.add_argument("--obsda", default=None,
                   help="read precomputed H(x) files (basename with @@@@)")
    q.add_argument("--addi", default=None,
                   help="directory with the additive-inflation ensemble "
                        "(INFL_ADD_IN_BASENAME files; default: --gues dir)")
    q.add_argument("--seed", type=int, default=0,
                   help="RNG seed (INFL_ADD_SHUFFLE)")
    _add_device(q)
    q.set_defaults(fn=cmd_letkf)

    q = sub.add_parser("obsope", help="observation operator")
    q.add_argument("--config", required=True)
    q.add_argument("--gues", required=True)
    q.add_argument("--obs", nargs="+", required=True)
    q.add_argument("--out", required=True)
    _add_device(q)
    q.set_defaults(fn=cmd_obsope)

    q = sub.add_parser("obsmake", help="synthetic obs from a nature run")
    q.add_argument("--config", required=True)
    q.add_argument("--nature", required=True)
    q.add_argument("--obs-template", required=True)
    q.add_argument("--out", required=True)
    q.add_argument("--seed", type=int, default=0)
    _add_device(q)
    q.set_defaults(fn=cmd_obsmake)

    q = sub.add_parser("obssim", help="simulate obs fields on the model grid")
    q.add_argument("--config", required=True)
    q.add_argument("--state", required=True)
    q.add_argument("--vars", required=True, help="e.g. REF,Vr,T")
    q.add_argument("--out", required=True)
    _add_device(q)
    q.set_defaults(fn=cmd_obssim)

    q = sub.add_parser("pp", help="topography preprocessing (scale-rm_pp)")
    q.add_argument("--config", required=True)
    q.add_argument("--dem", required=True,
                   help="DEM raster: .npz (elev/lon/lat) or flat binary")
    q.add_argument("--dem-geometry", default=None,
                   help="flat binary geometry: nlon,nlat,lon0,dlon,lat0,dlat")
    q.add_argument("--max-slope-ratio", type=float, default=0.5)
    q.add_argument("--out", required=True)
    _add_device(q)
    q.set_defaults(fn=cmd_pp)

    q = sub.add_parser("fcst", help="ensemble forecast")
    q.add_argument("--config", required=True)
    q.add_argument("--init", required=True)
    q.add_argument("--steps", type=int, required=True)
    q.add_argument("--out", required=True)
    _add_device(q)
    q.set_defaults(fn=cmd_fcst)

    q = sub.add_parser("cycle", help="cycling DA")
    q.add_argument("--config", required=True)
    q.add_argument("--init", required=True)
    q.add_argument("--cycles", type=int, required=True)
    q.add_argument("--steps-per-cycle", type=int, required=True)
    q.add_argument("--obs-pattern", required=True,
                   help="per-cycle obs path, e.g. obs/cycle{cycle}.dat")
    q.add_argument("--out", required=True)
    q.add_argument("--nest-init", default=None,
                   help="child-domain initial ensemble ([nest] section)")
    q.add_argument("--nest-obs-pattern", default=None,
                   help="per-cycle child-domain obs path, e.g. "
                        "obs/nest{cycle}.dat ([nest] section)")
    q.add_argument("--streamed", action="store_true",
                   help="member-streamed executor (da/bigcycle.py): the "
                        "ensemble in host memory, member batches and "
                        "analysis row tiles through the device")
    q.add_argument("--member-batch", type=int, default=5,
                   help="--streamed: members per device batch (rounded "
                        "down to a divisor of K)")
    q.add_argument("--tile-rows", type=int, default=24,
                   help="--streamed: row-tile height of the tiled analysis")
    q.add_argument("--pipeline", action="store_true",
                   help="--streamed: overlap the next batch's or tile's "
                        "upload with the current one's work")
    _add_device(q)
    q.set_defaults(fn=cmd_cycle)

    args = p.parse_args(argv)
    if not args.coordinator:
        return args.fn(args)
    import torch.distributed as dist

    from scale_letkf_torch.parallel.distributed import init_distributed
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     args.local_device_count,
                     backend="nccl" if args.device == "cuda" else "gloo")
    try:
        return args.fn(args)
    finally:
        dist.destroy_process_group()
