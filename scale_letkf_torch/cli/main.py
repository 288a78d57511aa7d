"""Command-line programs of the port (the reference's executable layer):

  python -m scale_letkf_torch letkf   --config c.toml --gues DIR --obs F --anal DIR
  python -m scale_letkf_torch obsope  --config c.toml --gues DIR --obs F --out F
  python -m scale_letkf_torch obsmake --config c.toml --nature F --obs-template F --out F
  python -m scale_letkf_torch obssim  --config c.toml --state F --vars REF,VR --out F
  python -m scale_letkf_torch fcst    --config c.toml --init DIR --steps N --out DIR
  python -m scale_letkf_torch cycle   --config c.toml --init DIR --cycles N ...

each with --device cuda (the default: the hand-written kernels, and an
error without a GPU) or cpu (their plain versions).

Port of scale_letkf_tpu/cli/main.py: the experiment loader, the driver
factory and the verbs, with the reference's arguments. States are
checkpoint directories in the reference's format (io/checkpoint.py) and obs
the reference's binary formats (obs/io.py), so either package's output
loads in the other. Not ported yet, each raising NotImplementedError that
names its ROADMAP item: the `pp` verb (terrain), `cycle --streamed` (the
full-size executors), a [nest] section (nesting), additive inflation
(INFL_ADD > 0) and a deterministic member in the checkpoint of `letkf` or
`cycle`.
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
    and its substeps. topo_file, bdy_file, [physics] and a mesh raise
    NotImplementedError (CycleDriver names the ROADMAP item)."""
    from scale_letkf_torch.cycle import CycleDriver
    from scale_letkf_torch.model.ideal import balanced_state
    qv0 = dom.get("qv_surface", 0.0)
    qv_prof = (qv0 * np.exp(-grid.cz / dom.get("qv_scale_height", 3000.0))
               if qv0 > 0 else None)
    # one column: only the reference profiles are kept
    _, rho_ref, p_ref = balanced_state(
        grid.nz, 1, 1, float(grid.fz[1] - grid.fz[0]), qv_prof=qv_prof,
        cz=grid.cz, device=device)
    topo = np.load(dom["topo_file"])["topo"] if dom.get("topo_file") else None
    pc = cfg.process
    mesh = (pc.mesh_member, pc.mesh_y, pc.mesh_x) \
        if pc.mesh_member * pc.mesh_y * pc.mesh_x > 1 else None
    return CycleDriver(grid, cfg, dycfg, rho_ref, p_ref,
                       use_physics=dom.get("use_physics", False),
                       topo=topo, phys_cfg=dom.get("physics"), mesh=mesh,
                       core=dom.get("core", "explicit"),
                       n_small=dom.get("n_small", 6),
                       bdy=dom.get("bdy_file") or None)


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
    from scale_letkf_torch.utils.device import require_cuda
    return (require_cuda() if args.device == "cuda"
            else torch.device(args.device))


def _setup(args):
    """(cfg, grid, dycfg, dom, driver, device) of a verb's --config and
    --device."""
    device = _device(args)
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    return cfg, grid, dycfg, dom, make_driver(cfg, grid, dycfg, dom,
                                              device), device


def _no_additive_inflation(cfg, addi):
    if cfg.letkf.infl_add > 0 or addi:
        raise NotImplementedError(
            "additive inflation (INFL_ADD > 0, load_addi_ens, "
            "da/inflation.py) is not ported yet (ROADMAP queue 1, the "
            "deterministic member and da/inflation.py)")


def _load_ens(path: str, device: torch.device):
    """(ensemble on `device`, aux, meta) of a checkpoint that holds no
    deterministic member."""
    from scale_letkf_torch.io.checkpoint import load_det, load_ensemble
    from scale_letkf_torch.io.convert import dycore_state_to_torch
    if load_det(path) is not None:
        raise NotImplementedError(
            f"{path} holds a deterministic member (DET_RUN): its analysis "
            f"is not ported yet (ROADMAP queue 1, the deterministic member "
            f"and da/inflation.py)")
    ens, aux, meta = load_ensemble(path)
    return dycore_state_to_torch(ens, device), aux, meta


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
        filename_replace_mem, load_history, save_ensemble)
    from scale_letkf_torch.obs import io as obsio
    cfg, grid, dycfg, dom, driver, device = _setup(args)
    _no_additive_inflation(cfg, args.addi)
    ens, aux, meta = _load_ens(args.gues, device)
    obs = read_obs_files(cfg, args.obs)
    precomputed = None
    if args.obsda:
        # OBSDA_IN path: per-member H(x) files from a separate obsope
        recs = [obsio.read_obs_da(filename_replace_mem(args.obsda, m),
                                  obs.nobs)
                for m in range(ens.rho.shape[0])]
        lev = (np.stack([r[4] for r in recs]).mean(axis=0)
               if len(recs[0]) > 4 else None)
        precomputed = (np.stack([r[2] for r in recs]),
                       np.stack([r[3] for r in recs]).max(axis=0), lev)
    # 4-D obsope: the per-slot history snapshots written by fcst
    hist = load_history(args.gues)
    ens_a, info = driver.analysis(
        ens, obs, infl_field=aux.get("infl"), precomputed_hx=precomputed,
        hist_slots=hist,
        slots=assign_slots(obs.dif, cfg) if hist is not None else None)
    _print_stats(cfg, info)
    d = info["diag"]
    aux_out = {k: v for k, v in (("infl", d.infl_field),
                                 ("rtps", d.rtps_field),
                                 ("nobs", d.nobs_field)) if v is not None}
    # mean/spread outputs (GUES_SPRD_OUT/ANAL_SPRD_OUT semantics)
    for k in ("anal_mean", "anal_sprd", "gues_mean", "gues_sprd"):
        aux_out[k] = info[k]
    save_ensemble(args.anal, ens_a, basename="anal.@@@@", aux=aux_out,
                  meta={**meta, "step": "letkf"})
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
    from scale_letkf_torch.state import state_to_history, state_trans
    cfg, grid, dycfg, dom, driver, device = _setup(args)
    ens, _, _ = _load_ens(args.gues, device)
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
    for m in range(ensval.shape[0]):
        obsio.write_obs_da(filename_replace_mem(args.out, m),
                           np.zeros(obs.nobs, np.int32),
                           np.arange(obs.nobs, dtype=np.int32),
                           ensval[m].astype(np.float32),
                           hx.qc.astype(np.int32))
    print(f"obsope: {obs.nobs} obs x {ensval.shape[0]} members -> {args.out}")


def cmd_obsmake(args):
    from scale_letkf_torch.da.obsmake import obsmake
    from scale_letkf_torch.obs import io as obsio
    from scale_letkf_torch.obs.types import TYP_PHARAD
    cfg, grid, dycfg, dom, driver, device = _setup(args)
    fields = _load_state(args.nature, driver)
    template = read_obs_files(cfg, [args.obs_template])
    obs = obsmake(fields, template, grid, cfg, driver.z_full,
                  np.random.default_rng(args.seed))
    if obs.nobs and (obs.typ == TYP_PHARAD).all():
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


def cmd_fcst(args):
    from scale_letkf_torch.io.checkpoint import (
        load_det, load_ensemble, save_ensemble, save_history)
    from scale_letkf_torch.io.convert import dycore_state_to_torch
    device = _device(args)
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    driver = make_driver(cfg, grid, dycfg, dom, device)
    ens, aux, meta = load_ensemble(args.init)
    ens = dycore_state_to_torch(ens, device)
    det = load_det(args.init)
    slot_steps = slot_steps_from_cfg(cfg, args.steps, dycfg.dt)
    hist = None
    if slot_steps is not None:
        # 4-D window: per-slot history snapshots beside the gues
        ens, hist = driver.forecast_slots(ens, args.steps, slot_steps)
    else:
        ens = driver.forecast(ens, args.steps)
    if det is not None:
        det = driver.forecast_one(dycore_state_to_torch(det, device),
                                  args.steps)
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


def cmd_cycle(args):
    from scale_letkf_torch.da.obsope import assign_slots
    from scale_letkf_torch.io.checkpoint import save_ensemble
    if args.streamed:
        raise NotImplementedError(
            "cycle --streamed (the member-streamed executor, "
            "da/bigcycle.py) is not ported yet (ROADMAP queue 1, the "
            "full-size executors)")
    cfg, grid, dycfg, dom, driver, device = _setup(args)
    if "nest" in dom or args.nest_init or args.nest_obs_pattern:
        raise NotImplementedError(
            "a [nest] section (one-way nesting, model/nesting.py, nested.py) "
            "is not ported yet (ROADMAP queue 1, nesting and EFSO)")
    _no_additive_inflation(cfg, None)
    ens, aux, _ = _load_ens(args.init, device)
    if "tsfc" in aux:
        raise NotImplementedError(
            "a persisted slab skin temperature (tsfc, physics suite) is not "
            "ported yet (ROADMAP queue 1, physics)")
    infl = aux.get("infl")
    slot_steps = slot_steps_from_cfg(cfg, args.steps_per_cycle, dycfg.dt)
    # the one reference to the ensemble; pop() hands it to the step, which
    # frees it once the next one exists (CycleDriver.run_osse does the same)
    ens = [ens]
    for c in range(args.cycles):
        hist = None
        if slot_steps is not None:
            fc, hist = driver.forecast_slots(ens.pop(), args.steps_per_cycle,
                                             slot_steps)
            ens.append(fc)
            del fc
        else:
            ens.append(driver.forecast(ens.pop(), args.steps_per_cycle))
        obs = read_obs_files(cfg, [args.obs_pattern.format(cycle=c)])
        anal, info = driver.analysis(
            ens.pop(), obs, infl_field=infl, hist_slots=hist,
            slots=assign_slots(obs.dif, cfg) if hist is not None else None)
        ens.append(anal)
        del anal
        if info["diag"].infl_field is not None:
            infl = info["diag"].infl_field
        print(f"=== cycle {c} ===")
        _print_stats(cfg, info)
        del info, hist
    save_ensemble(args.out, ens.pop(), basename="anal.@@@@",
                  aux={"infl": infl} if infl is not None else {},
                  meta={"cycles": args.cycles})
    print(driver.timer.report())


def _add_device(q):
    q.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (the hand-written kernels; "
                        "fails without a GPU) or 'cpu' (their plain "
                        "versions)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="scale_letkf_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("letkf", help="LETKF analysis step")
    q.add_argument("--config", required=True)
    q.add_argument("--gues", required=True)
    q.add_argument("--obs", nargs="+", required=True)
    q.add_argument("--anal", required=True)
    q.add_argument("--obsda", default=None,
                   help="read precomputed H(x) files (basename with @@@@)")
    q.add_argument("--addi", default=None,
                   help="additive-inflation ensemble directory (not ported; "
                        "raises)")
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
                   help="child-domain initial ensemble (nesting; not "
                        "ported, raises)")
    q.add_argument("--nest-obs-pattern", default=None,
                   help="per-cycle child-domain obs path (nesting; not "
                        "ported, raises)")
    q.add_argument("--streamed", action="store_true",
                   help="member-streamed executor (not ported; raises)")
    _add_device(q)
    q.set_defaults(fn=cmd_cycle)

    args = p.parse_args(argv)
    args.fn(args)
