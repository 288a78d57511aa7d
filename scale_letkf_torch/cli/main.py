"""Command-line programs of the port (the reference's executable layer):

  python -m scale_letkf_torch fcst --config c.toml --init DIR --steps N \\
      --out DIR [--device cuda|cpu]

Port of scale_letkf_tpu/cli/main.py: the experiment loader, the forecast
driver factory and the `fcst` verb. States are checkpoint directories in
the reference's format (io/checkpoint.py), so either package's output
loads in the other. The other verbs (letkf, obsope, obsmake, obssim, pp,
cycle) come with the modules they drive.
"""

from __future__ import annotations

import argparse
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
    return CycleDriver(grid, dycfg, rho_ref, p_ref,
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


def cmd_fcst(args):
    from scale_letkf_torch.io.checkpoint import (
        load_det, load_ensemble, save_ensemble, save_history)
    from scale_letkf_torch.io.convert import dycore_state_to_torch
    from scale_letkf_torch.utils.device import require_cuda
    device = (require_cuda() if args.device == "cuda"
              else torch.device(args.device))
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


def main(argv=None):
    p = argparse.ArgumentParser(prog="scale_letkf_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    q = sub.add_parser("fcst", help="ensemble forecast")
    q.add_argument("--config", required=True)
    q.add_argument("--init", required=True)
    q.add_argument("--steps", type=int, required=True)
    q.add_argument("--out", required=True)
    q.add_argument("--device", default="cuda",
                   help="torch device of the forecast: 'cuda' (the "
                        "hand-written kernels; fails without a GPU) or "
                        "'cpu' (their plain versions)")
    q.set_defaults(fn=cmd_fcst)
    args = p.parse_args(argv)
    args.fn(args)
