"""Entry: the ensemble forecast of a limited-area deployment over terrain
(scale_letkf_torch/cycle.py CycleDriver.forecast, the CycleDriver that
cli/main.py make_driver builds from the configuration): the split-explicit
steps with the terrain-following slow tendency, the Davies relaxation
toward the boundary data after each, and the physics suite after every
phys_interval of them, the members in CycleDriver's batches.

Inputs from the seed: the topography and the boundary data, written as the
configuration's topo_file and bdy_file beside the TOML the harness writes,
and the ensemble on the device. A unit is one forecast of `steps` steps of
every member, from steps·dt·unit on the boundary data's clock, on the
ensemble the last unit left; CycleDriver carries the slab skin temperature
from unit to unit, and `start` clears it, so the window's first unit
cold-starts it as the reference does.

Compared after the window, for the window's first unit (its inputs made
again from the seed): `forecast`, the ensemble mean of every restart field
at every point; `members`, the first and the last member (in different
member batches) at every point; `tsfc`, every member's skin temperature
after the unit; each against the reference's forecast of the same inputs
(benchmark/reference/regional.py), in member blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import compare as C
from benchmark import inputs_regional as RI
from benchmark import roofline as R
from benchmark import roofline_terrain as RT
from benchmark.reference import model as M
from benchmark.reference import regional as RG
from benchmark.reference import suite as S
from benchmark.reference import terrain as T

MEMBER_BATCH = 10         # members the reference forecasts at once


def settings(ctx) -> dict:
    """The configuration's settings the reference needs (the program's
    defaults where the file is silent)."""
    dom = ctx.dom
    col = M.column_of(dom)
    return {"K": ctx.raw["ensemble"]["member"],
            "steps": int(ctx.traffic["steps"]), "col": col,
            "suite": S.settings(dom.get("physics", {})),
            "phys_interval": int(dom.get("phys_interval", 5)),
            "dz_phys": float(col.fz[1] - col.fz[0]),
            "bdy_width": int(dom.get("bdy_width", 0)),
            "bdy_tau": float(dom.get("bdy_tau", 300.0))}


def ensemble(ctx, K: int) -> M.State:
    tr = ctx.traffic
    return RI.ensemble(ctx.seed, K, ctx.dom, ctx.device, tr["u0"],
                       tr["amp_theta"], tr["rh_max"], tr.get("cloud"))


def fields(s) -> dict:
    """The restart fields of a state (K leading), the tracers each a field
    of its own."""
    out = {n: getattr(s, n) for n in C.RESTART[:5]}
    for q in range(M.NQ):
        out[f"rhoq{q}"] = s.rhoq[:, q]
    return out


def add_members(acc: dict, s) -> dict:
    """acc plus every member of s, field by field, in float64."""
    for n, f in fields(s).items():
        a = acc.setdefault(n, torch.zeros(f.shape[1:], dtype=torch.float64,
                                          device=f.device))
        for k in range(f.shape[0]):
            a += f[k]
    return acc


class Inputs:
    """What the benchmark makes from the seed, without the program."""

    def __init__(self, ctx):
        dom, tr = ctx.dom, ctx.traffic
        self.ctx, self.s = ctx, settings(ctx)
        self.topo = RI.topography(ctx.seed, dom["ny"], dom["nx"],
                                  tr["hill_max_m"], int(tr["hills"]),
                                  int(tr["hill_taper_cells"]))

    def boundary(self, device) -> RG.Boundary:
        ctx, tr = self.ctx, self.ctx.traffic
        return RI.boundary(ctx.seed, ctx.dom, device, tr["u0"], tr["bdy_u"],
                           tr["bdy_theta"], tr["rh_max"], tr["bdy_seconds"])

    def files(self, device) -> dict:
        """The topography and the boundary data as the program's files
        (npz: 'topo'; b0_*, b1_*, t0, t1), beside the configuration's
        TOML; the [domain] keys that name them."""
        base = self.ctx.config_path.with_suffix("")
        topo, bdy = f"{base}.topo.npz", f"{base}.bdy.npz"
        np.savez(topo, topo=self.topo)
        b = self.boundary(device)
        arrs = {f"{tag}_{n}": f.cpu().numpy()
                for tag, st in (("b0", b.state0), ("b1", b.state1))
                for n, f in zip(M.State._fields, st)}
        np.savez(bdy, t0=b.t0, t1=b.t1, **arrs)
        return {"topo_file": topo, "bdy_file": bdy}


class Unit:
    """The program's side: the configuration's CycleDriver."""

    def __init__(self, ctx):
        from scale_letkf_torch.cli.main import (
            load_config_and_grid, make_driver)
        from scale_letkf_torch.utils.timing import EventTimer, Timer
        self.ctx, self.dev = ctx, ctx.device
        self.inp = Inputs(ctx)
        cfg, grid, dycfg, dom = load_config_and_grid(
            str(ctx.config_path), self.inp.files(self.dev))
        self.driver = make_driver(cfg, grid, dycfg, dom, self.dev)
        if self.driver.phys_interval != self.inp.s["phys_interval"]:
            raise SystemExit(f"the program runs physics every "
                             f"{self.driver.phys_interval} steps, the "
                             f"configuration every "
                             f"{self.inp.s['phys_interval']}")
        # a traced run times the sections on the device's clock;
        # CycleDriver's own Timer would synchronise at every one
        self.driver.timer = (EventTimer(self.dev) if ctx.trace
                             else Timer(self.dev, enabled=False))
        self.K, self.grid = cfg.ensemble.member, grid
        self.work = 1.0
        self.kept = None

    def start(self):
        from scale_letkf_torch.model.dycore import DycoreState
        self.ens = [DycoreState(*ensemble(self.ctx, self.K))]
        self.driver.tsfc = None

    def step(self, i: int):
        s = self.inp.s
        t0 = i * s["steps"] * s["col"].dt
        self.ens.append(self.driver.forecast(self.ens.pop(), s["steps"],
                                             t0=t0))

    def keep(self):
        e = self.ens[0]
        self.kept = {"mean": {n: a / self.K for n, a in
                              add_members({}, e).items()},
                     "members": {k: {n: f[k].clone() for n, f in
                                     fields(e).items()}
                                 for k in (0, self.K - 1)},
                     "tsfc": self.driver.tsfc.clone()}

    def reset_spans(self):
        t = self.driver.timer
        if hasattr(t, "settle"):
            t.settle()
        t.records.clear()
        t.counts.clear()

    def spans(self) -> dict:
        t = self.driver.timer
        if hasattr(t, "settle"):
            t.settle()
        return dict(t.records)

    def bounds(self, units: int) -> dict:
        """The unit's least time (roofline.si_step_bytes a member-step
        with the physics, the relaxation's bytes; the metrics and the
        boundary target once a member batch and step), and the member
        batches a unit (CycleDriver.batch's count, passed on here)."""
        g, s = self.grid, self.inp.s
        batches = -(-self.K // self.driver.batch)
        w = s["bdy_width"]
        member = (R.si_step_bytes(g.nz, g.ny, g.nx, s["col"].n_small,
                                  s["phys_interval"])
                  + RT.relaxation_bytes(g.nz, g.ny, g.nx, w))
        batch = (3 * RT.metric_bytes(g.nz, g.ny, g.nx)
                 + RT.target_bytes(g.nz, g.ny, g.nx, w))
        nbytes = s["steps"] * (self.K * member + batches * batch)
        return {"step": units * nbytes / R.HBM_BYTES_PER_S,
                "member_batches": float(batches)}

    def release(self):
        kept, inp = self.kept, self.inp
        self.__dict__.clear()
        self.kept, self.inp = kept, inp


def reference(ctx, inp: Inputs, kept: dict | None = None,
              control: str | None = None, units: int = 1) -> dict:
    """The reference's answers after the window's first `units` units (a
    run compares the first): the ensemble mean, the first and the last
    member and every member's skin temperature after `units` chained
    forecasts of `steps` steps from the seed's inputs, each from
    steps·dt·unit on the boundary clock with the last one's skin
    temperature. control 'bf16' or 'both' holds the state and the skin
    temperature in bfloat16 (the forecast computed in float32, rounded
    after every step and physics step)."""
    s, dom, dev = inp.s, ctx.dom, ctx.device
    K, col = s["K"], s["col"]
    store = torch.bfloat16 if control in ("bf16", "both") else None
    setup = RG.Setup(
        col=col, metrics=T.metrics(torch.as_tensor(inp.topo, device=dev),
                                   col),
        bdy=inp.boundary(dev) if s["bdy_width"] > 0 else None,
        w=RG.weight(dom["ny"], dom["nx"], s["bdy_width"], s["bdy_tau"], dev),
        suite=s["suite"], phys_interval=s["phys_interval"],
        dz_phys=s["dz_phys"])
    e0 = ensemble(ctx, K)
    acc, members = {}, {}
    tsfc = torch.empty((K, dom["ny"], dom["nx"]), dtype=torch.float32,
                       device=dev)
    for b0 in range(0, K, MEMBER_BATCH):
        b1 = min(K, b0 + MEMBER_BATCH)
        out, skin = M.State(*(f[b0:b1] for f in e0)), None
        for u in range(units):
            out, skin = RG.forecast(out, setup, s["steps"],
                                    u * s["steps"] * col.dt, dev, tsfc=skin,
                                    store=store)
        tsfc[b0:b1] = skin
        add_members(acc, out)
        for k in (0, K - 1):
            if b0 <= k < b1:
                members[k] = {n: f[k - b0].clone()
                              for n, f in fields(out).items()}
        del out
    return {"mean": {n: a / K for n, a in acc.items()}, "members": members,
            "tsfc": tsfc}


def compare(prog: dict, ref: dict) -> dict:
    """`forecast`, `members` (the worse of the two) and `tsfc`, each gap
    over the reference's variation: each field's, each tracer's own,
    deviations from its levels' horizontal means (the skin temperature's
    from its horizontal mean)."""
    mean = ref["mean"]
    tsfc = {"tsfc": ref["tsfc"]}
    return {"forecast": C.gap(prog["mean"], mean, C.level_scale(mean)),
            "members": max(C.gap(prog["members"][k], r, C.level_scale(r))
                           for k, r in ref["members"].items()),
            "tsfc": C.gap({"tsfc": prog["tsfc"]}, tsfc,
                          C.level_scale(tsfc))}
