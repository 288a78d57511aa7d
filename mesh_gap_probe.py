#!/usr/bin/env python3
"""Where a process grid's analysis departs from the undecomposed one, on
one GPU.

    python3 mesh_gap_probe.py

Runs chip_smoke.py's 18-km cycle composition (mesh_run: one run_osse cycle
of CYCLE_STEPS from the seeded ensemble and nature run) five ways:

  A  undecomposed
  B  undecomposed, from inputs perturbed by one rounding
  C  on the grid chip_smoke.MESH (2, 2, 2), halo 'explicit'
  D  on the grid, from the perturbed inputs
  E  undecomposed, the analysis chunk cut to a grid share's 21,600 points

and records, per level and column, what the analysis sees: the guess
members' float64 sum (is the forecast bit-equal?), the log-pressure of the
level mean that localizes vertically, and the local obs selection (count,
sums of the ids and of their squares, an order-weighted sum, the rloc
sum). For each pair of runs it prints the largest distances of the guess
and analysis means and spreads, how many points differ in each record,
and how many of the 0.1% largest analysis-mean differences sit where the
selection differs. The summary goes to chiprun_out/probe_mesh.json."""
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
from scale_letkf_torch.cli.main import load_config_and_grid  # noqa: E402
from scale_letkf_torch.da import letkf  # noqa: E402
from scale_letkf_torch.synthetic import synthetic_conv_network  # noqa: E402

NAMES = ("U", "V", "W", "T", "PRES", "QV")
RUNS = (("A", (1, 1, 1), False, None), ("C", (2, 2, 2), False, None),
        ("B", (1, 1, 1), True, None), ("D", (2, 2, 2), True, None),
        ("E", (1, 1, 1), False, 21600))
PAIRS = (("A", "C"), ("A", "B"), ("C", "D"), ("A", "E"), ("B", "D"),
         ("A", "D"))


class Recorder:
    """Wraps letkf.analyze_points, letkf._select and letkf.chunk_for."""

    def __init__(self, grid, nv: int):
        self.nz, self.ny, self.nx, self.nv = grid.nz, grid.ny, grid.nx, nv
        self.xs = np.asarray(grid.xy[0], dtype=np.float32)
        self.ys = np.asarray(grid.xy[1], dtype=np.float32)
        z = grid.calc_z(torch.zeros((grid.ny, grid.nx), dtype=torch.float64))
        self.zlev = z[:, 0, 0].numpy()      # flat terrain: one z a level
        self.chunk = None
        self.orig = (letkf.analyze_points, letkf._select, letkf.chunk_for)
        letkf.analyze_points = self.points
        letkf._select = self.select
        letkf.chunk_for = self.chunk_for
        self.rec = {}

    def reset(self, chunk):
        B = self.ny * self.nx
        self.chunk = chunk
        self.rec = {k: np.zeros((self.nz, B), t) for k, t in (
            ("logp", np.float32), ("cnt", np.int64), ("s1", np.int64),
            ("s2", np.int64), ("sord", np.int64), ("rsum", np.float64))}
        self.rec["gsum"] = np.zeros((self.nv, self.nz, B), np.float64)

    def cols(self, gp_x, gp_y):
        ix = np.searchsorted(self.xs, gp_x.cpu().numpy())
        iy = np.searchsorted(self.ys, gp_y.cpu().numpy())
        return iy * self.nx + ix

    def points(self, plan, dctx, members, mean, infl0, gp_x, gp_y,
               dist_bdy, z, **kw):
        acc = torch.zeros(members.shape[1:], dtype=torch.float64,
                          device=members.device)
        for m in range(members.shape[0]):
            acc += members[m].double()
        self.rec["gsum"][:, :, self.cols(gp_x, gp_y)] = acc.cpu().numpy()
        del acc
        return self.orig[0](plan, dctx, members, mean, infl0, gp_x, gp_y,
                            dist_bdy, z, **kw)

    def select(self, plan, dctx, gp_x, gp_y, logp, z):
        out = self.orig[1](plan, dctx, gp_x, gp_y, logp, z)
        idx, rloc = out[0], out[1]
        valid = rloc > 0
        i1 = (idx.long() + 1) * valid
        pos = torch.arange(1, i1.shape[-1] + 1, device=i1.device)
        c = self.cols(gp_x, gp_y)
        lev = int(np.argmin(np.abs(self.zlev - float(z[0]))))
        r = self.rec
        r["logp"][lev, c] = logp.cpu().numpy()
        r["cnt"][lev, c] = valid.sum(-1).cpu().numpy()
        r["s1"][lev, c] = i1.sum(-1).cpu().numpy()
        r["s2"][lev, c] = (i1 * i1).sum(-1).cpu().numpy()
        r["sord"][lev, c] = (i1 * pos).sum(-1).cpu().numpy()
        r["rsum"][lev, c] = rloc.double().sum(-1).cpu().numpy()
        return out

    def chunk_for(self, plan, ctx, B, K, dev):
        c = self.orig[2](plan, ctx, B, K, dev)
        return c if self.chunk is None else min(c, self.chunk)


def compare(ra, rb, nz) -> dict:
    d = {key: {n: float(np.abs(ra[key][v] - rb[key][v]).max())
               for v, n in enumerate(NAMES)}
         for key in ("gues_mean", "anal_mean", "anal_sprd")}
    xa, xb = ra["rec"], rb["rec"]
    sel = ((xa["cnt"] != xb["cnt"]) | (xa["s1"] != xb["s1"])
           | (xa["s2"] != xb["s2"]))
    logp = xa["logp"] != xb["logp"]
    d.update(sel_diff_points=int(sel.sum()),
             rsum_diff_points=int((xa["rsum"] != xb["rsum"]).sum()),
             order_diff_points=int((xa["sord"] != xb["sord"]).sum()),
             logp_diff_points=int(logp.sum()),
             gsum_diff_points=int((xa["gsum"] != xb["gsum"]).any(0).sum()),
             gsum_max_diff=float(np.abs(xa["gsum"] - xb["gsum"]).max()))
    # each variable's analysis-mean difference over its largest, the
    # largest over the variables, per (level, column)
    dm = np.abs(ra["anal_mean"] - rb["anal_mean"]).reshape(
        len(ra["anal_mean"]), nz, -1)[:len(NAMES)]
    am = (dm / np.maximum(dm.reshape(len(NAMES), -1).max(1), 1e-30)
          [:, None, None]).max(0)
    top = np.argsort(am.reshape(-1))[::-1][:200]
    thr = np.percentile(am, 99.9)
    big = am > thr
    d.update(top200_sel_differs=int(sel.reshape(-1)[top].sum()),
             top200_logp_differs=int(logp.reshape(-1)[top].sum()),
             p999_absdiff=float(thr), big_points=int(big.sum()),
             big_sel_differs=int((sel & big).sum()),
             omb_diff={k: ra["omb"][k] - rb["omb"].get(k, np.nan)
                       for k in ra["omb"]},
             oma_diff={k: ra["oma"][k] - rb["oma"].get(k, np.nan)
                       for k in ra["oma"]})
    return d


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_gap_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    device = torch.device("cuda", 0)
    cfg, grid, dycfg, dom = load_config_and_grid(str(cs.CONFIG))
    kw = {"u0": cs.FCST_U0, "amp_theta": cs.CYCLE_AMP_THETA,
          "smooth_passes": cs.CYCLE_SMOOTH_PASSES}
    template = synthetic_conv_network(cfg, grid,
                                      np.random.default_rng(cs.SEED))
    recorder = Recorder(grid, 11)
    runs = {}
    for name, mesh, rounded, chunk in RUNS:
        recorder.reset(chunk)
        t0 = time.perf_counter()
        _, driver, truth, ens, res = cs.mesh_run(
            device, cfg, grid, dycfg, dom, template, kw,
            rounded, decomposed=mesh != (1, 1, 1))
        out = {k: res.info[k].cpu().numpy() for k in (
            "gues_mean", "gues_sprd", "anal_mean", "anal_sprd")}
        out.update(omb=dict(res.stats_gues[0].rmse),
                   oma=dict(res.stats_anal[0].rmse), rec=recorder.rec,
                   wall=time.perf_counter() - t0,
                   chunk=res.info["diag"].chunk)
        del driver, truth, ens, res
        torch.cuda.empty_cache()
        runs[name] = out
        print(name, "done", out["wall"], out["chunk"], flush=True)
    summary = {"chunks": {k: v["chunk"] for k, v in runs.items()},
               "walls": {k: v["wall"] for k, v in runs.items()}}
    for a, b in PAIRS:
        summary[f"{a}-{b}"] = compare(runs[a], runs[b], grid.nz)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/probe_mesh.json", "w") as f:
        json.dump(summary, f, indent=1, default=float)
    print(json.dumps(summary, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
