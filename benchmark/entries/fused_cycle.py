"""Entry: the fused DA cycle of a fixed radar network
(scale_letkf_torch/da/fastcycle.py FusedCycle.step): the ensemble forecast
of the traffic's `steps`, H(x) of the phased-array volume, QC as a mask,
the local transform and the back-transform, all on the device.

Inputs: the ensemble (rain and cloud blobs) made on the device from the
seed; the volume's template valued from a nature member by the
reference's radar operator, with the obs noise drawn from the seed and
preprocessed to dBZ with the no-rain relabelling; each unit's obs values
the template's plus fresh noise at the obs errors, drawn on the device
from (seed, unit). The ensemble and the inflation carry from unit to unit.

Compared after the window, for the window's first unit (its inputs made
again from the seed): the guess ensemble mean at every point (`forecast`:
the forecast with Kessler microphysics and the state transform) against
the reference's forecast from the same inputs; and the analysed restart
state of every member at the seed's columns (`analysis`: H(x), QC,
selection, localization, the transform with RTPS, the back-transform)
against the reference's analysis of the program's own forecast of that
unit, copied to the host as the step returned it. The analysis stage is
followed from the program's forecast because the forecast's own gap to
the reference (kernels #2 and #3 against their plain versions, grown over
the steps) would otherwise hide a transform run in a lower precision; the
forecast stage is held by the `forecast` number.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import compare as C
from benchmark import inputs as I
from benchmark import roofline as R
from benchmark.reference import letkf as L
from benchmark.reference import model as M
from benchmark.reference import namelist as NL
from benchmark.reference import obsop as O

MEMBER_BATCH = 10         # members the reference forecasts at once
NEAR = 1e-3               # relative closeness to a QC threshold counted as on it


def settings(ctx) -> dict:
    """The configuration's settings the reference needs (the namelist's
    defaults where the file is silent)."""
    return {"K": ctx.raw["ensemble"]["member"],
            **NL.localization(ctx.raw, O.TYP_PHARAD), **NL.letkf(ctx.raw),
            **NL.radar(ctx.raw), "steps": int(ctx.traffic["steps"]),
            "col": M.column_of(ctx.dom)}


def ensemble(ctx, K: int) -> M.State:
    tr = ctx.traffic
    return I.ens_dycore(ctx.seed, K, ctx.dom, ctx.device, u0=tr["u0"],
                        amp_theta=tr["amp_theta"], qr_blob=tr["qr_blob"])


class Inputs:
    """What the benchmark makes from the seed, without the program: the
    template and the compared columns."""

    def __init__(self, ctx):
        dom, tr, dev = ctx.dom, ctx.traffic, ctx.device
        self.seed = ctx.seed
        s = self.s = settings(ctx)
        vol = I.radar_volume(dom, ctx.raw.get("obs_error", {}),
                             int(tr["radar_obs_target"]))
        nat = I.ens_dycore(ctx.seed, 1, dom, dev, u0=tr["u0"],
                           amp_theta=tr["amp_theta"], qr_blob=tr["qr_blob"],
                           stream=5)
        anal = M.to_analysis(M.collocated(M.State(*(f.double() for f in nat))))
        proj = O.projection_of(dom)
        geo = O.geometry(vol, dom["nx"], dom["ny"], dom["dx"], dom["dy"], proj,
                         torch.float64, dev)
        self.min_ref = 10.0 ** (0.1 * s["min_ref_dbz"])
        y, qc, _ = O.hx_radar(O.history(anal), geo, s["col"].cz,
                              self.min_ref, s["min_ref_dbz"], s["zmax"])
        y, qc = y[0].cpu().numpy(), qc[0].cpu().numpy()
        keep = (qc == O.QC_GOOD) | (qc == O.QC_REF_LOW)
        t = {k: (v[keep] if k != "meta" else v) for k, v in vol.items()}
        # H(nature) plus noise, reflectivity in linear Z with the echo-free
        # gates at half the floor, then in dBZ, the gates below the floor
        # relabelled as no-rain reports (letkf_obs.f90:275-298)
        rng = np.random.default_rng(I.sub_seed(ctx.seed, 6))
        dat = y[keep] + rng.standard_normal(int(keep.sum())) * t["err"]
        ref = t["elem"] == O.ID_RADAR_REF
        dat[ref] = 10.0 ** (dat[ref] / 10.0)
        dat[ref & (qc[keep] == O.QC_REF_LOW)] = 0.5 * self.min_ref
        low = ref & (dat < self.min_ref)
        t["elem"] = np.where(low, O.ID_RADAR_REF_ZERO, t["elem"]).astype(
            np.int32)
        dat[low] = s["min_ref_dbz"] + s["low_ref_shift"]
        dat[ref & ~low] = 10.0 * np.log10(dat[ref & ~low])
        t["dat"] = dat
        self.tmpl, self.nobs = t, len(dat)
        sx, sy = proj.to_xy(vol["meta"][0], vol["meta"][1])
        centre = (sy / dom["dy"] + dom["ny"] / 2 - 0.5,
                  sx / dom["dx"] + dom["nx"] / 2 - 0.5)
        self.j, self.i = C.columns(ctx.seed, dom["ny"], dom["nx"],
                                   int(tr["check_columns"]), centre,
                                   float(tr["check_radius_m"]) / dom["dx"])

    def obs_values(self, unit: int, device) -> torch.Tensor:
        """The unit's obs values: the template's plus fresh noise."""
        gen = torch.Generator(device=device)
        gen.manual_seed(I.sub_seed(self.seed, 100 + unit))
        t = self.tmpl
        return (torch.as_tensor(t["dat"], dtype=torch.float32, device=device)
                + torch.as_tensor(t["err"], dtype=torch.float32, device=device)
                * torch.randn(len(t["dat"]), generator=gen, device=device))


class Unit:
    """The program's side: a driver and a FusedCycle of the template."""

    def __init__(self, ctx):
        from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
        from scale_letkf_torch.da.fastcycle import FusedCycle
        from scale_letkf_torch.obs.types import Observations
        self.ctx, self.dev = ctx, ctx.device
        self.inp = Inputs(ctx)
        cfg, grid, dycfg, dom = load_config_and_grid(str(ctx.config_path))
        self.driver = make_driver(cfg, grid, dycfg, dom, self.dev)
        t = self.inp.tmpl
        obs = Observations(elem=t["elem"], lon=t["lon"], lat=t["lat"],
                           lev=t["lev"], dat=t["dat"], err=t["err"],
                           typ=t["typ"], dif=np.zeros(len(t["dat"])),
                           meta=t["meta"])
        self.fc = FusedCycle(self.driver, obs, self.inp.s["steps"],
                             timed=ctx.trace)
        self.K, self.grid = cfg.ensemble.member, grid
        self.work = 1.0
        self.kept = None
        # the first unit's forecast, copied to (pinned) host buffers as
        # FusedCycle.step's forecast returns it: the start of the analysis
        # stage that the `analysis` number follows
        self.guess, self._capture = None, False
        forecast = self.driver.forecast

        def capture(ens, nsteps, t0=0.0):
            out = forecast(ens, nsteps, t0=t0)
            if self._capture:
                self._capture = False
                self._keep_guess(out)
            return out
        self.driver.forecast = capture

    def _keep_guess(self, out):
        if self.guess is None:
            pin = self.dev.type == "cuda"
            self.guess = M.State(*(torch.empty(f.shape, dtype=f.dtype,
                                               pin_memory=pin) for f in out))
        for dst, src in zip(self.guess, out):
            dst.copy_(src)

    def start(self):
        from scale_letkf_torch.model.dycore import DycoreState
        self.ens = [DycoreState(*ensemble(self.ctx, self.K))]
        self.infl = self.fc.initial_inflation()

    def step(self, i: int):
        self._capture = i == 0
        obs = self.inp.obs_values(i, self.dev)
        ens, self.infl, self.diag = self.fc.step(self.ens.pop(), obs,
                                                 self.infl)
        self.ens.append(ens)

    def keep(self):
        self.kept = {"gues_mean": self.diag["gues_mean"],
                     "out": C.program_at(self.ens[0], self.inp.j, self.inp.i),
                     "guess": self.guess}

    def reset_spans(self):
        t = self.fc.timer
        if hasattr(t, "settle"):
            t.settle()
        t.records.clear()
        t.counts.clear()

    def spans(self) -> dict:
        t = self.fc.timer
        if hasattr(t, "settle"):
            t.settle()
        return dict(t.records)

    def bounds(self, units: int) -> dict:
        g, s = self.grid, self.inp.s
        pts = g.nz * g.ny * g.nx
        local = float(self.diag["nobs_per_level"].sum()) * g.ny * g.nx
        calls = 3 * s["steps"] * units
        col = s["col"]
        fcst = (self.K * s["steps"] * R.si_step_bytes(
            g.nz, g.ny, g.nx, col.n_small, col.phys_interval)
            / R.HBM_BYTES_PER_S)
        return {"invsqrt": units * R.invsqrt_s(pts, self.K),
                "dyn": calls * R.dyn_tendency_s(self.K, g.nz, g.ny, g.nx),
                "adv": calls * R.adv_ud3_s(self.K, g.nz, g.ny, g.nx),
                "step": units * (fcst + R.analysis_s(pts, self.K, local)),
                "member_steps": units * self.K * s["steps"]}

    def release(self):
        kept, inp = self.kept, self.inp
        self.__dict__.clear()
        self.kept, self.inp = kept, inp


def reference(ctx, inp: Inputs, kept: dict | None = None,
              control: str | None = None) -> dict:
    """The reference's answers for the window's first unit: the guess mean
    of its own forecast, and the restart state at the columns, with the
    columns' `sure` masks, analysed from the program's forecast of that
    unit (`kept['guess']`, the start of the analysis stage; from its own
    without one). control 'bf16' holds the state in bfloat16 (forecast,
    state transform, H(x) from bfloat16 fields), 'tf32' runs the
    transform's products in TF32, 'both' does both."""
    s, dom, dev = inp.s, ctx.dom, ctx.device
    K, col = s["K"], s["col"]
    nz, ny, nx = dom["nz"], dom["ny"], dom["nx"]
    bf16 = control in ("bf16", "both")
    store = torch.bfloat16 if bf16 else None
    anal_t = torch.bfloat16 if bf16 else torch.float64
    guess = (kept or {}).get("guess")
    t = inp.tmpl
    geo = O.geometry(t, nx, ny, dom["dx"], dom["dy"], O.projection_of(dom),
                     torch.float32 if bf16 else torch.float64, dev)
    sets = C.site_sets(inp.j, inp.i, ny, nx)
    P = len(inp.j)
    e0 = ensemble(ctx, K)
    gm = torch.zeros((M.NV, nz, ny, nx), dtype=torch.float64, device=dev)
    y = torch.empty((K, inp.nobs), dtype=torch.float64, device=dev)
    qc_worst = torch.zeros(inp.nobs, dtype=torch.int32, device=dev)
    near_low = torch.zeros(inp.nobs, dtype=torch.bool, device=dev)
    clear_low = torch.zeros(inp.nobs, dtype=torch.bool, device=dev)
    xb = torch.empty((3, nz, P, M.NV, K), dtype=torch.float64, device=dev)
    for b0 in range(0, K, MEMBER_BATCH):
        b1 = min(K, b0 + MEMBER_BATCH)
        g = M.forecast(M.State(*(f[b0:b1] for f in e0)), col, s["steps"], dev,
                       store)
        a = M.to_analysis(M.collocated(M.State(*(f.to(anal_t) for f in g))))
        gm += a.to(torch.float64).sum(dim=0)
        if guess is not None:
            a = M.to_analysis(M.collocated(M.State(*(
                f[b0:b1].to(dev, anal_t) for f in guess))))
        del g
        for n, (jj, ii) in enumerate(sets):
            xb[n, :, :, :, b0:b1] = a[:, :, :, jj, ii].permute(2, 3, 1, 0).to(
                torch.float64)
        yb, qb, rb = O.hx_radar(O.history(a), geo, col.cz,
                                inp.min_ref, s["min_ref_dbz"], s["zmax"])
        del a
        y[b0:b1] = yb.to(torch.float64)
        qc_worst = torch.maximum(qc_worst, qb.amax(dim=0))
        rb = rb.to(torch.float64)
        near_low |= ((rb - inp.min_ref).abs() <= NEAR * inp.min_ref).any(
            dim=0)
        clear_low |= (rb < inp.min_ref * (1.0 - NEAR)).any(dim=0)
        del yb, qb, rb
    del e0
    gm /= K

    # obs space: the first unit's values, departures and QC (gross error,
    # operator QC of any member, enough members seeing an echo)
    dat = inp.obs_values(0, dev).to(torch.float64)
    elem = torch.as_tensor(t["elem"], device=dev)
    err = torch.as_tensor(t["err"], dtype=torch.float64, device=dev)
    is_ref = (elem == O.ID_RADAR_REF) | (elem == O.ID_RADAR_REF_ZERO)
    mean_y = y.mean(dim=0)
    dep = dat - mean_y
    g_ref = s["gross_ref"] if s["gross_ref"] > 0 else s["gross"]
    g_vr = s["gross_vr"] if s["gross_vr"] > 0 else s["gross"]
    thr = torch.full_like(err, s["gross"])
    thr[is_ref] = g_ref
    thr[elem == O.ID_RADAR_VR] = g_vr
    thr *= err
    cut = s["thres_dbz"] + 1e-6
    near = (y - cut).abs() <= NEAR * cut
    above = (y > cut).sum(dim=0)
    sure_above = ((y > cut) & ~near).sum(dim=0)
    rainy = torch.as_tensor(t["dat"] > cut, device=dev)
    need = torch.full_like(above, s["min_member"])
    need[rainy] = s["min_member_obsref"]
    usable = ((qc_worst == O.QC_GOOD) & (dep.abs() <= thr)
              & (~is_ref | (above >= need)))
    # an obs is doubtful where rounding could flip its QC: some member's
    # echo on the floor with none clearly below it, |d| on the gross-error
    # threshold, or the members that see an echo on the count needed
    doubtful = ((near_low & ~clear_low)
                | ((dep.abs() - thr).abs() <= NEAR * thr)
                | (is_ref & near.any(dim=0) & (sure_above < need)))
    del near

    # the template's combined types, each thinned in its sorting mesh
    x, yy = O.projection_of(dom).to_xy(t["lon"], t["lat"])
    spacing, cap = L.sort_mesh(s["hori"] * L.DIST_ZERO_FAC, s["max_nobs"],
                               s["min_spacing"], min(dom["dx"], dom["dy"]),
                               s["sort_spacing"])
    hx, hy = nx * dom["dx"] / 2, ny * dom["dy"] / 2
    ctypes = []
    for e in (O.ID_RADAR_REF, O.ID_RADAR_REF_ZERO, O.ID_RADAR_VR):
        idx = np.flatnonzero(t["elem"] == e)
        if len(idx):
            kept = L.thin(x[idx], yy[idx], -hx, -hy, hx, hy, spacing, cap)
            ctypes.append(L.Ctype(idx[kept], s["hori"], s["vert"], True,
                                  s["max_nobs"]))

    px, py = C.site_xy(sets, dom)
    pz = np.tile(np.repeat(col.cz, P), 3)

    def put(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)
    anal, sure = L.analyse(
        ctypes, put(x), put(yy), put(t["lev"]), usable, doubtful,
        (y - mean_y).T.contiguous(), dep, err, put(px), put(py), put(pz),
        put(pz), xb.reshape(3 * nz * P, M.NV, K), s["infl"], rtpp=s["rtpp"],
        rtps=s["rtps"], control=control in ("tf32", "both"))
    out, masks, share = C.restart_at(anal, sure, nz, P)
    return {"gues_mean": gm, "out": out, "masks": masks, "sure_share": share}


def compare(prog: dict, ref: dict) -> dict:
    """`forecast`, `analysis` over every restart field, and `analysis_uvwq`
    over the momenta and the tracers alone: ρ and ρθ hold means 10³–10⁴
    times their members' spread, so float32's own rounding of the state
    sets the program's gap there, far above a lower precision's in the
    transform (benchmark/tests: ρ 2e-4, ρθ 8e-5, the rest 3e-6–3e-5)."""
    mean = C.variables(ref["gues_mean"])
    scale = C.member_scale(ref["out"])
    uvwq = {n: f for n, f in ref["out"].items() if n not in ("rho", "rhot")}
    return {"forecast": C.gap(C.variables(prog["gues_mean"]), mean,
                              C.level_scale(mean)),
            "analysis": C.gap(prog["out"], ref["out"], scale, ref["masks"]),
            "analysis_uvwq": C.gap(prog["out"], uvwq, scale, ref["masks"])}
