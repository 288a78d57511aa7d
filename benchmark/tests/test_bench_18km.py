"""The 18-km regional forecast cell through the harness on the CPU at a tiny
size: correct against the reference; a traced run reads every per-layer
metric the CPU can give, the physics suite's spans nested in
`forecast/physics`; correct false with the timed path broken underneath,
once for each fault the cell can have, and with the control in the
program's place; the control failing its limits; the traffic's clouds
converted by the microphysics; the window's second unit against two
chained reference units. A `cuda` case runs the cell at its own size on
the card."""

import time

import pytest
import torch

from benchmark import harness as H

CPU = torch.device("cpu")
CELL = "18km_forecast"
SEED = 2 ** 40 + 12345          # past 32 bits, as a run's seed may be
# 24 × 20 columns, 10 levels (900 m at the ground, so the top is below
# -30 °C and the clouds hold ice), 4 members, 2 steps; the Davies buffer
# and the hills' taper cut to 3 cells to leave an inside, the cloud systems
# to 4 cells
CLOUD = {"systems": 3, "width_cells": 4.0, "jitter_cells": 1.0,
         "z_m": 4500.0, "depth_m": 2500.0, "rh": 1.02, "q": 1.0e-3}
TINY = dict(domain_overrides={"nx": 24, "ny": 20, "nz": 10, "dz": 900.0,
                              "bdy_width": 3},
            member=4, traffic_overrides={"steps": 2, "hill_taper_cells": 3,
                                         "cloud": CLOUD})
# per-layer metrics a CPU run cannot give: the device's busy time and its
# allocator's peak
DEVICE_ONLY = {"idle_share.18km", "peak_mem_gib.18km"}


def run(trace: bool = False, device=CPU, **sizes):
    torch.set_num_threads(4)
    ctx = H.make_ctx(CELL, SEED, device, trace=trace, **(sizes or TINY))
    out = H.run_cell(ctx, 0.0, time.perf_counter())
    return H.result(ctx, out)[0], out


def test_cell_is_correct():
    res, _ = run()
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"forecast", "members", "tsfc"}
    e2e = {m["name"] for m in H.metrics_of(H.benchmark_json(), CELL)[0]}
    assert set(res["metrics"]) == e2e == {"cycle_s", "setup_s"}


def test_traced_run_reads_the_metrics():
    res, out = run(trace=True)
    assert res["correct"]
    layer = {m["name"] for m in H.metrics_of(H.benchmark_json(), CELL)[1]}
    assert set(res["metrics"]) == layer - DEVICE_ONLY
    m = res["metrics"]
    for name in ("forecast_s", "tendencies_s", "acoustic_s", "physics_s",
                 "radiation_s", "boundary_s"):
        assert m[f"{name}.18km"]["value"] > 0, name
    assert m["member_batches.18km"]["value"] == 1     # all K on the CPU
    assert 0 < m["step_mfu.18km"]["value"] < 100
    spans = out["rec"]["spans"]
    for name in ("microphysics", "radiation", "pbl"):
        assert 0 < spans[f"forecast/physics/{name}"] <= spans[
            "forecast/physics"]
    assert out["attempted"] == 2       # one unit untraced, one traced


def _faults():
    """(fault name, patcher): each breaks the timed path underneath the
    harness."""
    from scale_letkf_torch import cycle
    from scale_letkf_torch.model import physics_suite

    def no_physics(mp):
        mp.setattr(cycle, "physics_step", lambda s, phys, *a, **k: (s, phys))

    def no_microphysics(mp):
        mp.setattr(physics_suite, "nsw6_step", lambda s, dt, dz: s)

    def no_relaxation(mp):
        mp.setattr(cycle.CycleDriver, "_apply_bdy",
                   lambda self, s, t, bdy, w2d=None: s)

    def flat_metrics(mp):
        orig = cycle.make_metrics
        mp.setattr(cycle, "make_metrics",
                   lambda topo, *a: orig(torch.zeros_like(topo), *a))

    def slab_not_carried(mp):
        orig = cycle.physics_step

        def step(s, phys, *a, **k):
            s, new = orig(s, phys, *a, **k)
            return s, new._replace(tsfc=phys.tsfc)
        mp.setattr(cycle, "physics_step", step)

    def altered(mp):
        orig = cycle.CycleDriver.forecast

        def forecast(self, ens, n, t0=0.0):
            out = orig(self, ens, n, t0)
            return out._replace(rhot=out.rhot * (1 + 1e-3))
        mp.setattr(cycle.CycleDriver, "forecast", forecast)

    return [("physics step skipped", no_physics),
            ("microphysics skipped", no_microphysics),
            ("relaxation skipped", no_relaxation),
            ("flat metrics in place of the hills", flat_metrics),
            ("skin temperature not carried", slab_not_carried),
            ("one field altered by 1e-3", altered)]


@pytest.mark.parametrize("i", range(6), ids=[f[0] for f in _faults()])
def test_broken_timed_path_is_not_correct(i, monkeypatch):
    _faults()[i][1](monkeypatch)
    res, _ = run()
    assert not res["correct"], res["checks"]


def test_the_clouds_are_converted():
    """The traffic's clouds hold every condensate class, and the
    microphysics moves each by more than the limits: the comparison sees
    the scheme's conversions."""
    from benchmark import compare as C
    torch.set_num_threads(4)
    ctx = H.make_ctx(CELL, SEED, CPU, **TINY)
    entry = H.entry_of(ctx)
    e = entry.ensemble(ctx, 2)
    for q in range(1, 6):
        assert float(e.rhoq[:, q].max()) > 0, q
    inp = entry.Inputs(ctx)
    ref = entry.reference(ctx, inp)
    dry = inp.s["suite"]._replace(mp_scheme="none")
    inp.s["suite"] = dry
    without = entry.reference(ctx, inp)
    scale = C.level_scale(ref["mean"])
    for q in range(6):
        n = f"rhoq{q}"
        moved = float((without["mean"][n] - ref["mean"][n]).abs().max())
        assert moved / scale[n] > ctx.traffic["limits"]["forecast"], n


def _carry_faults():
    """(name, patcher): each breaks what one unit carries to the next."""
    from scale_letkf_torch import cycle
    orig = cycle.CycleDriver.forecast

    def tsfc_reset(mp):
        def forecast(self, ens, n, t0=0.0):
            self.tsfc = None
            return orig(self, ens, n, t0)
        mp.setattr(cycle.CycleDriver, "forecast", forecast)

    def clock_restarted(mp):
        mp.setattr(cycle.CycleDriver, "forecast",
                   lambda self, ens, n, t0=0.0: orig(self, ens, n, 0.0))

    return [("carried", None),
            ("skin temperature reset between units", tsfc_reset),
            ("boundary clock restarted each unit", clock_restarted)]


@pytest.mark.parametrize("i", range(3), ids=[f[0] for f in _carry_faults()])
def test_second_unit_against_two_chained_reference_units(i, monkeypatch):
    """The window's second unit (from one unit's time on the boundary
    clock, with the first unit's skin temperature) against two chained
    reference forecasts: bit for bit when both carry, `correct` false
    when the program drops either. The boundary data's states 2 min apart,
    so the clock moves the target within a unit."""
    name, patch = _carry_faults()[i]
    if patch is not None:
        patch(monkeypatch)
    torch.set_num_threads(4)
    sizes = dict(TINY, traffic_overrides={**TINY["traffic_overrides"],
                                          "bdy_seconds": 120.0})
    ctx = H.make_ctx(CELL, SEED, CPU, **sizes)
    entry = H.entry_of(ctx)
    unit = entry.Unit(ctx)
    unit.start()
    unit.step(0)
    unit.step(1)
    unit.keep()
    got = entry.compare(unit.kept, entry.reference(ctx, unit.inp, units=2))
    limits = ctx.traffic["limits"]
    if patch is None:
        assert got == {k: 0.0 for k in limits}, got
    else:
        assert any(got[k] > limits[k] for k in limits), (name, got)


def test_control_in_the_programs_place_is_not_correct(monkeypatch):
    """The reference with its state held in bfloat16 put in the program's
    place through the whole harness."""
    entry_of = H.entry_of

    def with_control(ctx):
        entry = entry_of(ctx)

        def keep(self):
            self.kept = entry.reference(self.ctx, self.inp, control="both")
        monkeypatch.setattr(entry.Unit, "keep", keep)
        return entry
    monkeypatch.setattr(H, "entry_of", with_control)
    res, _ = run()
    assert not res["correct"], res["checks"]


def test_control_fails_the_limits():
    from benchmark.readings import control
    torch.set_num_threads(4)
    ctx = H.make_ctx(CELL, SEED, CPU, **TINY)
    limits = ctx.traffic["limits"]
    for mode, got in control(ctx).items():
        assert got["forecast"] > limits["forecast"], (mode, got)
        assert got["members"] > limits["members"], (mode, got)


@pytest.mark.cuda
def test_cell_at_its_size(cuda_device):
    """The cell at its own size on the card (as a run of run.py with a
    window of one unit): correct, with every per-layer metric read."""
    res, _ = run(trace=True, device=cuda_device, domain_overrides={})
    assert res["correct"], res["checks"]
    layer = {m["name"] for m in H.metrics_of(H.benchmark_json(), CELL)[1]}
    assert set(res["metrics"]) == layer
