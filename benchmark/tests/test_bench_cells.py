"""The cell run through the harness on the CPU at a tiny size (the
program's plain paths in place of its kernels): correct against the
reference; correct false with the timed path broken underneath, once for
each fault the cell can have, and with the control in the program's
place; the control failing its limits; and the reference's forecast equal to the
program's plain forecast bit for bit."""

import time

import pytest
import torch

from benchmark import harness as H
from benchmark import inputs as I
from benchmark.reference import model as M

CPU = torch.device("cpu")
SEED = 2 ** 40 + 12345          # past 32 bits, as a run's seed may be
# 16 × 16 columns at 1 km, so that the volume's nearest gates (2 km from
# the radar) fall inside the domain
TINY = {
    "radar_cycle": dict(domain_overrides={"nx": 16, "ny": 16, "dx": 1000.0,
                                          "dy": 1000.0},
                        member=16,
                        traffic_overrides={"steps": 5,
                                           "radar_obs_target": 10000,
                                           "check_columns": 4,
                                           "check_radius_m": 55000.0}),
}


def run(cell: str, trace: bool = False):
    torch.set_num_threads(4)
    ctx = H.make_ctx(cell, SEED, CPU, trace=trace, **TINY[cell])
    out = H.run_cell(ctx, 0.0, time.perf_counter())
    return H.result(ctx, out)[0], out


@pytest.mark.parametrize("cell", list(TINY))
def test_cell_is_correct(cell):
    res, out = run(cell)
    assert res["correct"], res["checks"]
    assert out["info"]["sure_share"] > 0.9
    assert list(res)[-1] == "checks"
    e2e = {m["name"] for m in H.metrics_of(H.benchmark_json(), cell)[0]}
    assert set(res["metrics"]) == e2e


def test_traced_run_reads_the_spans():
    res, out = run("radar_cycle", trace=True)
    assert res["correct"]
    m = res["metrics"]
    assert m["forecast_s.cycle"]["value"] > 0
    assert m["das_letkf_s.cycle"]["value"] > 0
    assert 0 < m["step_mfu.cycle"]["value"] < 100
    assert out["attempted"] == 2       # one unit untraced, one traced
    assert res["device"]["window_s"] == out["rec"]["window_s"]


def _faults():
    """(cell, fault name, patcher): each breaks the timed path underneath
    the harness."""
    from scale_letkf_torch import cycle
    from scale_letkf_torch.da import fastcycle

    def unchanged_forecast(mp):
        mp.setattr(cycle.CycleDriver, "forecast",
                   lambda self, ens, n, t0=0.0: ens)

    def half_forecast(mp):
        orig = cycle.CycleDriver.forecast

        def half(self, ens, n, t0=0.0):
            K = ens.rho.shape[0] // 2
            out = orig(self, type(ens)(*(f[:K] for f in ens)), n, t0)
            return type(ens)(*(torch.cat([a, b[K:]]) for a, b in
                               zip(out, ens)))
        mp.setattr(cycle.CycleDriver, "forecast", half)

    def half_obs(mp):
        orig_qc = fastcycle.FusedCycle._qc_mask

        def qc_mask(self, y, qc_worst, dep):
            good = orig_qc(self, y, qc_worst, dep).clone()
            good[good.shape[0] // 2:] = False
            return good
        mp.setattr(fastcycle.FusedCycle, "_qc_mask", qc_mask)

    def altered_analysis(mp):
        orig = fastcycle.FusedCycle._restart

        def restart(self, anal):
            out = orig(self, anal)
            return type(out)(*(f * (1 + 1e-3) for f in out))
        mp.setattr(fastcycle.FusedCycle, "_restart", restart)

    return [("radar_cycle", "state unchanged", unchanged_forecast),
            ("radar_cycle", "half the batch", half_forecast),
            ("radar_cycle", "half the obs left out", half_obs),
            ("radar_cycle", "answer altered", altered_analysis)]


@pytest.mark.parametrize("i", range(4), ids=[f[1] for f in _faults()])
def test_broken_timed_path_is_not_correct(i, monkeypatch):
    cell, _, patch = _faults()[i]
    patch(monkeypatch)
    try:
        res, _ = run(cell)
    except (KeyError, TypeError, AttributeError, RuntimeError):
        return                          # a run that crashes prints no result
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("mode", ["tf32", "both"])
def test_control_in_the_programs_place_is_not_correct(mode, monkeypatch):
    """The control put in the program's place through the whole harness:
    the answers the window's first unit keeps are the reference's, its
    transform's products in TF32 (and with 'both' its state in bfloat16)."""
    entry_of = H.entry_of

    def with_control(ctx):
        entry = entry_of(ctx)

        def keep(self):
            self.kept = entry.reference(self.ctx, self.inp, control=mode)
        monkeypatch.setattr(entry.Unit, "keep", keep)
        return entry
    monkeypatch.setattr(H, "entry_of", with_control)
    res, _ = run("radar_cycle")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", list(TINY))
def test_control_fails_the_limits(cell):
    from benchmark.readings import control
    torch.set_num_threads(4)
    ctx = H.make_ctx(cell, SEED, CPU, **TINY[cell])
    limits = ctx.traffic["limits"]
    for mode, got in control(ctx).items():
        assert any(got[k] > limits[k] for k in limits), (mode, got, limits)


@pytest.mark.parametrize("cell", list(TINY))
def test_reference_forecast_is_the_plain_program(cell):
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    from scale_letkf_torch.model.dycore import DycoreState
    ctx = H.make_ctx(cell, SEED, CPU, **TINY[cell])
    cfg, grid, dycfg, dom = load_config_and_grid(str(ctx.config_path))
    drv = make_driver(cfg, grid, dycfg, dom, CPU)
    tr = ctx.traffic
    e0 = I.ens_dycore(SEED, 3, ctx.dom, CPU, u0=tr["u0"],
                      amp_theta=tr["amp_theta"], qr_blob=tr.get("qr_blob", 0))
    steps = 6 if ctx.dom.get("use_physics") else 2
    prog = drv.forecast(DycoreState(*e0), steps)
    ref = M.forecast(e0, M.column_of(ctx.dom), steps, CPU)
    for a, b in zip(prog, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(TINY))
def test_control_fails_at_the_cells_size(cell, cuda_device):
    """The controls at the cell's own size on the card (as
    `benchmark/readings.py --control` reads them)."""
    from benchmark.readings import control
    ctx = H.make_ctx(cell, SEED, cuda_device)
    limits = ctx.traffic["limits"]
    for mode, got in control(ctx).items():
        assert any(got[k] > v for k, v in limits.items()), (mode, got)
