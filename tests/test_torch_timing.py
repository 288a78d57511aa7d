"""The fused cycle's sections (utils/timing.py, da/fastcycle.py) on the CPU.

A tiny split-explicit case of the port alone (12 × 12 × 10 at 1 km, 8
members, Kessler, a conventional network valued from the ensemble's own
H(x)): a timed FusedCycle.step records the top-level sections, the
analysis's and the acoustic substeps'; an untimed one records nothing and
gives the same ensemble, inflation and diagnostics bit for bit. Under the
kineto-level recording of benchmark/trace.py Recorder, each timed section
is a host event named by its full path that is no user annotation; a
disabled Timer, or a section with no profiler, opens no range.
"""

import numpy as np
import pytest
import torch
from torch.autograd import _disable_profiler

from benchmark.trace import Recorder
from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
from scale_letkf_torch.da.fastcycle import FusedCycle
from scale_letkf_torch.model.dycore import to_collocated
from scale_letkf_torch.state import state_trans
from scale_letkf_torch.synthetic import (
    synthetic_conv_network, synthetic_ens_dycore_device,
)
from scale_letkf_torch.utils.timing import EventTimer, Timer

CPU = torch.device("cpu")
CONFIG = """\
[domain]
nx = 12
ny = 12
nz = 10
dx = 1000.0
dy = 1000.0
dz = 500.0
core = "si"
n_small = 4
dt = 2.0
use_physics = true
qv_surface = 0.015
sponge_height = 4000.0

[ensemble]
member = 8

[letkf]
infl_mul = 1.05
relax_alpha_spread = 0.9
"""
ANALYSIS = ("select", "gather", "gram", "solve", "weights", "apply")
TOP = ("forecast", "state_trans", "obsope", "qc", "das_letkf",
       "state_trans_inv", "monitor")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The driver, the template, the initial ensemble and the obs values:
    the ensemble mean's H(x) plus noise at half the obs errors."""
    torch.set_num_threads(1)
    path = tmp_path_factory.mktemp("timing") / "exp.toml"
    path.write_text(CONFIG)
    cfg, grid, dycfg, dom = load_config_and_grid(str(path))
    driver = make_driver(cfg, grid, dycfg, dom, CPU)
    template = synthetic_conv_network(cfg, grid, np.random.default_rng(5),
                                      n_sonde=12, n_ps=12)
    ens = synthetic_ens_dycore_device(7, 8, grid, dom, CPU, u0=5.0,
                                      qr_blob=2e-3)[0]
    fc = FusedCycle(driver, template, nsteps=2)
    y = fc._hx(state_trans(to_collocated(ens)))[0]
    gen = torch.Generator().manual_seed(9)
    dat = y.mean(dim=0) + 0.5 * fc._err * torch.randn(fc._err.shape,
                                                      generator=gen)
    return {"driver": driver, "template": template, "ens": ens, "dat": dat}


def _step(case, timed):
    fc = FusedCycle(case["driver"], case["template"], nsteps=2, timed=timed)
    ens = type(case["ens"])(*(f.clone() for f in case["ens"]))
    return fc, fc.step(ens, case["dat"].clone(), fc.initial_inflation())


@pytest.fixture(scope="module")
def steps(case):
    """A timed and an untimed step from the same inputs."""
    return {"timed": _step(case, True), "untimed": _step(case, False)}


def test_timed_step_records_the_sections(steps):
    fc, (_, _, diag) = steps["timed"]
    keys = set(fc.timer.records)
    want = {*TOP, "forecast/acoustic",
            *(f"das_letkf/{s}" for s in ANALYSIS)}
    assert want <= keys, want - keys
    assert int(diag["nobs_used"]) > 0
    assert not any("level" in k.split("/") for k in keys)
    assert set(fc.timer.counts) == keys
    assert all(v >= 0.0 for v in fc.timer.records.values())
    # one qc and one analysis a step; the selection once a level's chunk
    assert fc.timer.counts["qc"] == fc.timer.counts["das_letkf"] == 1
    assert fc.timer.counts["das_letkf/select"] >= 10


def test_untimed_step_records_nothing(steps, case):
    fc, _ = steps["untimed"]
    assert fc.timer.records == {} and fc.timer.counts == {}
    assert "forecast" not in case["driver"].timer.records


def test_timed_and_untimed_steps_are_bit_equal(steps):
    _, (ens, infl, diag) = steps["timed"]
    _, (ens0, infl0, diag0) = steps["untimed"]
    for a, b in zip(ens, ens0):
        assert torch.equal(a, b)
    assert torch.equal(infl, infl0)
    for k, v in diag.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, diag0[k]), k
        elif isinstance(v, dict):
            for n, t in v.items():
                assert torch.equal(t, diag0[k][n]), (k, n)
        else:
            assert v == diag0[k], k


def _recorded(fn):
    """(name, is_user_annotation) of the host events `fn` leaves under the
    benchmark's kineto-level recording."""
    Recorder(cuda=False).start()
    try:
        fn()
    finally:
        events = _disable_profiler().events()
    return [(e.name(), e.is_user_annotation()) for e in events]


@pytest.mark.parametrize("cls", [Timer, EventTimer])
def test_sections_mark_the_profiler_trace(cls):
    t, off = cls(CPU), Timer(CPU, enabled=False)

    def run():
        with t.section("a"):
            with t.section("b"):
                torch.ones(4).add_(1)
            with off.section("c"):
                torch.ones(4).add_(1)
    got = _recorded(run)
    assert ("a", False) in got and ("a/b", False) in got
    assert not any(n in ("b", "c", "a/c") for n, _ in got)
    assert t.counts == {"a": 1, "a/b": 1}


def test_timed_step_marks_every_section_in_the_trace(case):
    fc = FusedCycle(case["driver"], case["template"], nsteps=2, timed=True)
    ens = type(case["ens"])(*(f.clone() for f in case["ens"]))

    def run():
        fc.step(ens, case["dat"].clone(), fc.initial_inflation())
    got = _recorded(run)
    names = [n for n, _ in got]
    for k, c in fc.timer.counts.items():
        assert names.count(k) == c, k
    assert not any(u for n, u in got if n in fc.timer.counts)


def test_no_range_without_a_profiler_or_when_disabled(monkeypatch):
    opened = []

    def fast(name):
        opened.append(name)
        raise AssertionError(f"range {name} opened")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fast)
    assert not torch.autograd._profiler_enabled()
    t = EventTimer(CPU)
    with t.section("a"):
        with t.section("b"):
            pass
    assert t.counts == {"a": 1, "a/b": 1}
    Recorder(cuda=False).start()
    try:
        with Timer(CPU, enabled=False).section("c"):
            pass
    finally:
        _disable_profiler()
    assert opened == []
