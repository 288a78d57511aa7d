"""The yardstick's arithmetic on fixed inputs: peaks and bounds, the SI
step's byte model, the idle union, TF32 rounding."""

import pytest
import torch

from benchmark import roofline as R
from benchmark import trace as T
from benchmark.reference import letkf as L


def test_kernel_bounds():
    # kernel #1 on 28,928 Grams of K = 50: operations bound, as the smoke
    # counts them (5.70 ms a level chunk)
    assert R.invsqrt_s(28928, 50) == pytest.approx(
        62 * 2 * 64 ** 3 * 28928 / (495e12 / 3))
    assert R.invsqrt_s(28928, 50) * 1e3 == pytest.approx(5.70, abs=0.01)
    # kernels #2 and #3 over 10 members at 18 km: bytes bound (0.821 and
    # 1.191 ms, the smoke's own operands)
    assert R.dyn_tendency_s(10, 36, 360, 480) * 1e3 == pytest.approx(0.821,
                                                                     abs=0.002)
    assert R.adv_ud3_s(10, 36, 360, 480) * 1e3 == pytest.approx(1.191,
                                                                abs=0.002)


def test_si_step_bytes():
    S = 11 * 36 * 360 * 480 * 4
    ns = 3 + 5 + 10
    assert R.si_step_bytes(36, 360, 480, 10) == pytest.approx(
        6 * S + ns * 10 / 11 * S)
    assert R.si_step_bytes(36, 360, 480, 10, 5) == pytest.approx(
        6 * S + ns * 10 / 11 * S + 2 * S / 5)


def test_analysis_bound_is_the_larger_part():
    b = R.analysis_s(1000, 50, 0.0)
    assert b == pytest.approx(max(2 * 4 * 50 * 11 * 1000 / R.HBM_BYTES_PER_S,
                                  2 * 50 * 50 * 11 * 1000 / 67e12
                                  + 62 * 2 * 64 ** 3 * 1000 / (495e12 / 3)))


def test_union_and_gaps():
    iv = [(0.0, 10.0), (5.0, 20.0), (30.0, 40.0), (35.0, 36.0)]
    assert T.union_s(iv) == pytest.approx(30e-6)
    assert T.gaps(iv, 0.0, 50.0) == [(20.0, 30.0), (40.0, 50.0)]


def test_trace_reading():
    ev = [("kernel", "ns_fused_kernel<64>", 0.0, 100.0),
          ("kernel", "dyn_tendency_kernel", 150.0, 200.0),
          ("cpu_op", "aten::item", 90.0, 170.0),
          ("cpu_op", "outer", 0.0, 300.0)]
    got = T.summarize(ev)
    assert got["busy_s"] == pytest.approx(150e-6)
    assert got["idle_gaps"] == [["aten::item", pytest.approx(50e-6)]]
    assert T.kernel_s(got["kernels"], "ns_fused") == pytest.approx(100e-6)


def test_recorder_reads_kineto_events():
    rec = T.Recorder(cuda=False)
    rec.start()
    torch.ones(64, 64) @ torch.ones(64, 64)
    events = rec.stop()
    assert any(cat == "cpu_op" and "mm" in name and e >= s
               for cat, name, s, e in events)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -11,
                      1.0 + 2 ** -10])
    assert L._tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -1.0, 1.0 + 2 ** -10]


def test_thinning_keeps_every_nth():
    x = torch.zeros(10).numpy() + 0.5
    keep = L.thin(x, x, 0.0, 0.0, 1.0, 1.0, 1.0, 4)
    assert keep.sum() == 4
    assert keep.tolist() == [False, False, True, False, True, False, False,
                             True, False, True]
