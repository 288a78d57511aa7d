"""The device-resident cycle (da/resident.py) against the reference
package's, and against the port's streamed cycle, on the CPU.

Configuration: tests/test_torch_bigcycle.py's production composition (the
18-km configuration on 16×12×8, K = 6, a 500-m hill, the physics suite,
per-member Davies forcing from a boundary file, obs by obsmake from the
nature state) with a 3-D window of 4 steps, integrated in calls of at most
2 steps (max_steps_per_call): a segment boundary inside the window, where
the physics suite restarts its radiation index.

Tolerances. Port against reference, on one executor, quantize the same
deviations the same way (the bfloat16 casts agree bit for bit), so the
bounds are tests/test_torch_bigcycle.py's: each analysis variable to
1e-4·max|Δ_ref| plus 6 ulp, plus twice the port's own rounding floor (a run
from rounded inputs), plus one bfloat16 spacing (≤ 2⁻⁷·|x′|) of the
deviations per element. Resident against streamed: the reference's own
yardstick (tests/test_resident.py), 4e-2 of the field scale and O−B / O−A
RMSE within 10%, because the resident path starts from deviations
quantized to bfloat16.
"""

import numpy as np
import pytest
import torch

from scale_letkf_tpu.da.resident import ResidentCycle as RefResident
from scale_letkf_tpu.da.resident import ResidentEnsemble as RefEnsemble
from scale_letkf_torch.da.bigcycle import StreamedCycle
from scale_letkf_torch.da.resident import ResidentCycle, ResidentEnsemble
from scale_letkf_torch.io.convert import dycore_state_to_numpy
from scale_letkf_torch.model.dycore import DycoreState, from_collocated
from scale_letkf_torch.state import state_trans_inv
from test_torch_bigcycle import (
    BATCH, ROWS, anal_vars, assert_hx, assert_vars, production_case,
    ref_obs, var_floor,
)
from test_torch_cycle import CPU

torch.set_num_threads(1)
STEPS, CALL = 4, 2


def test_resident_roundtrip_matches_reference():
    """from_host_gues and to_host_gues: the float32 mean, the bfloat16
    deviations and the members rebuilt from them, bit for bit."""
    rng = np.random.default_rng(0)
    gues = (280.0 + rng.standard_normal((5, 11, 4, 8, 8))).astype(
        np.float32)
    re_r = RefEnsemble.from_host_gues(gues, batch=2)
    re = ResidentEnsemble.from_host_gues(gues, batch=2, device=CPU)
    assert re.dev.dtype == torch.bfloat16 and re.K == 5
    np.testing.assert_array_equal(re.mean.numpy(), np.asarray(re_r.mean))
    np.testing.assert_array_equal(
        re.dev.view(torch.int16).numpy(),
        np.asarray(re_r.dev).view(np.int16))
    back = re.to_host_gues(batch=2)
    np.testing.assert_array_equal(back, re_r.to_host_gues(batch=2))
    dev_scale = np.abs(gues - gues.mean(axis=0)).max()
    np.testing.assert_allclose(back, gues, atol=0.01 * dev_scale)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d_r, d, alt, ens, obs = production_case(
        tmp_path_factory.mktemp("resident"), slots=False)
    anal0 = anal_vars(ens)
    rc = RefResident(d_r, member_batch=BATCH, tile_rows=ROWS,
                     max_steps_per_call=CALL)
    re_r = RefEnsemble.from_host_gues(anal0, batch=2)
    rep_r = rc.cycle(re_r, ref_obs(obs), STEPS)
    ref = {"anal": re_r.to_host_gues(batch=2), "rep": rep_r,
           "tsfc": np.asarray(re_r.tsfc), "oma": np.asarray(rc.last_oma),
           "dep": np.asarray(rc.last_ctx.dep),
           "qc": np.asarray(rc.last_ctx.qc)}
    return d, alt, ens, obs, anal0, ref


def run_port(driver, anal0, obs):
    rc = ResidentCycle(driver, member_batch=BATCH, tile_rows=ROWS,
                       max_steps_per_call=CALL)
    re = ResidentEnsemble.from_host_gues(anal0, batch=2, device=CPU)
    rep = rc.cycle(re, obs, STEPS)
    return rc, re, rep


def rounded_vars(a, seed):
    """a with each element perturbed by one float32 rounding."""
    rng = np.random.default_rng(seed)
    return (a * (1.0 + 2.0 ** -24 * rng.standard_normal(a.shape))).astype(
        np.float32)


def test_resident_cycle_matches_reference(case):
    d, alt, ens, obs, anal0, ref = case
    rc, re, rep = run_port(d, anal0, obs)
    rc_b, re_b, _ = run_port(alt, rounded_vars(anal0, 6), obs)
    rep_r = ref["rep"]
    assert rep["batches"] == rep_r["batches"] == 2
    assert rep["letkf_tiles"] == rep_r["letkf_tiles"] == 3
    anal, anal_b = re.to_host_gues(), re_b.to_host_gues()
    pert_r = ref["anal"] - ref["anal"].mean(axis=0)
    assert np.isfinite(anal).all()
    assert_vars(anal, anal0, ref["anal"], var_floor(anal_b, anal), pert_r)
    assert np.abs(anal - anal0).max() > 0
    # the skin temperature at the analysis time
    tsfc, tsfc_b = re.tsfc.numpy(), re_b.tsfc.numpy()
    tol = (1e-4 * np.abs(ref["tsfc"] - anal0[:, 3, 0]).max()
           + 4 * np.spacing(np.float32(np.abs(ref["tsfc"]).max()))
           + 2 * np.abs(tsfc - tsfc_b).max())
    assert np.abs(tsfc - ref["tsfc"]).max() <= tol
    # per-obs O−B and O−A, with the floor; QC exactly equal
    ctx, ctx_b = rc.last_ctx, rc_b.last_ctx
    np.testing.assert_array_equal(ctx.qc, ref["qc"])
    good = ctx.qc == 0
    assert good.sum() > 100
    for e in np.unique(ctx.elem[good]):
        m = good & (ctx.elem == e)
        assert_hx(ctx.dep[m], ref["dep"][m], ctx_b.dep[m])
        assert_hx(rc.last_oma[m], ref["oma"][m], rc_b.last_oma[m])
    assert rep["stats_gues"].nobs == rep_r["stats_gues"].nobs
    # the obs-space arrays are all that crossed the host link: less, each
    # way, than one member
    assert 0 < rep["h2d_bytes"] < anal0[0].nbytes
    assert 0 < rep["d2h_bytes"] < anal0[0].nbytes


def test_resident_matches_streamed(case):
    """Both executors from the same analysis-variable ensemble (the
    streamed side from its restart): the analysis to 4e-2 of the field
    scale, and the O−B / O−A RMSE within 10% (tests/test_resident.py)."""
    d, alt, ens, obs, anal0, _ = case
    _, re, rep_r = run_port(d, anal0, obs)
    restart = from_collocated(state_trans_inv(torch.from_numpy(anal0)))
    ens_rt = DycoreState(*dycore_state_to_numpy(restart))
    sc = StreamedCycle(d, member_batch=BATCH, tile_rows=ROWS)
    gues, ensval, qc, _ = sc.forecast_and_hx(ens_rt, STEPS, obs)
    anal_s, _, _, _ = sc.analysis(gues, obs, ensval, qc)
    anal_r = re.to_host_gues()
    scale = max(np.abs(anal_s).max(), 1e-6)
    np.testing.assert_allclose(anal_r, anal_s, atol=4e-2 * scale, rtol=4e-2)
    sc = StreamedCycle(d, member_batch=BATCH, tile_rows=ROWS)
    _, _, rep_s = sc.cycle(ens_rt, obs, STEPS)
    for key in ("stats_gues", "stats_anal"):
        rs, rr = rep_s[key], rep_r[key]
        for v in rs.rmse:
            if rs.nobs[v]:
                assert abs(rr.rmse[v] - rs.rmse[v]) < 0.1 * rs.rmse[v] + 1e-3
    np.testing.assert_allclose(re.tsfc.numpy(), sc.tsfc_host, rtol=1e-4,
                               atol=1e-2)
