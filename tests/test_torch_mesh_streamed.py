"""The member-streamed cycle on the port's process grid (da/bigcycle.py
StreamedCycle on CycleDriver(mesh=)), on the CPU: each member batch's
forecast on the grid, everything else undecomposed, against the port's
undecomposed stream exactly and against the JAX package's stream on its
mesh driver.

Exactness. The grid forecasts every block with the undecomposed
arithmetic and the stream gathers each batch before H(x), so the grid
stream's restart ensembles, skin temperatures, O−A and O−B / O−A tables
equal the undecomposed stream's bit for bit (rtol = atol = 0). The
production composition of tests/test_torch_bigcycle.py (a hill, the
physics suite, per-member Davies forcing, the 3-slot window) runs at
16 × 16 columns, K = 6, batches of 2 members — three batches, so a batch
that relaxed toward another batch's boundary members or started from
another batch's skin temperature would show — over two cycles, the second
resuming the first's skin temperature (gpu_check.streamed_grid_on_device).
Every block plane is a multiple of 32 there (tests/test_torch_mesh_
physics.py says why the CPU needs that).

Against the JAX package: its StreamedCycle on a make_mesh(2, 2, 2) driver
of the 8 virtual devices (the gspmd halo: its physics does not compose
with its explicit one), the port's on make_mesh(2, 2, 2), both in batches
of 2 members, tests/test_torch_bigcycle.py's flat composition (16 × 12,
K = 6) at its bounds: the guess and the analysis per variable to
1e-4·max|Δ_ref| + 6 ulp plus twice the port's own rounding floor (a grid
run from inputs perturbed by one rounding), the analysis plus one
bfloat16 spacing of x′; H(x) to 2e-5 of its range plus 4 ulp plus the
floor; QC exactly equal; the restart by assert_increments.
"""

import types

import numpy as np
import pytest
import torch

from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_tpu.cli.main import make_driver as ref_make_driver
from scale_letkf_tpu.da.bigcycle import StreamedCycle as RefStreamed
from scale_letkf_tpu.model.dycore import DycoreState as RefState
from scale_letkf_torch import gpu_check
from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
from scale_letkf_torch.da.bigcycle import StreamedCycle, stream_batch
from scale_letkf_torch.da.obsmake import obsmake
from scale_letkf_torch.io.convert import dycore_state_to_torch
from scale_letkf_torch.model.dycore import to_collocated
from scale_letkf_torch.parallel.mesh import ProcessGrid, make_mesh
from scale_letkf_torch.state import state_to_history, state_trans
from test_torch_bigcycle import (
    ROWS, STEPS, anal_vars, assert_hx, assert_vars, ref_obs, var_floor,
)
from test_torch_cycle import (
    CONFIG, CPU, K, OVER, assert_increments, rounded, states, template,
)

torch.set_num_threads(1)
BATCH = 2
SQUARE = {**OVER, "ny": 16}


def test_stream_batch_is_a_multiple_of_the_member_slabs():
    """The largest divisor of K not above the request that the grid's
    member slabs divide: batch_of undecomposed, n_member · batch_of(K /
    n_member, request // n_member) on a grid."""
    assert stream_batch(50, 10) == 10 and stream_batch(6, 4) == 3
    assert stream_batch(50, 10, make_mesh(2, 2, 2)) == 10
    assert stream_batch(6, 4, make_mesh(2, 1, 1)) == 2
    assert stream_batch(6, 4, make_mesh(1, 2, 2)) == 3
    assert stream_batch(20, 3, make_mesh(4, 1, 1)) == 4
    with pytest.raises(ValueError, match="does not divide"):
        stream_batch(5, 4, make_mesh(2, 1, 1))


def test_streamed_cycle_refuses_a_world_of_processes():
    """A grid spread over processes: the stream keeps the ensemble and the
    tiled analysis in one process, so it refuses (the CLI with its own
    message, tests/test_torch_cli.py)."""
    d = types.SimpleNamespace(mesh=ProcessGrid(2, 2, 2, rank=1, world=2))
    with pytest.raises(ValueError, match="runs in one process"):
        StreamedCycle(d)
    StreamedCycle(types.SimpleNamespace(mesh=make_mesh(2, 2, 2)))


@pytest.mark.parametrize("shape,pipeline", [((2, 2, 2), False),
                                            ((1, 2, 2), False),
                                            ((2, 1, 1), True)])
def test_grid_stream_is_undecomposed(shape, pipeline):
    """The production composition over two cycles on the grid, bit for
    bit the undecomposed stream's; the driver's own skin temperature and
    boundary data untouched (each batch carries its own)."""
    r = gpu_check.streamed_grid_on_device(
        CPU, CONFIG, 0, shape=shape, member_batch=BATCH, pipeline=pipeline,
        cycles=2, over=SQUARE, members=K)
    assert r["batches"] == K // BATCH == 3
    assert r["bit_equal"] and r["stats_equal"], {
        k: v for k, v in r["distance"].items() if v}
    assert r["driver_untouched"]
    assert {f"{n}.{c}" for n in ("rhot", "tsfc", "oma")
            for c in (0, 1)} <= r["distance"].keys()
    assert not any(r["distance"].values())


def _mesh_drivers():
    """(reference driver on its make_mesh(2, 2, 2), port driver on
    make_mesh(2, 2, 2), a second port grid driver for the rounded run, the
    port's grid and cfg, the [domain] table, the reference grid)."""
    out = []
    for load, make in ((ref_load, ref_make_driver),
                       (load_config_and_grid, make_driver),
                       (load_config_and_grid, make_driver)):
        cfg, grid, dycfg, dom = load(CONFIG, OVER)
        cfg.ensemble.member = K
        cfg.letkf.hdxb_gather_bf16 = False
        cfg.process.mesh_member = cfg.process.mesh_y = 2
        cfg.process.mesh_x = 2
        d = (make(cfg, grid, dycfg, dom) if make is ref_make_driver
             else make(cfg, grid, dycfg, dom, CPU))
        assert d.mesh is not None
        out.append((d, grid, cfg, dom))
    (d_r, g_r, _, dom), (d, g, cfg, _), (alt, _, _, _) = out
    return d_r, d, alt, g, cfg, dom, g_r


def test_grid_stream_matches_reference():
    """The guess, the slot-free H(x) and QC, the analysis and the restart
    of the port's grid stream against the reference's mesh stream."""
    d_r, d, alt, g, cfg, dom, g_r = _mesh_drivers()
    nature, ens = states(g_r, dom)
    _, tmpl = template(cfg, g)
    nat_t = dycore_state_to_torch(nature, CPU)
    obs = obsmake(state_to_history(state_trans(to_collocated(nat_t)),
                                   d.z_full, d.topo),
                  tmpl, g, cfg, d.z_full, np.random.default_rng(2))
    sc_r = RefStreamed(d_r, member_batch=BATCH, tile_rows=ROWS)
    obs_r = ref_obs(obs)
    gues_r, ensval_r, qc_r, t_r = sc_r.forecast_and_hx(RefState(*ens),
                                                       STEPS, obs_r)
    gues_r0 = gues_r.copy()
    anal_r, _, _, _ = sc_r.analysis(gues_r, obs_r, ensval_r, qc_r)
    out_r = sc_r.to_state(anal_r)[0]

    sc = StreamedCycle(d, member_batch=BATCH, tile_rows=ROWS)
    gues, ensval, qc, t = sc.forecast_and_hx(ens, STEPS, obs)
    sc_b = StreamedCycle(alt, member_batch=BATCH, tile_rows=ROWS)
    gues_b, ensval_b, qc_b, _ = sc_b.forecast_and_hx(rounded(ens, 5), STEPS,
                                                     obs)
    assert t["batches"] == t_r["batches"] == K // BATCH
    init = anal_vars(ens)
    assert_vars(gues, init, gues_r0, var_floor(gues_b, gues))
    np.testing.assert_array_equal(qc, qc_r)
    good = qc == 0
    assert good.sum() > 100
    for e in np.unique(obs.elem):
        m = good & (obs.elem == e)
        assert_hx(ensval[:, m], ensval_r[:, m], ensval_b[:, m])
    anal, _, _, _ = sc.analysis(gues, obs, ensval, qc)
    anal_b, _, _, _ = sc_b.analysis(gues_b, obs, ensval_b, qc_b)
    assert_vars(anal, init, anal_r, var_floor(anal_b, anal),
                anal_r - anal_r.mean(axis=0))
    out, _ = sc.to_state(anal_r)
    assert_increments(out, ens, out_r)
