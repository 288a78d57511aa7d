"""The host-streamed tiled analysis (da/letkf_tiled.py) against the
reference package's analyze_tiled and against the port's own analyze, on
the CPU.

Inputs: tests/test_torch_analyze.py's (configs/18km_japan.toml coarsened to
24×20×4, K = 20, a synthetic conventional network, ensemble H(x) from the
obs values plus noise at the obs error), the same numpy arrays to both
packages; tiles of 8 rows (20 is not a multiple: the largest divisor, 5).

Tolerances. Against the reference's tiled analysis, which casts the same
float32 perturbations to bfloat16 (both round to nearest even, so the
uploads agree bit for bit): each variable's increment to 1e-4·max|Δ| plus
2 ulp of its largest value (tests/test_torch_analyze.py's bound), plus
2⁻⁷·|x′| per element: one bfloat16 spacing of the analysis perturbation x′
(bfloat16 keeps 8 significant bits, so the spacing at |x′| in [2ᵉ, 2ᵉ⁺¹)
is 2ᵉ⁻⁷), by which a last-bit difference of x′ may flip its rounding. Against the port's in-core
analyze: the reference's own tolerance for its tiled executor,
2e-2 of the perturbation scale (tests/test_letkf_tiled.py).
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scale_letkf_tpu.da.letkf_obs import build_obs_context as ref_context
from scale_letkf_tpu.da.letkf_tiled import analyze_tiled as ref_tiled
from scale_letkf_torch import state
from scale_letkf_torch.da import letkf
from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.da.letkf_tiled import analyze_tiled, tile_rows_of
from scale_letkf_torch.io.convert import ensemble_to_torch
from test_torch_analyze import _configs, _inputs

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROWS = 8


def assert_tiled_close(anal, anal_r, gues):
    """Per variable: |Δ − Δ_ref| ≤ 1e-4·max|Δ_ref| + 2 ulp(max|x|) +
    2⁻⁷·|x′_ref| (x′ the reference's analysis perturbation)."""
    pert_r = anal_r - anal_r.mean(axis=0)
    for v in range(gues.shape[1]):
        inc, inc_r = anal[:, v] - gues[:, v], anal_r[:, v] - gues[:, v]
        tol = (1e-4 * np.abs(inc_r).max()
               + 2 * np.spacing(np.abs(gues[:, v]).max())
               + 2.0 ** -7 * np.abs(pert_r[:, v]))
        err = np.abs(inc - inc_r)
        assert (err <= tol).all(), (v, float((err - tol).max()))


def _case(mod=None):
    cfg_r, grid_r, cfg, grid = _configs("rtpp")
    for c in (cfg_r, cfg):
        if mod is not None:
            mod(c)
    restart, obs, ensval = _inputs(cfg, grid)
    gues = state.state_trans(ensemble_to_torch(restart, CPU)).numpy()
    qc = np.zeros(obs.nobs, np.int32)
    ctx_r = ref_context(obs, ensval, qc, cfg_r, grid_r)
    ctx = build_obs_context(obs, ensval, qc, cfg, grid)
    z = np.asarray(grid.calc_z(torch.zeros((grid.ny, grid.nx))))
    return cfg_r, grid_r, ctx_r, cfg, grid, ctx, gues, z


@pytest.fixture(scope="module")
def plain():
    cfg_r, grid_r, ctx_r, cfg, grid, ctx, gues, z = _case()
    with pltpu.force_tpu_interpret_mode():
        anal_r, _, st_r = ref_tiled(gues, ctx_r, cfg_r, grid_r, z,
                                    tile_rows=ROWS)
    anal, infl, st = analyze_tiled(gues, ctx, cfg, grid, z, tile_rows=ROWS,
                                   device=CPU)
    return cfg, grid, ctx, gues, z, np.asarray(anal_r), anal, st_r, st


def test_tiled_matches_reference(plain):
    cfg, grid, ctx, gues, z, anal_r, anal, st_r, st = plain
    assert st["tiles"] == st_r["tiles"] == 4
    assert st["tile_rows"] == tile_rows_of(grid.ny, ROWS) == 5
    assert set(st_r) <= set(st)
    assert np.isfinite(anal).all()
    assert_tiled_close(anal, anal_r, gues)
    assert np.abs(anal - gues).max() > 0


def test_tiled_matches_incore_analyze(plain):
    cfg, grid, ctx, gues, z, _, anal, _, _ = plain
    want, _ = letkf.analyze(torch.from_numpy(gues), ctx, cfg, grid,
                            torch.from_numpy(z), device=CPU)
    scale = np.abs(gues - gues.mean(0)).max()
    np.testing.assert_allclose(anal, want.numpy(), atol=2e-2 * scale,
                               rtol=2e-2)


def test_tiled_pipeline_matches_plain(plain):
    """The pipelined stream gives the same analysis, written in place."""
    cfg, grid, ctx, gues, z, _, anal, _, _ = plain
    buf = gues.copy()
    out, _, st = analyze_tiled(buf, ctx, cfg, grid, z, tile_rows=ROWS,
                               out=buf, pipeline=True, device=CPU)
    assert out is buf and st["pipelined"] and "stream_s" in st
    np.testing.assert_array_equal(out, anal)


def _deflation(c):
    c.letkf.infl_mul = 0.9


def _adaptive(c):
    c.letkf.infl_mul = 1.0
    c.letkf.infl_mul_adaptive = True
    c.letkf.infl_mul_min = 1.0


@pytest.mark.parametrize("mod", [_deflation, _adaptive],
                         ids=["deflation", "adaptive"])
def test_tiled_inflation_matches_reference(mod):
    """Deflation (0 < INFL_MUL < 1) reaches the tiles as it is; the
    adaptive field comes back, and a prior field goes in, as the
    reference's."""
    cfg_r, grid_r, ctx_r, cfg, grid, ctx, gues, z = _case(mod)
    prior = None
    if mod is _adaptive:
        prior = (1.0 + 0.1 * np.random.default_rng(3).random(
            (grid.nz, grid.ny, grid.nx))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        anal_r, infl_r, _ = ref_tiled(gues, ctx_r, cfg_r, grid_r, z,
                                      infl_field=prior, tile_rows=ROWS)
    anal, infl, _ = analyze_tiled(gues, ctx, cfg, grid, z, infl_field=prior,
                                  tile_rows=ROWS, device=CPU)
    assert_tiled_close(anal, np.asarray(anal_r), gues)
    assert (infl is None) == (infl_r is None) == (mod is _deflation)
    if infl is not None:
        np.testing.assert_allclose(infl, infl_r, rtol=1e-5)
        assert not np.array_equal(infl, prior)


@pytest.mark.parametrize("kw", [
    {"infl_add": 0.5}, {"relax_spread_out": True, "relax_alpha_spread": 0.9},
    {"det_run": True}], ids=["infl_add", "rtps_out", "det_run"])
def test_tiled_guards_raise(kw):
    """The features the tile loop does not thread raise, as the
    reference's do."""
    _, _, _, cfg, grid, ctx, gues, z = _case()
    for k, v in kw.items():
        setattr(cfg.ensemble if k == "det_run" else cfg.letkf, k, v)
    with pytest.raises(NotImplementedError, match="tiled analysis"):
        analyze_tiled(gues, ctx, cfg, grid, z, tile_rows=ROWS, device=CPU)
