"""The full-size benches (scale_letkf_torch/bench_fullsize.py) against the
reference package's, on the CPU, from the same numpy inputs at small sizes.

- The host generators (_host_profiles, _synthetic_ens_dycore) bit-equal;
  _make_fullsize_driver's topography, boundary base state and physics
  configuration equal to what the reference hands its CycleDriver.
- _synthetic_resident_gues from the same noise: the reference draws it by
  jax.random.normal, here replaced by the numbers the port's noise seam
  gets (a numpy generator per seed and batch). The mean to float32 rtol
  1e-6 plus the summation floor of its K members (2·K ulp of the largest
  member value: the port sums the members in member order, the reference
  by batches); the bfloat16 deviations within one bfloat16 spacing.
- The cycle benches at tests/test_fullsize_cycle.py's SMALL shapes: the
  same obs counts, and O−B / O−A within tests/test_torch_bigcycle.py's
  bound (1e-4 relative) plus one unit of the printed precision; the
  resident full-window bench with its 4-D slots (slot interval cut to two
  steps) also on the analysis-time slot's obs, and the same window span.
- The analysis benches (configuration coarsened through _load_cfg, K = 20
  so that the solver is kernel #1's plain version and the reference's Pallas
  kernel runs in interpret mode): the analysis on the same inputs within
  tests/test_torch_letkf_tiled.py's bound; the resident ones with the
  guess means first held to the resident ensemble's bound, twice which
  widens the analysis's.
- bench_osse_impact at tests/test_fullsize_cycle.py's coarsened shape with
  the same noise: the four curves within OSSE_RTOL of the reference's, and
  the reference test's own assertions on the port's curves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import scale_letkf_tpu.bench_fullsize as R
import scale_letkf_tpu.cycle as ref_cycle
import scale_letkf_tpu.da.letkf_tiled as ref_tiled
import scale_letkf_tpu.da.resident as ref_resident
from scale_letkf_torch import bench_fullsize as B
from scale_letkf_torch.da import letkf_tiled, resident

torch.set_num_threads(1)
CPU = torch.device("cpu")
CONFIG = "configs/18km_japan.toml"
RADAR = "configs/bda_1km_radar.toml"
SMALL = {"nx": 16, "ny": 16, "nz": 12}
RADAR_SMALL = dict(SMALL, dx=3000.0, dy=3000.0)
# the OSSE curves, port against reference: relative to the reference's
# value (float32 forecasts of 32 steps from the same states)
OSSE_RTOL = 1e-3


def assert_tiled_close(anal, anal_r, gues, floor=None):
    """tests/test_torch_letkf_tiled.py's bound, per variable: |Δ − Δ_ref| ≤
    1e-4·max|Δ_ref| + 2 ulp(max|x|) + 2⁻⁷·|x′_ref| (x′ the reference's
    analysis perturbation), plus floor[v] where given."""
    pert_r = anal_r - anal_r.mean(axis=0)
    for v in range(gues.shape[1]):
        inc, inc_r = anal[:, v] - gues[:, v], anal_r[:, v] - gues[:, v]
        tol = (1e-4 * np.abs(inc_r).max()
               + 2 * np.spacing(np.abs(gues[:, v]).max())
               + 2.0 ** -7 * np.abs(pert_r[:, v])
               + (0.0 if floor is None else floor[v]))
        err = np.abs(inc - inc_r)
        assert (err <= tol).all(), (v, float((err - tol).max()))


def rounded(a, seed):
    """a with each element off by one float32 rounding."""
    rng = np.random.default_rng(seed)
    return (a * (1.0 + 2.0 ** -24 * rng.standard_normal(a.shape))).astype(
        np.float32)


def noise_of(seed):
    """(i0, shape) → the float32 standard normal noise of the member batch
    starting at i0 (a numpy generator per seed and batch)."""
    def noise(i0, shape):
        return np.random.default_rng([seed, i0]).standard_normal(
            shape, dtype=np.float32)
    return noise


def patch_same_noise(monkeypatch):
    """Both packages' _synthetic_resident_gues draw noise_of(seed): the
    reference's through a jax.random.normal that returns it, called eagerly
    once per batch (jax.disable_jit), the port's through its noise seam."""
    ref_gen, port_gen = R._synthetic_resident_gues, B._synthetic_resident_gues

    def ref(seed, K, grid, batch=10, t_offset=0.0, smooth_strides=(1,)):
        noise, at = noise_of(seed), [0]

        def normal(key, shape, dtype=jnp.float32):
            out = noise(at[0], shape)
            at[0] += shape[0]
            return jnp.asarray(out, dtype)
        with monkeypatch.context() as m, jax.disable_jit():
            m.setattr(jax.random, "normal", normal)
            return ref_gen(seed, K, grid, batch, t_offset, smooth_strides)

    def port(seed, K, grid, batch=10, t_offset=0.0, smooth_strides=(1,), *,
             device):
        return port_gen(seed, K, grid, batch, t_offset, smooth_strides,
                        device=device, noise=noise_of(seed))

    monkeypatch.setattr(R, "_synthetic_resident_gues", ref)
    monkeypatch.setattr(B, "_synthetic_resident_gues", port)
    return ref, port


@pytest.fixture
def same_noise(monkeypatch):
    return patch_same_noise(monkeypatch)


def test_host_generators_bit_equal():
    cfg, grid, _, dom = B._load_cfg(CONFIG, SMALL)
    _, grid_r, _, dom_r = R._load_cfg(CONFIG, SMALL)
    for a, b in zip(B._host_profiles(grid, dom),
                    R._host_profiles(grid_r, dom_r)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for qr_blob in (0.0, 2e-3):
        s, rho_ref, p_ref = B._synthetic_ens_dycore(
            np.random.default_rng(3), 3, grid, dom, qr_blob=qr_blob)
        s_r, rho_r, p_r = R._synthetic_ens_dycore(
            np.random.default_rng(3), 3, grid_r, dom_r, qr_blob=qr_blob)
        for a, b in zip((*s, rho_ref, p_ref), (*s_r, rho_r, p_r)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("production", [True, False])
def test_make_fullsize_driver_matches_reference(monkeypatch, production):
    """The topography, the boundary base state, the physics configuration
    and the composition's settings the reference hands its CycleDriver."""
    seen = {}

    class Recording(ref_cycle.CycleDriver):
        def __init__(self, *args, **kw):
            seen.update(kw)
            super().__init__(*args, **kw)

    monkeypatch.setattr(ref_cycle, "CycleDriver", Recording)
    cfg, grid, dycfg, dom = B._load_cfg(CONFIG, SMALL)
    cfg_r, grid_r, dycfg_r, dom_r = R._load_cfg(CONFIG, SMALL)
    rho_ref, p_ref = B._ref_columns(grid, dom)
    d = B._make_fullsize_driver(cfg, grid, dycfg, dom, rho_ref, p_ref,
                                production=production, device=CPU)
    R._make_fullsize_driver(cfg_r, grid_r, dycfg_r, dom_r, rho_ref, p_ref,
                            production=production)
    assert d.use_physics == seen["use_physics"]
    assert (d.core, d.n_small) == (seen["core"], seen["n_small"]) == (
        dom["core"], dom["n_small"])
    assert (d._bdy_w2d is None) == (seen["bdy_width"] == 0) == (
        not production)
    if not production:
        assert d.phys_cfg is seen["phys_cfg"] is None
        assert d.bdy is seen["bdy"] is None
        assert not bool(d.topo.any())
        return
    np.testing.assert_array_equal(d.topo.numpy(), seen["topo"])
    assert np.abs(seen["topo"]).max() > 10.0
    assert (dataclasses.asdict(d.phys_cfg)
            == dataclasses.asdict(seen["phys_cfg"]))
    assert d.phys_cfg.mp_scheme == "nsw6"
    assert seen["bdy_tau"] == dom.get("bdy_tau", 600.0)
    assert seen["bdy_width"] == dom.get("bdy_width", 8) > 0
    np.testing.assert_array_equal(d._bdy_w2d.numpy(),
                                  np.asarray(ref_relax(grid, seen)))
    for b0, r0 in ((d.bdy.state0, seen["bdy"].state0),
                   (d.bdy.state1, seen["bdy"].state1)):
        for a, b in zip(b0, r0):
            np.testing.assert_array_equal(a.numpy(), b)
    assert (d.bdy.t0, d.bdy.t1) == (seen["bdy"].t0, seen["bdy"].t1)


def ref_relax(grid, seen):
    from scale_letkf_tpu.model.boundary import relaxation_weight
    return relaxation_weight(grid.ny, grid.nx, seen["bdy_width"],
                             seen["bdy_tau"])


@pytest.mark.parametrize("strides", [(1,), (1, 2, 4, 8)],
                         ids=["one_stride", "multi_stride"])
def test_synthetic_resident_gues_matches_reference(same_noise, strides):
    ref, port = same_noise
    _, grid, _, _ = B._load_cfg(CONFIG, SMALL)
    _, grid_r, _, _ = R._load_cfg(CONFIG, SMALL)
    K = 6
    ens = port(4, K, grid, batch=4, t_offset=1.0, smooth_strides=strides,
               device=CPU)
    ens_r = ref(4, K, grid_r, batch=4, t_offset=1.0, smooth_strides=strides)
    assert ens.dev.dtype == torch.bfloat16 and ens.K == K
    np.testing.assert_array_equal(ens.ref.numpy(), np.asarray(ens_r.ref))
    mean, mean_r = ens.mean.numpy(), np.asarray(ens_r.mean)
    members = ens.ref.numpy()[None] + ens.dev.float().numpy()
    for v in range(mean.shape[0]):
        floor = 2 * K * np.spacing(np.float32(np.abs(members[:, v]).max()))
        np.testing.assert_allclose(mean[v], mean_r[v], rtol=1e-6,
                                   atol=floor / K, err_msg=str(v))
    dev = ens.dev.float().numpy()
    dev_r = np.asarray(ens_r.dev.astype(jnp.float32))
    assert np.all(np.abs(dev - dev_r) <= 2.0 ** -7 * np.abs(dev_r))
    assert np.abs(dev).max() > 0


def assert_departures(out, out_r, keys, digits):
    """|a − b| ≤ 1e-4·|b| + one unit of the printed precision."""
    for k in keys:
        assert abs(out[k] - out_r[k]) <= (1e-4 * abs(out_r[k])
                                          + 10.0 ** -digits), (k, out[k],
                                                               out_r[k])


def test_18km_cycle_matches_reference():
    kw = dict(nsteps=4, overrides=SMALL, members=4, member_batch=2,
              tile_rows=4, n_sonde=10, n_ps=10)
    out = B.bench_18km_cycle(device=CPU, **kw)
    out_r = R.bench_18km_cycle(**kw)
    for k in ("members", "nobs", "nobs_good", "composition", "steps_run",
              "window_steps", "batches", "letkf_tiles"):
        assert out[k] == out_r[k], k
    assert out["nobs_good"] > 0
    assert_departures(out, out_r, ("omb_rmse_T", "oma_rmse_T"), 4)
    assert out["oma_rmse_T"] <= out["omb_rmse_T"] * 1.05
    assert set(out_r) - set(out) == set()


def test_radar_cycle_matches_reference():
    kw = dict(overrides=RADAR_SMALL, members=4, member_batch=2, tile_rows=4,
              n_obs_target=4000)
    out = B.bench_radar_cycle(device=CPU, **kw)
    out_r = R.bench_radar_cycle(**kw)
    for k in ("members", "nobs", "nobs_good", "steps_run", "composition"):
        assert out[k] == out_r[k], k
    assert out["steps_run"] == 15 and out["nobs"] > 100
    assert ("omb_rmse_REF" in out) == ("omb_rmse_REF" in out_r)
    if "omb_rmse_REF" in out:
        assert_departures(out, out_r, ("omb_rmse_REF", "oma_rmse_REF"), 3)
    assert set(out_r) - set(out) == set()


def test_18km_cycle_resident_matches_reference(monkeypatch, same_noise):
    """The resident full-window bench with its 4-D slots (slot interval cut
    to 2 steps, so the window spans 6 + 3 × 2 steps): the truth's obs, the
    span and O−B / O−A, also on the analysis-time slot's obs."""
    for mod in (B, R):
        orig = mod._load_cfg

        def load(path, more=None, orig=orig):
            cfg, grid, dycfg, dom = orig(path, more)
            cfg.obsope.slot_tinterval = 2 * dycfg.dt
            return cfg, grid, dycfg, dom
        monkeypatch.setattr(mod, "_load_cfg", load)
    kw = dict(nsteps=6, slots=True, overrides=SMALL, members=4,
              member_batch=2, tile_rows=4, n_sonde=10, n_ps=10)
    out = B.bench_18km_cycle_resident(device=CPU, **kw)
    with pltpu.force_tpu_interpret_mode():
        out_r = R.bench_18km_cycle_resident(**kw)
    for k in ("members", "nobs", "nobs_good", "composition", "steps_run",
              "window_4d_slots", "window_span_steps_with_slots"):
        assert out[k] == out_r[k], k
    assert out["window_span_steps_with_slots"] == 12
    assert out["nobs_good"] > 0
    assert_departures(out, out_r, ("omb_rmse_T", "oma_rmse_T",
                                   "omb_rmse_T_centerslot",
                                   "oma_rmse_T_centerslot"), 4)
    assert set(out_r) - set(out) == set()
    assert (set(out_r["roofline"]) - set(out["roofline"])
            == {"v5e_hbm_peak_gbps"})
    assert out["roofline"]["si_step_bytes_model_gb"] == \
        out_r["roofline"]["si_step_bytes_model_gb"]


def _coarse_load(monkeypatch, overrides, members):
    """Both packages' _load_cfg coarsened to `overrides` with K members."""
    for mod in (B, R):
        orig = mod._load_cfg

        def load(path, more=None, orig=orig):
            cfg, grid, dycfg, dom = orig(path, {**overrides, **(more or {})})
            cfg.ensemble.member = members
            return cfg, grid, dycfg, dom
        monkeypatch.setattr(mod, "_load_cfg", load)


def _recording(monkeypatch, module, name, store, key, before=None):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        if before is not None:
            store[key + "_in"] = before(args[0])
        out = fn(*args, **kw)
        store[key] = out if before is None else before(args[0])
        return out
    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("name", ["radar", "18km"])
def test_tiled_analysis_benches_match_reference(monkeypatch, name):
    overrides = RADAR_SMALL if name == "radar" else SMALL
    _coarse_load(monkeypatch, overrides, 20)
    got = {}
    _recording(monkeypatch, letkf_tiled, "analyze_tiled", got, "port")
    _recording(monkeypatch, ref_tiled, "analyze_tiled", got, "ref")
    kw = {"n_obs_target": 4000} if name == "radar" else {}
    fn, fn_r = ((B.bench_radar_analysis, R.bench_radar_analysis)
                if name == "radar" else
                (B.bench_18km_analysis, R.bench_18km_analysis))
    out = fn(device=CPU, **kw)
    with pltpu.force_tpu_interpret_mode():
        out_r = fn_r(**kw)
    assert out["nobs"] == out_r["nobs"] > 100
    assert out["tiles"] == out_r["tiles"]
    assert set(out_r) - set(out) == set()
    anal, anal_r = got["port"][0], np.asarray(got["ref"][0])
    gues = R._synthetic_gues(np.random.default_rng(0), 20,
                             *(int(overrides[k]) for k in ("nz", "ny", "nx")),
                             np.asarray(B._load_cfg(
                                 RADAR if name == "radar" else CONFIG)[1].cz))
    assert np.isfinite(anal).all()
    assert_tiled_close(anal, anal_r, gues)
    assert np.abs(anal - gues).max() > 0


@pytest.mark.parametrize("name", ["radar", "18km"])
def test_resident_analysis_benches_match_reference(monkeypatch, same_noise,
                                                   name):
    """The same H(x) noise in both packages, and the port's analysis run from
    the reference's own guess ensemble: the port's generator gives that
    ensemble only to the resident ensemble's bound (checked first, as
    test_synthetic_resident_gues_matches_reference does), and a bfloat16
    spacing of a guess deviation is more than the analysis's bound allows.
    The analysis members against the reference's."""
    ref_gen, port_gen = same_noise
    overrides = RADAR_SMALL if name == "radar" else SMALL
    K = 20
    _coarse_load(monkeypatch, overrides, K)
    got, guess = {}, {}

    def members(ens):
        """(members, mean) of a resident ensemble, copied to the host (the
        port's analysis writes its buffers in place)."""
        dev = (ens.dev.float().numpy() if isinstance(ens.dev, torch.Tensor)
               else np.asarray(ens.dev.astype(jnp.float32)))
        return (np.asarray(ens.ref, np.float32)[None] + dev,
                np.array(ens.mean, np.float32))

    def ref_kept(*args, **kw):
        ens = ref_gen(*args, **kw)
        # the arrays, not the object: the analysis rebinds its fields
        guess.update(mean=np.array(ens.mean, np.float32),
                     dev=np.array(ens.dev.astype(jnp.float32)),
                     ref=np.array(ens.ref, np.float32))
        return ens

    def port_from_ref(seed, K, grid, *args, device, **kw):
        own = port_gen(seed, K, grid, *args, device=device, **kw)
        gues, mean = members(own)
        gues_r, mean_r = guess["ref"][None] + guess["dev"], guess["mean"]
        assert np.all(np.abs(gues - gues_r) <= 2.0 ** -7 * np.abs(
            guess["dev"]))
        for v in range(mean.shape[0]):
            np.testing.assert_allclose(
                mean[v], mean_r[v], rtol=1e-6,
                atol=2 * np.spacing(np.float32(np.abs(gues[:, v]).max())),
                err_msg=str(v))
        mean, ref = guess["mean"], guess["ref"]
        if guess.get("rounded"):
            mean, ref = rounded(mean, 6), rounded(ref, 7)
        return resident.ResidentEnsemble(
            torch.from_numpy(mean.copy()),
            torch.from_numpy(guess["dev"]).to(torch.bfloat16),
            ref=torch.from_numpy(ref.copy()))

    monkeypatch.setattr(R, "_synthetic_resident_gues", ref_kept)
    monkeypatch.setattr(B, "_synthetic_resident_gues", port_from_ref)
    _recording(monkeypatch, resident, "analyze_resident", got, "port",
               members)
    _recording(monkeypatch, ref_resident, "analyze_resident", got, "ref",
               members)

    def ens_noise(seed, shape, device):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            shape, dtype=np.float32))

    def normal(key, shape, dtype=jnp.float32):
        # the H(x) noise: the reference's key PRNGKey(seed + 1), the port's
        # _ensval_noise(seed + 1), seed 0
        return jnp.asarray(ens_noise(1, shape, None).numpy(), dtype)

    monkeypatch.setattr(B, "_ensval_noise", ens_noise)
    fn, fn_r = ((B.bench_radar_analysis_resident,
                 R.bench_radar_analysis_resident) if name == "radar" else
                (B.bench_18km_analysis_resident,
                 R.bench_18km_analysis_resident))
    kw = {"n_obs_target": 4000} if name == "radar" else {}
    with monkeypatch.context() as m, pltpu.force_tpu_interpret_mode():
        m.setattr(jax.random, "normal", normal)
        out_r = fn_r(**kw)
    out = fn(device=CPU, **kw)
    for k in ("nobs", "nobs_good", "tiles", "executor", "members"):
        assert out[k] == out_r[k], k
    assert out["nobs_good"] > 100
    assert set(out_r) - set(out) == {"new_compile_cache_entries"}
    for a, b in zip(got["port_in"], got["ref_in"]):
        np.testing.assert_array_equal(a, b)
    (anal, _), (anal_r, _) = got["port"], got["ref"]
    gues = got["ref_in"][0]
    assert np.isfinite(anal).all()
    assert np.abs(anal - gues).max() > 0
    # the port's own rounding floor: a run from a mean and a reference
    # profile each off by one float32 rounding (tests/test_torch_resident.py)
    guess["rounded"] = True
    fn(device=CPU, **kw)
    anal_b = got["port"][0]
    assert_tiled_close(anal, anal_r, gues, [
        2 * float(np.abs(anal[:, v] - anal_b[:, v]).max())
        for v in range(anal.shape[1])])


@pytest.fixture(scope="module")
def osse():
    """The reference test's coarsened OSSE in both packages, the same noise
    (module-scoped, so the patching is by hand)."""
    mp = pytest.MonkeyPatch()
    try:
        patch_same_noise(mp)
        kw = dict(members=16, n_cycles=3, steps_per_cycle=8, spinup_steps=8,
                  member_batch=8, tile_rows=4, n_sonde=40, n_ps=60,
                  overrides={"nx": 32, "ny": 24, "nz": 8, "n_small": 4},
                  infl_mul=1.1, relax_alpha=0.5, obs_err_scale=0.3)
        out = B.bench_osse_impact(device=CPU, **kw)
        out_r = R.bench_osse_impact(**kw)
    finally:
        mp.undo()
    return out, out_r


def test_osse_impact_matches_reference(osse):
    out, out_r = osse
    assert set(out_r) == set(out)
    for k in ("grid", "members", "n_cycles", "nobs", "nobs_good",
              "infl_mul", "relax_alpha", "composition"):
        assert out[k] == out_r[k], k
    for k in ("rmse_gues", "rmse_anal", "rmse_ctrl", "spread_gues"):
        np.testing.assert_allclose(out[k], out_r[k], rtol=OSSE_RTOL,
                                   atol=1e-4, err_msg=k)


def test_osse_impact_port_curves(osse):
    """tests/test_fullsize_cycle.py::test_osse_impact_coarsened's
    assertions, on the port's curves."""
    out, _ = osse
    g = np.asarray(out["rmse_gues"])
    a = np.asarray(out["rmse_anal"])
    c = np.asarray(out["rmse_ctrl"])
    assert np.isfinite(g).all() and np.isfinite(a).all()
    assert a.mean() < g.mean()
    assert g[-1] < c[-1] * 0.97


def test_tendency_fused_on_cpu():
    """On the CPU both paths are the plain versions: the same numbers."""
    res = B.bench_tendency_fused(nz=6, ny=8, nx=12, reps=2, device=CPU)
    assert res["fused_max_rel_err"] == 0.0
    assert res["grid"] == "6x8x12" and res["nq"] == 6
    for k in ("tendencies_xla_us", "tendencies_fused_us", "step_si_xla_ms",
              "step_si_fused_ms"):
        assert res[k] > 0


def test_cli_refuses_without_card_and_takes_nine_names(capsys):
    assert set(B.BENCHES) == {"radar", "18km", "radar_resident",
                              "18km_resident", "radar_cycle", "18km_cycle",
                              "18km_fullwindow", "tendency_fused",
                              "osse_impact"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.main(["tendency_fused"])
    with pytest.raises(SystemExit):
        B.main(["nonsense", "--device", "cpu"])


# the OSSE settings the smoke's shallow phase tried on the card: (spin-up
# steps, cycles, steps a cycle)
OSSE_SETTINGS = {"no_spinup_2x2": (0, 2, 2), "spinup2_3x4": (2, 3, 4),
                 "spinup2_2x2": (2, 2, 2)}


def osse_settings(name):
    """Both packages' bench_osse_impact at 48×36×36 (36 km), K = 50, 16
    sondes + 32 PS (the bench's obs density), the same noise, at
    OSSE_SETTINGS[name]: (port's curves, reference's)."""
    spinup, cycles, steps = OSSE_SETTINGS[name]
    kw = dict(members=50, n_cycles=cycles, steps_per_cycle=steps,
              spinup_steps=spinup, member_batch=50, tile_rows=12, n_sonde=16,
              n_ps=32, overrides={"nx": 48, "ny": 36, "nz": 36,
                                  "dx": 36000.0, "dy": 36000.0})
    mp = pytest.MonkeyPatch()
    try:
        patch_same_noise(mp)
        out = B.bench_osse_impact(device=CPU, **kw)
        out_r = R.bench_osse_impact(**kw)
    finally:
        mp.undo()
    keys = ("rmse_gues", "rmse_anal", "rmse_ctrl", "spread_gues")
    return {k: out[k] for k in keys}, {k: out_r[k] for k in keys}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bench_fullsize.py
    # [setting ...]: a few minutes a setting on 4 threads
    import json
    import sys
    torch.set_num_threads(4)
    for name in sys.argv[1:] or OSSE_SETTINGS:
        port, ref = osse_settings(name)
        print(json.dumps({"setting": name, "port": port, "reference": ref}))
