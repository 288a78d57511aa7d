"""The port's physics modules (scale_letkf_torch/model/{physics,
microphysics6,radiation,surface,pbl,physics_suite}.py) on the CPU against
the reference package's, from the same seeded numpy inputs.

The reference runs one member per call (its physics is vmapped); the port
takes a leading member axis. Every case runs 3 members of different states
(scale_letkf_torch/gpu_check.py physics_state, which the card's checks
share) on 8 stretched levels (1 km × 1.1ᵏ, ztop ≈ 11 km, so the columns hold
both warm and cold air), 6 × 10 columns: θ = 300 K + 4 K/km with 0.5-K
noise, 0.2% density noise, winds of ±3 m/s about (5, 0), qv 60-110% of
liquid saturation, and each hydrometeor zero in half the cells and up to a
few g/kg in the rest. The PBL case steps θ by 1-4 K between levels, up or
down, so that both stable and unstable interfaces occur.

Branches. The schemes switch on thresholds (warm/cold at T00, the riming
gate qs > 1e-3, the stable/unstable switches of the surface layer and of
the eddy diffusivity); the states are built away from them, and each test
asserts its margin (the temperature 0.01 K or more from T00; qs 0.4e-3 or
more from the gate; the virtual potential temperature differences that
set the signs of the bulk Richardson number and of the interface
stability N² 1e-3 K or more from zero, ~30 float32 ulp of θv), so both
packages take the same branch everywhere.

Tolerances (float32 on both sides): a state a scheme returns, per field,
1e-4·max|increment of the reference| plus 4 ulp of max|field| (the
bound of tests/test_torch_dycore.py); a diagnostic or tendency, 3e-5 of
its largest magnitude plus 4 ulp of it (the surface fluxes are differences
θs − θ1 of ~300-K values a few K apart, and one float32 ulp of θ is
~5e-6 of such a difference; the port and XLA round such terms apart by a
few ulp).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scale_letkf_tpu.model import microphysics6 as ref_mp6
from scale_letkf_tpu.model import pbl as ref_pbl
from scale_letkf_tpu.model import physics as ref_phys
from scale_letkf_tpu.model import physics_suite as ref_suite
from scale_letkf_tpu.model import radiation as ref_rad
from scale_letkf_tpu.model import surface as ref_sfc
from scale_letkf_tpu.model.dycore import DycoreState as RefState
from scale_letkf_torch.constants import PRE00, RD, T00
from scale_letkf_torch.gpu_check import (
    PHYS_CZ as CZ, PHYS_FZ as FZ, PHYS_SHAPE, _qsat_liq_np, physics_state,
)
from scale_letkf_torch.model import (
    microphysics6, pbl, physics, physics_suite, radiation, surface,
)
from scale_letkf_torch.model.dycore import DycoreState, make_vgrid

CPU = torch.device("cpu")
K, NZ, NY, NX = PHYS_SHAPE
DT = 30.0


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_state(seed: int = 0, layered: bool = False):
    return physics_state(seed, layered)


def port(s):
    return DycoreState(*(torch.from_numpy(np.ascontiguousarray(f))
                         for f in s))


def ref_member(s, m):
    return RefState(*(jnp.asarray(f[m]) for f in s))


def ref_stack(outs):
    """Per-member reference NamedTuples → one of stacked numpy arrays."""
    return type(outs[0])(*(np.stack([np.asarray(o[i]) for o in outs])
                           for i in range(len(outs[0]))))


def ulp(a):
    return np.spacing(np.float32(np.abs(a).max()))


def assert_state(out, init, ref, label=""):
    """Per field: |port − ref| ≤ 1e-4·max|ref − init| + 4 ulp(max|ref|)."""
    for name, a, f0, b in zip(DycoreState._fields, out, init, ref):
        a, f0, b = (np.asarray(x, np.float64) for x in (a, f0, b))
        tol = 1e-4 * np.abs(b - f0).max() + 4 * ulp(b)
        err = np.abs(a - b).max()
        assert err <= tol, f"{label} {name}: {err:.3e} > {tol:.3e}"


def assert_diag(a, b, label):
    """|port − ref| ≤ 3e-5·max|ref| + 4 ulp(max|ref|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tol = 3e-5 * np.abs(b).max() + 4 * ulp(b)
    err = np.abs(a - b).max()
    assert err <= tol, f"{label}: {err:.3e} > {tol:.3e}"


def temperature(s):
    """Float64 T of the numpy state (the schemes' warm/cold switch)."""
    st = port(s)
    q = st.rhoq.double() / st.rho.double()[:, None]
    t, _ = physics.temperature(DycoreState(*(f.double() for f in st)), q)
    return t.numpy()


def test_states_avoid_the_switch_points():
    s, tsfc = make_state()
    t = temperature(s)
    assert (t < T00).any() and (t > T00).any()
    assert np.abs(t - T00).min() > 0.01
    qs = s.rhoq[:, 4] / s.rho
    assert ((qs > 1.4e-3).any() and (qs < 0.7e-3).any()
            and np.abs(qs - 1e-3).min() > 0.4e-3)
    # distinct members
    assert not np.array_equal(s.rhot[0], s.rhot[1])


@pytest.mark.parametrize("dz", ["uniform", "stretched"])
def test_kessler_step_matches_reference(dz):
    s, _ = make_state()
    if dz == "uniform":
        dz_p = dz_r = 500.0
    else:
        vg = make_vgrid(CZ, FZ, CPU)
        dz_p, dz_r = vg.dzc, jnp.asarray(vg.dzc.numpy())
    out = physics.kessler_step(port(s), DT, dz_p)
    ref = ref_stack([ref_phys.kessler_step(ref_member(s, m), DT, dz_r)
                     for m in range(K)])
    assert_state(out, s, ref, f"kessler {dz}")
    # rain fell and cloud converted: the step did something in each member
    for m in range(K):
        assert np.abs(out.rhoq[m, 2].numpy() - s.rhoq[m, 2]).max() > 1e-6


def test_nsw6_step_matches_reference():
    s, _ = make_state(1)
    t = temperature(s)
    assert np.abs(t - T00).min() > 0.01
    qs = s.rhoq[:, 4] / s.rho
    assert np.abs(qs - 1e-3).min() > 0.4e-3
    vg = make_vgrid(CZ, FZ, CPU)
    for dz_p, dz_r in ((vg.dzc, jnp.asarray(vg.dzc.numpy())), (1000.0, 1000.0)):
        out = microphysics6.nsw6_step(port(s), DT, dz_p)
        ref = ref_stack([ref_mp6.nsw6_step(ref_member(s, m), DT, dz_r)
                         for m in range(K)])
        assert_state(out, s, ref, "nsw6")


@pytest.mark.parametrize("with_tsfc", [False, True])
def test_radiation_step_matches_reference(with_tsfc):
    s, tsfc = make_state(2)
    out = radiation.radiation_step(port(s), 1000.0, 0.5, 0.2, 0.98,
                                   torch.from_numpy(tsfc) if with_tsfc
                                   else None)
    ref = ref_stack([ref_rad.radiation_step(
        ref_member(s, m), 1000.0, 0.5, 0.2, 0.98,
        jnp.asarray(tsfc[m]) if with_tsfc else None) for m in range(K)])
    for name, a, b in zip(out._fields, out, ref):
        assert a.shape == (K,) + b.shape[1:], name
        assert_diag(a, b, name)
    assert float(out.drhot.abs().max()) > 0


def surface_inputs(seed: int = 3):
    """Lowest-level slabs of a state and its skin temperature."""
    s, tsfc = make_state(seed)
    rho, p = s.rho[:, 0], None
    st = port(s)
    _, pres = physics.temperature(st, st.rhoq / st.rho[:, None])
    p = pres[:, 0].numpy()
    q = s.rhoq[:, 0, 0] / rho
    t1 = temperature(s)[:, 0].astype(np.float32)
    u1 = s.rhou[:, 0] / rho
    v1 = s.rhov[:, 0] / rho
    z1 = np.float32(CZ[0])
    psfc = (p + rho * 9.81 * z1).astype(np.float32)
    return (u1, v1, t1, q, p, rho, z1, tsfc, psfc)


def test_surface_fluxes_match_reference():
    args = surface_inputs()
    u1, v1, t1, qv1, p1, rho1, z1, tsfc, psfc = args
    # the bulk Richardson number's sign, well away from the switch
    kappa = RD / (RD + 717.6)
    thv1 = t1 / (p1 / PRE00) ** kappa * (1 + 0.608 * qv1)
    thvs = tsfc / (psfc / PRE00) ** kappa * (1 + 0.608 * _qsat_liq_np(tsfc,
                                                                    psfc))
    d = thv1 - thvs
    assert (d < 0).any() and (d > 0).any()
    assert np.abs(d).min() > 1e-3
    out = surface.surface_fluxes(*(torch.as_tensor(a) for a in args))
    ref = ref_sfc.surface_fluxes(*(jnp.asarray(a) for a in args))
    for name, a, b in zip(out._fields, out, ref):
        assert a.shape == b.shape, name
        assert_diag(a, b, name)
    rib = torch.as_tensor(np.linspace(-2.0, 2.0, 9, dtype=np.float32))
    for a, b in zip(surface.louis_stability(rib, 1000.0, 0.01),
                    ref_sfc.louis_stability(jnp.asarray(rib.numpy()),
                                            1000.0, 0.01)):
        assert_diag(a, b, "louis")


def test_pbl_step_matches_reference():
    s, tsfc = make_state(4, layered=True)
    zc = torch.as_tensor(CZ, dtype=torch.float32)
    dz = float(FZ[1] - FZ[0])
    thv = (s.rhot / s.rho) * (1 + 0.608 * s.rhoq[:, 0] / s.rho)
    n2 = np.diff(thv, axis=1)
    assert (n2 > 0).any() and (n2 < 0).any()
    assert np.abs(n2).min() > 1e-3
    res = pbl.pbl_step(port(s), DT, dz, zc, torch.from_numpy(tsfc))
    refs = [ref_pbl.pbl_step(ref_member(s, m), DT, dz, jnp.asarray(CZ,
                                                                   jnp.float32),
                             jnp.asarray(tsfc[m])) for m in range(K)]
    assert_state(res.state, s, ref_stack([r.state for r in refs]), "pbl")
    sfc_r = ref_stack([r.sfc for r in refs])
    for name, a, b in zip(res.sfc._fields, res.sfc, sfc_r):
        assert_diag(a, b, f"sfc.{name}")
    km, kh = pbl.eddy_diffusivity(*(torch.from_numpy(a) for a in (
        s.rhou / s.rho, s.rhov / s.rho, thv)), zc, dz)
    for m in range(K):
        km_r, kh_r = ref_pbl.eddy_diffusivity(
            *(jnp.asarray(a[m]) for a in (s.rhou / s.rho, s.rhov / s.rho,
                                          thv)), jnp.asarray(CZ, jnp.float32),
            dz)
        assert_diag(km[m], km_r, "km")
        assert_diag(kh[m], kh_r, "kh")


@pytest.mark.parametrize("mp", ["kessler", "nsw6", "none"])
def test_physics_step_matches_reference(mp):
    """Three physics steps at indices 0, 1, 2 with rad_interval 2 (so
    radiation is recomputed, reused, recomputed), the last one a
    remainder chunk of another length; the slab skin temperature evolves.
    The port starts from an empty radiation cache (the driver's cold
    start), the reference from its primed one: index 0 recomputes it, so
    the outputs agree."""
    s, _ = make_state(5)
    pc = dict(mp_scheme=mp, rad_interval=2, slab_capacity=2.0e5)
    pcfg = physics_suite.PhysicsConfig(**pc)
    pcfg_r = ref_suite.PhysicsConfig(**pc)
    dz = float(FZ[1] - FZ[0])
    zc = torch.as_tensor(CZ, dtype=torch.float32)
    st = port(s)
    tsfc0 = physics_suite.skin_temperature(st)
    ph = physics_suite.PhysicsState(tsfc0, torch.zeros_like(st.rhot),
                                    torch.zeros_like(tsfc0))
    refs = []
    for m in range(K):
        sr = ref_member(s, m)
        phr = ref_suite.init_physics_state(sr, dz, pcfg_r)
        refs.append((sr, phr))
    init_p = physics_suite.init_physics_state(st, dz, pcfg)
    init_r = ref_stack([phr for _, phr in refs])
    for name, a, b in zip(init_p._fields, init_p, init_r):
        assert_diag(a, b, f"init.{name}")
    for i, dt in enumerate((5 * DT, 5 * DT, 3 * DT)):
        st, ph = physics_suite.physics_step(st, ph, i, pcfg, dt, dz, zc)
        refs = [ref_suite.physics_step(sr, phr, i, pcfg_r, dt, dz,
                                       jnp.asarray(CZ, jnp.float32))
                for sr, phr in refs]
        ref_s = ref_stack([r[0] for r in refs])
        ref_p = ref_stack([r[1] for r in refs])
        assert_state(st, s, ref_s, f"{mp} step {i}")
        for name, a, b in zip(ph._fields, ph, ref_p):
            assert_diag(a, b, f"{mp} step {i} {name}")
    assert float((ph.tsfc - tsfc0).abs().min()) > 0


def test_gpu_check_physics_helpers_on_cpu():
    """gpu_check's physics comparisons with the CPU in the card's place: a
    run agrees with itself exactly, the suite's forecast runs its 3 physics
    steps and 10 relaxations, and the radar forecast keeps qr ≥ 0."""
    from scale_letkf_torch import gpu_check
    from pathlib import Path
    configs = Path(__file__).resolve().parents[1] / "configs"
    modules = gpu_check.physics_modules_vs_cpu(CPU)
    assert not any(modules["max_err_over_tol"].values())
    assert all(f > 0 for f in modules["rounding_floor_over_tol"].values())
    suite = gpu_check.physics_forecast_vs_cpu(CPU,
                                              str(configs / "18km_japan.toml"))
    kessler = gpu_check.kessler_forecast_vs_cpu(
        CPU, str(configs / "bda_1km_radar.toml"))
    assert suite["sections"] == {"forecast/physics": 3,
                                 "forecast/boundary": 10}
    for r in (suite, kessler):
        assert r["finite"] and not any(r["max_err_over_tol"].values())
        assert all(0 < f < 100 for f in
                   r["rounding_floor_over_1e-4_increment"].values())
