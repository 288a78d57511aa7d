"""The port's parallel-Jacobi eigensolver (ops/eigh_jacobi.py) against the
reference's and against LAPACK, at tests/test_eigh_jacobi.py's bounds: the
round-robin schedule exactly; float64 eigenvalues and reconstruction to
rtol 1e-8, orthogonality to 1e-9; float32 at K = 64 eigenvalues to rtol
2e-4 and reconstruction to 5e-5; the LETKF transform built from it to rtol
1e-6. Both packages' solvers on the same matrices agree to the same
bounds, and the analysis with eigh_impl = 'jacobi' runs the ported Jacobi
and matches the reference's on tests/test_torch_analyze.py's slice."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scale_letkf_tpu.ops import eigh_jacobi as ref
from scale_letkf_tpu.ops.letkf_core import letkf_core as ref_core
from scale_letkf_torch.da import letkf
from scale_letkf_torch.ops import eigh_jacobi as port
from scale_letkf_torch.ops import letkf_core as port_core
from scale_letkf_torch.ops.letkf_core import letkf_core

torch.set_num_threads(1)


def _spd(rng, B, L, K, dtype=np.float64):
    x = rng.standard_normal((B, L, K))
    a = np.einsum("blk,blj->bkj", x, x) + (K - 1) * np.eye(K)
    return a.astype(dtype)


def test_schedule_matches_reference():
    for K in (2, 4, 8, 16, 50, 66):
        np.testing.assert_array_equal(port._round_robin_schedule(K),
                                      ref._round_robin_schedule(K))
    with pytest.raises(ValueError, match="even"):
        port._round_robin_schedule(7)


@pytest.mark.parametrize("K", [4, 8, 16, 20, 50, 66])
def test_matches_lapack_and_reference_f64(K):
    """K = 66 takes the matmul form (K > ROWCOL_MAX_K)."""
    rng = np.random.default_rng(0)
    a = _spd(rng, 8, K + 10, K)
    w, v = (x.numpy() for x in port.eigh_jacobi(torch.from_numpy(a),
                                                 sweeps=10))
    w_ref, _ = np.linalg.eigh(a)
    np.testing.assert_allclose(w, w_ref, rtol=1e-8)
    rec = np.einsum("bik,bk,bjk->bij", v, w, v)
    np.testing.assert_allclose(rec, a, rtol=1e-8, atol=1e-8)
    vtv = np.einsum("bki,bkj->bij", v, v)
    np.testing.assert_allclose(vtv, np.broadcast_to(np.eye(K), vtv.shape),
                               atol=1e-9)
    # the reference's solver on the same matrices: the same eigenvalues, and
    # eigenvectors equal up to sign (the spectrum is simple)
    wr, vr = (np.asarray(x) for x in ref.eigh_jacobi(jnp.asarray(a),
                                                      sweeps=10))
    np.testing.assert_allclose(w, wr, rtol=1e-8)
    sign = np.sign(np.einsum("bki,bki->bi", v, vr))
    np.testing.assert_allclose(v * sign[:, None, :], vr, atol=1e-9)


@pytest.mark.parametrize("K", [16, 64])
def test_float32_letkf_conditions(K):
    """float32 on the LETKF's matrix class, tests/test_eigh_jacobi.py's
    K = 64 case and the K ≤ 16 size 'auto' may give it."""
    rng = np.random.default_rng(1)
    B, L = 4, 100
    x = rng.standard_normal((B, L, K)).astype(np.float32)
    a = np.einsum("blk,blj->bkj", x, x) + (K - 1) * np.eye(K, dtype=np.float32)
    a = 0.5 * (a + a.transpose(0, 2, 1))
    w, v = (t.numpy() for t in port.eigh_jacobi(torch.from_numpy(a),
                                                 sweeps=10))
    w_ref, _ = np.linalg.eigh(a.astype(np.float64))
    np.testing.assert_allclose(w, w_ref, rtol=2e-4)
    rec = np.einsum("bik,bk,bjk->bij", v.astype(np.float64),
                    w.astype(np.float64), v.astype(np.float64))
    err = np.abs(rec - a).max() / np.abs(a).max()
    assert err < 5e-5, f"f32 reconstruction error {err}"
    wr, _ = ref.eigh_jacobi(jnp.asarray(a), sweeps=10)
    np.testing.assert_allclose(w, np.asarray(wr), rtol=2e-4)


def test_letkf_core_jacobi_solver():
    """letkf_core(solver='jacobi') against the reference's
    letkf_core(eigh_impl='jacobi') and its 'lax' eigh, float64: rtol 1e-6
    (tests/test_eigh_jacobi.py's transform bound)."""
    rng = np.random.default_rng(2)
    B, L, K = 16, 30, 8
    hdxb = rng.standard_normal((B, L, K))
    rdiag = rng.uniform(0.5, 2.0, (B, L))
    rloc = rng.uniform(0.05, 1.0, (B, L))
    dep = rng.standard_normal((B, L))
    args = (hdxb, rdiag, rloc, dep, np.ones(B))
    res = letkf_core(*(torch.from_numpy(a) for a in args), solver="jacobi")
    for impl in ("jacobi", "lax"):
        r = ref_core(*(jnp.asarray(a) for a in args), eigh_impl=impl)
        for name in ("trans", "transm", "pao"):
            np.testing.assert_allclose(getattr(res, name).numpy(),
                                       np.asarray(getattr(r, name)),
                                       rtol=1e-6, atol=1e-8, err_msg=name)


def test_eigh_impl_jacobi_runs_the_ported_jacobi(monkeypatch):
    """cfg.letkf.eigh_impl = 'jacobi' reaches ops/eigh_jacobi.py (once per
    level) and the analysis matches the reference's Jacobi analysis on the
    coarsened slice at K = 16 to the increments bound."""
    import test_torch_analyze as ta
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(ta, "K", 16)
    cfg_r, grid_r, cfg, grid = ta._configs("rtpp")
    for c in (cfg_r, cfg):
        c.ensemble.member = 16
        c.letkf.eigh_impl = "jacobi"
    restart, obs, ensval = ta._inputs(cfg, grid)
    calls = []
    jac = port_core.eigh_jacobi

    def counting(a, *args, **kw):
        calls.append(a.shape)
        return jac(a, *args, **kw)
    monkeypatch.setattr(port_core, "eigh_jacobi", counting)
    with pltpu.force_tpu_interpret_mode():
        g_r, a_r, _, _ = ta._run_reference(restart, obs, ensval, cfg_r,
                                           grid_r)
    g, a, _, _ = ta._run_port(restart, obs, ensval, cfg, grid)
    assert len(calls) == grid.nz and calls[0][-2:] == (16, 16)
    assert letkf._SOLVER_OF_EIGH_IMPL["jacobi"] == "jacobi"
    ta._assert_increments_close(g, a, g_r, a_r)


def test_auto_picks_a_measured_solver_at_small_k():
    """'auto' at even K ≤ 16 takes AUTO_SMALL_K_SOLVER, one of the two the
    card's measurement chose between; odd K takes the reference's path
    beyond its Jacobi."""
    assert port_core.AUTO_SMALL_K_SOLVER in ("jacobi", "eigh")
    for K in (2, 8, 16):
        assert port_core.pick_solver("auto", K, torch.float32) == \
            port_core.AUTO_SMALL_K_SOLVER
    assert port_core.pick_solver("auto", 15, torch.float32) == "ns_kernel"
    assert port_core.pick_solver("jacobi", 50, torch.float32) == "jacobi"


def test_eigh_solver_in_batches_of_at_most_eigh_max_batch(monkeypatch):
    """The 'eigh' solver calls torch.linalg.eigh on at most EIGH_MAX_BATCH
    matrices at once (cuSOLVER refuses a whole 18-km level) and gives the
    one-call result."""
    rng = np.random.default_rng(6)
    B, L, K = 40, 12, 6
    args = [torch.from_numpy(a) for a in (
        rng.standard_normal((B, L, K)), rng.uniform(0.5, 2.0, (B, L)),
        rng.uniform(0.0, 1.0, (B, L)), rng.standard_normal((B, L)),
        np.full(B, 1.1))]
    whole = letkf_core(*args, solver="eigh")
    sizes = []
    eigh = torch.linalg.eigh

    def counting(a):
        sizes.append(a.reshape(-1, K, K).shape[0])
        return eigh(a)
    monkeypatch.setattr(port_core, "EIGH_MAX_BATCH", 16)
    monkeypatch.setattr(torch.linalg, "eigh", counting)
    parts = letkf_core(*args, solver="eigh")
    assert sizes == [16, 16, 8]
    for name in ("trans", "transm", "pao"):
        torch.testing.assert_close(getattr(parts, name), getattr(whole, name),
                                   rtol=0, atol=0)
