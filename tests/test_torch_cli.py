"""The cycle's command-line programs of both packages on the same files, in
process: obsmake → obsope → letkf (and letkf --obsda) → obssim → cycle, the
port's with --device cpu, on tests/test_cli.py's experiment (12×12×8, dt
1 s, explicit core, K = 4, INFL_MUL 1.1, 6-km localization) from one numpy
init checkpoint, a nature member and a 15-sonde template.

Each verb of the port reads what the reference's verbs wrote before it, so
the two chains see the same inputs at every step. Tolerances: obs values
and H(x) to 2e-5 of their range plus 4 float32 ulp of their largest
magnitude (tests/test_torch_obsope.py), QC exactly equal; analyses per
restart field to 1e-4·max|Δ| plus 6 ulp (tests/test_torch_cycle.py); the
2-cycle `cycle` adds twice the port's own rounding floor, measured by a
second port run from an init perturbed by one rounding.
"""

import contextlib
import io
import shutil

import numpy as np
import pytest
import torch

from scale_letkf_tpu.cli.main import main as ref_main
from scale_letkf_tpu.io import checkpoint as ref_ckpt
from scale_letkf_tpu.obs import io as ref_io
from scale_letkf_torch.cli.main import main
from scale_letkf_torch.da.obsmake import make_obs_network
from scale_letkf_torch.grid import Grid, Projection
from scale_letkf_torch.io import checkpoint
from scale_letkf_torch.model.dycore import DycoreState
from scale_letkf_torch.obs import io as obsio
from scale_letkf_torch.obs.types import ID_PS
from test_cli import CONFIG
from test_torch_cycle import assert_increments
from test_torch_fcst import _members
from test_torch_obs_operators import assert_close

torch.set_num_threads(1)
K = 4


def run(verb_main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        verb_main(list(args))
    return buf.getvalue()


def both(tmp, *args, out_flag=None, out=None):
    """Runs one verb in both packages; the output path `out` gets the
    package's name in front ('ref_', 'port_'). Returns the two stdouts."""
    res = []
    for name, fn, extra in (("ref", ref_main, []),
                            ("port", main, ["--device", "cpu"])):
        tail = [out_flag, str(tmp / f"{name}_{out}")] if out_flag else []
        res.append(run(fn, *args, *tail, *extra))
    return res


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    (tmp / "exp.toml").write_text(CONFIG)
    members = _members(K + 1, 3)
    checkpoint.save_ensemble(tmp / "init", DycoreState(*(
        np.stack(f) for f in zip(*members[1:]))), basename="anal.@@@@")
    checkpoint.save_member(tmp / "nature.npz", DycoreState(*members[0]))
    grid = Grid.uniform(nx=12, ny=12, nz=8, dx=2000.0, dy=2000.0, dz=500.0,
                        proj=Projection())
    obsio.write_obs(str(tmp / "template.dat"), make_obs_network(
        grid, np.random.default_rng(0), n_profiles=15,
        levels_hpa=(900.0, 800.0)))
    cfg = ["--config", str(tmp / "exp.toml")]
    # obsmake, then everything downstream from the reference's obs file
    both(tmp, "obsmake", *cfg, "--nature", str(tmp / "nature.npz"),
         "--obs-template", str(tmp / "template.dat"), "--seed", "5",
         out_flag="--out", out="obs.dat")
    obs = str(tmp / "ref_obs.dat")
    both(tmp, "obsope", *cfg, "--gues", str(tmp / "init"), "--obs", obs,
         out_flag="--out", out="obsda.@@@@")
    stdout = both(tmp, "letkf", *cfg, "--gues", str(tmp / "init"), "--obs",
                  obs, out_flag="--anal", out="anal")
    both(tmp, "letkf", *cfg, "--gues", str(tmp / "init"), "--obs", obs,
         "--obsda", str(tmp / "ref_obsda.@@@@"), out_flag="--anal",
         out="anal_obsda")
    both(tmp, "obssim", *cfg, "--state", str(tmp / "nature.npz"), "--vars",
         "T,U,V,Q,PS", out_flag="--out", out="sim.grd")
    return tmp, cfg, stdout


def test_obsmake_verbs_agree(exp):
    tmp, _, _ = exp
    ref = ref_io.read_obs(str(tmp / "ref_obs.dat"))
    got = obsio.read_obs(str(tmp / "port_obs.dat"))
    assert got.nobs == ref.nobs > 50
    for k in ("elem", "lon", "lat", "lev", "err", "typ", "dif"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), k)
    for e in np.unique(ref.elem):
        m = ref.elem == e
        assert_close(got.dat[m], ref.dat[m], f"element {e}")


def test_obsope_verbs_agree(exp):
    tmp, _, _ = exp
    n = ref_io.read_obs(str(tmp / "ref_obs.dat")).nobs
    elem = ref_io.read_obs(str(tmp / "ref_obs.dat")).elem
    for m in range(K):
        path = f"obsda.{m + 1:04d}"
        want = ref_io.read_obs_da(str(tmp / f"ref_{path}"), n)
        got = obsio.read_obs_da(str(tmp / f"port_{path}"), n)
        np.testing.assert_array_equal(got[3], want[3])
        assert (want[3] == 0).sum() > 50
        for e in np.unique(elem):
            sel = (elem == e) & (want[3] == 0)
            assert_close(got[2][sel], want[2][sel], f"member {m}, {e}")


def _assert_anal_dirs_agree(tmp, a, b):
    init, _, _ = checkpoint.load_ensemble(tmp / "init")
    ref, aux_r, meta_r = ref_ckpt.load_ensemble(tmp / a)
    got, aux, meta = checkpoint.load_ensemble(tmp / b)
    assert meta == meta_r
    assert_increments(got, init, ref)
    assert set(aux) == set(aux_r)
    # means and spreads per variable: a spread is as exact as the float32
    # mean it is taken around
    gm = aux_r["gues_mean"]
    for k in ("gues_mean", "gues_sprd", "anal_mean", "anal_sprd"):
        for v in range(gm.shape[0]):
            tol = (1e-4 * np.abs(aux_r["anal_mean"][v] - gm[v]).max()
                   + 2 * np.spacing(np.float32(np.abs(gm[v]).max())))
            assert np.abs(aux[k][v] - aux_r[k][v]).max() <= tol, (k, v)


def test_letkf_verbs_agree(exp):
    tmp, _, (out_r, out) = exp
    _assert_anal_dirs_agree(tmp, "ref_anal", "port_anal")
    dep_r = np.load(tmp / "ref_anal" / "obsdep.npz")
    dep = np.load(tmp / "port_anal" / "obsdep.npz")
    np.testing.assert_array_equal(dep["qc"], dep_r["qc"])
    good = dep_r["qc"] == 0
    # O−B per element, to the H(x) bound on the values it is taken from
    for e in np.unique(dep_r["elem"][good]):
        m = good & (dep_r["elem"] == e)
        dat = dep_r["dat"][m]
        tol = (2e-5 * np.ptp(dat) + (12 if e == ID_PS else 4)
               * np.spacing(np.float32(np.abs(dat).max())))
        assert np.abs(dep["omb"][m] - dep_r["omb"][m]).max() <= tol, e
    np.testing.assert_allclose(
        dep["oma"][good], dep_r["oma"][good], rtol=0,
        atol=1e-4 * np.abs(dep_r["oma"] - dep_r["omb"])[good].max()
        + 1e-5 * np.abs(dep_r["dat"]).max())
    # the O-B and O-A tables: the same obs counts per variable
    rows = [[ln for ln in o.splitlines() if ln.startswith("NOBS")]
            for o in (out_r, out)]
    assert len(rows[0]) >= 2 and rows[0] == rows[1]
    assert (tmp / "port_anal" / "obsdep.dat").exists()


def test_letkf_obsda_verbs_agree(exp):
    """The OBSDA_IN path of both packages on the reference's obsope files:
    equal to each other, and to the port's integrated analysis."""
    tmp, _, _ = exp
    _assert_anal_dirs_agree(tmp, "ref_anal_obsda", "port_anal_obsda")
    _assert_anal_dirs_agree(tmp, "ref_anal", "port_anal_obsda")


def test_obssim_verbs_agree(exp):
    tmp, _, _ = exp
    ref = np.fromfile(tmp / "ref_sim.grd", np.float32)
    got = np.fromfile(tmp / "port_sim.grd", np.float32)
    n3, n2 = 8 * 12 * 12, 12 * 12
    assert ref.shape == got.shape == (4 * n3 + n2,)
    for i in range(4):
        assert_close(got[i * n3:(i + 1) * n3], ref[i * n3:(i + 1) * n3],
                     f"3-D field {i}")
    assert_close(got[4 * n3:], ref[4 * n3:], "PS", ulps=12)


def test_cycle_verbs_agree(exp):
    """2 cycles of 2 steps, each cycle's obs the reference's obsmake file;
    the outputs load in either package."""
    tmp, cfg, _ = exp
    for c in range(2):
        shutil.copy(tmp / "ref_obs.dat", tmp / f"obs{c}.dat")
    args = ["cycle", *cfg, "--cycles", "2", "--steps-per-cycle", "2",
            "--obs-pattern", str(tmp / "obs{cycle}.dat")]
    run(ref_main, *args, "--init", str(tmp / "init"), "--out",
        str(tmp / "ref_cyc"))
    out = run(main, *args, "--init", str(tmp / "init"), "--out",
              str(tmp / "port_cyc"), "--device", "cpu")
    assert out.count("=== cycle") == 2 and "das_letkf" in out
    # the port's rounding floor: the same run from an init perturbed by one
    # rounding
    init, _, _ = checkpoint.load_ensemble(tmp / "init")
    rng = np.random.default_rng(6)
    checkpoint.save_ensemble(tmp / "init_rounded", DycoreState(*(
        (f * (1.0 + 2.0 ** -24 * rng.standard_normal(f.shape))).astype(
            np.float32) for f in init)), basename="anal.@@@@")
    run(main, *args, "--init", str(tmp / "init_rounded"), "--out",
        str(tmp / "port_cyc2"), "--device", "cpu")
    got, _, meta = checkpoint.load_ensemble(tmp / "port_cyc")
    got2, _, _ = checkpoint.load_ensemble(tmp / "port_cyc2")
    ref, _, meta_r = ref_ckpt.load_ensemble(tmp / "ref_cyc")
    assert meta == meta_r == {"cycles": 2}
    floor = {n: 2 * float(np.abs(a - b).max())
             for n, a, b in zip(DycoreState._fields, got, got2)}
    assert_increments(got, init, ref, extra=floor)
    for d in ("ref_cyc", "port_cyc"):
        a, _, _ = ref_ckpt.load_ensemble(tmp / d)
        b, _, _ = checkpoint.load_ensemble(tmp / d)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y)


@pytest.mark.parametrize("case,item", [
    ("streamed", "full-size executors"),
    ("nest", "nesting"),
    ("det", "deterministic member"),
    ("infl_add", "da/inflation.py"),
])
def test_cycle_unported_options_raise(exp, tmp_path, case, item):
    tmp, _, _ = exp
    cfg_text, init, extra = CONFIG, str(tmp / "init"), []
    if case == "streamed":
        extra = ["--streamed"]
    elif case == "nest":
        extra = ["--nest-init", init]
    elif case == "det":
        ens, _, _ = checkpoint.load_ensemble(tmp / "init")
        init = str(tmp_path / "init_det")
        checkpoint.save_ensemble(init, ens, basename="anal.@@@@",
                                 det=DycoreState(*(f[0] for f in ens)))
    else:
        cfg_text = CONFIG.replace("infl_mul = 1.1", "infl_mul = 1.1\ninfl_add = 0.1")
    (tmp_path / "exp.toml").write_text(cfg_text)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        main(["cycle", "--config", str(tmp_path / "exp.toml"), "--init", init,
              "--cycles", "1", "--steps-per-cycle", "1", "--obs-pattern",
              str(tmp / "ref_obs.dat"), "--out", str(tmp_path / "out"),
              "--device", "cpu", *extra])


@pytest.mark.parametrize("verb,flag", [
    ("cycle", "--member-batch=5"), ("cycle", "--tile-rows=24"),
    ("cycle", "--pipeline"), ("letkf", "--seed=0"),
])
def test_options_of_unported_paths_are_refused(exp, tmp_path, capsys, verb,
                                               flag):
    """The streamed executor's options and additive inflation's seed are
    not accepted until their paths are ported: argparse refuses them."""
    tmp, cfg, _ = exp
    common = [*cfg, "--obs" if verb == "letkf" else "--obs-pattern",
              str(tmp / "ref_obs.dat"), "--device", "cpu"]
    args = (["letkf", *common, "--gues", str(tmp / "init"), "--anal",
             str(tmp_path / "a")] if verb == "letkf" else
            ["cycle", *common, "--init", str(tmp / "init"), "--cycles", "1",
             "--steps-per-cycle", "1", "--out", str(tmp_path / "o")])
    with pytest.raises(SystemExit):
        main([*args, flag])
    assert f"unrecognized arguments: {flag}" in capsys.readouterr().err


def test_verbs_need_a_gpu_by_default(exp, tmp_path):
    """--device cuda (the default) needs a GPU: no quiet move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    tmp, cfg, _ = exp
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["obsope", *cfg, "--gues", str(tmp / "init"), "--obs",
              str(tmp / "ref_obs.dat"), "--out", str(tmp_path / "x.@@@@")])
