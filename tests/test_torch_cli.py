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


def _write_addi(path, seed=9):
    """Additive-inflation source members (the INFL_ADD_IN_BASENAME files,
    addi.0001.npz …) into the checkpoint directory `path`."""
    members = _members(K, seed)
    for m, mem in enumerate(members):
        checkpoint.save_member(path / checkpoint.filename_replace_mem(
            "addi.@@@@.npz", m), DycoreState(*mem))


def _det_init(tmp, dst):
    """The init checkpoint with a deterministic member (member 0 of
    another draw) and additive-inflation source members."""
    ens, _, _ = checkpoint.load_ensemble(tmp / "init")
    checkpoint.save_ensemble(dst, ens, basename="anal.@@@@",
                             det=DycoreState(*_members(1, 8)[0]))
    _write_addi(dst)
    return ens


INFL_ADD_CONFIG = CONFIG.replace(
    "infl_mul = 1.1", "infl_mul = 1.1\ninfl_add = 0.1\ninfl_add_shuffle = true")


def _init_rounded_to(tmp, dst):
    """The init checkpoint perturbed by one rounding (the port's floor)."""
    init, _, _ = checkpoint.load_ensemble(tmp / "init")
    rng = np.random.default_rng(6)
    checkpoint.save_ensemble(dst, DycoreState(*(
        (f * (1.0 + 2.0 ** -24 * rng.standard_normal(f.shape))).astype(
            np.float32) for f in init)), basename="anal.@@@@")
    return init


def _streamed_close(got, got2, init, ref):
    """The streamed cycle's restart against the reference's: the restart
    increments bound plus twice the port's floor (got2: the run from the
    rounded init) plus one bfloat16 spacing, 2⁻⁷, of the field's largest
    member perturbation (the analysis tiles carry the perturbations in
    bfloat16, and a last-bit difference may flip a rounding)."""
    floor = {n: 2 * float(np.abs(a - b).max())
             + 2.0 ** -7 * float(np.abs(r - r.mean(axis=0)).max())
             for n, a, b, r in zip(DycoreState._fields, got, got2, ref)}
    assert_increments(got, init, ref, extra=floor)


def _cycle_nested_agrees(tmp_path, refused: bool, process: str = ""):
    """cycle with a [nest] section at tests/test_cli_nested.py's CONFIG
    and inputs (16×16×6 parent, ratio-2 child, K = 4, 4 parent steps), with
    the TOML `process` appended (a [process] table): the parent's and the
    child's analyses (OUT and OUT/nest) to the restart increments bound plus
    twice the port's own rounding floor, measured from both inits rounded
    once; without --nest-obs-pattern both verbs refuse the section."""
    from test_cli_nested import _write_inputs
    cfg_path = _write_inputs(tmp_path)
    cfg_path.write_text(cfg_path.read_text() + process)
    args = ["cycle", "--config", str(cfg_path), "--cycles", "1",
            "--steps-per-cycle", "4", "--obs-pattern",
            str(tmp_path / "obs{cycle}.dat")]
    nest = ["--nest-init", str(tmp_path / "cinit")]
    if refused:
        for name, fn, extra in (("ref", ref_main, []),
                                ("port", main, ["--device", "cpu"])):
            with pytest.raises(SystemExit, match="nest-obs-pattern"):
                run(fn, *args, "--init", str(tmp_path / "init"), *nest,
                    "--out", str(tmp_path / name), *extra)
        return
    nest += ["--nest-obs-pattern", str(tmp_path / "cobs{cycle}.dat")]
    run(ref_main, *args, "--init", str(tmp_path / "init"), *nest, "--out",
        str(tmp_path / "ref"))
    out = run(main, *args, "--init", str(tmp_path / "init"), *nest, "--out",
              str(tmp_path / "port"), "--device", "cpu")
    assert "nest O-B" in out and "nest O-A" in out
    rng = np.random.default_rng(6)
    for d in ("init", "cinit"):
        ens, _, _ = checkpoint.load_ensemble(tmp_path / d)
        checkpoint.save_ensemble(tmp_path / f"{d}_rounded", DycoreState(*(
            (f * (1.0 + 2.0 ** -24 * rng.standard_normal(f.shape))).astype(
                np.float32) for f in ens)), basename="anal.@@@@")
    run(main, *args, "--init", str(tmp_path / "init_rounded"),
        "--nest-init", str(tmp_path / "cinit_rounded"), *nest[2:], "--out",
        str(tmp_path / "port2"), "--device", "cpu")
    for sub, init in (("", "init"), ("nest", "cinit")):
        ens0, _, _ = checkpoint.load_ensemble(tmp_path / init)
        ref, aux_r, meta_r = ref_ckpt.load_ensemble(tmp_path / "ref" / sub)
        got, aux, meta = checkpoint.load_ensemble(tmp_path / "port" / sub)
        got2, _, _ = checkpoint.load_ensemble(tmp_path / "port2" / sub)
        assert meta == meta_r and sorted(aux) == sorted(aux_r)
        floor = {n: 2 * float(np.abs(a - b).max())
                 for n, a, b in zip(DycoreState._fields, got, got2)}
        assert_increments(got, ens0, ref, extra=floor)
        assert np.abs(got.rhot - ens0.rhot).max() > 0


PROCESS = """
[process]
mesh_member = 2
mesh_y = 2
mesh_x = 2
"""


def test_nested_cycle_verb_on_a_process_grid(tmp_path):
    """cycle with [nest] and a [process] (2, 2, 2) table, which the port
    refused until the child ran on the grid: both packages' verbs on the
    same TOML (the reference's drivers on its mesh) agree as without the
    table, and the port's parent and child analyses equal its verb's
    without [process] exactly (the child periodic)."""
    _cycle_nested_agrees(tmp_path, False, PROCESS)
    flat = tmp_path / "flat"
    flat.mkdir()
    for name in ("init", "cinit", "obs0.dat", "cobs0.dat"):
        src = tmp_path / name
        (shutil.copytree if src.is_dir() else shutil.copy)(src, flat / name)
    (flat / "exp.toml").write_text(
        (tmp_path / "exp.toml").read_text().replace(PROCESS, ""))
    out = run(main, "cycle", "--config", str(flat / "exp.toml"), "--init",
              str(flat / "init"), "--cycles", "1", "--steps-per-cycle", "4",
              "--obs-pattern", str(flat / "obs{cycle}.dat"), "--nest-init",
              str(flat / "cinit"), "--nest-obs-pattern",
              str(flat / "cobs{cycle}.dat"), "--out", str(flat / "port"),
              "--device", "cpu")
    assert "transpose" not in out
    for sub in ("", "nest"):
        got, _, _ = checkpoint.load_ensemble(tmp_path / "port" / sub)
        want, _, _ = checkpoint.load_ensemble(flat / "port" / sub)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_streamed_cycle_verb_on_a_process_grid(exp, tmp_path):
    """cycle --streamed with a [process] (2, 2, 2) table, which the port
    refused until the stream forecast its batches on the grid: two cycles
    (the second resuming the first's restart) write the files of the verb
    without the table, bit for bit, and its meta."""
    tmp, _, _ = exp
    outs = {}
    for name, extra in (("flat", ""), ("grid", PROCESS)):
        (tmp_path / f"{name}.toml").write_text(CONFIG + extra)
        run(main, "cycle", "--config", str(tmp_path / f"{name}.toml"),
            "--init", str(tmp / "init"), "--cycles", "2",
            "--steps-per-cycle", "1", "--obs-pattern",
            str(tmp / "ref_obs.dat"), "--out", str(tmp_path / name),
            "--streamed", "--member-batch", "2", "--tile-rows", "4",
            "--device", "cpu")
        outs[name] = checkpoint.load_ensemble(tmp_path / name)
    (got, aux, meta), (want, aux_w, meta_w) = outs["grid"], outs["flat"]
    assert meta == meta_w == {"cycles": 2, "streamed": True}
    assert sorted(aux) == sorted(aux_w)
    for k in aux_w:
        np.testing.assert_array_equal(aux[k], aux_w[k])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got.rhot - checkpoint.load_ensemble(
        tmp / "init")[0].rhot).max() > 0


def test_streamed_cycle_verb_refuses_a_world_of_processes(exp, tmp_path,
                                                          monkeypatch):
    """A [process] grid spread over several processes keeps a refusal of
    its own (the stream holds the ensemble in one process): the grid of a
    2-process world, made without starting a process group, stops the
    verb before it reads a member."""
    from scale_letkf_torch.cli import main as cli_main
    from scale_letkf_torch.parallel.mesh import ProcessGrid
    tmp, _, _ = exp
    monkeypatch.setattr(cli_main, "process_grid",
                        lambda cfg: ProcessGrid(2, 2, 2, rank=0, world=2))
    (tmp_path / "exp.toml").write_text(CONFIG + PROCESS)
    with pytest.raises(SystemExit,
                       match=r"--streamed runs in one process; the "
                             r"\[process\] grid spreads over 2"):
        main(["cycle", "--config", str(tmp_path / "exp.toml"), "--init",
              str(tmp / "init"), "--cycles", "1", "--steps-per-cycle",
              "1", "--obs-pattern", str(tmp / "ref_obs.dat"), "--out",
              str(tmp_path / "out"), "--streamed", "--device", "cpu"])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("case,item", [
    ("streamed", "full-size executors"),
    ("nest", "nesting"),
    ("nest_refused", "nesting"),
    ("det", "deterministic member"),
    ("infl_add", "da/inflation.py"),
])
def test_cycle_unported_options_raise(exp, tmp_path, case, item):
    """Every option of the cycle verb that earlier slices left out now
    runs: a [nest] section (one-way nesting: parent and child against the
    reference's verb, and the reference's refusal without
    --nest-obs-pattern), --streamed (the member-streamed executor), a
    deterministic member in the init checkpoint (DET_RUN_CYCLED) and
    INFL_ADD (shuffled, from the init's addi files); one cycle matches the
    reference's verb (the member saved as 'mdet'; the streamed run's meta
    and aux as the reference's)."""
    tmp, _, _ = exp
    if case.startswith("nest"):
        return _cycle_nested_agrees(tmp_path, case == "nest_refused")
    cfg_text, init, extra = CONFIG, str(tmp / "init"), []
    if case == "streamed":
        extra = ["--streamed"]
    else:
        init = str(tmp_path / "init_det")
        ens = _det_init(tmp, tmp_path / "init_det")
        if case == "infl_add":
            cfg_text = INFL_ADD_CONFIG
    (tmp_path / "exp.toml").write_text(cfg_text)
    args = ["cycle", "--config", str(tmp_path / "exp.toml"), "--init", init,
            "--cycles", "1", "--steps-per-cycle", "1", "--obs-pattern",
            str(tmp / "ref_obs.dat")]
    run(ref_main, *args, "--out", str(tmp_path / "ref"), *extra)
    out = run(main, *args, "--out", str(tmp_path / "port"), "--device",
              "cpu", *extra)
    ref, aux_r, meta_r = ref_ckpt.load_ensemble(tmp_path / "ref")
    got, aux, meta = checkpoint.load_ensemble(tmp_path / "port")
    if case == "streamed":
        assert meta == meta_r == {"cycles": 1, "streamed": True}
        assert sorted(aux) == sorted(aux_r)
        assert "DAS_LETKF" in out and "O-A" in out
        ens = _init_rounded_to(tmp, tmp_path / "init_rounded")
        run(main, *[a if a != init else str(tmp_path / "init_rounded")
                    for a in args], "--out", str(tmp_path / "port2"),
            "--device", "cpu", *extra)
        got2, _, _ = checkpoint.load_ensemble(tmp_path / "port2")
        _streamed_close(got, got2, ens, ref)
        return
    assert_increments(got, ens, ref)
    det0 = checkpoint.load_det(init)
    det, det_r = (checkpoint.load_det(tmp_path / d) for d in ("port", "ref"))
    assert_increments(det, det0, det_r)
    assert np.abs(det.rhot - det0.rhot).max() > 0


def test_letkf_verbs_agree_with_det_and_addi(exp, tmp_path):
    """letkf on a guess with a deterministic member and INFL_ADD from
    --addi (shuffled by --seed 3) in both packages: the ensemble and 'mdet'
    to the restart increments bound."""
    tmp, _, _ = exp
    ens = _det_init(tmp, tmp_path / "gues")
    checkpoint.save_ensemble(tmp_path / "addi", DycoreState(*(
        np.stack(f) for f in zip(*_members(K, 10)))), basename="addi.@@@@")
    (tmp_path / "exp.toml").write_text(INFL_ADD_CONFIG)
    args = ["letkf", "--config", str(tmp_path / "exp.toml"), "--gues",
            str(tmp_path / "gues"), "--obs", str(tmp / "ref_obs.dat"),
            "--addi", str(tmp_path / "addi"), "--seed", "3"]
    run(ref_main, *args, "--anal", str(tmp_path / "ref"))
    run(main, *args, "--anal", str(tmp_path / "port"), "--device", "cpu")
    ref, _, _ = ref_ckpt.load_ensemble(tmp_path / "ref")
    got, _, _ = checkpoint.load_ensemble(tmp_path / "port")
    assert_increments(got, ens, ref)
    det0 = checkpoint.load_det(tmp_path / "gues")
    det, det_r = (checkpoint.load_det(tmp_path / d) for d in ("port", "ref"))
    assert_increments(det, det0, det_r)
    # the source ensemble came from --addi: without it the analysis differs
    run(main, *args[:-4], "--anal", str(tmp_path / "port_gues_addi"),
        "--device", "cpu")
    other, _, _ = checkpoint.load_ensemble(tmp_path / "port_gues_addi")
    assert np.abs(other.rhot - got.rhot).max() > 0


@pytest.mark.parametrize("verb,flag", [
    ("cycle", "--member-batch=5"), ("cycle", "--tile-rows=24"),
    ("cycle", "--pipeline"), ("letkf", "--seed=0"),
])
def test_options_of_unported_paths_are_refused(exp, tmp_path, monkeypatch,
                                               verb, flag):
    """The streamed executor's options are accepted and act: the member
    batch is the largest divisor of K not above the request, the analysis
    takes the requested tile height (its largest divisor of ny), and the
    pipelined stream equals the plain one; none changes the numbers.
    letkf's --seed (INFL_ADD_SHUFFLE's generator) is accepted: with
    INFL_ADD 0 it changes nothing."""
    from scale_letkf_torch.da import bigcycle, letkf_tiled
    tmp, cfg, _ = exp
    common = [*cfg, "--obs" if verb == "letkf" else "--obs-pattern",
              str(tmp / "ref_obs.dat"), "--device", "cpu"]
    if verb == "letkf":
        args = ["letkf", *common, "--gues", str(tmp / "init"), "--anal",
                str(tmp_path / "a")]
        run(main, *args, flag)
        got, _, _ = checkpoint.load_ensemble(tmp_path / "a")
        want, _, _ = checkpoint.load_ensemble(tmp / "port_anal")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    seen = {"batch": [], "rows": [], "pipeline": []}
    batch_of, rows_of, tiled = (bigcycle.batch_of, letkf_tiled.tile_rows_of,
                                letkf_tiled.analyze_tiled)

    def spy_batch(K, req):
        seen["batch"].append((K, req, batch_of(K, req)))
        return seen["batch"][-1][2]

    def spy_rows(ny, req):
        seen["rows"].append((ny, req, rows_of(ny, req)))
        return seen["rows"][-1][2]

    def spy_tiled(*a, **kw):
        seen["pipeline"].append(kw["pipeline"])
        return tiled(*a, **kw)

    monkeypatch.setattr(bigcycle, "batch_of", spy_batch)
    monkeypatch.setattr(letkf_tiled, "tile_rows_of", spy_rows)
    monkeypatch.setattr(bigcycle, "analyze_tiled", spy_tiled)

    def cycle(out, *extra):
        for v in seen.values():
            v.clear()
        stdout = run(main, "cycle", *common, "--init", str(tmp / "init"),
                     "--cycles", "1", "--steps-per-cycle", "1", "--out",
                     str(tmp_path / out), "--streamed", *extra)
        return checkpoint.load_ensemble(tmp_path / out)[0], stdout

    want, _ = cycle("plain")
    got, stdout = cycle("o", flag)
    name, _, value = flag.partition("=")
    if name == "--member-batch":
        assert seen["batch"][0] == (K, 5, 4)
        got2, _ = cycle("o2", "--member-batch=3")
        assert seen["batch"][0] == (K, 3, 2)
    elif name == "--tile-rows":
        assert seen["rows"] == [(12, 24, 12)]
        got2, _ = cycle("o2", "--tile-rows=5")
        assert seen["rows"] == [(12, 5, 4)]
    else:
        assert seen["pipeline"] == [True]
        assert "letkf compute (est)" in stdout
        got2 = got
    for a, b, c in zip(got, got2, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def test_verbs_need_a_gpu_by_default(exp, tmp_path):
    """--device cuda (the default) needs a GPU: no quiet move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    tmp, cfg, _ = exp
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["obsope", *cfg, "--gues", str(tmp / "init"), "--obs",
              str(tmp / "ref_obs.dat"), "--out", str(tmp_path / "x.@@@@")])


# --- the physics suite and boundary forcing through the verbs --------------
PHYS_TOML = """
[physics]
mp_scheme = "nsw6"
rad_interval = 2
slab_capacity = 2.0e5
"""


@pytest.fixture(scope="module")
def phys_exp(exp):
    """exp's experiment with a [physics] section and Davies forcing (a
    2-cell buffer, tau 60 s) toward a boundary file that warms the first
    init member by 0.2% over 100 s, and an init checkpoint whose aux holds
    a slab skin temperature (each member's lowest-level air ± 3 K)."""
    from scale_letkf_torch.model.boundary import BoundaryData, save_boundary
    from scale_letkf_torch.model.physics_suite import skin_temperature
    tmp, _, _ = exp
    init, _, _ = checkpoint.load_ensemble(tmp / "init")
    s0 = DycoreState(*(np.ascontiguousarray(f[0]) for f in init))
    s1 = s0._replace(rhot=s0.rhot * np.float32(1.002))
    save_boundary(tmp / "bdy.npz", BoundaryData(s0, s1, 0.0, 100.0))
    text = CONFIG.replace("[domain]\n", f"[domain]\nbdy_file = "
                          f"\"{tmp / 'bdy.npz'}\"\nbdy_width = 2\n"
                          f"bdy_tau = 60.0\n") + PHYS_TOML
    (tmp / "phys.toml").write_text(text)
    tsfc = skin_temperature(DycoreState(*(torch.from_numpy(f)
                                          for f in init))).numpy()
    sign = np.random.default_rng(9).choice([-1.0, 1.0], tsfc.shape)
    checkpoint.save_ensemble(tmp / "init_tsfc", init, basename="anal.@@@@",
                             aux={"tsfc": (tsfc + 3.0 * sign).astype(
                                 np.float32)})
    for c in range(2):
        shutil.copy(tmp / "ref_obs.dat", tmp / f"phys_obs{c}.dat")
    return tmp, ["--config", str(tmp / "phys.toml")]


def _floor(tmp, a, b):
    x, _, _ = checkpoint.load_ensemble(tmp / a)
    y, _, _ = checkpoint.load_ensemble(tmp / b)
    return {n: 2 * float(np.abs(p - q).max())
            for n, p, q in zip(DycoreState._fields, x, y)}


def _rounded_init(tmp, name):
    init, aux, _ = checkpoint.load_ensemble(tmp / "init_tsfc")
    rng = np.random.default_rng(8)
    checkpoint.save_ensemble(tmp / name, DycoreState(*(
        (f * (1.0 + 2.0 ** -24 * rng.standard_normal(f.shape))).astype(
            np.float32) for f in init)), basename="anal.@@@@", aux=aux)


def test_fcst_verbs_agree_with_physics(phys_exp):
    """fcst with [physics], bdy_file and a tsfc in the init: both packages
    cold-start the slab and pass the init's aux through unchanged."""
    tmp, cfg = phys_exp
    args = ["fcst", *cfg, "--steps", "3"]
    run(ref_main, *args, "--init", str(tmp / "init_tsfc"), "--out",
        str(tmp / "ref_pfc"))
    out = run(main, *args, "--init", str(tmp / "init_tsfc"), "--out",
              str(tmp / "port_pfc"), "--device", "cpu")
    assert "physics" in out and "boundary" in out
    _rounded_init(tmp, "init_tsfc_r")
    run(main, *args, "--init", str(tmp / "init_tsfc_r"), "--out",
        str(tmp / "port_pfc2"), "--device", "cpu")
    init, aux0, _ = checkpoint.load_ensemble(tmp / "init_tsfc")
    ref, aux_r, _ = ref_ckpt.load_ensemble(tmp / "ref_pfc")
    got, aux, _ = checkpoint.load_ensemble(tmp / "port_pfc")
    assert_increments(got, init, ref,
                      extra=_floor(tmp, "port_pfc", "port_pfc2"))
    for a in (aux, aux_r):
        np.testing.assert_array_equal(a["tsfc"], aux0["tsfc"])


def test_cycle_verbs_agree_with_physics(phys_exp):
    """2 cycles of 2 steps with [physics], bdy_file and the init's tsfc
    resumed: the analyses, and the slab skin temperature both packages
    write beside them."""
    tmp, cfg = phys_exp
    args = ["cycle", *cfg, "--cycles", "2", "--steps-per-cycle", "2",
            "--obs-pattern", str(tmp / "phys_obs{cycle}.dat")]
    run(ref_main, *args, "--init", str(tmp / "init_tsfc"), "--out",
        str(tmp / "ref_pcyc"))
    out = run(main, *args, "--init", str(tmp / "init_tsfc"), "--out",
              str(tmp / "port_pcyc"), "--device", "cpu")
    assert out.count("=== cycle") == 2
    _rounded_init(tmp, "init_tsfc_r2")
    run(main, *args, "--init", str(tmp / "init_tsfc_r2"), "--out",
        str(tmp / "port_pcyc2"), "--device", "cpu")
    init, aux0, _ = checkpoint.load_ensemble(tmp / "init_tsfc")
    ref, aux_r, _ = ref_ckpt.load_ensemble(tmp / "ref_pcyc")
    got, aux, _ = checkpoint.load_ensemble(tmp / "port_pcyc")
    _, aux2, _ = checkpoint.load_ensemble(tmp / "port_pcyc2")
    assert_increments(got, init, ref,
                      extra=_floor(tmp, "port_pcyc", "port_pcyc2"))
    assert set(aux) == set(aux_r) and "tsfc" in aux
    tol = (1e-4 * np.abs(aux_r["tsfc"] - aux0["tsfc"]).max()
           + 4 * np.spacing(np.float32(np.abs(aux_r["tsfc"]).max()))
           + 2 * np.abs(aux["tsfc"] - aux2["tsfc"]).max())
    assert np.abs(aux["tsfc"] - aux_r["tsfc"]).max() <= tol
    # the resumed slab moved
    assert np.abs(aux["tsfc"] - aux0["tsfc"]).max() > 0


def test_unknown_physics_key_raises(exp, tmp_path):
    tmp, _, _ = exp
    (tmp_path / "bad.toml").write_text(CONFIG + "\n[physics]\nmp = 1\n")
    for fn, extra in ((ref_main, []), (main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match=r"unknown \[physics\] keys"):
            fn(["fcst", "--config", str(tmp_path / "bad.toml"), "--init",
                str(tmp / "init"), "--steps", "1", "--out",
                str(tmp_path / "o"), *extra])


def test_radar_config_builds_a_driver():
    """configs/bda_1km_radar.toml as shipped: Kessler every 5 steps on its
    stretched levels, the split-explicit core."""
    from pathlib import Path
    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    path = Path(__file__).resolve().parents[1] / "configs" / "bda_1km_radar.toml"
    cfg, grid, dycfg, dom = load_config_and_grid(str(path))
    d = make_driver(cfg, grid, dycfg, dom, torch.device("cpu"))
    assert d.use_physics and d.phys_cfg is None and d.phys_interval == 5
    assert d.core == "si" and d.n_small == 4 and dycfg.dt == 2.0
    assert tuple(d.dz_col.shape) == (48, 1, 1)
    assert d.bdy is None and (grid.nx, grid.ny, grid.nz) == (192, 192, 48)
