"""One process of tests/test_torch_multiprocess.py: the port on a (2, 2, 2)
process grid over 4 gloo processes of 2 blocks each. It imports no jax.

    python tests/torch_mp_worker.py RANK WORLD PORT DIR [fused]

Reads DIR/inputs.npz (written by the test), then on the grid of
global_device_mesh(2, 2, 2) — with `fused`, run_fused's fused radar cycle
alone (DIR/fused_out.npz), else:
1. two split-explicit halo steps with terrain (rk3_step_si_halo_ens) of the
   4-member ensemble `si_*`, gathered onto every process;
2. one run_osse cycle of 2 steps of tests/test_torch_cycle.py's coarsened
   18-km configuration from the nature member `nat_*` and the 6-member
   ensemble `ens_*`, each process holding its own members' blocks
   (ensemble_from_process_local);
3. the same cycle with the physics suite (PHYS: a physics step after the
   2 steps, the PBL's halo crossing processes) and the skin temperature
   `tsfc` resumed from each process's own members.
Process 0 writes DIR/out.npz; every process prints "OK <rank>".
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from scale_letkf_torch.cli.main import load_config_and_grid, make_driver  # noqa: E402
from scale_letkf_torch.io.convert import dycore_state_to_torch  # noqa: E402
from scale_letkf_torch.model.dycore import DycoreConfig, DycoreState, VGrid  # noqa: E402
from scale_letkf_torch.model.dycore_si import SplitConfig  # noqa: E402
from scale_letkf_torch.model.terrain import make_metrics  # noqa: E402
from scale_letkf_torch.parallel import halo  # noqa: E402
from scale_letkf_torch.parallel.distributed import (  # noqa: E402
    ensemble_from_process_local, global_device_mesh, init_distributed,
)
from scale_letkf_torch.synthetic import synthetic_conv_network  # noqa: E402

CONFIG = str(ROOT / "configs" / "18km_japan.toml")
OVER = {"nx": 16, "ny": 12, "nz": 8, "dz": 1000.0, "dz_stretch": 1.1}
CPU = torch.device("cpu")
PHYS = {"mp_scheme": "nsw6", "rad_interval": 2, "slab_capacity": 2.0e5}


def state(z, prefix):
    return dycore_state_to_torch([z[f"{prefix}_{k}"]
                                  for k in DycoreState._fields], CPU)


def run_fused(z, mesh) -> dict:
    """tests/test_torch_fastcycle.py's radar case (its template `t_*`, its
    8-member ensemble `ens_*` and nature member `nat_*` on the grid `g_*`,
    its radar configuration) through FusedCycle on a driver on `mesh`, each
    process holding its own members' blocks: run_osse of 2 cycles of 5
    steps (seed 4). Returns the global final ensemble, nature run and
    series (numpy)."""
    from scale_letkf_torch import config as pcfg
    from scale_letkf_torch.cycle import CycleDriver
    from scale_letkf_torch.da.fastcycle import FusedCycle
    from scale_letkf_torch.grid import Grid, Projection
    from scale_letkf_torch.obs.types import Observations
    K = 8
    cfg = pcfg.Config(ensemble=pcfg.EnsembleConfig(member=K),
                      letkf=pcfg.LetkfConfig(infl_mul=1.05),
                      radar=pcfg.RadarConfig(method_ref_calc=3,
                                             min_radar_ref_member=1,
                                             radar_ref_thres_dbz=10.0))
    cfg.letkf_obs.hori_local = tuple([4.0e3] + [-1.0] * 23)
    cfg.letkf_obs.vert_local = tuple([0.2] + [-1.0] * 20
                                     + [1500.0, -1.0, -1.0])
    ny, nx = z["ens_rho"].shape[-2:]
    dx, dz = float(z["g_dx"]), float(z["g_dz"])
    grid = Grid(nx=nx, ny=ny, nz=len(z["g_cz"]), dx=dx, dy=dx, cz=z["g_cz"],
                fz=z["g_fz"], proj=Projection(kind="LC"))
    driver = CycleDriver(grid, cfg, DycoreConfig(dx=dx, dy=dx, dz=dz, dt=1.0,
                                                 ztop=float(z["g_fz"][-1])),
                         torch.from_numpy(z["rho_ref"]),
                         torch.from_numpy(z["p_ref"]), mesh=mesh)
    template = Observations(**{k: z[f"t_{k}"] for k in (
        "elem", "lon", "lat", "lev", "dat", "err", "typ", "dif", "meta")})
    fc = FusedCycle(driver, template, 5)
    ens = state(z, "ens")
    local = ensemble_from_process_local(
        mesh, DycoreState(*(f[mesh.local_members(K)] for f in ens)))
    truth, ens_a, series = fc.run_osse(state(z, "nat"), local, n_cycles=2,
                                       seed=4)
    ens_a = mesh.gather_ensemble(ens_a)
    out = {f"ens_{k}": f.numpy() for k, f in zip(DycoreState._fields, ens_a)}
    out.update({f"nat_{k}": f.numpy()
                for k, f in zip(DycoreState._fields, truth)})
    for k in ("rmse_gues", "rmse_anal", "omb", "oma", "nobs_used"):
        out[k] = series[k].numpy()
    for k in ("omb_by_group", "oma_by_group"):
        out.update({f"{k}_{n}": v.numpy() for n, v in series[k].items()})
    return out


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), Path(sys.argv[4]))
    torch.set_num_threads(1)
    z = np.load(out_dir / "inputs.npz")
    init_distributed(f"127.0.0.1:{port}", world, rank, local_device_count=2,
                     backend="gloo")
    mesh = global_device_mesh(2, 2, 2)
    assert mesh.world == world and len(mesh.local) == 2
    if sys.argv[5:] == ["fused"]:
        out = run_fused(z, mesh)
        if rank == 0:
            np.savez(out_dir / "fused_out.npz", **out)
        import torch.distributed as dist
        dist.destroy_process_group()
        print(f"OK {rank}")
        return

    # 1. the SI halo step with terrain
    cfg = DycoreConfig(**{k: float(z[f"cfg_{k}"]) for k in (
        "dx", "dy", "dz", "dt", "ztop", "sponge_height", "sponge_tau")})
    vg = VGrid(torch.from_numpy(z["dzc"]), torch.from_numpy(z["dzf"]))
    metrics = make_metrics(torch.from_numpy(z["topo"]), z["cz"], z["fz"],
                           cfg.dx, cfg.dy)
    si = state(z, "si")
    col = [torch.from_numpy(z[k]) for k in ("rho_ref", "p_ref", "zc")]
    for _ in range(2):
        si = halo.rk3_step_si_halo_ens(si, cfg, SplitConfig(dtau=1.0), *col,
                                       mesh, 4, vg=vg, metrics=metrics)

    # 2. one cycle of the coarsened 18-km configuration on the grid
    c, grid, dycfg, dom = load_config_and_grid(CONFIG, OVER)
    c.ensemble.member = 6
    c.process.mesh_member, c.process.mesh_y, c.process.mesh_x = 2, 2, 2
    driver = make_driver(c, grid, dycfg, dom, CPU)
    assert driver.mesh == mesh
    ens = state(z, "ens")
    local = ensemble_from_process_local(
        mesh, DycoreState(*(f[mesh.local_members(6)] for f in ens)))
    tmpl = synthetic_conv_network(c, grid, np.random.default_rng(1),
                                  n_sonde=25, n_ps=40)
    truth, ens_a, res = driver.run_osse(state(z, "nat"), local, tmpl,
                                        n_cycles=1, steps_per_cycle=2,
                                        seed=3)
    ens_a = mesh.gather_ensemble(ens_a)

    # 3. the cycle with the physics suite, the skin temperature resumed
    phys = make_driver(c, grid, dycfg, {**dom, "physics": PHYS}, CPU)
    phys.tsfc = ensemble_from_process_local(mesh, torch.from_numpy(
        z["tsfc"][mesh.local_members(6)]))
    local = ensemble_from_process_local(
        mesh, DycoreState(*(f[mesh.local_members(6)] for f in ens)))
    _, ens_p, res_p = phys.run_osse(state(z, "nat"), local, tmpl,
                                    n_cycles=1, steps_per_cycle=2, seed=3)
    ens_p = mesh.gather_ensemble(ens_p)
    tsfc_p = mesh.gather_ensemble(phys.tsfc)
    if rank == 0:
        np.savez(out_dir / "out.npz",
                 **{f"si_{k}": f.numpy() for k, f in zip(
                     DycoreState._fields, si)},
                 **{f"ens_{k}": f.numpy() for k, f in zip(
                     DycoreState._fields, ens_a)},
                 anal_mean=res.info["anal_mean"].numpy(),
                 anal_sprd=res.info["anal_sprd"].numpy(),
                 rmse=np.array([res.rmse_gues[0], res.rmse_anal[0]]),
                 batch=driver.batch,
                 **{f"phys_{k}": f.numpy() for k, f in zip(
                     DycoreState._fields, ens_p)},
                 phys_tsfc=tsfc_p.numpy(),
                 phys_anal_mean=res_p.info["anal_mean"].numpy(),
                 phys_rmse=np.array([res_p.rmse_gues[0],
                                     res_p.rmse_anal[0]]))
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"OK {rank}")


if __name__ == "__main__":
    main()
