"""Profile of a full-size path on one GPU: the analysis, or the forecast.

    python -m scale_letkf_torch.profile_analysis [--path analysis|forecast]
        [--config PATH] [--out DIR] [--steps N]

Builds the inputs of chip_smoke.py's phase for that path (the config
unchanged; for the analysis the ensemble generated on the card and the
synthetic conventional network with synthetic H(x), for the forecast the
synthetic restart ensemble with u0 = 10 m/s and `--steps` steps), times two
plain runs (the first one is cold), then runs a third under torch.profiler
(CPU and CUDA activities). Prints one JSON object: the untimed and
profiled wall seconds, the device-busy seconds (union of the device
events' intervals), the device's idle share of the profiled wall, and the
30 names with the most device time. The full key_averages table goes to
DIR/profile_table.txt. Post-processing a full-size analysis trace (about a
million device events) takes minutes.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
from scale_letkf_torch.da.letkf import analyze
from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.state import state_trans, state_trans_inv
from scale_letkf_torch.synthetic import (
    synthetic_conv_network, synthetic_ens_dycore_device, synthetic_gues_device,
)
from scale_letkf_torch.utils.device import require_cuda

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "18km_japan.toml"


def busy_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals in µs, as seconds."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=str(CONFIG))
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--path", choices=("analysis", "forecast"),
                    default="analysis")
    ap.add_argument("--steps", type=int, default=2,
                    help="forecast steps of each run (--path forecast)")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    dev = require_cuda()
    if args.path == "forecast":
        run, res = forecast_run(args, dev)
    else:
        run, res = analysis_run(args, dev)

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    res.update(device=torch.cuda.get_device_name(0), path=args.path,
               untimed_s=[timed(), timed()])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in events)
    res.update(profiled_s=wall, n_device_events=len(events),
               device_busy_s=busy, idle_share_of_profiled_wall=1 - busy / wall)
    ka = prof.key_averages()
    top = sorted(ka, key=lambda k: -k.self_device_time_total)[:30]
    res["top_device_time"] = [
        {"name": k.key[:90], "calls": k.count,
         "device_s": k.self_device_time_total / 1e6} for k in top]
    (out / "profile_table.txt").write_text(
        ka.table(sort_by="self_device_time_total", row_limit=40))
    print(json.dumps(res, indent=1))
    return 0


def forecast_run(args, dev):
    """(run, description) of the full-size forecast of args.steps steps."""
    cfg, grid, dycfg, dom = load_config_and_grid(args.config)
    K = cfg.ensemble.member
    ens, _, _ = synthetic_ens_dycore_device(args.seed, K, grid, dom, dev,
                                            u0=10.0)
    driver = make_driver(cfg, grid, dycfg, dom, dev)

    def run():
        driver.forecast(ens, args.steps)

    return run, {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K,
                 "steps": args.steps}


def analysis_run(args, dev):
    """(run, description) of the full-size analysis."""
    cfg, grid, _, _ = load_config_and_grid(args.config)
    K = cfg.ensemble.member
    gues = state_trans(state_trans_inv(synthetic_gues_device(
        args.seed, K, grid.nz, grid.ny, grid.nx, grid.cz, dev)))
    rng = np.random.default_rng(args.seed)
    obs = synthetic_conv_network(cfg, grid, rng)
    ensval = (obs.dat[None] + rng.standard_normal((K, obs.nobs))
              * obs.err[None]).astype(np.float32)
    ctx = build_obs_context(obs, ensval, np.zeros(obs.nobs, np.int32), cfg,
                            grid)
    z = grid.calc_z(torch.zeros((grid.ny, grid.nx), device=dev))

    def run():
        analyze(gues, ctx, cfg, grid, z, device=dev)

    return run, {"grid": f"{grid.nx}x{grid.ny}x{grid.nz}", "members": K}


if __name__ == "__main__":
    raise SystemExit(main())
