"""The two readings a cell's limits are set from, on many seeds in one
process:

    python3 benchmark/readings.py --workload <name> --seeds <n>[,<n>...]
        [--control [tf32,bf16,both]]

Without --control, the program's: a run of the cell with a window of one
unit (the same set-up, warm-up, timed path and comparison as a run of
run.py). With --control, the control's: the reference put in the
program's place and computed in the nearest precision below the
configuration's (the traffic's `control`: the state held in bfloat16, the
transform's products in TF32, or both; or the modes named), read by the
same comparison. Prints one JSON line a seed and side: the numbers
compared and the cell's limits. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def control(ctx, modes: str | None = None) -> dict:
    """The control's readings, {mode: numbers}, for each of the
    comma-separated modes ('tf32', 'bf16', 'both'; the traffic's `control`
    when None), against one reference."""
    from benchmark import harness as H
    entry = H.entry_of(ctx)
    inp = entry.Inputs(ctx)
    ref = entry.reference(ctx, inp)
    return {m: entry.compare(entry.reference(ctx, inp, control=m), ref)
            for m in (modes or ctx.traffic["control"]).split(",")}


def program(ctx) -> dict:
    from benchmark import harness as H
    run = H.run_cell(ctx, 0.0, time.perf_counter())
    return {**run["checks"], "sure_share": run["info"]["sure_share"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", nargs="?", const="", default=None,
                    help="the control's readings (tf32, bf16 or both, or "
                         "several joined by commas; the traffic's own when "
                         "bare)")
    args = ap.parse_args()
    import torch
    from benchmark import harness as H
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else None
    if dev is None:
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = H.make_ctx(args.workload, seed, dev)
        got = ({f"control {m}": v for m, v in
                control(ctx, args.control or None).items()}
               if args.control is not None else {"program": program(ctx)})
        for side, readings in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "readings": readings,
                              "limits": ctx.traffic["limits"],
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
