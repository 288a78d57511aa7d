"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (one JSON object) and each compared number beside its
limit as the last lines of standard error. Exits non-zero, printing no
result, without a CUDA device (or fewer than the cell asks for), or when
the process has loaded JAX or the JAX package.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from benchmark import harness as H
    cell = H.cell_of(H.benchmark_json(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell.get("chips", 1)):
        print(f"{cell['name']} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    ctx = H.make_ctx(args.workload, args.seed, torch.device("cuda", 0),
                     trace=bool(args.trace))
    run = H.run_cell(ctx, args.seconds, T_PROCESS)
    bad = sorted(set(run["forbidden"]) | set(H.forbidden_modules()))
    if bad:
        print(f"loaded {', '.join(bad)}: the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    res, lines = H.result(ctx, run)
    info = run["info"]
    print(json.dumps({"info": {k: v for k, v in info.items()
                               if k != "bounds"}}), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
