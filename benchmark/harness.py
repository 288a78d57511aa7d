"""The benchmark's general driver: one cell, one seed, one run.

Everything that belongs to one cell is found by name: the cell's entry in
BENCHMARK.json names its configuration (`configs/<config>.toml`, a frozen
copy of the program's TOML with a [benchmark] table of its own) and its
traffic (`traffic/<traffic>.toml`: the entry point it drives, its
parameters, the end-to-end metric it reports and the limits of its
comparison); the traffic names its entry (`entries/<entry>.py`, the
binding to the program); each per-layer metric is read by
`metrics/<name before the first dot>.py`. Adding a cell, a traffic or a
metric adds files and entries and edits none.

A run: set-up (the program's objects, the inputs made from the seed, one
warm-up unit on the cell's own shapes, the first inputs made again), then
the window: whole units until `seconds` have passed (with trace, the
traffic's `trace_units` units, then as many under torch.profiler), then, once the
program's state is freed, the comparison with the plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
import tomllib
import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
OUT = ROOT / "build" / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "scale_letkf_tpu")


@dataclass
class Ctx:
    """What an entry sees of its run."""
    cell: dict
    config_path: Path          # the TOML the program's loader reads
    raw: dict                  # that TOML, parsed
    dom: dict                  # its [domain] table
    traffic: dict
    seed: int
    device: torch.device
    trace: bool = False


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_json(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str) -> tuple[list, list]:
    """The cell's end-to-end and per-layer metrics: those that list it,
    and those without a list whose end-to-end metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def make_ctx(workload: str, seed: int, device: torch.device,
             trace: bool = False, domain_overrides: dict | None = None,
             member: int | None = None, traffic_overrides: dict | None = None,
             root: Path = ROOT) -> Ctx:
    bench = benchmark_json(root)
    cell = cell_of(bench, workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / conf["file"], "rb") as f:
        raw = tomllib.load(f)
    raw.pop("benchmark", None)
    dom = dict(raw.get("domain", {}))
    dom.update(domain_overrides or {})
    if member is not None:
        raw.setdefault("ensemble", {})["member"] = member
    raw["domain"] = dom
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"{cell['config']}.toml"
    path.write_text(_toml(raw))
    with open(HERE / "traffic" / f"{cell['traffic']}.toml", "rb") as f:
        traffic = tomllib.load(f)
    traffic.update(traffic_overrides or {})
    return Ctx(cell=cell, config_path=path, raw=raw, dom=dom,
               traffic=traffic, seed=int(seed), device=device, trace=trace)


def _toml(d: dict, prefix: str = "") -> str:
    """A TOML text of nested tables of numbers, strings, booleans and
    lists (what the configurations hold)."""
    def val(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return json.dumps(v)
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(val(x) for x in v) + "]"
        return repr(v)
    lines, tables = [], []
    for k, v in d.items():
        if isinstance(v, dict):
            tables.append((k, v))
        else:
            lines.append(f"{k} = {val(v)}")
    out = "\n".join(lines) + "\n"
    for k, v in tables:
        name = f"{prefix}{k}"
        out += f"\n[{name}]\n" + _toml(v, name + ".")
    return out


def entry_of(ctx: Ctx):
    return load_module(HERE / "entries" / f"{ctx.traffic['entry']}.py",
                       f"bench_entry_{ctx.traffic['entry']}")


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package the process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _program_syncs(caught) -> int:
    """Synchronising calls the sync debug mode reported, less the
    benchmark's own."""
    return sum(1 for w in caught if "synchroniz" in str(w.message)
               and str(HERE) not in str(w.filename))


def run_cell(ctx: Ctx, seconds: float, t_process: float) -> dict:
    """One run of the cell: {'info', 'rec', 'checks', 'forbidden',
    'attempted', 'failed'}."""
    entry = entry_of(ctx)
    dev = ctx.device
    unit = entry.Unit(ctx)
    unit.start()
    unit.step(0)                       # warm-up: the cell's own shapes,
    unit.keep()                        # and the kernels keep() launches
    unit.start()                       # the window's first inputs, anew
    _sync(dev)
    setup_s = time.perf_counter() - t_process
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = {}
    if ctx.trace:
        rec = _traced_window(ctx, unit)
        units, window = rec["units"], rec["plain_s"]
    else:
        units, t0 = 0, time.perf_counter()
        while True:
            unit.step(units)
            if units == 0:
                unit.keep()
            _sync(dev)
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    bad = forbidden_modules()
    info = {"units": units, "window_s": window, "setup_s": setup_s,
            "work": unit.work * units, "peak_bytes": peak}
    if ctx.trace:
        info["bounds"] = unit.bounds(units)
    unit.release()
    inp, kept = unit.inp, unit.kept
    del unit
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = entry.reference(ctx, inp, kept)
    checks = entry.compare(kept, ref)
    info["reference_s"] = time.perf_counter() - t1
    info["sure_share"] = ref.get("sure_share", 1.0)
    return {"info": info, "rec": rec, "checks": checks, "forbidden": bad,
            "attempted": 2 * units if ctx.trace else units, "failed": 0}


def _traced_window(ctx: Ctx, unit) -> dict:
    """The traffic's trace_units units twice. First without the profiler:
    the program's spans, its synchronising calls (under
    torch.cuda.set_sync_debug_mode('warn')) and the units' wall time
    (`plain_s`). Then as many more under the profiler (CPU and CUDA
    activities): the device's busy time, kernel times and breakdown over
    their wall (`window_s`). So no span or wall a metric divides by holds
    the profiler's own host time."""
    from benchmark import trace as tr
    dev = ctx.device
    n = int(ctx.traffic.get("trace_units", 1))
    cuda = dev.type == "cuda"
    unit.reset_spans()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            for i in range(n):
                unit.step(i)
                if i == 0:
                    unit.keep()
                _sync(dev)
            plain = time.perf_counter() - t0
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    spans = unit.spans()
    rec = tr.Recorder(cuda)
    rec.start()
    t0 = time.perf_counter()
    for i in range(n, 2 * n):
        unit.step(i)
        _sync(dev)
    window = time.perf_counter() - t0
    t1 = time.perf_counter()
    got = tr.summarize(rec.stop())
    got["read_s"] = time.perf_counter() - t1
    return {"units": n, "plain_s": plain, "window_s": window, "spans": spans,
            "sync_calls": _program_syncs(caught), **got}


def layer_metrics(layer: list, rec: dict, info: dict) -> dict:
    """Each per-layer metric's reader over the traced record; a reader
    that finds nothing leaves its metric out."""
    full = {**rec, **info}
    out = {}
    for m in layer:
        base = m["name"].split(".")[0]
        mod = load_module(HERE / "metrics" / f"{base}.py",
                          f"bench_metric_{base}")
        v = mod.read(full)
        if v is not None and np.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def e2e_metrics(e2e: list, ctx: Ctx, info: dict) -> dict:
    spec = ctx.traffic["e2e"]
    out = {}
    for m in e2e:
        if m["name"] == "setup_s":
            v = info["setup_s"]
        elif m["name"] == spec["name"]:
            v = (info["window_s"] / info["units"] if spec["form"] == "period"
                 else info["work"] / info["window_s"])
        else:
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_of(ctx: Ctx, info: dict, rec: dict) -> dict:
    dev = ctx.device
    d = {"platform": "gpu" if dev.type == "cuda" else dev.type,
         "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                  else "cpu"),
         "count": int(ctx.cell.get("chips", 1)),
         "memory_peak_bytes": int(info["peak_bytes"])}
    if ctx.trace:
        d["busy_s"] = float(rec.get("busy_s", 0.0))
        d["window_s"] = float(rec.get("window_s", 0.0))
    return d


def result(ctx: Ctx, run: dict) -> tuple[dict, list[str]]:
    """The result line and the check lines (each number beside its
    limit)."""
    bench = benchmark_json()
    e2e, layer = metrics_of(bench, ctx.cell["name"])
    info, rec = run["info"], run["rec"]
    limits = ctx.traffic["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in run["checks"].items() if k in limits}
    correct = bool(checks) and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()) and len(checks) == len(limits)
    metrics = (layer_metrics(layer, rec, info) if ctx.trace
               else e2e_metrics(e2e, ctx, info))
    res = {"correct": correct, "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics,
           "device": device_of(ctx, info, rec)}
    if ctx.trace:
        res["breakdown"] = {"device_ops": rec.get("device_ops", []),
                            "idle_gaps": rec.get("idle_gaps", [])}
    res["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return res, lines
