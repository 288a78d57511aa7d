"""The invsqrt_ns kernel against other builds of it, in one process on one GPU.

    python -m scale_letkf_torch.invsqrt_compare --other OLD.cu [--other ...]
        [--batch 28928] [--members 50] [--cond 1e3] [--reps 5]

Each OLD.cu is a source with the same C entry point as
csrc/invsqrt_ns.cu (for example an earlier commit's kernel, unpacked by
`git archive` into a gitignored directory); it is built with the package's
nvcc flags into build/kernels/. The operands are `--batch` LETKF-shaped
Grams hᵀh·scale/40 + (K-1)·I of `--members` members at the target
condition number, made on the card from a seed, normalised and padded by
ns_operands — the shape of one level chunk of the 18-km analysis by
default. The package's kernel and every other build are timed in turns
with CUDA events (the others, this one, this one, the others reversed),
after one warm-up launch each. Prints the card's
`nvidia-smi --query-gpu=name,power.limit` line, then one JSON line per
build: its label, ptxas's register and spill lines, the two timed turns in
ms, the largest error against invsqrt_ns_plain relative to max|isq|, and
whether two launches gave bit-identical outputs. The last line is the
card's rate of the kernel's tensor-core instruction alone
(mma.sync.m16n8k8 TF32 on independent accumulators, 4 warps × 4 CTAs an
SM): the ceiling of the kernel's design, which 495 TFLOP/s, the rate of
wgmma, is not.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from scale_letkf_torch.ops.invsqrt import (
    invsqrt_ns_kernel, invsqrt_ns_plain, ns_operands)
from scale_letkf_torch.utils import kernels
from scale_letkf_torch.utils.device import require_cuda


def ptxas_lines(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def build_other(src: Path):
    """The C entry point invsqrt_ns_launch of another source, built and
    loaded, and ptxas's report; raises if nvcc fails."""
    h = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = kernels.BUILD_DIR / f"libinvsqrt_ns_other_{h}.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    fn = ctypes.CDLL(str(so)).invsqrt_ns_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(a, areg):
        isq, inv = torch.empty_like(a), torch.empty_like(a)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = fn(a.data_ptr(), areg.data_ptr(), isq.data_ptr(),
                    inv.data_ptr(), a.shape[0], a.shape[1], 18, 2, stream)
        if status != 0:
            raise RuntimeError(f"{src}: CUDA error {status}")
        return isq, inv
    return run, ptxas_lines(res.stderr)


MMA_PEAK_SRC = r"""
#include <cstdint>
__global__ void mma_peak(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t a = __float_as_uint(1.f + threadIdx.x) & 0xffffe000u;
  const uint32_t b = __float_as_uint(2.f - threadIdx.x) & 0xffffe000u;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %4, %4, %4}, {%5, %5}, {%0, %1, %2, %3};"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a), "r"(b));
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 0.5f) out[0] = s;  // keeps the loop; never true
}
extern "C" int mma_peak_launch(float* out, int blocks, int iters) {
  mma_peak<<<blocks, 128>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_tf32_tflops(device, iters: int = 20000) -> dict:
    """TFLOP/s of mma.sync m16n8k8 TF32 alone on this card: 8 independent
    accumulators a warp, 4 warps a CTA, 4 CTAs an SM."""
    src = kernels.BUILD_DIR / "mma_peak.cu"
    so = kernels.BUILD_DIR / "libmma_peak.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(MMA_PEAK_SRC)
    subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                    str(src)], capture_output=True, text=True, timeout=600,
                   check=True)
    fn = ctypes.CDLL(str(so)).mma_peak_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = torch.empty(1, device=device)
    blocks = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    if fn(out.data_ptr(), blocks, iters) != 0:
        raise RuntimeError("mma_peak launch failed")
    ms = cuda_ms(lambda: fn(out.data_ptr(), blocks, iters), 3)
    mmas = blocks * 4 * iters * 8
    return {"mma_sync_tf32_tflops": mmas * 2 * 16 * 8 * 8 / ms / 1e9,
            "ms": ms, "blocks": blocks}


def grams(B: int, K: int, cond: float, device, seed: int = 0):
    """LETKF-shaped SPD Grams at the target condition number (the
    Marchenko–Pastur edge of hᵀh/40) and their exact λ_min bound K-1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    scale = (cond - 1.0) * (K - 1) / (1.0 + (K / 40.0) ** 0.5) ** 2
    h = torch.randn((B, 40, K), generator=gen, device=device)
    c = (h.transpose(1, 2) @ h) * (scale / 40.0)
    c.diagonal(dim1=1, dim2=2).add_(K - 1.0)
    return c, torch.full((B,), K - 1.0, device=device)


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], type=Path)
    ap.add_argument("--batch", type=int, default=28928)
    ap.add_argument("--members", type=int, default=50)
    ap.add_argument("--cond", type=float, default=1e3)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    device = require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    builds, ptxas = {}, {}
    for p in args.other:
        builds[str(p)], ptxas[str(p)] = build_other(p)
    kernels.load("invsqrt_ns")
    builds["csrc/invsqrt_ns.cu"] = invsqrt_ns_kernel
    ptxas["csrc/invsqrt_ns.cu"] = ptxas_lines(
        kernels.BUILD_LOG["invsqrt_ns"]["ptxas"])
    c, smin = grams(args.batch, args.members, args.cond, device)
    a, areg, _ = ns_operands(c, smin)
    del c
    isq_p, _ = invsqrt_ns_plain(a, areg)
    scale = float(isq_p.abs().max())
    rows = {}
    for label, run in builds.items():
        first, _ = run(a, areg)
        second, _ = run(a, areg)
        torch.cuda.synchronize()
        rows[label] = {
            "label": label, "ptxas": ptxas[label], "batch": args.batch,
            "kp": int(a.shape[-1]),
            "cond": args.cond,
            "rel_err": float((first - isq_p).abs().max()) / scale,
            "bit_identical_runs": bool(torch.equal(first, second)),
            "ms_runs": []}
        del first, second
    order = [lb for lb in builds if lb != "csrc/invsqrt_ns.cu"]
    turns = order + ["csrc/invsqrt_ns.cu"] * 2 + order[::-1]
    for label in turns:
        rows[label]["ms_runs"].append(
            cuda_ms(lambda: builds[label](a, areg), args.reps))
    for row in rows.values():
        row["ms"] = sum(row["ms_runs"]) / len(row["ms_runs"])
        print(json.dumps(row), flush=True)
    print(json.dumps(mma_tf32_tflops(device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
