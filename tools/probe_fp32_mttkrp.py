#!/usr/bin/env python3
"""Probe what bounds the "highest" fp32 MTTKRP kernel on the card.

    python3 tools/probe_fp32_mttkrp.py [--out DIR]

Builds copies of cp_cals_tpu_torch/csrc/fused_mttkrp.cu into DIR/probe_fp32/
(default chiprun_out/), each with one change made by text substitution,
and times each, replayed from a CUDA graph, at every (bucket, mode) of the
"highest" engine's launch mix of chip_smoke.py (the bench tensor, buckets
4/8/12/16/20 at B*R = 384-768), weighted by the engine's bucket-iterations:

- base: the kernel as it is;
- no_x_stream: X is never copied (no TMA, no wait on it): the FFMA loop on
  whatever the ring holds, its barriers and the U2 gather (wrong results);
- no_stage_barrier: as no_x_stream, and without the block barrier per ring
  stage (wrong results);
- warps16: a 64-row tile of 8 x 4 per thread, 16 warps per block in place
  of 8 (modes 0-1; results right);
- warp_4x8: the 64-row tile's warps span 4 x 8 threads in place of 2 x 16,
  fewer shared-memory wavefronts per operand load (results right).

It also prints ptxas's register and spill counts of each build, and the
rate of one cuBLAS fp32 SGEMM (TF32 off) at 8192^3: the practical FFMA
ceiling of the card, against which the kernel's rate is read. Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the bench tensor, its timing helpers)
from cp_cals_tpu_torch import _build  # noqa: E402
from cp_cals_tpu_torch.ops import fused_mttkrp as fm  # noqa: E402
from cp_cals_tpu_torch.utils.roofline import device_peaks  # noqa: E402

SOURCE = _build.CSRC / "fused_mttkrp.cu"
NO_X = [
    ("mbar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);", ""),
    ("mbar_expect(bar, T::XSTAGE * 4);", ""),
    ("tma_load(xst + g", "tma_skip(xst + g"),
    ('#include "smem_attr.cuh"\n', '#include "smem_attr.cuh"\n#define tma_skip(...) ((void)0)\n'),
]
TILES = "#define FP32_TILES(X) X(0, 64, 8, 8, 2) X(1, 48, 16, 4, 4)"
WX = "  static constexpr int WX = NTX < 32 ? NTX : 32;"
VARIANTS = {
    "base": [],
    "no_x_stream": NO_X,
    "no_stage_barrier": NO_X + [
        ("    __syncthreads();              // everyone's have; and stage t - 1's slot is free", "")],
    "warps16": [(TILES, TILES + " X(2, 64, 8, 4, 2)")],
    "warp_4x8": [(WX, "  static constexpr int WX = (NTY % 4 == 0 && NTX >= 8) ? 8 : (NTX < 32 ? NTX : 32);")],
}
EXACT = {"base", "warps16", "warp_4x8"}  # the variants whose results are right
# The "highest" engine run's bucket-iterations per bucket rank, and each
# bucket's batch (chip_smoke.py's bench workload).
WEIGHTS = {4: 10, 8: 20, 12: 20, 16: 30, 20: 30}
BATCH = {4: 96, 8: 64, 12: 64, 16: 32, 20: 32}


def build(out_dir: str) -> dict:
    """Each variant's library and ptxas's per-kernel (registers, spill bytes)."""
    src = SOURCE.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for a, b in subs:
            if a not in text:
                raise RuntimeError(f"{name}: the source no longer has {a!r}")
            text = text.replace(a, b)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
               "-o", os.path.join(out_dir, f"{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        kernels, current = {}, None
        for line in log.splitlines():
            m = re.search(r"mttkrp_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
            if m and "Compiling entry" in line:
                current = "x".join(m.groups())
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and current:
                kernels.setdefault(current, {})["spill_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and current:
                kernels.setdefault(current, {})["registers"] = int(m.group(1))
                current = None
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.fused_mttkrp_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 2
        lib.fused_mttkrp_launch.restype = ctypes.c_int
        libs[name] = (lib, kernels)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_fp32_mttkrp: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out_dir = os.path.join(args.out, "probe_fp32")
    os.makedirs(out_dir, exist_ok=True)
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = build(out_dir)
    for name, (_, kernels) in libs.items():
        print(f"build {name}: (rows x rows/thread x columns/thread x groups) -> {kernels}", flush=True)

    x_np, _ = chip_smoke.bench_tensor()
    x = torch.from_numpy(x_np).to(dev)
    held = {m: fm.prepare_mode_tensor(x, m) for m in range(3)}
    gen = torch.Generator().manual_seed(1)
    index = torch.cuda.current_device()
    rows, mix = [], {}
    for r, b in BATCH.items():
        fs = [(torch.rand(b, n, r, generator=gen) * 2 - 1).to(dev).contiguous() for n in chip_smoke.MODES]
        for mode in range(3):
            small, big = fm.split_others(chip_smoke.MODES, mode)
            x3, u1, u2 = held[mode], fs[small], fs[big]
            j, k, i = x3.shape
            want = fm.fused_mttkrp_plain(x3, u1, u2, "highest")
            plan = fm.fp32_plan(index, j, i, k, b * r)
            for name, (lib, _) in libs.items():
                p = plan
                if name == "warps16":
                    if plan[0] != 0:
                        continue  # the 64-row tile only
                    p = (2,) + plan[1:]
                tile, kspan, ksplits, jsplits, jchunk = p
                out = torch.empty(b, i, r, device=dev)
                work = (torch.empty(ksplits * jsplits, i, b * r, device=dev)
                        if ksplits * jsplits > 1 else None)

                def call(lib=lib, out=out, work=work, p=p):
                    code = lib.fused_mttkrp_launch(
                        x3.data_ptr(), u1.data_ptr(), u2.data_ptr(), out.data_ptr(),
                        work.data_ptr() if work is not None else None, j, i, x3.stride(1), k, b, r,
                        *p, None, torch.cuda.current_stream().cuda_stream)
                    if code != 0:
                        raise RuntimeError(f"{name}: CUDA error {code}")

                call()
                torch.cuda.synchronize()
                err = ((out - want).abs().max() / want.abs().max()).item()
                if name in EXACT and not err <= chip_smoke.TOL["mttkrp"]:
                    raise AssertionError(f"{name} R={r} mode={mode}: {err}")
                t = chip_smoke.graph_ms(call)
                flops = 2 * j * i * k * b * r + 2 * j * i * b * r
                rows.append(dict(variant=name, R=r, B=b, mode=mode, plan=list(p), graph_ms=t,
                                 tflops=flops / t / 1e9, rel_err=err))
                mix.setdefault(name, []).append((WEIGHTS[r], t))
                print(f"R={r:2d} B={b:2d} mode={mode} {name:17s} plan {p}: {t:.4f} ms "
                      f"({flops / t / 1e9:.1f} TFLOP/s), err/max {err:.1e}", flush=True)
    summary = {name: sum(w * t for w, t in v) / sum(w for w, _ in v) for name, v in mix.items()}
    for name, t in summary.items():
        print(f"mix {name}: {t:.4f} ms graph-replayed over {len(mix[name])} shapes", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    n = 8192
    a, bm = torch.randn(n, n, device=dev), torch.randn(n, n, device=dev)
    t = chip_smoke.cuda_ms(lambda: torch.matmul(a, bm), reps=10)
    sgemm = 2 * n**3 / t / 1e9
    peak = device_peaks(0)["fp32_tflops"]
    print(f"cuBLAS fp32 SGEMM {n}^3 (TF32 off): {t:.3f} ms, {sgemm:.1f} TFLOP/s "
          f"({sgemm / peak:.3f} of the {peak:.0f} TFLOP/s peak)",
          flush=True)
    with open(os.path.join(args.out, "probe_fp32_mttkrp.json"), "w") as fh:
        json.dump(dict(card=card, builds={k: v[1] for k, v in libs.items()}, rows=rows, mix=summary,
                       sgemm_tflops=sgemm), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
