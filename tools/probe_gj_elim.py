#!/usr/bin/env python3
"""Probe what bounds the shared Gauss-Jordan inverse (csrc/gj_elim.cuh).

    python3 tools/probe_gj_elim.py [--out DIR]

Builds copies of cp_cals_tpu_torch/csrc/gj_elim.cuh into DIR/probe_gj/
(default chiprun_out/), each with one change made by text substitution and
compiled with a small launcher source that calls both front ends as the port's
sources do, and times each replayed from a CUDA graph: the normal inverse
at the bench tiers' shapes (B, R) = (96, 4), (64, 8), (64, 12), (32, 16),
(32, 20), weighted by the bench-tier engine's bucket-iterations (10, 20,
20, 30, 30), and the SPD inverse at J2's (B, R) = (80, 8), (160, 8),
(320, 8), weighted by J2's launches (18, 3, 9). Variants:

- base: the header as it is;
- mpb1: one model (warp) per block on the warp path (base: 4);
- fdiv: the normal inverse divides with __fdiv_rn alone, zero numerators
  included (the division's slow path for them);
- branch_loads: the warp path loads under `c < R`, lanes past R loading
  nothing;
- pipelined: the warp path software-pipelined (each step shuffles the next
  step's column as it updates the rows, and scales the next pivot row at
  its end);
- rcp: the normal inverse takes one reciprocal of the pivot and multiplies,
  as the SPD inverse does (results off by rounding: what the division
  costs).

Every variant but rcp computes the same values in the same order, so each
must be bit-identical to the port's kernels. Prints ptxas's largest register count
and spill bytes of each build.

With --against CHECKOUT, both inverses of this checkout are also held to
the kernels that another checkout built (the newest CHECKOUT/build/cuda/*/
fused_epilogue.so and spd_inverse.so, built by running anything of it
that launches them) on the same inputs, at B = 37 and every R from 1 to 64
(gramians of random factors, masked columns, a dead slot), and the
differing elements are counted: 0 at every R says the two compute the
same bits. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402  (timing helpers, the card line)
from cp_cals_tpu_torch import _build  # noqa: E402
from cp_cals_tpu_torch.ops import fused_epilogue as fe  # noqa: E402
from cp_cals_tpu_torch.ops import spd_inverse as si  # noqa: E402
from probe_inverse_wrapper import problem  # noqa: E402

HEADER = _build.CSRC / "gj_elim.cuh"
LAUNCHER = """#include "gj_elim.cuh"
extern "C" int probe_hinv(const float* g0, const float* g1, const uint8_t* mask, float* out,
                          int B, int R, void* s) {
  return gj_launch<DividePivot>(HadamardLoad{g0, g1, mask, R}, out, B, R, (cudaStream_t)s);
}
extern "C" int probe_spd(const float* h, float* out, int B, int R, void* s) {
  return gj_launch<ReciprocalPivot>(PlainLoad{h, R}, out, B, R, (cudaStream_t)s);
}
"""
WARP_START = "template <int R, class Pivot, class Loader>\n__global__ void __launch_bounds__(32 * MODELS_PER_BLOCK)"
WARP_END = "template <class Pivot, class Loader>\n__global__ void __launch_bounds__(BLOCK_THREADS)"
# The warp path software-pipelined: as each row of A is updated, lane
# j + 1's new entry is shuffled to every lane (the next step's column), and
# the next pivot row is scaled at the end of the step; two steps per pass,
# the column buffers swapping roles.
PIPELINED = """// One step of the warp path, pivot row j in slot 0: colj is column j (A's,
// shuffled from lane j during the previous step), pa and pv this lane's
// scaled pivot-row entries of A and V. Leaves column j + 1 in next and the
// next pivot row's scaled entries in pa and pv.
template <int R, class Pivot>
__device__ __forceinline__ void gj_warp_step(float (&a)[R], float (&v)[R], const float (&colj)[R],
                                             float (&next)[R], float& pa, float& pv, int j) {
  const int jn = (j + 1) % 32;  // the next pivot's lane (after the last step: unused)
#pragma unroll
  for (int s = 1; s < R; ++s) {  // row (j + s) mod R moves to slot s - 1
    a[s - 1] = __fmaf_rn(-colj[s], pa, a[s]);
    v[s - 1] = __fmaf_rn(-colj[s], pv, v[s]);
    next[s - 1] = __shfl_sync(FULL_WARP, a[s - 1], jn);
  }
  a[R - 1] = pa;
  v[R - 1] = pv;
  next[R - 1] = __shfl_sync(FULL_WARP, pa, jn);
  Pivot::scale(next[0], a[0], v[0], pa, pv);
}

template <int R, class Pivot, class Loader>
__global__ void __launch_bounds__(32 * MODELS_PER_BLOCK)
gj_warp_kernel(Loader load, float* __restrict__ out, int B) {
  const int b = blockIdx.x * MODELS_PER_BLOCK + threadIdx.x / 32;
  if (b >= B) return;  // whole warps only: no shuffle loses a lane
  const int c = threadIdx.x % 32;
  float a[R], v[R], c0[R], c1[R];
  const int cl = c < R ? c : R - 1;
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = load(b, r, cl);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = c < R ? a[r] : 0.f;
    v[r] = r == c ? 1.f : 0.f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) c0[r] = __shfl_sync(FULL_WARP, a[r], 0);
  float pa, pv;
  Pivot::scale(c0[0], a[0], v[0], pa, pv);
#pragma unroll 1
  for (int j = 0; j + 1 < R; j += 2) {
    gj_warp_step<R, Pivot>(a, v, c0, c1, pa, pv, j);
    gj_warp_step<R, Pivot>(a, v, c1, c0, pa, pv, j + 1);
  }
  if constexpr (R % 2 == 1) gj_warp_step<R, Pivot>(a, v, c0, c1, pa, pv, R - 1);
  if (c < R) {
    float* o = out + (size_t)b * R * R + c;
#pragma unroll
    for (int r = 0; r < R; ++r) o[r * R] = v[r];
  }
}

"""
UNCONDITIONAL_LOADS = """#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = load(b, r, cl);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = c < R ? a[r] : 0.f;"""
BRANCH_LOADS = """#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = c < R ? load(b, r, c) : 0.f;"""


def replace(old: str, new: str):
    def edit(text: str) -> str:
        if text.count(old) != 1:
            raise RuntimeError(f"the header no longer has {old!r} once")
        return text.replace(old, new)
    return edit


def models_per_block(n: int):
    def edit(text: str) -> str:
        out, k = re.subn(r"constexpr int MODELS_PER_BLOCK = \d+;", f"constexpr int MODELS_PER_BLOCK = {n};", text)
        if k != 1:
            raise RuntimeError("the header no longer sets MODELS_PER_BLOCK once")
        return out
    return edit


def pipelined(text: str) -> str:
    a, b = text.index(WARP_START), text.index(WARP_END)
    return text[:a] + PIPELINED + text[b:]


VARIANTS = {
    "base": [],
    "mpb1": [models_per_block(1)],
    "fdiv": [replace("    pa = div_rn(a, d);\n    pv = div_rn(v, d);",
                     "    pa = __fdiv_rn(a, d);\n    pv = __fdiv_rn(v, d);")],
    "branch_loads": [replace(UNCONDITIONAL_LOADS, BRANCH_LOADS)],
    "pipelined": [pipelined],
    "rcp": [replace("    pa = div_rn(a, d);\n    pv = div_rn(v, d);",
                    "    const float rd = __frcp_rn(d);\n    pa = __fmul_rn(a, rd);\n    pv = __fmul_rn(v, rd);")],
}
EXACT = set(VARIANTS) - {"rcp"}  # the variants whose results must be bit-identical
NORMAL_MIX = {(96, 4): 10, (64, 8): 20, (64, 12): 20, (32, 16): 30, (32, 20): 30}
SPD_MIX = {(80, 8): 18, (160, 8): 3, (320, 8): 9}


def build(out_dir: str) -> dict:
    """Each variant's library and ptxas's (largest register count, spill bytes)."""
    text0 = HEADER.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = text0
        for edit in subs:
            text = edit(text)
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, "gj_elim.cuh"), "w") as fh:
            fh.write(text)
        with open(os.path.join(vdir, "probe_gj.cu"), "w") as fh:
            fh.write(LAUNCHER)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", vdir,
               "-o", os.path.join(vdir, "probe_gj.so"), os.path.join(vdir, "probe_gj.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        lib = ctypes.CDLL(os.path.join(out_dir, name, "probe_gj.so"))
        lib.probe_hinv.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.probe_spd.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        libs[name] = (lib, dict(max_registers=max(regs), spill_bytes=max(spills)))
    return libs


def against(root: str, dev) -> dict:
    """Differing elements between this checkout's inverses and ``root``'s
    built kernels, per R."""
    libs = {}
    for name in ("fused_epilogue", "spd_inverse"):
        found = sorted(glob.glob(os.path.join(root, "build", "cuda", "*", name + ".so")), key=os.path.getmtime)
        if not found:
            raise RuntimeError(f"{root} has no built {name}.so")
        libs[name] = ctypes.CDLL(found[-1])
    hinv, spd_inv = libs["fused_epilogue"].hinv_launch, libs["spd_inverse"].spd_inverse_launch
    hinv.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    spd_inv.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    out = {}
    b = 37
    for r in range(1, si.MAX_R + 1):
        grams, mask = problem(b, r, dev, seed=100 + r)
        if r > 2:
            mask[::3, r - 2:] = False  # masked columns
        got_n, got_s = fe.normal_inverse(grams, mask, 0), si.spd_inverse(grams[1])
        ref_n, ref_s = torch.empty_like(got_n), torch.empty_like(got_s)
        stream = _build.stream_ptr(dev)
        _build.check(hinv(grams[1].data_ptr(), grams[2].data_ptr(), mask.data_ptr(), ref_n.data_ptr(),
                          b, r, stream), "hinv_launch")
        _build.check(spd_inv(grams[1].data_ptr(), ref_s.data_ptr(), b, r, stream), "spd_inverse_launch")
        torch.cuda.synchronize()
        out[r] = dict(normal_differing=int((got_n != ref_n).sum()), spd_differing=int((got_s != ref_s).sum()),
                      normal_max_abs=(got_n - ref_n).abs().max().item(), spd_max_abs=(got_s - ref_s).abs().max().item())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gj_elim: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--against", help="another checkout whose built inverse kernels to hold these to")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    out_dir = os.path.join(args.out, "probe_gj")
    libs = build(out_dir)
    normal = {s: problem(*s, dev) for s in NORMAL_MIX}
    spd = {s: problem(*s, dev)[0][1] for s in SPD_MIX}
    want_n = {s: fe.normal_inverse(g, m, 0) for s, (g, m) in normal.items()}
    want_s = {s: si.spd_inverse(h) for s, h in spd.items()}
    result = dict(card=card, variants={})
    for name, (lib, ptxas) in libs.items():
        def hinv(s, lib=lib):
            (grams, mask), (b, r) = normal[s], s
            out = torch.empty((b, r, r), device=dev)
            _build.check(lib.probe_hinv(grams[1].data_ptr(), grams[2].data_ptr(), mask.data_ptr(),
                                        out.data_ptr(), b, r, _build.stream_ptr(dev)), name)
            return out

        def spd_inv(s, lib=lib):
            h = spd[s]
            out = torch.empty_like(h)
            _build.check(lib.probe_spd(h.data_ptr(), out.data_ptr(), *s, _build.stream_ptr(dev)), name)
            return out

        exact = (all(torch.equal(hinv(s), want_n[s]) for s in NORMAL_MIX)
                 and all(torch.equal(spd_inv(s), want_s[s]) for s in SPD_MIX))
        n_ms = {s: chip_smoke.graph_ms(lambda s=s: hinv(s)) for s in NORMAL_MIX}
        s_ms = {s: chip_smoke.graph_ms(lambda s=s: spd_inv(s)) for s in SPD_MIX}
        entry = dict(
            **ptxas, exact=exact,
            normal_mix_ms=sum(w * n_ms[s] for s, w in NORMAL_MIX.items()) / sum(NORMAL_MIX.values()),
            spd_mix_ms=sum(w * s_ms[s] for s, w in SPD_MIX.items()) / sum(SPD_MIX.values()),
            normal_ms={f"B={b} R={r}": v for (b, r), v in n_ms.items()},
            spd_ms={f"B={b} R={r}": v for (b, r), v in s_ms.items()},
        )
        result["variants"][name] = entry
        print(f"{name}: normal mix {entry['normal_mix_ms']:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in entry["normal_ms"].items())
              + f"), spd mix {entry['spd_mix_ms']:.4f} ms; exact {exact}; registers <= "
              f"{ptxas['max_registers']}, spills {ptxas['spill_bytes']} bytes", flush=True)
    same = True
    if args.against:
        result["against"] = dict(checkout=args.against, by_rank=against(args.against, dev))
        for r, d in result["against"]["by_rank"].items():
            same = same and d["normal_differing"] == 0 and d["spd_differing"] == 0
            print(f"against {args.against} R={r}: normal inverse {d['normal_differing']} elements differ "
                  f"(max {d['normal_max_abs']:.3g}), SPD inverse {d['spd_differing']} (max {d['spd_max_abs']:.3g})",
                  flush=True)
    with open(os.path.join(args.out, "probe_gj_elim.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0 if same and all(result["variants"][n]["exact"] for n in EXACT) else 1


if __name__ == "__main__":
    sys.exit(main())
