#!/usr/bin/env python3
"""Where the host time of the inverse kernels' wrappers goes, and the
kernels' device time at every rank.

    python3 tools/probe_inverse_wrapper.py [--out DIR]

Run from the root of a checkout of the port: the package is imported from
the current directory, so the same script times an older checkout's
wrappers too. Needs a CUDA card.

1. At the bench tiers' normal-inverse shapes (B, R) = (96, 4), (64, 8),
   (64, 12), (32, 16), (32, 20): ``normal_inverse`` per call eager (CUDA
   events over 200 calls back to back, as chip_smoke.py's ``cuda_ms``) and
   on the host clock (200 calls, no synchronise between them), and the host
   cost of each step a wrapper takes, each timed alone over 2,000 calls:
   the other-mode list, the dtype and shape checks and ``_check_cuda`` as
   the wrapper had them before its host cost was cut, ``torch.empty`` and
   ``torch.empty_like``, the
   current stream through ``torch.cuda.current_stream`` and through
   ``torch._C._cuda_getCurrentRawStream``, ``_build.stream_ptr``, the
   library lookup, four ``data_ptr`` calls, and the bare ctypes call of
   ``hinv_launch`` on prepared integers. ``spd_inverse`` likewise at J2's
   (B, R) = (320, 8).
2. Both kernels replayed from a CUDA graph (chip_smoke.py's ``graph_ms``)
   at B = 64 and R = 1 ... 64 (every boundary of csrc/gj_elim.cuh's plan).

Prints the card's name and power limit, one line per measurement, and
writes everything to DIR/probe_inverse_wrapper.json (default chiprun_out/).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402  (timing helpers, the card line)
from cp_cals_tpu_torch import _build  # noqa: E402
from cp_cals_tpu_torch.ops import fused_epilogue as fe  # noqa: E402
from cp_cals_tpu_torch.ops import spd_inverse as si  # noqa: E402

BENCH_SHAPES = ((96, 4), (64, 8), (64, 12), (32, 16), (32, 20))
SWEEP_RANKS = (1, 2, 4, 5, 8, 12, 16, 20, 24, 28, 31, 32, 33, 40, 48, 56, 64)
SWEEP_B = 64


def host_us(fn, n: int = 2000) -> float:
    for _ in range(20):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def problem(b: int, r: int, dev, seed: int = 0):
    """Three gramians (the first never read at skip 0) and a rank mask with
    the last slot dead; the normal matrix is SPD with cond below 1e3."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(b, 2 * r + 8, r))
    g0 = torch.from_numpy((np.transpose(f, (0, 2, 1)) @ f).astype(np.float32)).to(dev)
    g1 = (torch.ones(r, r, device=dev) + 0.5 * torch.eye(r, device=dev)).expand(b, r, r).contiguous()
    mask = torch.ones(b, r, dtype=torch.bool, device=dev)
    mask[-1] = False
    return [torch.zeros_like(g0), g0, g1], mask


def steps(grams, mask, dev, skip: int = 0) -> dict:
    """Each step of a wrapper alone, host microseconds per call."""
    others = [g for n, g in enumerate(grams) if n != skip]
    b, r, _ = others[0].shape
    out = torch.empty((b, r, r), dtype=torch.float32, device=dev)
    launch = fe._lib().hinv_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (others[0].data_ptr(), others[1].data_ptr(), mask.data_ptr(), out.data_ptr(), b, r, stream)

    def shape_checks():  # as the wrapper had them (tuple() of every shape)
        for g in others:
            if g.dtype != torch.float32 or tuple(g.shape) != (b, r, r):
                raise ValueError
        if mask.dtype != torch.bool or tuple(mask.shape) != (b, r):
            raise ValueError

    def check_cuda():  # the keyword dict with an f-string key per gramian
        fe._check_cuda("normal_inverse", dev, rank_mask=mask, **{f"gram{k}": g for k, g in enumerate(others)})

    timed = dict(
        others_list=lambda: [g for n, g in enumerate(grams) if n != skip],
        shape_checks=shape_checks,
        check_cuda=check_cuda,
        torch_empty=lambda: torch.empty((b, r, r), dtype=torch.float32, device=dev),
        torch_empty_like=lambda: torch.empty_like(others[0]),
        current_stream=lambda: torch.cuda.current_stream(dev).cuda_stream,
        stream_ptr=lambda: _build.stream_ptr(dev),
        lib_lookup=lambda: fe._lib().hinv_launch,
        data_ptrs=lambda: (others[0].data_ptr(), others[1].data_ptr(), mask.data_ptr(), out.data_ptr()),
        bare_launch=lambda: launch(*args),
        raw_stream=lambda: torch._C._cuda_getCurrentRawStream(dev.index),
    )
    res = {k: host_us(fn) for k, fn in timed.items()}
    torch.cuda.synchronize()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_inverse_wrapper: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    fe._lib()
    si._lib()
    result = dict(card=card, torch=torch.__version__, bench=[], sweep=[])
    for b, r in BENCH_SHAPES:
        grams, mask = problem(b, r, dev)
        fe.normal_inverse(grams, mask, 0)
        n = 200
        t0 = time.perf_counter()
        for _ in range(n):
            fe.normal_inverse(grams, mask, 0)
        host = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        entry = dict(kernel="normal_inverse", B=b, R=r, host_us=host,
                     eager_ms=chip_smoke.cuda_ms(lambda: fe.normal_inverse(grams, mask, 0), reps=200),
                     steps=steps(grams, mask, dev))
        result["bench"].append(entry)
        print(f"normal_inverse B={b} R={r}: eager {entry['eager_ms']:.4f} ms, host {host:.2f} us per call; "
              + ", ".join(f"{k} {v:.2f}" for k, v in entry["steps"].items()) + " (us)", flush=True)
    h = problem(320, 8, dev)[0][1]
    si.spd_inverse(h)
    t0 = time.perf_counter()
    for _ in range(200):
        si.spd_inverse(h)
    host = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    entry = dict(kernel="spd_inverse", B=320, R=8, host_us=host,
                 eager_ms=chip_smoke.cuda_ms(lambda: si.spd_inverse(h), reps=200))
    result["bench"].append(entry)
    print(f"spd_inverse B=320 R=8: eager {entry['eager_ms']:.4f} ms, host {host:.2f} us per call", flush=True)
    for r in SWEEP_RANKS:
        grams, mask = problem(SWEEP_B, r, dev, seed=r)
        h = grams[1]
        entry = dict(B=SWEEP_B, R=r,
                     normal_inverse_graph_ms=chip_smoke.graph_ms(lambda: fe.normal_inverse(grams, mask, 0)),
                     spd_inverse_graph_ms=chip_smoke.graph_ms(lambda: si.spd_inverse(h)))
        result["sweep"].append(entry)
        print(f"graph-replayed B={SWEEP_B} R={r}: normal_inverse {entry['normal_inverse_graph_ms']:.4f} ms, "
              f"spd_inverse {entry['spd_inverse_graph_ms']:.4f} ms", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "probe_inverse_wrapper.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
