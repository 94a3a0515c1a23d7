"""What the component profiles share: the counterpart of each JAX script's
``timed`` and ``_null``, the scripts' input draws, the checks of a kernel
against its plain version, and the result's header and file.

Timing. A JAX script times ``n_loop`` chained steps of one jitted
``fori_loop`` on the host's clock, less the null round trip. Here the
``n_loop`` steps are captured once into a CUDA graph, after one eager
warm-up step (the manner of ``probe_overhead._graph_replay``), and a
replay is timed with CUDA events: the best of ``reps`` replays, over
``n_loop`` (``Chain``, ``timed``). Each step reads the previous step's
output, as the scripts' ``fo + sum(g) * 1e-30`` chains do, so no step
repeats the same work on unchanged inputs. The null round trip is
measured as ``probe_overhead.run_probe`` measures ``null_ms`` and kept in
each result under the script's key, but nothing subtracts it: the events
time the device alone. X (14.8 MB at 299x301x41 in float32) stays in the
H100's 50 MB L2 from step to step, as it does between the engine's
chained iterations; nothing flushes it.

The replays add what the capture added to the launch counts
(``solvers/graph_loop.Graph``), so the counts are the launches that ran.

On the CPU (``--device cpu``) every body runs once, uncaptured, through
the plain versions, and every time is None: no CPU time is written under
a device key. On the card every result carries ``card``, the card's name
and power limit as nvidia-smi gives them.

The port's precision tiers act on the MTTKRP only (ROADMAP, intended
differences): where a script passes "high" to an update, a gramian or a
normalization, the port runs strict float32.
"""

from __future__ import annotations

import json
import os
import subprocess

import torch

from .. import prng
from ..ops.fused_mttkrp import fused_mttkrp_plain, mttkrp_batched_fused, split_others
from ..solvers.state import tree_leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "profiles")  # git-ignored; never data/benchmarks/

# A kernel against its plain version on the same inputs (the kernel tests'
# tolerances, chip_smoke.TOL): the MTTKRP and the apply relative to the
# largest magnitude of the plain result; the inverses per model relative to
# cond(H) * max|H^-1|. Fused against unfused iteration after one step: each
# state tensor relative to its largest magnitude, and the fit absolute, at
# the engine phase's "highest" limit (chip_smoke.CROSS_TOL): both epilogues
# are strict float32 on the same MTTKRP results.
TOL = {"mttkrp": 2e-5, "inverse": 1e-6, "apply": 1e-5, "iteration": 5e-5}


def out_path(name: str) -> str:
    return os.path.join(OUT_DIR, name)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def header(dev: torch.device) -> dict:
    """``device`` (the card's name, or "cpu"), and ``card`` on the card."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    return {"device": torch.cuda.get_device_name(dev), "card": card_line()}


def null_ms(dev: torch.device) -> float | None:
    """The null round trip (``probe_overhead.null_roundtrip_ms``); None on the CPU."""
    if dev.type != "cuda":
        return None
    from ..probe_overhead import null_roundtrip_ms

    return null_roundtrip_ms(dev)


def write(path: str, obj: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def rate(flops: float, ms: float | None) -> float | None:
    """TFLOP/s of ``flops`` in ``ms``; None without a time."""
    return None if ms is None else flops / (ms * 1e-3) / 1e12


def fmt(ms: float | None) -> str:
    return "not timed (cpu)" if ms is None else f"{ms:8.4f} ms"


# ------------------------------------------------------------------ timing


def _chain(step, carry, n: int):
    for _ in range(n):
        carry = step(carry)
    return carry


class Chain:
    """``n_loop`` steps of ``step`` chained from ``carry`` (a tensor or a
    (named) tuple of tensors): on the card captured once into a CUDA graph
    on a stream of its own, after one eager warm-up step (kernel builds,
    plans, cuBLAS workspace) and followed by one untimed replay (the
    graph's upload); on the CPU one step, run here. ``out`` is the last
    carry."""

    def __init__(self, step, carry, n_loop: int, dev: torch.device):
        self.n_loop, self.dev = n_loop, dev
        if dev.type != "cuda":
            self.out = step(carry)
            return
        from ..solvers.graph_loop import Graph

        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            self.static = tree_map(torch.clone, carry)
            step(self.static)

            def body():
                self.out = _chain(step, self.static, n_loop)

            self.graph = Graph(body)
            self.graph.replay(1)
        self.stream.synchronize()

    def once(self) -> float | None:
        """One replay's ms per step; None on the CPU."""
        if self.dev.type != "cuda":
            return None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record()
            self.graph.replay(1)
            end.record()
        end.synchronize()
        return start.elapsed_time(end) / self.n_loop

    def best(self, reps: int) -> float | None:
        if self.dev.type != "cuda":
            return None
        return min(self.once() for _ in range(reps))


def timed(step, carry, n_loop: int, reps: int, dev: torch.device) -> float | None:
    """ms per step of ``n_loop`` chained steps, the best of ``reps`` replays
    (``Chain``); None on the CPU."""
    return Chain(step, carry, n_loop, dev).best(reps)


# ------------------------------------------------------------------- inputs


def draw(modes, b: int, r: int, n_keys: int, dev: torch.device, scale: float | None = 0.1):
    """The scripts' draw: ``jax.random.PRNGKey(0)`` split into ``n_keys``,
    X ``modes`` from the first key and a factor [B, I_m, R] per mode from
    the next ones, times ``scale`` (None: unscaled), in float32 on ``dev``
    (``prng``: within 2 ulps of JAX's). Returns (keys, X, factors)."""
    ks = prng.split(prng.prng_key(0, dev), n_keys)
    x = prng.normal(ks[0], tuple(modes))
    factors = tuple(prng.normal(k, (b, m, r)) for k, m in zip(ks[1:], modes))
    if scale is not None:
        factors = tuple(f * scale for f in factors)
    return ks, x, factors


def first_other(n_modes: int, mode: int) -> int:
    """The factor a per-mode MTTKRP chain runs through: the first
    non-target mode (the target factor would leave the product unchained)."""
    return [m for m in range(n_modes) if m != mode][0]


# ------------------------------------------------------------------- checks


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """``max|got - want| <= tol * max|want|``; returns the difference, raises
    AssertionError beyond it."""
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3e} beyond {tol} x {scale:.3e}")
    return err


def check_inverse(name: str, got: torch.Tensor, want: torch.Tensor, h: torch.Tensor) -> float:
    """Per model ``max|got - want| <= TOL["inverse"] * cond(H) * max|want|``;
    returns the largest ratio."""
    cond = torch.linalg.cond(h.double())
    err = (got.double() - want.double()).abs().amax((-2, -1))
    ratio = (err / (cond * want.double().abs().amax((-2, -1)))).max().item()
    if not ratio <= TOL["inverse"]:
        raise AssertionError(f"{name}: |kernel - plain| / (cond(H) max|H^-1|) {ratio:.3e} beyond {TOL['inverse']}")
    return ratio


def check_fused_mttkrp(name: str, x, factors, mode: int, held, tier: str, plan=None) -> tuple:
    """The fused MTTKRP of ``mode`` (``plan``: the kernel's, None the
    planner's) against its plain version on the same held layout; returns
    (G, max |difference|)."""
    small, big = split_others(tuple(x.shape), mode)
    got = mttkrp_batched_fused(x, factors, mode, held, tier, plan=plan)
    want = fused_mttkrp_plain(held, factors[small], factors[big], tier)
    return got, check_close(name, got, want, TOL["mttkrp"])


def check_states(name: str, got, want) -> float:
    """Two iteration states after one step: the fit within
    ``TOL["iteration"]``, every other floating tensor within it relative to
    its largest magnitude, the integer ones equal; returns the largest
    relative difference."""
    worst = 0.0
    fit = (got.fit.double() - want.fit.double()).abs().max().item()
    if not fit <= TOL["iteration"]:
        raise AssertionError(f"{name}: |fit difference| {fit:.3e} beyond {TOL['iteration']}")
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: an integer state tensor differs")
            continue
        err = (a.double() - b.double()).abs().max().item() / max(b.double().abs().max().item(), 1e-30)
        if not err <= TOL["iteration"]:
            raise AssertionError(f"{name}: a state tensor {tuple(a.shape)} differs by {err:.3e} relative")
        worst = max(worst, err)
    return worst
