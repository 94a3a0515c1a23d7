"""The inputs of a run, made on the device from ``--seed`` in a few large
calls of a ``torch.Generator``: the same seed gives the same inputs.

- The tensor: a random CP model of the configuration's ``true_rank``
  (factors uniform in [-1, 1), columns normalized, weights the norms'
  products, as ``bench.py`` draws the bench tensor) plus Gaussian noise of
  ``noise`` times the model's standard deviation, made in float64 and
  stored in the configuration's dtype.
- Initial models: for each rank of the queue, factors uniform in [-1, 1)
  with normalized columns, drawn in one call for the whole queue.

Every seed gives the same sizes and the same amount of work; only the
values differ.
"""

from __future__ import annotations

import numpy as np
import torch

STREAMS = {"tensor": 1, "inits": 2, "sample": 3}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of ``seed`` (any
    non-negative whole number; the streams never share a state)."""
    state = np.random.SeedSequence([int(seed), STREAMS[stream]]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def host_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed), STREAMS[stream]])


def uniform_columns(g, rows: int, cols: int, dtype, device) -> torch.Tensor:
    return torch.rand(rows, cols, generator=g, dtype=dtype, device=device) * 2 - 1


def split_model(block: torch.Tensor, modes, rank_slices):
    """Per model, its three factors (``[I_n, R]``, columns normalized) and
    lam (the norms' products), cut from one ``[sum(modes), sum(ranks)]``
    block."""
    edges = np.cumsum([0, *modes])
    out = []
    for lo, hi in rank_slices:
        factors, lam = [], torch.ones(hi - lo, dtype=block.dtype, device=block.device)
        for a, b in zip(edges[:-1], edges[1:]):
            f = block[a:b, lo:hi]
            norms = torch.linalg.vector_norm(f, dim=0)
            factors.append(f / torch.where(norms > 0, norms, torch.ones_like(norms)))
            lam = lam * norms
        out.append((factors, lam))
    return out


def tensor(cfg: dict, seed: int, device, with_model: bool = False):
    """The configuration's tensor; with ``with_model`` also the CP model it
    was made from (three float64 factors with unit columns, and lam)."""
    modes, rank = tuple(cfg["modes"]), int(cfg["true_rank"])
    g = generator(seed, "tensor", device)
    block = uniform_columns(g, sum(modes), rank, torch.float64, device)
    (factors, lam), = split_model(block, modes, [(0, rank)])
    x = torch.einsum("ir,jr,kr,r->ijk", *factors, lam)
    noise = torch.randn(x.shape, generator=g, dtype=torch.float64, device=device)
    x += float(cfg["noise"]) * x.std() * noise
    x = x.to(getattr(torch, cfg["dtype"])).contiguous()
    return (x, (factors, lam)) if with_model else x


def queue_ranks(traffic: dict) -> list[int]:
    """The ranks of the queue, in queue order: each rank of ``ranks``
    ``copies`` times, rank after rank."""
    q = traffic["queue"]
    return [r for r in range(q["ranks"][0], q["ranks"][1] + 1) for _ in range(q["copies"])]


def inits(modes, ranks, seed: int, device, dtype=torch.float32):
    """The queue's initial models as (factors, lam) on ``device``."""
    g = generator(seed, "inits", device)
    edges = np.cumsum([0, *ranks])
    block = uniform_columns(g, sum(modes), int(edges[-1]), dtype, device)
    return split_model(block, modes, list(zip(edges[:-1], edges[1:])))
