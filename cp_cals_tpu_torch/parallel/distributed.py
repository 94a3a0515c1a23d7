"""Multi-process initialization and the mesh over every process (port of
``cp_cals_tpu/parallel/distributed.py``).

One process per device; ``initialize()`` joins them into one
``torch.distributed`` process group, and ``pod_mesh`` builds the (dp, tp)
mesh over all of them. The backend is the caller's: NCCL on the card by
default, gloo on the CPU, and gloo on the card only where asked (it takes
CUDA tensors for the all-reduce the port uses, and runs two ranks on one
card, which NCCL refuses). No backend replaces another when it fails.

Launch pattern (one process per card, e.g. under torchrun):

    from cp_cals_tpu_torch.parallel import distributed
    distributed.initialize()           # no-op on a single process
    mesh = distributed.pod_mesh(n_tp=1)
    results, report = cp_cals(x, queue, params, mesh=mesh)

or ``torchrun --nproc_per_node=N -m cp_cals_tpu_torch.cli --distributed
--dp N ...``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .sharding import local_device, make_mesh


def initialize(
    init_method: str | None = None,
    backend: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    device=None,
) -> None:
    """Join the process group from the arguments or torchrun's variables
    (``RANK``, ``WORLD_SIZE``; ``env://`` reads ``MASTER_ADDR`` and
    ``MASTER_PORT``). A single process (no ``init_method`` and a world of
    one) is a no-op. ``backend`` None is "nccl" on the card and "gloo" when
    ``device`` is the CPU. On the card the process's current device
    becomes its local rank's card (``local_device``)."""
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if init_method is None and (world_size or 1) <= 1:
        return
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("gloo" if dev.type == "cpu" else "nccl"),
        init_method=init_method or "env://", rank=rank if rank is not None else -1,
        world_size=world_size if world_size is not None else -1,
    )


def pod_mesh(n_tp: int = 1, device=None):
    """Mesh over every process: dp x tp."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % n_tp:
        raise ValueError(f"{n} processes not divisible by tp={n_tp}")
    return make_mesh(n_dp=n // n_tp, n_tp=n_tp, device=device)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
