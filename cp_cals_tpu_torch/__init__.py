"""cp_cals_tpu_torch: the PyTorch/CUDA port of cp_cals_tpu.

Concurrent ALS for canonical polyadic decomposition on an NVIDIA H100, with
the JAX package's TPU kernels written by hand in CUDA C++ for Hopper
(``csrc/``): the fused 3-D MTTKRP, the fused per-mode epilogue, the batched
SPD inverse, and the launch-overhead probe's copy kernel. Entry points run
on the card unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions. The user API is ``api.py`` (``cp_cals``,
``cp_cals_jk``, ``cp_cals_hybrid``), the CLI ``python -m
cp_cals_tpu_torch.cli``.
"""

from .config import AlsParams, CalsParams, LineSearchMethod, MttkrpMethod, UpdateMethod
from .device import resolve_device
from .ktensor import (
    Ktensor,
    RandomKtensorSpec,
    denormalize,
    normalize_full,
    normalize_mode,
    random_ktensor,
    random_ktensor_host,
    spec_to_ktensor,
    to_tensor,
)
from .solvers import (
    AlsReport,
    CalsModelReport,
    CalsReport,
    JKReport,
    cp_als,
    cp_batched_als,
    cp_cals,
    jackknife_norms,
    jk_cp_als,
    jk_cp_batched_als,
    jk_cp_cals,
    jk_permutation_adjustment,
    release_graphs,
)

__all__ = [
    "AlsParams",
    "AlsReport",
    "CalsModelReport",
    "CalsParams",
    "CalsReport",
    "JKReport",
    "Ktensor",
    "LineSearchMethod",
    "MttkrpMethod",
    "RandomKtensorSpec",
    "UpdateMethod",
    "cp_als",
    "cp_batched_als",
    "cp_cals",
    "jackknife_norms",
    "jk_cp_als",
    "jk_cp_batched_als",
    "jk_cp_cals",
    "jk_permutation_adjustment",
    "release_graphs",
    "denormalize",
    "normalize_full",
    "normalize_mode",
    "random_ktensor",
    "random_ktensor_host",
    "resolve_device",
    "spec_to_ktensor",
    "to_tensor",
]
