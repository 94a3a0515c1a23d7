"""cp_cals_tpu_torch: the PyTorch/CUDA port of cp_cals_tpu.

Concurrent ALS for canonical polyadic decomposition on an NVIDIA H100, with
the JAX package's hot kernels written by hand in CUDA C++ for Hopper
(``csrc/``): the fused 3-D MTTKRP and the fused per-mode epilogue. Entry
points run on the card unless the caller passes ``device="cpu"``, which
runs the kernels' plain PyTorch versions.
"""

from .config import AlsParams, CalsParams, LineSearchMethod, MttkrpMethod, UpdateMethod
from .device import resolve_device
from .ktensor import Ktensor, random_ktensor_host
from .solvers.cals import CalsModelReport, CalsReport, cp_cals

__all__ = [
    "AlsParams",
    "CalsModelReport",
    "CalsParams",
    "CalsReport",
    "Ktensor",
    "LineSearchMethod",
    "MttkrpMethod",
    "UpdateMethod",
    "cp_cals",
    "random_ktensor_host",
    "resolve_device",
]
