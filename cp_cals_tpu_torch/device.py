"""Device resolution and the float32 matmul policy of the port.

Entry points run on the CUDA card unless the caller asks for the CPU: a
``device`` of None means ``"cuda"``, and that raises when no card is
present instead of continuing on the CPU.

TF32 is switched off for every float32 product the port leaves to PyTorch:
the ``"highest"`` precision tier means strict float32, as it does in the
JAX package.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises if there is none); else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
