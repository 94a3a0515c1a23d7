"""Peak rates of the card and fraction-of-peak accounting (port of
``cp_cals_tpu/utils/roofline.py``).

The one home of the card's peaks: ``chip_smoke.py``'s bounds and any
fraction of peak read them from here. ``PEAKS`` is keyed by
``torch.cuda.get_device_name``; its figures are NVIDIA's data-sheet dense
peaks for the H100 SXM (H100 Tensor Core GPU data sheet: bf16 on the
tensor cores 989 TFLOP/s without sparsity, fp32 on the CUDA cores 67
TFLOP/s, HBM3 3.35 TB/s), not measurements. An unknown card has no peaks
(None), as in the JAX package.

* ``mfu``: useful FLOPs over the bf16 tensor-core peak (each algorithmic
  FLOP counted once).
* ``mxu_utilization``: the JAX name kept; here the executed share of the
  tensor cores, the bf16 passes a tier runs per algorithmic FLOP counted
  ("default" 1, "high" 3: hi*hi, hi*lo, lo*hi). "highest" is strict fp32
  on the CUDA cores and is counted against the fp32 peak instead.
"""

from __future__ import annotations

import torch

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_tflops=989.0, fp32_tflops=67.0, hbm_tb_s=3.35),
}

# bf16 tensor-core passes per algorithmic FLOP of a float32 product, by tier.
PASSES = {"default": 1, "high": 3}


def device_peaks(device=None) -> dict | None:
    """The card's peaks (``PEAKS``) by its name, or a name given as a
    string; None for an unknown card or without one."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return PEAKS.get(device)
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return PEAKS.get(torch.cuda.get_device_name(dev))


def device_peak_bf16_tflops(device=None) -> float | None:
    peaks = device_peaks(device)
    return None if peaks is None else peaks["bf16_tflops"]


def mfu(achieved_tflops: float, device=None) -> float | None:
    """Useful-FLOP fraction of the card's bf16 tensor-core peak."""
    peak = device_peak_bf16_tflops(device)
    return None if peak is None else achieved_tflops / peak


def mxu_utilization(achieved_tflops: float, precision: str = "high", device=None) -> float | None:
    """Executed fraction of the tensor cores' bf16 peak, counting the passes
    a tier runs per algorithmic FLOP; at "highest" the fraction of the fp32
    CUDA-core peak."""
    peaks = device_peaks(device)
    if peaks is None:
        return None
    if precision == "highest":
        return achieved_tflops / peaks["fp32_tflops"]
    return achieved_tflops * PASSES.get(precision, 1) / peaks["bf16_tflops"]
