"""The card's peak, for MFU, as ``cron_operator_tpu/backends/tpu.py``'s
``PEAK_FLOPS_PER_CHIP`` is the TPU chip's.

Published dense bf16 tensor-core FLOP/s per card, without sparsity (NVIDIA
H100 data sheet): the H100 SXM 989.4 TFLOP/s, written as the 989e12 that
``chip_smoke.py`` and ``PERF.md`` use. ``param.peak_flops_per_chip``
overrides it (a card not in the table, a CPU run).
"""

from __future__ import annotations

from typing import Optional

PEAK_FLOPS_PER_CHIP = {
    "h100-sxm": 989e12,
}


def peak_flops_per_chip(name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s of one card by its device name as
    ``torch.cuda.get_device_name`` gives it ("NVIDIA H100 80GB HBM3" is the
    SXM card; the PCIe and NVL cards name themselves) or by a key of the
    table; None when the card is unknown: callers then skip MFU rather than
    divide by a guess."""
    key = (name or "").lower()
    if key not in PEAK_FLOPS_PER_CHIP and "h100" in key and (
            "hbm3" in key or "sxm" in key) and not (
            "pcie" in key or "nvl" in key):
        key = "h100-sxm"
    return PEAK_FLOPS_PER_CHIP.get(key)


__all__ = ["PEAK_FLOPS_PER_CHIP", "peak_flops_per_chip"]
