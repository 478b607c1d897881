"""The card's peaks, for MFU and the decode roofline, as
``cron_operator_tpu/backends/tpu.py``'s ``PEAK_FLOPS_PER_CHIP`` is the TPU
chip's and ``bench.py``'s ``PEAK_HBM`` its memory rate.

Published rates per card (NVIDIA H100 data sheet, SXM part): dense bf16
tensor-core FLOP/s without sparsity, 989.4 TFLOP/s, written as the 989e12
that ``chip_smoke.py`` and ``PERF.md`` use; HBM3 bytes/s, 3.35e12.
``param.peak_flops_per_chip`` overrides the FLOP/s (a card not in the
table, a CPU run).
"""

from __future__ import annotations

from typing import Dict, Optional

PEAK_FLOPS_PER_CHIP = {
    "h100-sxm": 989e12,
}
PEAK_HBM_BYTES_PER_S = {
    "h100-sxm": 3.35e12,
}


def _lookup(table: Dict[str, float], name: str) -> Optional[float]:
    """``table``'s entry for a card by its device name as
    ``torch.cuda.get_device_name`` gives it ("NVIDIA H100 80GB HBM3" is the
    SXM card; the PCIe and NVL cards name themselves) or by a key of the
    table; None when the card is unknown: callers then skip the figure
    rather than divide by a guess."""
    key = (name or "").lower()
    if key not in table and "h100" in key and (
            "hbm3" in key or "sxm" in key) and not (
            "pcie" in key or "nvl" in key):
        key = "h100-sxm"
    return table.get(key)


def peak_flops_per_chip(name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s of one card by its name (see :func:`_lookup`)."""
    return _lookup(PEAK_FLOPS_PER_CHIP, name)


def peak_hbm_bytes_per_s(name: str) -> Optional[float]:
    """Peak HBM bytes/s of one card by its name (see :func:`_lookup`)."""
    return _lookup(PEAK_HBM_BYTES_PER_S, name)


__all__ = ["PEAK_FLOPS_PER_CHIP", "PEAK_HBM_BYTES_PER_S",
           "peak_flops_per_chip", "peak_hbm_bytes_per_s"]
