"""Attention dispatch, as in ``cron_operator_tpu/ops/attention.py``.

- ``"flash"`` — the hand-written Hopper kernels (:mod:`ops.flash_attention`):
  K1 forward, K2/K3 backward, so gradients pass through; the automatic pick
  for CUDA tensors with tile-aligned shapes.
- ``"xla"`` — plain PyTorch attention with f32 products
  (:func:`parallel.ring._single_device_attention`); the name is kept from the
  JAX package so configs carry over. The CPU path.
- ``"ring"`` / ``"ulysses"`` — sequence parallelism; not ported yet.

Models call :func:`multi_head_attention` and stay strategy-agnostic.
"""

from __future__ import annotations

import torch

from cron_operator_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_attention
from cron_operator_tpu_torch.parallel.ring import _single_device_attention


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """Naive full attention on ``[b, s, h, d]`` — the numeric ground truth."""
    return _single_device_attention(q, k, v, causal=causal)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatching attention on ``[batch, seq, heads, head_dim]``.

    ``impl``: ``"auto" | "flash" | "xla"`` (``"ring"``/``"ulysses"`` raise
    until the sequence-parallel slice). Grouped-query K/V (fewer heads, a
    divisor) go to the flash kernel as they are; the other impls repeat
    them here.
    """
    if impl == "auto":
        # The JAX package also waits for seq >= 1024 before it picks its
        # kernel; that crossover was measured on a TPU v5e and does not carry
        # over, so it stays out until an H100 measurement sets one (PERF.md
        # keeps the kernel's and the plain version's times).
        impl = (
            "flash"
            if q.is_cuda and q.shape[1] % 128 == 0 and q.shape[-1] in HEAD_DIMS
            else "xla"
        )

    h, kv_h = q.shape[2], k.shape[2]
    if kv_h != h and impl != "flash":
        if kv_h < 1 or h % kv_h:
            raise ValueError(
                f"k/v heads {kv_h} must be a positive divisor of "
                f"q heads {h}"
            )
        k = k.repeat_interleave(h // kv_h, dim=2)
        v = v.repeat_interleave(h // kv_h, dim=2)

    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"impl={impl!r} waits for the sequence-parallel slice "
            "(ROADMAP.md queue 1, sequence parallel: ring/Ulysses)"
        )
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal)
    if impl == "xla":
        return _single_device_attention(q, k, v, causal=causal)
    raise ValueError(f"unknown attention impl {impl!r}")


__all__ = ["multi_head_attention", "reference_attention"]
