"""Attention dispatch, as in ``cron_operator_tpu/ops/attention.py``.

- ``"flash"`` — the hand-written Hopper kernels (:mod:`ops.flash_attention`):
  K1 forward, K2/K3 backward, so gradients pass through; the automatic pick
  for CUDA tensors with tile-aligned shapes.
- ``"xla"`` — plain PyTorch attention with f32 products
  (:func:`parallel.ring._single_device_attention`); the name is kept from the
  JAX package so configs carry over. The CPU path.
- ``"ring"`` — sequence-parallel ring attention over the mesh's ``seq``
  axis (:mod:`parallel.ring`); the automatic pick when the mesh has
  ``seq > 1``. Any head count.
- ``"ulysses"`` — the all-to-all head-scatter variant
  (:mod:`parallel.ulysses`); the head count must divide the ``seq`` axis.

Models call :func:`multi_head_attention` and stay strategy-agnostic. On the
``meta`` device (a FLOP count, :func:`count_attention_flops`) attention
computes nothing and is counted by formula, whatever ``impl`` says. Over a
device mesh q, k and v are DTensors that carry their mesh, so a model
passes none (the JAX models pass theirs): each rank runs the dispatch on
its local block (:func:`_sharded_attention`, the JAX ``_sharded_flash``),
or under ``seq > 1`` (or an explicit ``ring``/``ulysses``) the
sequence-parallel body on its block of the sequence. A plain tensor has no
mesh, so ``ring`` and ``ulysses`` give plain attention there: what the JAX
dispatch gives under a mesh without a ``seq`` axis, which is how every JAX
job calls it on one device (JAX raises only when no mesh is passed at all).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from cron_operator_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_attention
from cron_operator_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    SEQ_AXIS,
    TENSOR_AXIS,
    axis_sizes,
)
from cron_operator_tpu_torch.parallel.ring import (
    _single_device_attention,
    ring_attention,
)
from cron_operator_tpu_torch.parallel.ulysses import ulysses_attention


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """Naive full attention on ``[b, s, h, d]`` — the numeric ground truth."""
    return _single_device_attention(q, k, v, causal=causal)


class AttentionFlops:
    """A running count of attention's model FLOPs."""

    def __init__(self) -> None:
        self.flops = 0


_TALLY: contextvars.ContextVar[Optional[AttentionFlops]] = (
    contextvars.ContextVar("attention_flops", default=None))


@contextlib.contextmanager
def count_attention_flops() -> Iterator[AttentionFlops]:
    """Counts the model FLOPs of the attention that runs on ``meta`` tensors
    in this context: 4 d per (query, key) pair that the mask keeps and per
    query head in the forward (Q K^T and P V), twice that in the backward,
    the convention of ``chip_smoke.py``'s MFU. The kernels' own work is
    larger: K2 and K3 recompute Q K^T (6 d and 8 d a pair, not 8 d)."""
    tally = AttentionFlops()
    token = _TALLY.set(tally)
    try:
        yield tally
    finally:
        _TALLY.reset(token)


class _MetaAttention(torch.autograd.Function):
    """Attention on ``meta`` tensors: the output's shape, no values, and the
    FLOPs into the tally of :func:`count_attention_flops` (taken at the
    forward, since the backward may run on another thread)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        b, s, h, d = q.shape
        pairs = s * (s + 1) // 2 if causal else s * k.shape[1]
        ctx.flops = 4 * d * b * h * pairs
        ctx.tally = _TALLY.get()
        ctx.inputs = [(t.shape, t.dtype) for t in (q, k, v)]
        if ctx.tally is not None:
            ctx.tally.flops += ctx.flops
        return q.new_empty(b, s, h, v.shape[-1])

    @staticmethod
    def backward(ctx, do):
        if ctx.tally is not None:
            ctx.tally.flops += 2 * ctx.flops
        return (*(torch.empty(shape, dtype=dtype, device="meta")
                  for shape, dtype in ctx.inputs), None)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatching attention on ``[batch, seq, heads, head_dim]``.

    ``impl``: ``"auto" | "flash" | "xla" | "ring" | "ulysses"``.
    Grouped-query K/V (fewer heads, a divisor) go to the flash kernel as
    they are; the other impls repeat them here, the sequence-parallel ones
    before the sequence is split.
    """
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal=causal, impl=impl)
    if q.is_meta:
        return _MetaAttention.apply(q, k, v, causal)
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

    if impl != "flash":
        k, v = _full_heads(q, k, v)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal)
    if impl in ("xla", "ring", "ulysses"):
        return _single_device_attention(q, k, v, causal=causal)
    raise ValueError(f"unknown attention impl {impl!r}")


def _full_heads(q, k, v):
    """Grouped-query ``k``/``v`` broadcast to ``q``'s head count (each K/V
    head serves ``h / kv_h`` consecutive query heads), as the JAX dispatch's
    ``jnp.repeat``; by ``expand``, which a DTensor split over the batch or
    the sequence takes too."""
    h, kv_h = q.shape[2], k.shape[2]
    if kv_h == h:
        return k, v
    if kv_h < 1 or h % kv_h:
        raise ValueError(
            f"k/v heads {kv_h} must be a positive divisor of q heads {h}"
        )
    b, s, _, d = k.shape

    def repeat(t):
        return t[:, :, :, None, :].expand(b, s, kv_h, h // kv_h, d).reshape(
            b, s, h, d)
    return repeat(k), repeat(v)


def attention_placements(q, k, mesh) -> tuple:
    """Placements of ``[b, s, h, d]`` attention operands on ``mesh``, the
    JAX ``_sharded_flash`` spec: the batch over the batch axes when it
    divides their product, the heads over ``tensor`` when both the q and
    the kv head counts divide it, everything else replicated."""
    sizes = axis_sizes(mesh)
    n_batch = 1
    for name in BATCH_AXES:
        n_batch *= sizes.get(name, 1)
    split_batch = q.shape[0] % n_batch == 0
    t = sizes.get(TENSOR_AXIS, 1)
    split_heads = t > 1 and q.shape[2] % t == 0 and k.shape[2] % t == 0
    out = []
    for name in sizes:
        if name in BATCH_AXES and split_batch:
            out.append(Shard(0))
        elif name == TENSOR_AXIS and split_heads:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out)


def _sharded_attention(q, k, v, *, causal: bool, impl: str):
    """Attention on DTensors. ``auto`` under ``seq > 1`` is ``ring``, as the
    JAX dispatch picks it for a mesh with a ``seq`` axis; ``ring`` and
    ``ulysses`` take full-head K/V and run
    :func:`parallel.ring.ring_attention` or
    :func:`parallel.ulysses.ulysses_attention` over the mesh. Otherwise, as
    the JAX ``_sharded_flash``: q, k and v are laid out by
    :func:`attention_placements` and each rank runs
    :func:`multi_head_attention` (K1-K3 on the card) on its local ``[b/dp,
    s, h/tp, d]`` block, which needs no collective; the output keeps that
    layout. The kernel wrappers only ever see local tensors."""
    mesh = q.device_mesh
    if impl == "auto" and axis_sizes(mesh).get(SEQ_AXIS, 1) > 1:
        impl = "ring"
    if impl in ("ring", "ulysses"):
        k, v = _full_heads(q, k, v)
        fn = ring_attention if impl == "ring" else ulysses_attention
        return fn(q, k, v, mesh, causal=causal)
    spec = list(attention_placements(q, k, mesh))  # a list: ONE output
    fn = local_map(
        lambda q, k, v: multi_head_attention(q, k, v, causal=causal,
                                             impl=impl),
        out_placements=spec, in_placements=(spec, spec, spec),
        redistribute_inputs=True, device_mesh=mesh,
    )
    return fn(q, k, v)


__all__ = ["attention_placements", "count_attention_flops", "multi_head_attention",
           "reference_attention"]
