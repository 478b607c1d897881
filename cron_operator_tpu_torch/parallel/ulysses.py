"""Ulysses sequence parallelism, as in ``cron_operator_tpu/parallel/ulysses.py``:
an all-to-all head scatter.

Where ring attention (:mod:`parallel.ring`) keeps heads whole and rotates
K/V blocks, Ulysses redistributes once each way::

    [b, seq/P, heads, d]  --all_to_all-->  [b, seq, heads/P, d]
        full attention over the whole sequence for the local heads
    [b, seq, heads/P, d]  --all_to_all-->  [b, seq/P, heads, d]

Two collectives in all, at the cost of needing ``heads % P == 0``. Both
are exact, so ``param.attention`` picks either. The attention between the
two all-to-alls is ``ops.flash_attention.flash_attention_block``'s output
on the local ``[b, seq, heads/P, d]`` heads: K1 forward, K2 and K3
backward on the card, their plain versions on the CPU. The JAX body is
plain f32 ``jnp`` there (``parallel.ring._single_device_attention`` here,
the plain version).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cron_operator_tpu_torch.parallel.mesh import SEQ_AXIS, axis_sizes
from cron_operator_tpu_torch.parallel.ring import seq_sharded_call


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x [P, ...]``: chunk j goes to coordinate j of ``group``, and chunk
    i of the result came from coordinate i. gloo's all-to-all takes CUDA
    tensors (``hack/torch_gloo_cuda_probe.py``), so no staging."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all`, which is its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def ulysses_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis_name: str = SEQ_AXIS,
    causal: bool = False,
) -> torch.Tensor:
    """Per-rank body on this rank's blocks ``[b, t, h, d]`` of a sequence
    split over ``axis_name`` of ``mesh``: the JAX tiled all-to-alls
    (heads split into P chunks, chunk j to coordinate j, the sequence
    concatenated in coordinate order), full-sequence attention on ``h/P``
    heads through ``flash_attention_block`` (one K1, K2 and K3 launch on a
    CUDA tensor; causal needs no offsets: the sequence is whole), and
    back."""
    from cron_operator_tpu_torch.ops.flash_attention import (
        flash_attention_block,
    )

    group = mesh.get_group(axis_name)
    par = axis_sizes(mesh)[axis_name]

    def heads_out(x):  # [b, t, h, d] -> [b, P t, h/P, d]
        b, t, h, d = x.shape
        x = x.reshape(b, t, par, h // par, d).permute(2, 0, 1, 3, 4)
        y = _AllToAll.apply(x, group)  # [P (seq block), b, t, h/P, d]
        return y.permute(1, 0, 2, 3, 4).reshape(b, par * t, h // par, d)

    def heads_back(x):  # [b, P t, h/P, d] -> [b, t, h, d]
        b, s, hp, d = x.shape
        x = x.reshape(b, par, s // par, hp, d).permute(1, 0, 2, 3, 4)
        y = _AllToAll.apply(x, group)  # [P (head block), b, t, h/P, d]
        return y.permute(1, 2, 0, 3, 4).reshape(b, s // par, par * hp, d)

    out, _ = flash_attention_block(heads_out(q), heads_out(k), heads_out(v),
                                   causal=causal)
    return heads_back(out)


def check_heads(heads: int, par: int, seq_axis: str = SEQ_AXIS) -> None:
    """Raises ``ValueError`` unless ``heads`` divide the ``par``-way
    ``seq_axis``, which the head scatter needs."""
    if par > 1 and heads % par:
        raise ValueError(
            f"ulysses_attention: {heads} heads do not divide the {par}-way "
            f"{seq_axis!r} axis; use ring attention (any head count) or "
            "resize the mesh"
        )


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    causal: bool = False,
    seq_axis: str = SEQ_AXIS,
) -> torch.Tensor:
    """Sequence-parallel attention on ``[batch, seq, heads, head_dim]``
    through head-scatter all-to-alls, with the guards of
    :func:`parallel.ring.seq_sharded_call`; the head count must divide the
    ``seq_axis`` size (``ValueError``)."""
    check_heads(q.shape[2], axis_sizes(mesh).get(seq_axis, 1), seq_axis)

    def body(q, k, v):
        return ulysses_attention_local(q, k, v, mesh=mesh, axis_name=seq_axis,
                                       causal=causal)
    return seq_sharded_call(body, q, k, v, mesh, seq_axis=seq_axis,
                            causal=causal, op_name="ulysses_attention")


__all__ = ["check_heads", "ulysses_attention", "ulysses_attention_local"]
