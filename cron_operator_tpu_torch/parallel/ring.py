"""Ring attention over the ``seq`` axis of a device mesh, as in
``cron_operator_tpu/parallel/ring.py``, and the one-hop rotation round a
mesh axis (:func:`ppermute`) that it and :mod:`parallel.pipeline` share.

Long sequences are split over the mesh's ``seq`` axis; each rank holds a
block of Q, K and V. K/V blocks rotate round the axis's process group one
hop at a time while each rank folds every block into its queries'
attention with an online softmax (running max, normaliser and output in
f32). After ``ring`` blocks every query block has seen every K/V block
once: the same math as full attention, with ``[b, h, t/P, t/P]`` scores a
step. The body is plain PyTorch attention in f32, as the JAX body is plain
``jnp``; it calls no flash kernel.

``lax.ppermute`` has a transpose, so JAX differentiates the ring for free;
``torch.distributed`` has no differentiable send and receive, so
:func:`ppermute` is an autograd Function whose backward is the reverse hop.
Every rank runs the same ops in the same order (no branch on the rank
decides whether a hop's output is used), so each rank's backward runs every
hop's reverse hop, in the same order as the others'.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from cron_operator_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    SEQ_AXIS,
    axis_sizes,
)


def _hop_through_host(tensors: Sequence[torch.Tensor], dst: int, src: int,
                      group) -> List[torch.Tensor]:
    """One hop of CUDA tensors over a gloo group, staged through pinned host
    buffers. gloo's send and receive hand the tensor's data pointer to its
    TCP transport, which reads and writes host memory only: under torch
    2.11 a CUDA tensor fails there with ``writev ... Bad address``
    (``hack/torch_gloo_cuda_probe.py``), where gloo's all-reduce,
    all-gather and all-to-all stage CUDA tensors themselves. NCCL groups
    take the direct path; only the bytes cross the host, the math stays on
    the card."""
    def buffer(t):  # pinned for a card's tensor (a CPU one in the tests)
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)

    sent = [buffer(t).copy_(t) for t in tensors]
    got = [buffer(t) for t in tensors]
    _exchange(sent, got, dst, src, group)
    return [g.to(t.device) for g, t in zip(got, tensors)]


def _exchange(sent, got, dst: int, src: int, group) -> None:
    """Posts every send to ``dst`` and every receive from ``src`` (global
    ranks), then waits: blocking sends round a ring would deadlock."""
    ops = [dist.P2POp(dist.isend, t, dst, group, tag=i)
           for i, t in enumerate(sent)]
    ops += [dist.P2POp(dist.irecv, t, src, group, tag=i)
            for i, t in enumerate(got)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def stages_through_host(group, tensors: Sequence[torch.Tensor]) -> bool:
    """Whether a hop of ``tensors`` over ``group`` goes through
    :func:`_hop_through_host`: CUDA tensors over a gloo group."""
    return (dist.get_backend(group) == "gloo"
            and any(t.is_cuda for t in tensors))


def _hop(tensors: Sequence[torch.Tensor], group, shift: int
         ) -> List[torch.Tensor]:
    """``tensors`` sent ``shift`` places up the group's order (coordinate i
    to i + shift, cyclically); returns what coordinate i - shift sent."""
    n = dist.get_world_size(group)
    if n == 1:
        return [t.clone() for t in tensors]
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    tensors = [t.contiguous() for t in tensors]
    if stages_through_host(group, tensors):
        return _hop_through_host(tensors, dst, src, group)
    got = [torch.empty_like(t) for t in tensors]
    _exchange(tensors, got, dst, src, group)
    return got


class _Hop(torch.autograd.Function):
    """``lax.ppermute`` by ``shift``; its transpose is the hop by
    ``-shift``."""

    @staticmethod
    def forward(ctx, group, shift, *tensors):
        ctx.group, ctx.shift = group, shift
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(_hop(tensors, group, shift))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=d, device=dev) if g is None else g
                 for g, (s, d, dev) in zip(grads, ctx.like)]
        return (None, None, *_hop(grads, ctx.group, -ctx.shift))


def ppermute(x: Union[torch.Tensor, Sequence[torch.Tensor]], group,
             shift: int = 1):
    """One differentiable hop round a mesh axis's process group
    (``mesh.get_group(axis)``): coordinate i sends to i + ``shift`` and
    receives from i - ``shift``, cyclically. ``x`` is a tensor or a sequence
    of tensors (one hop carries them all; returns a tuple). Plain tensors
    only: call it on a rank's local blocks."""
    single = torch.is_tensor(x)
    out = _Hop.apply(group, shift, *([x] if single else x))
    return out[0] if single else out


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis_name: str = SEQ_AXIS,
    causal: bool = False,
) -> torch.Tensor:
    """Per-rank body on this rank's blocks ``[b, t, h, d]`` (q, k and v at
    one head count) of a sequence split over ``axis_name`` of ``mesh``.
    ``causal`` masks in global coordinates: the rank's block is its
    coordinate on the axis, and the K/V block it holds after ``i`` hops
    came from coordinate ``(mine - i) mod ring``. Fully masked rows give 0.
    Returns ``[b, t, h, d]`` in ``q``'s dtype."""
    group = mesh.get_group(axis_name)
    ring = axis_sizes(mesh)[axis_name]
    mine = mesh.get_local_rank(axis_name)
    b, t, h, d = q.shape
    qf = q.float() * (1.0 / math.sqrt(d))
    rows = torch.arange(t, device=q.device)
    q_pos = (mine * t + rows)[:, None]

    carry = (q.new_zeros((b, h, t, d), dtype=torch.float32),
             q.new_full((b, h, t), float("-inf"), dtype=torch.float32),
             q.new_zeros((b, h, t), dtype=torch.float32))
    k_cur, v_cur = k, v
    for step in range(ring):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur.float())
        if causal:
            src = (mine - step) % ring
            keep = (src * t + rows)[None, :] <= q_pos  # [q, k]
            s = s.masked_fill(~keep, float("-inf"))
        carry = online_softmax_step(carry, s, v_cur)
        if step < ring - 1:  # JAX's scan makes one more hop, never read
            k_cur, v_cur = ppermute((k_cur, v_cur), group)
    return online_softmax_result(carry).to(q.dtype)


def online_softmax_step(carry, s: torch.Tensor, v: torch.Tensor):
    """Folds one block into the running ``(o [b, h, q, d], m [b, h, q],
    l [b, h, q])``, f32: ``s [b, h, q, k]`` the block's scaled scores
    (``-inf`` where masked), ``v [b, k, h, d]`` its values. The ``-inf``
    guards of the JAX step: a row masked on a whole block keeps its state,
    and one masked so far takes the block's as it is."""
    o, m, l = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    # A row masked on this whole block is -inf here: keep the running max
    # finite so that exp() stays defined.
    m_safe = torch.where(m_new.isneginf(), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(s.isneginf(), 0.0, p)
    alpha = torch.exp(torch.where(m.isneginf(), m_safe, m) - m_safe)
    alpha = torch.where(m.isneginf(), 0.0, alpha)
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return o, m_new, l


def online_softmax_result(carry) -> torch.Tensor:
    """``o / l`` as ``[b, q, h, d]`` f32; fully masked rows (``l`` 0) give
    0, not NaN."""
    o, _, l = carry
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l[..., None]).permute(0, 2, 1, 3)


def _seq_placements(q, mesh, seq_axis: str, split_seq: bool) -> list:
    """The JAX spec ``P(batch axes if they divide, seq, None, None)`` as
    placements: the batch over the batch axes when it divides their
    product, the sequence over ``seq_axis`` when ``split_seq``, heads
    whole (not over ``tensor``, as in JAX)."""
    sizes = axis_sizes(mesh)
    n_batch = 1
    for name in BATCH_AXES:
        n_batch *= sizes.get(name, 1)
    split_batch = q.shape[0] % n_batch == 0
    out = []
    for name in sizes:
        if name in BATCH_AXES and split_batch:
            out.append(Shard(0))
        elif name == seq_axis and split_seq:
            out.append(Shard(1))
        else:
            out.append(Replicate())
    return out


def seq_sharded_call(
    local_fn: Callable[..., torch.Tensor],
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    seq_axis: str,
    causal: bool,
    op_name: str,
) -> torch.Tensor:
    """The scaffolding that ring and Ulysses share, with JAX's guards: a
    ``seq_axis`` of 1 gives plain attention; a sequence that does not
    divide the axis raises ``ValueError`` for a batch above 1 (a silent
    fallback would build the full ``S x S`` scores these ops exist to
    avoid) and gives plain attention for a batch of 1; otherwise each rank
    runs ``local_fn(q, k, v)`` on its blocks (:func:`_seq_placements`).

    ``q``, ``k`` and ``v`` are DTensors on ``mesh``, or plain tensors that
    every rank holds whole (the global arrays of the JAX function): those
    are placed as replicated and the result is returned whole."""
    if not isinstance(q, DTensor):
        rep = [Replicate()] * mesh.ndim
        q, k, v = (DTensor.from_local(t, mesh, rep, run_check=False)
                   for t in (q, k, v))
        return seq_sharded_call(local_fn, q, k, v, mesh, seq_axis=seq_axis,
                                causal=causal, op_name=op_name).full_tensor()
    par = axis_sizes(mesh).get(seq_axis, 1)
    split = par > 1
    if split and q.shape[1] % par:
        if q.shape[0] > 1:
            raise ValueError(
                f"{op_name}: seq len {q.shape[1]} does not divide the "
                f"{par}-way {seq_axis!r} axis; pad the sequence or resize "
                "the mesh (the plain fallback is for a batch of 1 only)"
            )
        split = False
    if not split:
        local_fn = lambda q, k, v: _single_device_attention(  # noqa: E731
            q, k, v, causal=causal)
    spec = _seq_placements(q, mesh, seq_axis, split)
    fn = local_map(local_fn, out_placements=spec,
                   in_placements=(spec, spec, spec),
                   redistribute_inputs=True, device_mesh=mesh)
    return fn(q, k, v)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    causal: bool = False,
    seq_axis: str = SEQ_AXIS,
) -> torch.Tensor:
    """Sequence-parallel attention on ``[batch, seq, heads, head_dim]``
    (q, k and v at one head count) over ``seq_axis`` of ``mesh``, through
    :func:`seq_sharded_call`'s guards; plain attention when the mesh has no
    ``seq_axis``."""
    def body(q, k, v):
        return ring_attention_local(q, k, v, mesh=mesh, axis_name=seq_axis,
                                    causal=causal)
    return seq_sharded_call(body, q, k, v, mesh, seq_axis=seq_axis,
                            causal=causal, op_name="ring_attention")


def _single_device_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool
) -> torch.Tensor:
    """Plain attention on ``[b, s, h, d]`` (K/V at full head count), f32
    products and softmax, ``-inf`` causal mask; returns ``q``'s dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        keep = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


__all__ = ["online_softmax_result", "online_softmax_step", "ppermute",
           "ring_attention", "ring_attention_local", "seq_sharded_call",
           "stages_through_host"]
