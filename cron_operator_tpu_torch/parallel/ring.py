"""Ring attention over the ``seq`` axis of a device mesh, as in
``cron_operator_tpu/parallel/ring.py``, and the one-hop rotation round a
mesh axis (:func:`ppermute`) that it and :mod:`parallel.pipeline` share.

Long sequences are split over the mesh's ``seq`` axis; each rank holds a
block of Q, K and V. K/V blocks rotate round the axis's process group one
hop at a time. After ``ring`` blocks every query block has seen every K/V
block once: the same math as full attention, with one ``t/P x t/P`` block
of scores at a time. Each block runs through
``ops.flash_attention.flash_attention_block`` (K1 forward, K2 and K3
backward on the card; their plain versions on the CPU), which returns the
block's output and LSE; the blocks merge by their LSEs in f32
(:func:`merge_blocks`). Under a causal mask a block from a later rank adds
nothing and is skipped, the one from the rank itself runs causal and the
earlier ones run in full. The JAX body is plain ``jnp`` in f32, which XLA
fuses; its arithmetic stays here as :func:`ring_attention_local_reference`
(the online softmax of :func:`online_softmax_step`), the plain version that
the tests and ``chip_smoke.py`` hold the kernels' body against.

``lax.ppermute`` has a transpose, so JAX differentiates the ring for free;
``torch.distributed`` has no differentiable send and receive, so
:func:`ppermute` is an autograd Function whose backward is the reverse hop.
Every rank runs the same hops in the same order, and every hop's output
reaches the body's output on every rank (a skipped block's K/V through
:class:`_KeepHops`), so each rank's backward runs every hop's reverse hop,
in the same order as the others'.
"""

from __future__ import annotations

import importlib
import math
from typing import Callable, Dict, List, Sequence, Union

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
    came from coordinate ``src = (mine - i) mod ring``. Without a mask, or
    for ``src < mine``, the block runs in full; ``src == mine`` runs causal
    (the diagonal); ``src > mine`` is skipped, though the hop still runs.
    Each block is one ``flash_attention_block`` call (K1, and K2 and K3 in
    the backward, on a CUDA tensor); the blocks merge by
    :func:`merge_blocks`. Returns ``[b, t, h, d]`` in ``q``'s dtype."""
    from cron_operator_tpu_torch.ops.flash_attention import (
        flash_attention_block,
    )

    group = mesh.get_group(axis_name)
    ring = axis_sizes(mesh)[axis_name]
    mine = mesh.get_local_rank(axis_name)
    outs, lses = [], []
    k_cur, v_cur = k, v
    used = True  # whether the last K/V block held reached a block call
    for step in range(ring):
        src = (mine - step) % ring
        used = not causal or src <= mine
        if used:
            o, lse = flash_attention_block(q, k_cur, v_cur,
                                           causal=causal and src == mine)
            outs.append(o)
            lses.append(lse)
        if step < ring - 1:  # JAX's scan makes one more hop, never read
            k_cur, v_cur = ppermute((k_cur, v_cur), group)
    out = merge_blocks(outs, lses)
    if used:
        return out.to(q.dtype)
    return _KeepHops.apply(out, q.dtype, k_cur, v_cur)


def merge_blocks(outs: Sequence[torch.Tensor],
                 lses: Sequence[torch.Tensor]) -> torch.Tensor:
    """The attention over the union of the blocks' keys from each block's
    ``o_i [b, t, h, d]`` and ``lse_i [b*h, t, 1]`` (f32), in f32:
    ``lse = logsumexp_i lse_i`` and ``o = sum_i exp(lse_i - lse) o_i``.
    Returns ``o`` in f32. A row that saw no key in a block carries
    ``LSE_MASKED`` (+1e30) there, which would take the whole weight: it is
    read as ``-inf`` (no mass), a branch-free guard. The bodies' blocks
    never have such a row: q and k share their rows, and a causal block
    keeps its diagonal."""
    from cron_operator_tpu_torch.ops.flash_attention import LSE_MASKED

    b, t, h, _ = outs[0].shape
    stacked = torch.stack([x.reshape(b, h, t).transpose(1, 2) for x in lses])
    stacked = stacked.masked_fill(stacked >= LSE_MASKED, float("-inf"))
    weights = torch.exp(stacked - torch.logsumexp(stacked, dim=0))
    out = weights[0][..., None] * outs[0].float()
    for w, o in zip(weights[1:], outs[1:]):
        out = out + w[..., None] * o.float()
    return out


class _KeepHops(torch.autograd.Function):
    """``out`` cast to ``dtype``, with ``keep`` (K/V blocks that no block
    call read) tied into the graph at a zero gradient: so the reverse hop
    that delivered them runs in this rank's backward, as it does on the
    ranks that read them (a hop is a collective: every rank must run it)."""

    @staticmethod
    def forward(ctx, out, dtype, *keep):
        ctx.like = [(t.shape, t.dtype) for t in keep]
        ctx.out_dtype = out.dtype
        cast = out.to(dtype)
        return cast.clone() if cast is out else cast

    @staticmethod
    def backward(ctx, grad):
        zeros = [grad.new_zeros(s, dtype=d) for s, d in ctx.like]
        return (grad.to(ctx.out_dtype), None, *zeros)


def body_tolerances(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, *, causal: bool = False,
                    blocks: int = 1) -> Dict[str, torch.Tensor]:
    """Elementwise bounds on ``|body - whole|`` for keys ``o``, ``dq``,
    ``dk`` and ``dv``: a sequence-parallel body's output and gradients (for
    the output's gradient ``do``) against K1, K2 and K3 over the whole
    sequence (``ops.flash_attention.flash_attention_block`` and
    ``flash_attention_bwd``) on the same whole inputs ``q``, ``k``, ``v``
    ``[b, s, h, d]`` (one head count), the body splitting the sequence into
    ``blocks`` equal blocks and merging them (1: one block, as Ulysses,
    which runs the whole sequence's arithmetic).

    The base is the whole-sequence kernels' own bound against their plain
    versions (``forward_tolerance``, ``dq_tolerance``, ``dkv_tolerance``),
    which also bounds the body's roundings of the same kind (P and dS to
    bf16 before their products, each result's last rounding). With ``u``
    half an ulp of the dtype at 1 (bf16: 2^-8), the body adds, with P, dS
    and Delta the plain version's f32 values over the whole sequence:

    - o: each block's ``o_i`` is rounded to the dtype once before the f32
      merge, by up to ``u |o_i|``; its weight is the block's share of the
      row's mass, so ``w_i |o_i| = |sum_{k in block i} P V|`` and the
      merge is off by ``u sum_i |sum_{k in i} P V|``.
    - dq (dk, dv): each block's partial gradient is rounded once and the
      partials add up in the dtype (autograd's accumulation, and the K/V
      gradients' reverse hops), ``blocks`` roundings at most, each within
      ``u`` of the sum of the partials' magnitudes ``sum_i |g_i|`` (the
      partials over the key blocks for dq, over the query blocks for dk
      and dv).
    - dS: the block's dO is ``w_i dO`` rounded to the dtype (``u`` of each
      term of dP = dO V and of rowsum(dO o_i)), and its Delta is computed
      from the merged o, which lies within the o bound of K1's: so dS moves
      by ``P (u (|dO| |V| + U) + |dO| bound_o)`` per entry (``U = sum_k P
      |dO| |V|`` bounds |Delta|), times ``scale |K|`` into dq and ``scale
      |Q|`` into dk; dV moves by ``u P |dO|``."""
    fa = importlib.import_module(
        "cron_operator_tpu_torch.ops.flash_attention")

    b, s, h, d = q.shape
    if k.shape[2] != h or s % blocks:
        raise ValueError(f"{blocks} blocks of {s} rows at one head count")
    o_ref, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    delta = fa._delta(o_ref, do)
    dq_ref = fa.flash_attention_dq_reference(q, k, v, do, lse, delta,
                                             causal=causal)
    dk_ref, dv_ref = fa.flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                                      causal=causal)
    bounds = {"o": fa.forward_tolerance(q, k, v, o_ref, lse, causal=causal),
              "dq": fa.dq_tolerance(q, k, v, do, lse, delta, dq_ref,
                                    causal=causal)}
    bounds["dk"], bounds["dv"] = fa.dkv_tolerance(
        q, k, v, do, lse, delta, dk_ref, dv_ref, causal=causal)
    if blocks == 1:
        return bounds
    u = torch.finfo(q.dtype).eps / 2
    scale = 1.0 / math.sqrt(d)
    n, t = blocks, s // blocks
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    p = torch.exp(fa._reference_scores(q, k, causal) - lse.reshape(b, h, s, 1))
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta.reshape(
        b, h, s, 1))

    def by_key_block(m, x):  # sum_i |sum_{k in i} m x|: [b, s, h, d]
        part = torch.einsum("bhqnk,bnkhd->bnqhd", m.unflatten(3, (n, t)),
                            x.unflatten(1, (n, t)))
        return part.abs().sum(1)

    def by_query_block(m, x):  # sum_j |sum_{q in j} m x|: [b, s, h, d]
        part = torch.einsum("bhnqk,bnqhd->bnkhd", m.unflatten(2, (n, t)),
                            x.unflatten(1, (n, t)))
        return part.abs().sum(1)

    bounds["o"] = bounds["o"] + u * by_key_block(p, vf)
    a = torch.einsum("bqhd,bkhd->bhqk", dof.abs(), vf.abs())  # >= |dP|
    big_u = (p * a).sum(-1, keepdim=True)  # >= |Delta|
    o_shift = torch.einsum("bqhd,bqhd->bhq", dof.abs(), bounds["o"])
    e = p * (u * (a + big_u) + o_shift[..., None])  # dS's shift
    bounds["dq"] = bounds["dq"] + u * blocks * scale * by_key_block(ds, kf) \
        + scale * torch.einsum("bhqk,bkhd->bqhd", e, kf.abs())
    bounds["dk"] = bounds["dk"] + u * blocks * scale * by_query_block(ds, qf) \
        + scale * torch.einsum("bhqk,bqhd->bkhd", e, qf.abs())
    bounds["dv"] = bounds["dv"] + u * blocks * by_query_block(p, dof) \
        + u * torch.einsum("bhqk,bqhd->bkhd", p, dof.abs())
    return bounds


def ring_attention_local_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis_name: str = SEQ_AXIS,
    causal: bool = False,
) -> torch.Tensor:
    """The plain version of :func:`ring_attention_local`, the JAX body's
    arithmetic: every block folded into an online softmax (running max,
    normaliser and output in f32) with ``[b, h, t, t]`` f32 scores, masked
    blocks included. Fully masked rows give 0. The same hops and the same
    result within the kernels' rounding (:func:`body_tolerances`)."""
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


__all__ = ["body_tolerances", "merge_blocks", "online_softmax_result",
           "online_softmax_step", "ppermute", "ring_attention",
           "ring_attention_local", "ring_attention_local_reference",
           "seq_sharded_call", "stages_through_host"]
