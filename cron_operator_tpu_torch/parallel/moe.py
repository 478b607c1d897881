"""Switch top-1 mixture-of-experts FFN on one device, as in
``cron_operator_tpu/parallel/moe.py``.

- **Dispatch and combine by token index.** The router gives each token an
  expert and a slot in that expert's buffer (:func:`router_top1_indices`);
  :func:`slot_indices` turns them into each token's flat slot and each
  slot's token. Dispatch gathers the kept tokens' rows into ``[E, C, d]``
  and combine gathers each token's expert output back, scaled by its
  gate. Each kept token fills one slot and each slot holds at most one
  token, so these equal the reference's dense ``[tokens, experts,
  capacity]`` one-hot products (GShard's formulation) to the bit, forward
  and through the dispatch's gradient, at none of their cost: those
  products were a ``[T, E*C]`` matmul each, five a layer in training.
  Their backward passes are gathers too, with no atomics, so reruns are
  bit-identical. Only the gate's gradient, summed in f32 here, adds in
  another order.
- **Static shapes, no host read.** Every shape follows from the input's,
  and the index build is device ops alone (a scatter into a buffer with
  one spare entry, no ``nonzero`` or boolean indexing), so a routed step
  can be captured in a CUDA graph and replayed.
- **Top-1 routing with a capacity.** Each expert's buffer holds
  ``capacity = ceil(tokens / E * factor)`` tokens, filled in token order;
  the tokens past it are dropped (gate 0, a zero row: they pass through
  the residual). The Switch load-balancing loss is returned for the
  trainer to add.

:func:`router_top1` builds the reference's one-hots from the same routes,
by comparing indices with an ``arange``: a dropped token's slot index is
``capacity``, which matches no column and gives the all-zero row that
``jax.nn.one_hot`` gives an out-of-range index (``F.one_hot`` would raise,
and checks its range on the host). :func:`moe_ffn_reference` runs the
dense products on them: the plain version the index path is held to.

Over a mesh of DTensors the dense formulation runs: the expert-stacked
``wi``/``wo`` lie on ``Shard(0)`` over the ``expert`` axis
(:func:`moe_param_sharding`, or ``parallel.mesh.sharding_for_tree``), the
router is replicated, and DTensor's propagation over the four products
places the collectives, as GSPMD does for the JAX package. Routing gathers
the logits (:func:`_route`), so capacities and slots are those of one
device and the output equals the unsharded one; under sequence
parallelism too, where ``x`` holds every rank's positions in the global
row-major token order and the capacity comes from the global token
count. On the plain path (``parallel.mesh.data_parallel``) the tokens are
each rank's plain rows, or under ``seq`` its rows of a block of positions,
and ``moe_ffn`` takes the process group of the batch axes (``group``):
the logits are gathered, put in the one-device token order (row, position)
(:func:`token_order`: rank order is (batch shard, seq block, row,
position), which differs once a rank holds more than one row of a split
sequence, and capacity fills slots in token order) and routed alike on
every rank, the capacity counts every rank's tokens, each rank gathers its
own tokens into their slots (other ranks' slots read a zero row), each
expert's input is the sum over the ranks (each slot holds one token, so
the sum is exact), and every rank runs every expert on it and combines its
own rows. The routes and the output are those of one device, as under
GSPMD. Under a ``tensor`` axis too (``tensor_group``): the group's ranks
hold the same tokens and route them alike, each keeps ``wi`` and ``wo``
on its slice of the FFN's width, and the experts' outputs are summed over
the group before the combine (``parallel.mesh.reduce_from_tensor``), the
gradient of their input summed over it (``copy_to_tensor``). Under an
``expert`` axis (``expert_group``), JAX's layout: the batch is not split
over ``expert``, so the group's ranks hold the same tokens and route them
alike, the router whole; each keeps its E/n experts' ``wi`` and ``wo``,
dispatches its tokens into those experts' slots alone, runs its experts,
and the experts' outputs are gathered over the group before the combine
(:func:`gather_experts`: the backward keeps this rank's slice unsummed,
every rank's gradient of the replicated output being whole already). The
dispatch's input takes ``copy_to_tensor`` over the group, since each rank
sees the gradient of its own experts' slots alone; the router, the gate
and the aux loss are whole and alike on every rank, so their gradients
are whole already and are not summed (a sum would count them n times).

Usage::

    params = init_moe_params(generator, d_model=..., d_ff=..., n_experts=8)
    y, aux = moe_ffn(params, x)               # x: [tokens, d_model]
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from cron_operator_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    axis_sizes,
    copy_to_tensor,
    expert_stacked,
    reduce_from_tensor,
)


def init_moe_params(
    generator: torch.Generator, *, d_model: int, d_ff: int, n_experts: int
) -> Dict[str, torch.Tensor]:
    """f32 parameters on the generator's device, at the JAX function's
    scales: ``router [d_model, E]`` normal(0.02), ``wi [E, d_model, d_ff]``
    normal / sqrt(d_model), ``wo [E, d_ff, d_model]`` normal / sqrt(d_ff),
    all untruncated."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    return {
        "router": normal(d_model, n_experts) * 0.02,
        "wi": normal(n_experts, d_model, d_ff) / math.sqrt(d_model),
        "wo": normal(n_experts, d_ff, d_model) / math.sqrt(d_ff),
    }


def _capacity(tokens: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, int(math.ceil(tokens / n_experts * capacity_factor)))


def _slot_positions(expert_mask: torch.Tensor) -> torch.Tensor:
    """Each token's 0-based rank among the tokens routed to its expert, in
    token order, from the one-hot ``[T, E]`` mask: the cumsum over the
    tokens, the unselected entries adding 0 so the sum picks out the
    selected expert's rank. The scan runs along the inner axis of a
    contiguous ``[E, T]`` copy: over dim 0 of ``[T, E]`` the card's cumsum
    walks the token axis as an outer dim, about a millisecond at T 8192.
    The counts are integers below 2**24, exact in f32, so the order of the
    scan changes nothing."""
    counts = torch.cumsum(expert_mask.t().contiguous(), dim=1).t()  # [T, E]
    return ((counts - 1.0) * expert_mask).sum(dim=-1).long()


def router_top1_indices(
    logits: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Switch top-1 router in index form.

    ``logits``: ``[T, E]``. Returns (``expert_index [T]``, ``slot [T]``,
    ``gate [T]``, aux load-balance loss). A token's slot is its 0-based
    rank among the tokens routed to its expert (cumsum order over ``T``);
    rank >= capacity drops it, and its ``slot`` is then ``capacity``.
    ``gate`` is the chosen expert's router probability, in ``logits``'
    dtype, and 0 for a dropped token; it carries the router's gradient,
    and the aux loss carries it through the mean router probability.
    """
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    expert_index = probs.argmax(dim=-1)  # [T], the first maximum, as jnp
    experts = torch.arange(E, device=logits.device)
    expert_mask = (expert_index[:, None] == experts).to(probs.dtype)  # [T, E]

    # Switch aux loss: E * sum_e (token fraction on e) * (mean router prob e).
    density = expert_mask.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux_loss = E * torch.sum(density * density_proxy)

    position = _slot_positions(expert_mask)  # [T]
    kept = position < capacity

    gate = (probs * expert_mask).sum(dim=-1) * kept  # [T]
    slot = torch.where(kept, position, capacity)  # overflow -> C
    return expert_index, slot, gate, aux_loss


def router_top1(
    logits: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Switch top-1 router in the reference's one-hot form.

    ``logits``: ``[T, E]``. Returns (combine ``[T, E, C]``, dispatch
    ``[T, E, C]`` one-hot, aux load-balance loss), in ``logits``' dtype,
    built from :func:`router_top1_indices`: a dropped token's slot is
    ``capacity``, which matches no column. ``dispatch`` carries no
    gradient; ``combine`` carries the router's through the gate.
    """
    E = logits.shape[1]
    expert_index, slot, gate, aux_loss = router_top1_indices(logits, capacity)
    experts = torch.arange(E, device=logits.device)
    expert_mask = (expert_index[:, None] == experts).to(gate.dtype)  # [T, E]
    slots = torch.arange(capacity, device=logits.device)
    slot_one_hot = (slot[:, None] == slots).to(gate.dtype)  # [T, C]
    dispatch = expert_mask[:, :, None] * slot_one_hot[:, None, :]  # [T, E, C]
    combine = gate[:, None, None] * dispatch
    return combine, dispatch, aux_loss


def _route(logits: torch.Tensor, capacity: int):
    """:func:`router_top1`, on DTensor logits over the whole token set on
    every rank: a token's slot is its rank among ALL the tokens routed to
    its expert, as on one device (and under GSPMD), so the logits are
    gathered and each rank routes them alike. The one-hots and the aux
    loss come back replicated."""
    if not isinstance(logits, DTensor):
        return router_top1(logits, capacity)
    mesh = logits.device_mesh
    rep = [Replicate()] * mesh.ndim
    fn = local_map(lambda lg: router_top1(lg, capacity),
                   out_placements=(rep, rep, rep), in_placements=(rep,),
                   redistribute_inputs=True, device_mesh=mesh)
    return fn(logits)


def token_order(group, tokens: int, rows: int = 1, seq_blocks: int = 1,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, mine)`` for the tokens of a batch spread over ``group``:
    each rank holds ``tokens`` of them, its ``rows`` rows of a block of
    positions, row-major, and the batch's positions are split into
    ``seq_blocks`` blocks over consecutive ranks (rank = batch shard x
    ``seq_blocks`` + block, the mesh's order: data, fsdp, then seq).
    ``order[i]`` is the rank-order index (every rank's tokens gathered in
    rank order) of token i in the one-device order (global row, position);
    ``mine[j]`` is the one-device index of this rank's token j. Without a
    split sequence, or at one row a rank, both orders agree."""
    ranks = dist.get_world_size(group)
    everyone = torch.arange(ranks * tokens, device=device)
    shape = (ranks // seq_blocks, seq_blocks, rows, tokens // rows)
    order = everyone.view(shape).permute(0, 2, 1, 3).reshape(-1)
    one_device = everyone.view(shape[0], rows, seq_blocks, shape[3])
    at = one_device.permute(0, 2, 1, 3).reshape(-1)
    me = dist.get_rank(group)
    return order, at[me * tokens:(me + 1) * tokens]


def _gather_routed(logits: torch.Tensor, group, rows: int, seq_blocks: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's router logits over ``group`` in the one-device token
    order (:func:`token_order`), and this rank's tokens' indices there."""
    order, mine = token_order(group, logits.shape[0], rows, seq_blocks,
                              logits.device)
    gathered = _GatherRows.apply(logits, group)
    return gathered.index_select(0, order), mine


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of ``x`` over ``group``, in rank order; the
    gradient of this rank's rows sums every rank's gradient of them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                           *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        rows = grad.shape[0] // dist.get_world_size(ctx.group)
        me = dist.get_rank(ctx.group)
        return grad[me * rows:(me + 1) * rows], None


class _SumOver(torch.autograd.Function):
    """The sum of ``x`` over ``group`` on every rank; each rank's gradient
    is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def moe_param_sharding(params: Dict[str, torch.Tensor], mesh) -> Dict[str, tuple]:
    """Placements of the MoE parameters, as the JAX function: expert-stacked
    weights (:func:`parallel.mesh.expert_stacked`) on ``Shard(0)`` over the
    ``expert`` axis, everything else (the router) replicated."""
    sizes = axis_sizes(mesh)
    expert = sizes.get(EXPERT_AXIS, 1)
    out = {}
    for name, t in params.items():
        stacked = expert_stacked(tuple(t.shape), expert)
        out[name] = tuple(Shard(0) if stacked and axis == EXPERT_AXIS
                          else Replicate() for axis in sizes)
    return out


def slot_indices(
    expert_index: torch.Tensor, slot: torch.Tensor, capacity: int,
    n_experts: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``dest [T]``, ``src [E*C]``) from :func:`router_top1_indices`'s
    routes: ``dest[t]`` is token t's flat slot ``expert * C + slot``, or
    ``E*C`` for a dropped token; ``src[j]`` is the token in flat slot j,
    or ``T`` for an empty slot. Device ops only (no ``nonzero``, no
    boolean indexing, no host read), so a step that builds them captures:
    ``src`` is ``arange(T)`` scattered into ``E*C + 1`` entries of ``T``,
    every dropped token onto the last one, whose undefined winner is cut
    off unread."""
    T = expert_index.shape[0]
    flat = n_experts * capacity
    dest = torch.where(slot < capacity, expert_index * capacity + slot, flat)
    src = torch.full((flat + 1,), T, dtype=torch.long,
                     device=expert_index.device)
    src.scatter_(0, dest, torch.arange(T, device=expert_index.device))
    return dest, src[:flat]


def _rows(v: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``index`` of the 2-D ``v``, where index ``len(v)`` reads a row
    of zeros."""
    return torch.cat([v, v.new_zeros(1, v.shape[1])])[index]


class _Dispatch(torch.autograd.Function):
    """``expert_in [E, C, d]``: flat slot j holds row ``src[j]`` of ``x``,
    zeros where the slot is empty. The gradient is a gather too, row
    ``dest[t]`` of the incoming one (zeros for a dropped token): each slot
    holds one token, so no sum is needed, and no atomics run."""

    @staticmethod
    def forward(ctx, x, src, dest, n_experts):
        ctx.save_for_backward(dest)
        return _rows(x, src).view(n_experts, -1, x.shape[1])

    @staticmethod
    def backward(ctx, grad):
        (dest,) = ctx.saved_tensors
        return _rows(grad.reshape(-1, grad.shape[-1]), dest), None, None, None


class _Combine(torch.autograd.Function):
    """``y[t] = gate[t] * expert_out[dest[t]]`` in the expert output's dtype,
    the f32 gate cast to it first, as the reference casts its combine
    tensor; a dropped token reads a zero row. Backward, by gathers:
    ``d expert_out[j] = gate[src[j]] * dy[src[j]]`` and
    ``d gate[t] = <dy[t], expert_out[dest[t]]>`` summed in f32."""

    @staticmethod
    def forward(ctx, expert_out, gate, src, dest):
        picked = _rows(expert_out.reshape(-1, expert_out.shape[-1]), dest)
        gate_cd = gate.to(picked.dtype)
        ctx.save_for_backward(picked, gate_cd, src)
        ctx.shape, ctx.gate_dtype = expert_out.shape, gate.dtype
        return picked * gate_cd[:, None]

    @staticmethod
    def backward(ctx, dy):
        picked, gate_cd, src = ctx.saved_tensors
        d_out = _rows(dy, src) * _rows(gate_cd[:, None], src)
        d_gate = (dy.float() * picked.float()).sum(dim=-1)
        return d_out.view(ctx.shape), d_gate.to(ctx.gate_dtype), None, None


class _GatherExperts(torch.autograd.Function):
    """Every rank's experts of ``x`` (``[E/n, ...]``) over ``group``, in
    rank order, ``[E, ...]``; backward, this rank's slice of the gradient,
    not summed: every rank of the group holds the same tokens and combines
    them alike, so its gradient of the gathered output is whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                           *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        rows = grad.shape[0] // dist.get_world_size(ctx.group)
        me = dist.get_rank(ctx.group)
        return grad[me * rows:(me + 1) * rows], None


def gather_experts(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`_GatherExperts` over ``group``; ``x`` itself when ``group``
    is None."""
    return x if group is None else _GatherExperts.apply(x, group)


def _expert_slots(dest: torch.Tensor, src: torch.Tensor, capacity: int,
                  n_local: int, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``dest``, ``src``) of :func:`slot_indices` cut to this rank's
    ``n_local`` experts of an ``expert`` group: ``src``'s slots of those
    experts, and each token's slot among them, or ``n_local * capacity``
    (the zero row) for a token that another rank's expert holds or that
    was dropped. Without a group, as they are."""
    if group is None:
        return dest, src
    span = n_local * capacity
    first = dist.get_rank(group) * span
    mine = (dest >= first) & (dest < first + span)
    return torch.where(mine, dest - first, span), src[first:first + span]


def moe_ffn(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    capacity_factor: float = 1.25,
    compute_dtype: Optional[torch.dtype] = None,
    group=None,
    rows: int = 1,
    seq_blocks: int = 1,
    tensor_group=None,
    expert_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixture-of-experts FFN over a flat token batch.

    ``x``: ``[T, d_model]`` -> (``[T, d_model]``, aux loss). Dropped tokens
    give zeros: compose with a residual connection. With ``group`` (a
    process group of more than one rank), ``x`` is this rank's part of a
    batch spread over the group's ranks, routed with every rank's tokens in
    the one-device order (see the module docstring): its ``rows`` rows,
    row-major, of a block of positions when the batch's positions are split
    into ``seq_blocks`` blocks over consecutive ranks (:func:`token_order`).
    With ``tensor_group``, ``wi`` and ``wo`` are this rank's slices of the
    FFN's width and the experts' outputs are summed over that group. With
    ``expert_group`` (n ranks holding the same tokens), ``wi`` and ``wo``
    are this rank's E/n experts, in rank order, and the experts' outputs
    are gathered over that group; E is the router's.

    Routing (logits, softmax, aux loss) always runs in f32. Dispatch and
    combine are gathers by token index; the two expert matmuls run in
    ``compute_dtype`` (default ``x.dtype``); gelu is tanh-approximate, as
    flax's. DTensor inputs or parameters take :func:`moe_ffn_reference`.
    """
    kw = dict(capacity_factor=capacity_factor, compute_dtype=compute_dtype,
              group=group, rows=rows, seq_blocks=seq_blocks,
              tensor_group=tensor_group, expert_group=expert_group)
    if isinstance(x, DTensor) or any(isinstance(p, DTensor)
                                     for p in params.values()):
        return moe_ffn_reference(params, x, **kw)
    T = x.shape[0]
    E, local = params["router"].shape[-1], params["wi"].shape[0]
    ranks = 1 if group is None else dist.get_world_size(group)
    C = _capacity(T * ranks, E, capacity_factor)
    cd = compute_dtype or x.dtype

    logits = x.float() @ params["router"].float()
    if ranks > 1:
        logits, mine = _gather_routed(logits, group, rows, seq_blocks)
    expert_index, slot, gate, aux_loss = router_top1_indices(logits, C)
    dest, src = slot_indices(expert_index, slot, C, E)
    if ranks > 1:
        # this rank's tokens are one-device tokens mine[0 .. T - 1]; the
        # slots of other ranks' tokens (and empty ones) read the zero row
        dest, gate = dest.index_select(0, mine), gate.index_select(0, mine)
        owner = torch.full((ranks * T + 1,), T, dtype=torch.long,
                           device=x.device)
        src = owner.scatter_(0, mine, torch.arange(T, device=x.device))[src]

    to_mine, from_mine = _expert_slots(dest, src, C, local, expert_group)
    x_in = copy_to_tensor(copy_to_tensor(x.to(cd), tensor_group),
                          expert_group)
    expert_in = _Dispatch.apply(x_in, from_mine, to_mine, local)  # [E/n, C, d]
    if ranks > 1:
        expert_in = _SumOver.apply(expert_in, group)
    h = F.gelu(torch.bmm(expert_in, params["wi"].to(cd)), approximate="tanh")
    expert_out = reduce_from_tensor(
        torch.bmm(h, params["wo"].to(cd)), tensor_group)
    expert_out = gather_experts(expert_out, expert_group)  # [E, C, d]
    return _Combine.apply(expert_out, gate, src, dest), aux_loss


def moe_ffn_reference(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    capacity_factor: float = 1.25,
    compute_dtype: Optional[torch.dtype] = None,
    group=None,
    rows: int = 1,
    seq_blocks: int = 1,
    tensor_group=None,
    expert_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_ffn` in the reference's dense formulation: dispatch and
    combine are products with the ``[T, E, C]`` one-hots of
    :func:`router_top1`, cast to ``compute_dtype``; under ``expert_group``
    the dispatch takes this rank's experts' columns. It is the plain
    version that the index path is held to, and the path of DTensor
    inputs and parameters (``pipe`` meshes, ``tensor`` under MLP and
    ResNet, and the tests' placed ``expert`` cases), whose collectives
    DTensor's propagation over the products places."""
    T = x.shape[0]
    E, local = params["router"].shape[-1], params["wi"].shape[0]
    ranks = 1 if group is None else dist.get_world_size(group)
    C = _capacity(T * ranks, E, capacity_factor)
    cd = compute_dtype or x.dtype

    logits = x.float() @ params["router"].float()
    if ranks > 1:
        logits, mine = _gather_routed(logits, group, rows, seq_blocks)
        combine, dispatch, aux_loss = router_top1(logits, C)
        combine = combine.index_select(0, mine)
        dispatch = dispatch.index_select(0, mine)
    else:
        combine, dispatch, aux_loss = _route(logits, C)
    if expert_group is not None:
        first = dist.get_rank(expert_group) * local
        dispatch = dispatch[:, first:first + local]

    # Matmuls that keep the expert dim leading: einsum's own reshapes would
    # merge a sharded expert dim behind another, which DTensor refuses. With
    # wi/wo on Shard(0) over expert each rank runs its experts' products and
    # the combine is a partial sum over the expert axis.
    x = copy_to_tensor(copy_to_tensor(x.to(cd), tensor_group), expert_group)
    dispatch, combine = dispatch.to(cd), combine.to(cd)
    expert_in = torch.matmul(dispatch.permute(1, 2, 0), x)  # [E/n, C, d]
    if ranks > 1:
        expert_in = _SumOver.apply(expert_in, group)
    h = F.gelu(torch.bmm(expert_in, params["wi"].to(cd)), approximate="tanh")
    expert_out = reduce_from_tensor(
        torch.bmm(h, params["wo"].to(cd)), tensor_group)
    expert_out = gather_experts(expert_out, expert_group)  # [E, C, d]
    y = torch.matmul(combine.reshape(T, E * C), expert_out.reshape(E * C, -1))
    return y, aux_loss


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``x`` over ``group`` in rank order,
    differentiable: the gradient of this rank's rows sums every rank's
    gradient of them."""
    return _GatherRows.apply(x, group)


__all__ = ["gather_experts", "gather_rows", "init_moe_params", "moe_ffn",
           "moe_ffn_reference", "moe_param_sharding", "router_top1",
           "router_top1_indices", "slot_indices", "token_order"]
