"""Pipeline parallelism: GPipe microbatches over a ``pipe`` mesh axis, as in
``cron_operator_tpu/parallel/pipeline.py``.

The JAX function is one SPMD program under ``shard_map``: each pipe shard
holds one stage's weights, activations hop stage to stage by
``lax.ppermute``, and a ``lax.scan`` over ticks makes the loop
differentiable. Here each rank of the ``pipe`` axis runs the same tick loop
eagerly on plain tensors, activations hop by :func:`parallel.ring.ppermute`
(an autograd Function whose backward is the reverse hop), and autograd
gives the backward pipeline: no hand-built 1F1B schedule, as in JAX.

Schedule: fill-drain (GPipe). With S stages and M microbatches the loop
runs M + S - 1 ticks; at tick t stage s processes microbatch t - s. Every
rank runs every op of every tick, its selections made by ``torch.where``
on tensors as JAX's ``jnp.where`` does, so every rank's backward runs the
same reverse hops in the same order.

Usage::

    stacked = stack_pipeline_stages([dict(l.named_parameters()) for l in layers])
    mesh = mesh_for_devices(pipe=4)           # optionally x data
    y = spmd_pipeline(stage_fn, stacked, x, mesh=mesh, n_microbatches=8)

``stage_fn(stage_params, x) -> y`` maps activations to activations of the
same shape and dtype (the inter-stage buffer is one rotating tensor).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from cron_operator_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    PIPE_AXIS,
    axis_sizes,
    batch_rows,
)
from cron_operator_tpu_torch.parallel.ring import ppermute


def stack_pipeline_stages(
    stage_params: List[Dict[str, torch.Tensor]]
) -> Dict[str, torch.Tensor]:
    """Each stage's ``{name: tensor}`` stacked on a new leading dim
    ``[S, ...]``. Every stage must have the same names and shapes (the
    GPipe regime of equal-width stages)."""
    names = list(stage_params[0])
    for params in stage_params[1:]:
        if list(params) != names:
            raise ValueError(
                f"stages differ in their parameters: {names} and "
                f"{list(params)}"
            )
    return {n: torch.stack([p[n] for p in stage_params]) for n in names}


def pipeline_param_sharding(tree: Dict[str, torch.Tensor], mesh) -> Dict[str, tuple]:
    """Placements of stacked stage parameters: dim 0 on ``pipe``
    (``Shard(0)``), replicated over every other axis."""
    place = tuple(Shard(0) if name == PIPE_AXIS else Replicate()
                  for name in axis_sizes(mesh))
    return {name: place for name in tree}


def _batch_groups(mesh) -> list:
    return [mesh.get_group(a) for a in BATCH_AXES if a in axis_sizes(mesh)]


class _SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``groups`` in
    turn. A tensor that every rank holds whole, of which each rank uses a
    part (its rows, its stage), gets its whole gradient everywhere: the
    transpose ``shard_map`` gives an input replicated over its axes."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class _Assemble(torch.autograd.Function):
    """``local`` (this rank's ``rows`` of an ``n``-row result, zeros off
    the last stage) written into zeros and summed over ``groups``: the
    whole result on every rank, JAX's ``psum`` over ``pipe`` and its
    batch-split out spec. The loss of the result is the same on every rank,
    so the backward hands each rank its rows of that gradient."""

    @staticmethod
    def forward(ctx, local, rows, n, groups):
        ctx.rows = rows
        out = local.new_zeros((n, *local.shape[1:]))
        out[rows] = local
        for group in groups:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None, None, None


def _stage_params(stacked: Dict[str, torch.Tensor], mesh, stage: int,
                  groups: Sequence) -> Dict[str, torch.Tensor]:
    """This rank's stage of each stacked tensor, as a plain tensor. A
    DTensor is laid out by :func:`pipeline_param_sharding` and its
    gradient is this rank's shard, summed over the batch axes (each data
    shard saw its rows). A plain tensor, whole on every rank, gets its
    whole gradient on every rank (:class:`_SumGrads` over ``groups``)."""
    sizes = axis_sizes(mesh)
    place = [Shard(0) if a == PIPE_AXIS else Replicate() for a in sizes]
    grads = [Shard(0) if a == PIPE_AXIS else
             Partial() if a in BATCH_AXES else Replicate() for a in sizes]
    out = {}
    for name, p in stacked.items():
        if isinstance(p, DTensor):
            out[name] = p.redistribute(mesh, place).to_local(
                grad_placements=grads)[0]
        else:
            out[name] = _SumGrads.apply(p, groups)[stage]
    return out


def _pipeline_loop(
    stage_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor],
    n_microbatches: int,
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    group,
    stage: int,
    n_stages: int,
) -> torch.Tensor:
    """Per-rank body: this rank's stage ``params`` over its rows ``x``;
    returns its rows of the result on the last stage, zeros elsewhere."""
    mb = x.reshape(n_microbatches, x.shape[0] // n_microbatches,
                   *x.shape[1:])
    ticks = n_microbatches + n_stages - 1
    first = torch.tensor(stage == 0, device=x.device)
    state = torch.zeros_like(mb[0])
    outputs = torch.zeros_like(mb)
    for t in range(ticks):
        # Stage 0 injects microbatch t (clamped: past M the pipeline drains
        # and the value is never collected); the others take the hop's.
        x_in = torch.where(first, mb[min(t, n_microbatches - 1)], state)
        y = stage_fn(params, x_in)
        # The last stage collects microbatch t - (S - 1).
        out_idx = t - (n_stages - 1)
        slot = torch.tensor([min(max(out_idx, 0), n_microbatches - 1)],
                            device=x.device)
        keep = torch.tensor(stage == n_stages - 1 and out_idx >= 0,
                            device=x.device)
        outputs = torch.where(keep, outputs.index_copy(0, slot, y[None]),
                              outputs)
        if t < ticks - 1:  # JAX's scan makes one more hop, never read
            state = ppermute(y, group)
    return outputs.reshape(x.shape)


def spmd_pipeline(
    stage_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor],
    stacked_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    mesh,
    n_microbatches: int,
) -> torch.Tensor:
    """Run ``x`` through the mesh's ``pipe``-many pipelined stages (see the
    module docstring).

    ``stacked_params``: ``{name: [S, ...]}`` (:func:`stack_pipeline_stages`),
    plain tensors whole on every rank or DTensors on ``mesh``
    (:func:`pipeline_param_sharding`). ``x``: the global ``[batch, ...]``,
    whole on every rank; the batch is split over the mesh's batch axes,
    and each shard's rows must divide into ``n_microbatches``. Returns the
    whole result on every rank. Differentiable: a loss computed alike on
    every rank gives every rank the whole gradient of ``x`` and of plain
    parameters (of a DTensor, its shard)."""
    sizes = axis_sizes(mesh)
    if PIPE_AXIS not in sizes:
        raise ValueError(f"mesh has no {PIPE_AXIS!r} axis: {tuple(sizes)}")
    n_stages = sizes[PIPE_AXIS]
    for name, leaf in stacked_params.items():
        if leaf.shape[0] != n_stages:
            # Each rank would otherwise take one slice of a wrong stack and
            # run a pipeline that ignores stages.
            raise ValueError(
                f"stacked params have {leaf.shape[0]} stage(s) ({name!r}) "
                f"but the mesh {PIPE_AXIS!r} axis has {n_stages}"
            )
    shards = 1
    for a in BATCH_AXES:
        shards *= sizes.get(a, 1)
    if x.shape[0] % shards:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by the mesh's batch-axis "
            f"product {shards}"
        )
    if (x.shape[0] // shards) % n_microbatches:
        raise ValueError(
            f"per-shard batch {x.shape[0] // shards} (global {x.shape[0]} "
            f"over {shards} data shard(s)) not divisible by "
            f"n_microbatches={n_microbatches}"
        )
    group = mesh.get_group(PIPE_AXIS)
    stage = mesh.get_local_rank(PIPE_AXIS)
    groups = [group, *_batch_groups(mesh)]
    rows = batch_rows(mesh, x.shape[0])
    params = _stage_params(stacked_params, mesh, stage, groups)
    local = _SumGrads.apply(x, groups)[rows]
    out = _pipeline_loop(stage_fn, n_microbatches, params, local, group,
                         stage, n_stages)
    return _Assemble.apply(out, rows, x.shape[0], groups)


__all__ = ["pipeline_param_sharding", "spmd_pipeline", "stack_pipeline_stages"]
