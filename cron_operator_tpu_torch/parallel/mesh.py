"""Device meshes and placement rules, as in ``cron_operator_tpu/parallel/mesh.py``.

The JAX package expresses parallelism as a ``jax.sharding.Mesh`` of named
axes and lets GSPMD insert the collectives. The port's mesh is the process
group's world: one rank per device (a rank drives ``cuda:$LOCAL_RANK``, or
the CPU under gloo), arranged by a :class:`MeshPlan` into a
``torch.distributed.device_mesh.DeviceMesh`` with the plan's axis names in
the same row-major order. Parameters, optimizer state and batches become
DTensors whose placements (``Shard(i)``/``Replicate()``, one per mesh axis)
come from the rules below, and DTensor's propagation inserts the
collectives, as GSPMD does for the JAX package.

Axis convention (outer to inner), shared with the JAX package:

- ``pipe``   pipeline stages (not consumed by the standard jobs);
- ``data``   data parallelism (batch rows; gradients summed);
- ``fsdp``   parameter sharding, ZeRO-3 style (a second batch axis);
- ``expert`` expert parallelism (expert-stacked MoE weights);
- ``seq``    sequence parallelism (ring and Ulysses attention, a batch's
  positions split by ``batch_placements(mesh, seq_dim=...)``);
- ``tensor`` tensor parallelism (a weight's output-features dim, heads).

Two paths train over a mesh (:func:`plain_axes` picks one). A mesh whose
axes above 1 are among ``data``, ``fsdp``, ``seq`` and ``expert``, and
``tensor`` for a model that splits its blocks (GPT, BERT and ViT:
``splits_over_tensor``), trains plain modules (:func:`data_parallel`).
First each module that names parameters to split keeps this rank's pieces
(:func:`split_over_tensor`): under ``expert`` an MoE block its E/n
experts' ``wi`` and ``wo`` (JAX's ``P('expert')`` of the expert-stacked
leaves; the ranks of an ``expert`` group hold the same rows, and the
experts' outputs are gathered over the group); under ``tensor`` each
block its own heads and its slice of the FFN (the Megatron layout: the QKV
projection and ``fc_in`` split by output features, ``out`` and ``fc_out``
by input features, their partial sums reduced over the ``tensor`` group by
:func:`reduce_from_tensor` and their inputs' gradients by
:func:`copy_to_tensor`), and GPT's and BERT's tied table its block of the
vocab rows (:class:`VocabSplit`, the vocab-parallel layout); every other
parameter stays whole on every rank of those groups, which hold the same
rows. Then
``DistributedDataParallel`` over the batch axes (:func:`batch_group`)
without ``fsdp``, or FSDP2 ``fully_shard`` per block and on the root with
it (sharded on ``fsdp``, replicated over ``data`` and ``seq``, at this
rank's ``expert`` and ``tensor`` coordinates), each parameter split on the
dim the placement rule gives it. Each rank holds its rows of the batch
and, under ``seq``, its block of positions as plain tensors; the modules
that see a block of positions get the mesh (``seq_mesh``: learned and
rotary positions at the block's global offset, ring and Ulysses attention
on the local blocks), the MoE blocks the batch group (``token_group``)
and the ``expert`` group (``expert_group``), the blocks the ``tensor``
group (``tensor_group``), and on NCCL the step can be captured as a CUDA
graph. A mesh with ``pipe`` above 1, or ``tensor`` for a model that does
not split (MLP, ResNet), places every parameter as a DTensor
(:func:`distribute_parameters`) and DTensor's propagation places the
collectives. The JAX package has one path, GSPMD, for every mesh.

The plan half (:class:`MeshPlan`, :func:`plan_for_devices`, :func:`replan`,
:func:`regrow`) is a copy of the JAX package's pure Python: the controller
replans a preempted job with the JAX copy and resubmits a port job, so the
two must agree case for case.

A "slice" of the JAX package (one TPU slice, ICI inside, DCN between) is a
node here: :func:`hybrid_mesh_for_slices` groups ranks by
``LOCAL_WORLD_SIZE`` and keeps every model axis inside a node, with the
``data`` axis outermost and node-major.

Placement rule, on the port's own layout. The JAX rule reads flax shapes,
whose last dim is a kernel's output features; a torch ``Linear`` or
``Conv2d`` weight keeps its output features in dim 0. :func:`placements_for_shape`
takes that dim (``features_dim``) and applies the JAX rule to the shape
with the features dim moved last, so a 2-D weight gets, transposed, the
JAX placement of its flax kernel, ties of a square matrix included. The
rank-3/4 ``DenseGeneral`` kernels that the port flattens (``qkv``
``[3 * h * d, hidden]``, ``out`` ``[hidden, h * d]``) are the one
divergence: JAX shards their head_dim on ``tensor``, which no single
``Shard`` of the flattened weight expresses; the port shards the flattened
output features. Checkpoints hold full tensors keyed by name, so placement
never reaches the file format.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)

from cron_operator_tpu_torch.utils.device import world_size

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

# Axes over which a batch's leading dimension is split.
BATCH_AXES: Tuple[str, ...] = (DATA_AXIS, FSDP_AXIS)


@dataclass(frozen=True)
class MeshPlan:
    """A named-axis factorization of a device count."""

    axis_sizes: Dict[str, int] = field(default_factory=dict)

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.axis_sizes.values():
            n *= s
        return n

    def axis(self, name: str) -> int:
        return self.axis_sizes.get(name, 1)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axis_sizes.keys())

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.axis_sizes.values())


def plan_for_devices(
    n_devices: int,
    *,
    tensor: int = 1,
    seq: int = 1,
    fsdp: int = 1,
    pipe: int = 1,
    expert: int = 1,
    data: Optional[int] = None,
) -> MeshPlan:
    """Factor ``n_devices`` into the standard axes, ``data`` inferred as the
    remainder unless given; raises ``ValueError`` when the factors do not
    multiply out. Axis order (outer to inner): pipe, data, fsdp, expert,
    seq, tensor."""
    model_par = tensor * seq * fsdp * pipe * expert
    if n_devices % model_par != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by "
            f"tensor*seq*fsdp*pipe*expert={model_par}"
        )
    inferred_data = n_devices // model_par
    if data is not None and data != inferred_data:
        raise ValueError(
            f"data={data} inconsistent: {n_devices} devices / {model_par} = "
            f"{inferred_data}"
        )
    sizes: Dict[str, int] = {}
    if pipe > 1:
        sizes[PIPE_AXIS] = pipe
    sizes[DATA_AXIS] = inferred_data
    if fsdp > 1:
        sizes[FSDP_AXIS] = fsdp
    if expert > 1:
        sizes[EXPERT_AXIS] = expert
    if seq > 1:
        sizes[SEQ_AXIS] = seq
    if tensor > 1:
        sizes[TENSOR_AXIS] = tensor
    return MeshPlan(sizes)


def replan(
    old_plan: MeshPlan,
    surviving_devices: Any,
    *,
    allow_grow: bool = False,
    original_plan: Optional[MeshPlan] = None,
) -> MeshPlan:
    """Recompute a plan after the device pool changed size (a count or a
    sequence of devices).

    Shrink (preemption): ``data`` absorbs the loss first; model axes keep
    their sizes while the surviving count stays divisible by their
    product, and are otherwise reduced largest-first by prime factors.
    Grow (``allow_grow=True``): ``data`` widens first, and with
    ``original_plan`` model axes that a shrink reduced are restored toward
    their original sizes, largest deficit first, one prime factor at a
    time, while the target stays divisible. A larger pool without
    ``allow_grow``, an empty pool, or an indivisible grow target raise
    ``ValueError``."""
    try:
        surviving = int(surviving_devices)
    except (TypeError, ValueError):
        surviving = len(surviving_devices)
    if surviving <= 0:
        raise ValueError("no surviving devices to replan onto")
    if surviving > old_plan.n_devices and not allow_grow:
        raise ValueError(
            f"replan is shrink-only: {surviving} surviving > "
            f"{old_plan.n_devices} planned"
        )
    if surviving == old_plan.n_devices:
        return old_plan
    model = {
        name: old_plan.axis(name)
        for name in (PIPE_AXIS, EXPERT_AXIS, SEQ_AXIS, FSDP_AXIS, TENSOR_AXIS)
    }

    def _model_par() -> int:
        n = 1
        for s in model.values():
            n *= s
        return n

    if surviving > old_plan.n_devices:
        if original_plan is not None:
            while True:
                deficits = {
                    a: original_plan.axis(a) // model[a]
                    for a in model
                    if original_plan.axis(a) > model[a]
                    and original_plan.axis(a) % model[a] == 0
                }
                restorable = None
                for a in sorted(deficits, key=lambda a: -deficits[a]):
                    f = deficits[a]
                    p = next(q for q in range(2, f + 1) if f % q == 0)
                    if surviving % (_model_par() * p) == 0:
                        restorable = (a, p)
                        break
                if restorable is None:
                    break
                model[restorable[0]] *= restorable[1]
        if surviving % _model_par():
            raise ValueError(
                f"cannot grow onto {surviving} devices: not divisible by "
                f"model parallelism {_model_par()}"
            )
    else:
        while surviving % _model_par():
            name = max((a for a in model if model[a] > 1),
                       key=lambda a: model[a])
            size = model[name]
            factor = next(p for p in range(2, size + 1) if size % p == 0)
            model[name] //= factor
    return plan_for_devices(
        surviving,
        tensor=model[TENSOR_AXIS],
        seq=model[SEQ_AXIS],
        fsdp=model[FSDP_AXIS],
        pipe=model[PIPE_AXIS],
        expert=model[EXPERT_AXIS],
    )


def regrow(
    old_plan: MeshPlan,
    devices: Any,
    original_plan: Optional[MeshPlan] = None,
) -> MeshPlan:
    """Explicit grow: :func:`replan` with ``allow_grow=True``."""
    return replan(
        old_plan, devices, allow_grow=True, original_plan=original_plan
    )


# ---- meshes over the process group ----------------------------------------


def world_ranks() -> List[int]:
    """The ranks of the default process group, in order (``[0]`` without
    one)."""
    return list(range(world_size()))


def rank_grid(plan: MeshPlan, ranks: Sequence[int]) -> torch.Tensor:
    """``ranks`` reshaped row-major into the plan's shape, as the JAX
    ``make_mesh`` lays out ``jax.devices()``."""
    ranks = list(ranks)
    if plan.n_devices != len(ranks):
        raise ValueError(
            f"mesh plan needs {plan.n_devices} devices, got {len(ranks)}"
        )
    return torch.tensor(ranks, dtype=torch.int64).reshape(plan.shape)


def _device_mesh(grid: torch.Tensor, names: Tuple[str, ...],
                 device_type: Optional[str]):
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, grid, mesh_dim_names=names)


def make_mesh(plan: MeshPlan, ranks: Optional[Sequence[int]] = None, *,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of the plan over ``ranks`` (default: the whole
    world), row-major, with the plan's axis names. Every rank of the world
    must call it (it creates the axes' sub-groups)."""
    ranks = world_ranks() if ranks is None else list(ranks)
    return _device_mesh(rank_grid(plan, ranks), plan.axis_names, device_type)


def mesh_for_devices(
    ranks: Optional[Sequence[int]] = None,
    *,
    tensor: int = 1,
    seq: int = 1,
    fsdp: int = 1,
    pipe: int = 1,
    expert: int = 1,
    device_type: Optional[str] = None,
):
    """One call: factor the world (or ``ranks``) and build the mesh."""
    ranks = world_ranks() if ranks is None else list(ranks)
    plan = plan_for_devices(len(ranks), tensor=tensor, seq=seq, fsdp=fsdp,
                            pipe=pipe, expert=expert)
    return make_mesh(plan, ranks, device_type=device_type)


def mesh_for_slice(
    slice_spec: Any,
    *,
    tensor: int = 1,
    seq: int = 1,
    fsdp: int = 1,
    pipe: int = 1,
    expert: int = 1,
    ranks: Optional[Sequence[int]] = None,
    device_type: Optional[str] = None,
):
    """The mesh over the devices of ``slice_spec``, any object with
    ``.chips`` and ``.topology`` (the operator's slice spec): the world
    must hold exactly ``chips`` ranks."""
    ranks = world_ranks() if ranks is None else list(ranks)
    if len(ranks) != slice_spec.chips:
        raise ValueError(
            f"slice {slice_spec.topology!r} has {slice_spec.chips} chips but "
            f"{len(ranks)} devices are visible"
        )
    plan = plan_for_devices(slice_spec.chips, tensor=tensor, seq=seq,
                            fsdp=fsdp, pipe=pipe, expert=expert)
    return make_mesh(plan, ranks, device_type=device_type)


def group_devices_by_slice(devices: Sequence[Any],
                           n_slices: int) -> List[List[Any]]:
    """Partition devices (ranks) into their slices (nodes).

    Items that carry ``slice_index`` are grouped by it, as the JAX
    function groups TPU devices; plain ranks fall into contiguous equal
    chunks, which is node-major under torchrun's rank order. Uneven or
    indivisible groupings raise ``ValueError``."""
    if len(devices) % n_slices:
        raise ValueError(
            f"{len(devices)} devices not divisible into {n_slices} slices"
        )
    indices = [getattr(d, "slice_index", None) for d in devices]
    if all(i is not None for i in indices):
        groups: Dict[Any, list] = {}
        for d in devices:
            groups.setdefault(d.slice_index, []).append(d)
        if len(groups) != n_slices:
            raise ValueError(
                f"devices span {len(groups)} slice(s), expected {n_slices}"
            )
        sizes = {len(g) for g in groups.values()}
        if len(sizes) != 1:
            raise ValueError(f"uneven slice sizes: {sorted(sizes)}")
        return [groups[k] for k in sorted(groups)]
    per = len(devices) // n_slices
    return [list(devices[i * per:(i + 1) * per]) for i in range(n_slices)]


@dataclass(frozen=True)
class _NodeRank:
    """A rank and the node (``rank // LOCAL_WORLD_SIZE``) it runs on."""

    rank: int
    slice_index: int


def _node_ranks(ranks: Sequence[int]) -> List[Any]:
    """``ranks`` tagged with their node when ``LOCAL_WORLD_SIZE`` is set
    (ranks per node, as torchrun and the PyTorchJob render it), else as
    they are."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    if local <= 0:
        return list(ranks)
    return [_NodeRank(r, r // local) for r in ranks]


def hybrid_grid(
    n_slices: int,
    devices: Sequence[Any],
    *,
    tensor: int = 1,
    seq: int = 1,
    fsdp: int = 1,
    pipe: int = 1,
    expert: int = 1,
) -> Tuple[List[List[Any]], Tuple[str, ...], Tuple[int, ...]]:
    """The multi-slice layout of the JAX ``hybrid_mesh_for_slices``:
    ``(groups, axis_names, inner_shape)``. ``data`` is outermost and
    slice-major (consecutive data indices stay in one slice), every model
    axis lives inside one slice, ``pipe`` included."""
    groups = group_devices_by_slice(list(devices), n_slices)
    per_slice = len(groups[0])
    model_par = tensor * seq * fsdp * pipe * expert
    if per_slice % model_par:
        raise ValueError(
            f"per-slice device count {per_slice} not divisible by "
            f"tensor*seq*fsdp*pipe*expert={model_par}"
        )
    sizes: Dict[str, int] = {}
    if pipe > 1:
        sizes[PIPE_AXIS] = pipe
    if fsdp > 1:
        sizes[FSDP_AXIS] = fsdp
    if expert > 1:
        sizes[EXPERT_AXIS] = expert
    if seq > 1:
        sizes[SEQ_AXIS] = seq
    if tensor > 1:
        sizes[TENSOR_AXIS] = tensor
    inner = (per_slice // model_par, *sizes.values())
    return groups, (DATA_AXIS, *sizes.keys()), inner


def hybrid_mesh_for_slices(
    n_slices: int,
    *,
    tensor: int = 1,
    seq: int = 1,
    fsdp: int = 1,
    pipe: int = 1,
    expert: int = 1,
    ranks: Optional[Sequence[int]] = None,
    device_type: Optional[str] = None,
):
    """Multi-node (inter-node x intra-node) mesh over the world: the
    ``data`` axis outermost and node-major, so only the data-parallel
    gradient sums cross nodes; the model axes stay inside a node."""
    ranks = world_ranks() if ranks is None else list(ranks)
    groups, names, inner = hybrid_grid(
        n_slices, _node_ranks(ranks), tensor=tensor, seq=seq, fsdp=fsdp,
        pipe=pipe, expert=expert)
    grid = torch.cat([
        torch.tensor([getattr(r, "rank", r) for r in g]).reshape(inner)
        for g in groups
    ])
    return _device_mesh(grid, names, device_type)


# ---- placement rules -------------------------------------------------------


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a :class:`MeshPlan`."""
    if isinstance(mesh, MeshPlan):
        return dict(mesh.axis_sizes)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_placements(mesh: Any, *, seq_dim: Optional[int] = None) -> tuple:
    """Placements of a batch (the JAX ``batch_pspec``): rows (dim 0) split
    over ``data`` then ``fsdp``, and with ``seq_dim`` that dim over
    ``seq``; every other axis replicates."""
    if seq_dim is not None and seq_dim <= 0:
        raise ValueError("seq_dim must be a positive dim index")
    out = []
    for name in axis_sizes(mesh):
        if name in BATCH_AXES:
            out.append(Shard(0))
        elif name == SEQ_AXIS and seq_dim is not None:
            out.append(Shard(seq_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def on_local_rows(fn, x, *weights):
    """``fn(x_rows, *weights_whole)`` on each rank, for an op that DTensor
    has no rule for (a convolution, a group norm, a pooling): ``x`` (a
    DTensor) is laid out by :func:`batch_placements`, each weight is
    gathered whole (FSDP's all-gather at use), and each rank runs ``fn`` on
    its own rows of the batch with plain tensors. A weight's gradient is a
    partial sum over the batch axes (each rank saw its own rows), so it is
    declared ``Partial`` there and reduced, or reduce-scattered onto the
    weight's shards, in the backward. The result is a DTensor laid out as
    the batch. A weight may be None."""
    mesh = x.device_mesh
    rows = batch_placements(mesh)
    out = fn(x.redistribute(mesh, rows).to_local(),
             *_whole_weights(mesh, rows, weights))
    return DTensor.from_local(out, mesh, rows, run_check=False)


def on_own_rows(fn, x, *weights):
    """``fn(x_local, *weights_whole)`` on each rank, for an op that works
    row by row over the last dim (a layer norm): ``x`` (a DTensor) keeps
    the splits of its rows, and a split of its last dim or a pending sum
    becomes a replica first; each weight is gathered whole, its gradient
    ``Partial`` on the axes that split x's rows, as in
    :func:`on_local_rows`. The result is a DTensor of x's shape in that
    layout."""
    mesh, last = x.device_mesh, x.ndim - 1
    rows = tuple(p if isinstance(p, Shard) and p.dim % x.ndim != last
                 else Replicate() for p in x.placements)
    out = fn(x.redistribute(mesh, rows).to_local(),
             *_whole_weights(mesh, rows, weights))
    return DTensor.from_local(out, mesh, rows, run_check=False,
                              shape=x.shape, stride=x.stride())


def _whole_weights(mesh, rows, weights) -> list:
    """Each weight (or None) gathered whole as a plain tensor, its gradient
    a partial sum on the axes that ``rows`` shards."""
    grads = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    whole = [Replicate()] * mesh.ndim
    return [None if w is None else
            w.redistribute(mesh, whole).to_local(grad_placements=grads)
            for w in weights]


def spec_for_shape(shape: Tuple[int, ...], mesh: Any, *,
                   features_dim: int = -1) -> List[Optional[str]]:
    """The JAX ``pspec_for_shape`` in the port's layout: one entry per dim
    of ``shape``, the mesh axis it is split over or None.

    - rank 0/1 (biases, scales): replicated;
    - with a ``tensor`` axis, ``features_dim`` (the output features: the
      last dim of a flax kernel, dim 0 of a torch ``Linear``/``Conv2d``
      weight) goes on ``tensor`` when it divides;
    - with an ``fsdp`` axis, the largest remaining divisible dim goes on
      ``fsdp``, ties to the first in flax order (the features dim moved
      last)."""
    n = len(shape)
    spec: List[Optional[str]] = [None] * n
    if n < 2:
        return spec
    sizes = axis_sizes(mesh)
    feat = features_dim % n
    order = [i for i in range(n) if i != feat] + [feat]  # flax order
    t = sizes.get(TENSOR_AXIS, 1)
    if t > 1 and shape[feat] % t == 0:
        spec[feat] = TENSOR_AXIS
    f = sizes.get(FSDP_AXIS, 1)
    if f > 1:
        for i in sorted(order, key=lambda i: -shape[i]):
            if spec[i] is None and shape[i] % f == 0:
                spec[i] = FSDP_AXIS
                break
    return spec


def placements_from_spec(spec: Sequence[Optional[Any]], mesh: Any) -> tuple:
    """Per-dim axis entries (an axis name, a tuple of names, or None) as
    DTensor placements, one per mesh axis."""
    dim_of: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                dim_of[name] = dim
    return tuple(Shard(dim_of[name]) if name in dim_of else Replicate()
                 for name in axis_sizes(mesh))


def placements_for_shape(shape: Tuple[int, ...], mesh: Any, *,
                         features_dim: int = -1) -> tuple:
    """:func:`spec_for_shape` as DTensor placements."""
    return placements_from_spec(
        spec_for_shape(shape, mesh, features_dim=features_dim), mesh)


def expert_stacked(shape: Tuple[int, ...], expert_size: int) -> bool:
    """Shape test for expert-stacked ``[E, ...]`` weights, shared by
    :func:`sharding_for_tree` (under a ``moe`` name) and
    ``parallel.moe.moe_param_sharding``."""
    return (
        expert_size > 1
        and len(shape) >= 3
        and shape[0] % expert_size == 0
    )


def features_dims(model: nn.Module) -> Dict[str, int]:
    """``{parameter name: output-features dim}`` for the weights that keep
    their output features in dim 0 (``Linear`` and ``Conv2d``); every other
    parameter has them last."""
    out = {}
    for prefix, module in model.named_modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            out[f"{prefix}.weight" if prefix else "weight"] = 0
    return out


def sharding_for_tree(tree: Any, mesh: Any) -> Dict[str, tuple]:
    """``{name: placements}`` for a model's parameters (an ``nn.Module``)
    or a flat ``{name: tensor}`` dict, by :func:`placements_for_shape`,
    with the JAX package's one name-aware rule: under an ``expert`` axis, a
    rank >= 3 tensor whose name has a ``moe`` component and whose leading
    dim divides the axis is expert-stacked and goes on ``Shard(0)`` over
    ``expert`` alone. The optimizer's state takes its parameter's
    placements."""
    if isinstance(tree, nn.Module):
        feats = features_dims(tree)
        named = dict(tree.named_parameters())
    else:
        feats, named = {}, dict(tree)
    expert = axis_sizes(mesh).get(EXPERT_AXIS, 1)
    out = {}
    for name, t in named.items():
        shape = tuple(t.shape)
        if expert_stacked(shape, expert) and "moe" in name.split("."):
            out[name] = placements_from_spec(
                [EXPERT_AXIS] + [None] * (len(shape) - 1), mesh)
        else:
            out[name] = placements_for_shape(
                shape, mesh, features_dim=feats.get(name, -1))
    return out


def distribute_parameters(model: nn.Module, mesh: Any,
                          placements: Optional[Dict[str, tuple]] = None
                          ) -> nn.Module:
    """Replaces each parameter of ``model`` by a DTensor on ``mesh``, placed
    by ``placements`` (default :func:`sharding_for_tree`). Every rank holds
    the same whole values (the same seed, or the same checkpoint), so each
    keeps its own shard and nothing is sent. Parameters that are DTensors
    already stay; a tied parameter is placed once."""
    placements = placements or sharding_for_tree(model, mesh)
    done: Dict[int, nn.Parameter] = {}
    for prefix, module in model.named_modules(remove_duplicate=False):
        for name, p in list(module.named_parameters(recurse=False)):
            if isinstance(p, DTensor):
                continue
            if id(p) not in done:
                full = f"{prefix}.{name}" if prefix else name
                done[id(p)] = nn.Parameter(
                    distribute_tensor(p.detach(), mesh, placements[full],
                                      src_data_rank=None),
                    requires_grad=p.requires_grad)
            module.register_parameter(name, done[id(p)])
    return model


# Axes that a mesh may split above 1 and still train plain modules, and
# ``tensor`` too for a model that splits its blocks (:func:`plain_axes`).
PLAIN_AXES: Tuple[str, ...] = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS, EXPERT_AXIS)
# The plain axes whose ranks hold different tokens (rows, or under ``seq``
# blocks of positions): :func:`batch_group`'s. The ranks of an ``expert``
# or ``tensor`` group hold the same ones.
TOKEN_AXES: Tuple[str, ...] = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS)
# The axes that :func:`split_over_tensor` splits parameters over, in the
# order it takes them (a parameter split over one is not split over the
# next), and the module attribute that names each axis's splits.
SPLIT_RULES: Dict[str, str] = {EXPERT_AXIS: "expert_splits",
                               TENSOR_AXIS: "tensor_splits"}
# The attributes through which :func:`data_parallel` hands the modules of a
# model the mesh: ``token_group`` (the MoE block: the batch group),
# ``seq_mesh`` (each module that sees a rank's block of positions),
# ``tensor_group`` (each module that splits over ``tensor``) and
# ``expert_group`` (the MoE block, whose experts split over ``expert``).
MESH_ATTACHMENTS: Tuple[str, ...] = ("token_group", "seq_mesh",
                                     "tensor_group", "expert_group")


def plain_axes(mesh: Any, model: Any = None) -> bool:
    """Whether ``mesh`` trains plain modules (:func:`data_parallel`): every
    axis above 1 is ``data``, ``fsdp``, ``seq`` or ``expert`` (a model
    without MoE blocks keeps every parameter whole on each ``expert``
    rank, as JAX's ``sharding_for_tree`` does), or ``tensor`` for a
    ``model`` (a module or its class) whose ``splits_over_tensor`` is true
    (GPT, BERT and ViT: :func:`split_over_tensor`). Any other mesh
    (``pipe`` above 1, ``tensor`` for MLP and ResNet) keeps DTensor
    parameters (:func:`distribute_parameters`)."""
    allowed = PLAIN_AXES + ((TENSOR_AXIS,) if getattr(
        model, "splits_over_tensor", False) else ())
    return all(size == 1 or name in allowed
               for name, size in axis_sizes(mesh).items())


def regrid(grid: torch.Tensor, sizes: Dict[str, int],
           dims: Dict[str, Sequence[str]]) -> Tuple[torch.Tensor, tuple]:
    """``grid`` (the ranks of a mesh of axes ``sizes``, row-major) as a grid
    with one dim for each entry of ``dims``, joining the axes it lists (in
    the mesh's order), after a first dim ``rest`` that joins the other
    axes when their sizes multiply above 1; and the new dims' names."""
    names = list(sizes)
    joined = [a for axes in dims.values() for a in axes]
    rest = [a for a in names if a not in joined]
    shape = [math.prod(sizes[a] for a in axes) for axes in dims.values()]
    dim_names = tuple(dims)
    if math.prod(sizes[a] for a in rest) > 1:
        shape, dim_names = [-1, *shape], ("rest", *dim_names)
    grid = grid.permute([names.index(a) for a in rest + joined])
    return grid.reshape(shape), dim_names


def _regroup(mesh: Any, dims: Dict[str, Sequence[str]]):
    """``mesh``'s ranks as a ``DeviceMesh`` laid out by :func:`regrid`.
    Every rank of the world builds its groups."""
    grid, names = regrid(mesh.mesh, axis_sizes(mesh), dims)
    return DeviceMesh(mesh.device_type, grid, mesh_dim_names=names)


def batch_group(mesh: Any):
    """The process group of a :func:`plain_axes` mesh over which its
    gradients are averaged (each rank's loss the mean over its own tokens,
    every rank holding as many): the ranks of its batch axes (``data``,
    ``fsdp``, ``seq``: :data:`TOKEN_AXES`) at this rank's ``expert`` and
    ``tensor`` coordinates, the ranks of an ``expert`` or ``tensor`` group
    holding the same rows. Its ranks are in the mesh's order (data, fsdp,
    seq), which ``parallel.moe.token_order`` reads. One batch axis above 1
    (or none: a group of one rank) gives that axis's group; several give
    the default group when the mesh is the world and has no other axis
    above 1, else a group made once for the mesh (:func:`_regroup`: under
    ``expert`` the mesh's order, data, fsdp, expert, seq, puts ``expert``
    between ``fsdp`` and ``seq``)."""
    sizes = axis_sizes(mesh)
    batch = [name for name in sizes if name in TOKEN_AXES]
    big = [name for name in batch if sizes[name] > 1]
    if len(big) == 1 or (not big and batch):
        return mesh.get_group((big or batch)[0])
    if (len(big) == sum(size > 1 for size in sizes.values())
            and mesh.size() == dist.get_world_size()):
        return dist.group.WORLD
    group = getattr(mesh, "_batch_group", None)
    if group is None:
        group = _regroup(mesh, {"batch": batch}).get_group("batch")
        mesh._batch_group = group
    return group


@dataclass(frozen=True)
class TensorSplit:
    """How a parameter is split over the mesh axis ``axis`` (``tensor`` or
    ``expert``): its dim ``dim`` is made of ``outer`` blocks (the fused
    ``qkv`` rows: q, k and v), each cut into as many equal pieces as the
    axis's group has ranks, and rank i keeps piece i of every block, in
    order (:class:`VocabSplit` pads the dim first). A module's rule names
    its splits without the axis; :func:`split_over_tensor` records the
    axis it ran them over."""

    dim: int
    outer: int = 1
    axis: str = TENSOR_AXIS

    def local(self, whole: torch.Tensor, index: int,
              count: int) -> torch.Tensor:
        """Rank ``index``'s piece of ``whole`` among ``count`` ranks."""
        n = whole.shape[self.dim]
        blocks = whole.unflatten(
            self.dim, (self.outer, count, n // (self.outer * count)))
        return blocks.select(self.dim + 1, index).flatten(
            self.dim, self.dim + 1)

    def whole(self, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from every rank's piece, in rank order."""
        blocks = [p.unflatten(self.dim, (self.outer, -1)) for p in pieces]
        return torch.stack(blocks, self.dim + 1).flatten(
            self.dim, self.dim + 2)

    def whole_size(self, piece: int, count: int) -> int:
        """The whole size of dim ``dim`` from a piece's among ``count``
        ranks."""
        return piece * count


@dataclass(frozen=True)
class VocabSplit(TensorSplit):
    """The Megatron vocab-parallel split of a tied table's rows (dim 0):
    ``rows`` (the vocab V) padded with zero rows to :meth:`padded`, a
    multiple of ``multiple`` x the group's ranks, and rank i keeping the
    i-th of the equal blocks, ``padded / count`` rows from row ``i *
    padded / count`` on (a multiple of ``multiple``, so a rank's product
    is as wide a multiple as the whole padded one). The rows past V, on
    the last ranks, are zero and get no gradient. The whole tensor has V
    rows: :meth:`whole` cuts the padding off again."""

    rows: int = 0
    multiple: int = 1

    def padded(self, count: int) -> int:
        """V rounded up to a multiple of ``multiple * count``."""
        unit = self.multiple * count
        return -(-self.rows // unit) * unit

    def offset(self, index: int, count: int) -> Tuple[int, int]:
        """Rank ``index``'s first row and its count of real rows (0 to
        ``padded / count``)."""
        per = self.padded(count) // count
        lo = index * per
        return lo, max(0, min(per, self.rows - lo))

    def local(self, whole: torch.Tensor, index: int,
              count: int) -> torch.Tensor:
        per = self.padded(count) // count
        lo, real = self.offset(index, count)
        shape = list(whole.shape)
        shape[self.dim] = per
        piece = whole.new_zeros(shape)
        piece.narrow(self.dim, 0, real).copy_(
            whole.narrow(self.dim, min(lo, self.rows), real))
        return piece

    def whole(self, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(pieces), self.dim).narrow(self.dim, 0,
                                                        self.rows)

    def whole_size(self, piece: int, count: int) -> int:
        return self.rows


@dataclass
class TensorParallel:
    """A model split by :func:`split_over_tensor`: for each split axis
    above 1 (``tensor``, ``expert``) its group (``groups``), this rank's
    index in it (``index``) and its size (``size``), and ``{parameter name:
    TensorSplit}`` of the parameters it holds in pieces, each split naming
    its axis; every other parameter is whole on every rank of those
    groups."""

    groups: Dict[str, Any]
    index: Dict[str, int]
    size: Dict[str, int]
    splits: Dict[str, TensorSplit]

    def group_of(self, name: str) -> Any:
        """The group that parameter ``name`` is split over, or None when
        it is whole."""
        split = self.splits.get(name)
        return None if split is None else self.groups[split.axis]

    def take(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor of parameter ``name`` (or
        of state shaped like it); a whole parameter's as it is."""
        split = self.splits.get(name)
        if split is None:
            return whole
        return split.local(whole, self.index[split.axis],
                           self.size[split.axis])

    def gather(self, name: str, piece: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` from this rank's
        ``piece``, on every rank (a collective of the split's group: every
        rank calls it); a whole parameter's as it is."""
        split = self.splits.get(name)
        if split is None:
            return piece
        count = self.size[split.axis]
        piece = piece.contiguous()
        flat = piece.new_empty((count * piece.numel(),))
        dist.all_gather_into_tensor(flat, piece.reshape(-1),
                                    group=self.groups[split.axis])
        return split.whole(list(flat.view(count, *piece.shape)))

    def whole_shape(self, name: str, shape: Sequence[int]) -> Tuple[int, ...]:
        """The whole shape of parameter ``name`` from its piece's."""
        shape = list(shape)
        split = self.splits.get(name)
        if split is not None:
            shape[split.dim] = split.whole_size(shape[split.dim],
                                                self.size[split.axis])
        return tuple(shape)


def split_over_tensor(model: nn.Module, mesh: Any
                      ) -> Optional[TensorParallel]:
    """Each module of ``model`` that names parameters to split over an
    axis of :data:`SPLIT_RULES` of n ranks (``expert_splits(n)``,
    ``tensor_splits(n)``: ``{name relative to the module: TensorSplit}``)
    keeps this rank's piece of each, as a new plain parameter. The axes
    are taken in that order, and a parameter that ``expert`` split is not
    split again over ``tensor``: an MoE block's ``wi`` and ``wo`` keep
    their E/n experts at full width, as JAX places expert-stacked leaves
    on ``expert`` alone, and split on the FFN's width over ``tensor`` only
    when ``expert`` leaves them whole. Under ``tensor`` this is the
    Megatron layout: a block's QKV projection keeps the rows of its heads
    and ``fc_in`` its slice of the FFN's outputs (column-parallel), ``out``
    and ``fc_out`` the matching input columns (row-parallel: their partial
    products are summed over the group, :func:`reduce_from_tensor`), and
    a tied table its block of the vocab rows (:class:`VocabSplit`). Every
    rank must hold the whole values (the same seed, or the same
    checkpoint), as for :func:`distribute_parameters`. Returns the record
    of the split, also left on the model as ``tensor_parallel``; None
    without a split axis above 1."""
    sizes = axis_sizes(mesh)
    axes = [a for a in SPLIT_RULES if sizes.get(a, 1) > 1]
    if not axes:
        return None
    record = TensorParallel(
        {a: mesh.get_group(a) for a in axes},
        {a: mesh.get_local_rank(a) for a in axes},
        {a: sizes[a] for a in axes}, {})
    for axis in axes:
        count, index = record.size[axis], record.index[axis]
        for prefix, module in model.named_modules():
            rule = getattr(module, SPLIT_RULES[axis], None)
            for name, split in (rule(count) if rule is not None
                                else {}).items():
                full = f"{prefix}.{name}" if prefix else name
                if full in record.splits:
                    continue  # split over an earlier axis
                owner, _, leaf = name.rpartition(".")
                holder = module.get_submodule(owner) if owner else module
                p = getattr(holder, leaf)
                holder.register_parameter(leaf, nn.Parameter(
                    split.local(p.detach(), index, count).clone(),
                    requires_grad=p.requires_grad))
                record.splits[full] = replace(split, axis=axis)
    model.tensor_parallel = record
    return record


def tensor_parallel(model: nn.Module) -> Optional[TensorParallel]:
    """The record of :func:`split_over_tensor` on ``model``, or None when
    it holds every parameter whole."""
    return getattr(model, "tensor_parallel", None)


class _CopyToTensor(torch.autograd.Function):
    """The identity forward; the gradient summed over ``group`` backward:
    the input of a column-parallel product (the QKV projection, ``fc_in``),
    whose ranks each contribute the gradient through their own pieces."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTensor(torch.autograd.Function):
    """The sum over ``group`` forward; the identity backward: the output of
    a row-parallel product (``out``, ``fc_out``), each rank's gradient that
    of the whole sum."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTensor(torch.autograd.Function):
    """Every rank's ``x [..., n]`` laid end to end on the last dim, in rank
    order, forward; this rank's own ``n`` columns of the gradient backward
    (each rank's loss of the whole output is the same, so nothing is
    summed): the output of a column-parallel product that a caller needs
    whole."""

    @staticmethod
    def forward(ctx, x, group):
        count, n = dist.get_world_size(group), x.shape[-1]
        ctx.index, ctx.n = dist.get_rank(group), n
        flat = x.new_empty((count * x.numel(),))
        dist.all_gather_into_tensor(flat, x.contiguous().reshape(-1),
                                    group=group)
        return flat.view(count, *x.shape).movedim(0, -2).reshape(
            *x.shape[:-1], count * n)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.index * ctx.n, ctx.n), None


def gather_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s last dim gathered over ``group`` (every rank's in rank
    order), its gradient this rank's own columns (the in-place
    ``torch.distributed`` all-gather); ``x`` itself when ``group`` is
    None."""
    return x if group is None else _GatherFromTensor.apply(x, group)


def copy_to_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, its gradient summed over ``group`` in the backward (the
    in-place ``torch.distributed`` call, which gloo also runs on CUDA
    tensors); ``x`` itself when ``group`` is None."""
    return x if group is None else _CopyToTensor.apply(x, group)


def reduce_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, its gradient passed through unchanged;
    ``x`` itself when ``group`` is None. Unlike ``parallel.moe``'s
    ``_SumOver``, which also sums the gradient: a replicated gradient
    summed over t ranks would count t times."""
    return x if group is None else _ReduceFromTensor.apply(x, group)


@dataclass
class DataParallel:
    """A model wrapped by :func:`data_parallel`."""

    module: nn.Module  # what a step calls: the DDP wrapper, or the model
    group: Any  # :func:`batch_group`: the batch axes' ranks
    # Parameters that FSDP2 leaves whole on every rank (those the rule
    # replicates over ``fsdp``): their gradients are this rank's, and the
    # caller averages them over ``group``.
    replicated: List[nn.Parameter]
    # The split over ``expert`` and ``tensor`` (:func:`split_over_tensor`),
    # or None.
    tensor: Optional[TensorParallel] = None


def _blocks(model: nn.Module) -> List[nn.Module]:
    """The repeated blocks of ``model``: the children of each outermost
    ``nn.ModuleList`` (transformer layers, ResNet blocks, MLP layers)."""
    blocks, outer = [], []
    for name, module in model.named_modules():
        if isinstance(module, nn.ModuleList) and not any(
                name.startswith(o + ".") for o in outer):
            outer.append(name)
            blocks.extend(module)
    return blocks


def _fsdp_mesh(mesh: Any):
    """The mesh FSDP2 shards over, built from the batch axes alone at this
    rank's ``expert`` and ``tensor`` coordinates: ``fsdp`` alone, or with
    ``data`` or ``seq`` above 1 a 2-D mesh whose first dim replicates over
    them (HSDP) and whose second is ``fsdp``. The mesh's order (data, fsdp,
    expert, seq, tensor) keeps ``data`` and ``seq`` apart, which no slice
    of it joins, so the grid is regrouped (:func:`_regroup`), and every
    rank of the world builds its groups."""
    sizes = axis_sizes(mesh)
    replicate = [a for a in (DATA_AXIS, SEQ_AXIS) if a in sizes]
    if all(sizes[a] == 1 for a in replicate):
        return mesh[FSDP_AXIS]
    regrouped = _regroup(mesh, {"replicate": replicate,
                                FSDP_AXIS: [FSDP_AXIS]})
    if regrouped.ndim == 3:  # an expert or tensor axis above 1 ahead
        return regrouped["replicate", FSDP_AXIS]
    return regrouped


def data_parallel(model: nn.Module, mesh: Any) -> DataParallel:
    """``model`` trained over a :func:`plain_axes` mesh, its parameters
    plain tensors in the model code. First, under an ``expert`` or a
    ``tensor`` axis above 1, each module keeps its pieces
    (:func:`split_over_tensor`); then:

    - no ``fsdp`` axis: ``DistributedDataParallel`` over :func:`batch_group`
      (the gradients averaged by bucketed all-reduces in the backward, as
      views of the buckets; no initial broadcast: every rank holds the same
      values, the same seed or checkpoint, as :func:`distribute_parameters`
      assumes; no buffers broadcast; every parameter used);
    - an ``fsdp`` axis (:func:`plan_for_devices` names it when it is above
      1; a mesh made from a plan that names it at 1 runs FSDP2 on one
      rank): FSDP2 ``fully_shard`` on each block
      (:func:`_blocks`) and on the root, over :func:`_fsdp_mesh` (sharded
      on ``fsdp``, replicated over ``data`` and ``seq`` where they are above
      1), each parameter (a ``tensor`` piece: the piece) split on the dim
      :func:`sharding_for_tree` gives it on ``fsdp``, and an ``expert``
      piece whole on each ``fsdp`` rank, as JAX gives expert-stacked
      leaves ``P('expert')`` alone; the parameters it replicates there stay
      plain (``ignored_params``) and are returned in ``replicated``. The
      all-gathers stay f32, as the parameters are (no mixed precision).

    Every module gets its :data:`MESH_ATTACHMENTS`: ``token_group`` (the
    MoE block) is :func:`batch_group`, so it routes over the batch axes'
    tokens, as the JAX sharded trainer does (:func:`parallel.moe.moe_ffn`);
    ``seq_mesh`` is ``mesh`` under a ``seq`` axis above 1 (else None), for
    the modules that see this rank's block of positions
    (:func:`local_positions`); ``tensor_group`` and ``expert_group`` are
    those axes' groups under a split (else None), for the modules that
    split."""
    from torch.distributed.fsdp import fully_shard
    from torch.nn.parallel import DistributedDataParallel

    split = split_over_tensor(model, mesh)
    group = batch_group(mesh)
    sizes = axis_sizes(mesh)
    groups = {} if split is None else split.groups
    attach = {"token_group": group,
              "seq_mesh": mesh if sizes.get(SEQ_AXIS, 1) > 1 else None,
              "tensor_group": groups.get(TENSOR_AXIS),
              "expert_group": groups.get(EXPERT_AXIS)}
    for module in model.modules():
        for name, value in attach.items():
            if hasattr(module, name):
                setattr(module, name, value)
    if FSDP_AXIS not in sizes:
        device = next(model.parameters()).device
        ddp = DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            process_group=group, broadcast_buffers=False, init_sync=False,
            gradient_as_bucket_view=True)
        return DataParallel(ddp, group, [], split)
    names = list(sizes)
    rule = sharding_for_tree(model, mesh)
    experts = {n for n, s in (split.splits if split else {}).items()
               if s.axis == EXPERT_AXIS}
    sharded, replicated = {}, []
    for name, p in model.named_parameters():
        placement = rule[name][names.index(FSDP_AXIS)]
        if isinstance(placement, Shard) and name not in experts:
            sharded[p] = placement
        else:
            replicated.append(p)
    kw = dict(mesh=_fsdp_mesh(mesh), shard_placement_fn=sharded.__getitem__,
              ignored_params=set(replicated))
    for block in _blocks(model):
        fully_shard(block, **kw)
    fully_shard(model, **kw)
    return DataParallel(model, group, replicated, split)


def batch_rows(mesh: Any, n_rows: int) -> slice:
    """The rows of an ``n_rows`` global batch that this rank holds under
    :func:`batch_placements`: the batch axes split it in order (``data``
    major, ``fsdp`` minor), as a ``P(("data", "fsdp"))`` batch. Raises
    ``ValueError`` when the rows do not divide."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for axis in BATCH_AXES:
        if axis in names:
            i = names.index(axis)
            index = index * mesh.shape[i] + coord[i]
            count *= mesh.shape[i]
    if n_rows % count:
        raise ValueError(
            f"a batch of {n_rows} rows does not divide over the "
            f"{count} shards of the batch axes {BATCH_AXES}"
        )
    per = n_rows // count
    return slice(index * per, (index + 1) * per)


def seq_block(mesh: Any, n_positions: int) -> slice:
    """The positions of an ``n_positions`` sequence that this rank holds
    under ``batch_placements(mesh, seq_dim=...)``: its coordinate's block on
    ``seq`` (all of them without a ``seq`` axis). Raises ``ValueError`` when
    the positions do not divide."""
    count = axis_sizes(mesh).get(SEQ_AXIS, 1)
    if n_positions % count:
        raise ValueError(
            f"a sequence of {n_positions} positions does not divide over "
            f"the {count} shards of the {SEQ_AXIS!r} axis"
        )
    per = n_positions // count
    index = mesh.get_local_rank(SEQ_AXIS) if count > 1 else 0
    return slice(index * per, (index + 1) * per)


def local_positions(mesh: Any, n_local: int) -> slice:
    """The global positions of this rank's block of ``n_local`` positions,
    a sequence split over ``seq`` of ``mesh`` in coordinate order as
    :func:`seq_block` lays it out: ``coord * n_local`` on; ``0 ..
    n_local - 1`` without a mesh (None)."""
    if mesh is None:
        return slice(0, n_local)
    return seq_block(mesh, n_local * axis_sizes(mesh).get(SEQ_AXIS, 1))


__all__ = [
    "BATCH_AXES",
    "DATA_AXIS",
    "DataParallel",
    "EXPERT_AXIS",
    "FSDP_AXIS",
    "MESH_ATTACHMENTS",
    "MeshPlan",
    "PIPE_AXIS",
    "PLAIN_AXES",
    "SEQ_AXIS",
    "SPLIT_RULES",
    "TENSOR_AXIS",
    "TOKEN_AXES",
    "TensorParallel",
    "TensorSplit",
    "VocabSplit",
    "axis_sizes",
    "batch_group",
    "batch_placements",
    "batch_rows",
    "copy_to_tensor",
    "data_parallel",
    "distribute_parameters",
    "expert_stacked",
    "features_dims",
    "gather_from_tensor",
    "group_devices_by_slice",
    "hybrid_grid",
    "hybrid_mesh_for_slices",
    "local_positions",
    "make_mesh",
    "mesh_for_devices",
    "mesh_for_slice",
    "on_local_rows",
    "on_own_rows",
    "placements_for_shape",
    "placements_from_spec",
    "plain_axes",
    "plan_for_devices",
    "rank_grid",
    "reduce_from_tensor",
    "regrid",
    "regrow",
    "replan",
    "seq_block",
    "sharding_for_tree",
    "spec_for_shape",
    "split_over_tensor",
    "tensor_parallel",
    "world_ranks",
]
