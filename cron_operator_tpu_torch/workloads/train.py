"""Training harness of the port, as in ``cron_operator_tpu/workloads/train.py``.

An optimizer step is the forward, the loss, the backward (through the
Hopper flash kernels K1-K3 when attention runs on the card), the optional
global-norm clip and the optimizer update, on one device, or over a device
mesh (``Trainer(..., mesh=...)``, a ``DeviceMesh`` from
:mod:`parallel.mesh` over a process group of one rank per device), as the
JAX ``Trainer`` jits it over its mesh.

Under a mesh each rank draws or receives the same global batch and keeps
its part (:func:`workloads.data.local_rows`: the rows split over ``data``
then ``fsdp``, and with ``TrainConfig.seq_dim_in_batch`` that dim's block
over ``seq``, for ``y`` too under ``labels_follow_seq``), so a sharded run
sees exactly the one-process batch; the ranks of a ``tensor`` or an
``expert`` group hold the same part. The reported loss and the clip norm
are global. Two paths (:func:`parallel.mesh.plain_axes`):

- a mesh whose axes above 1 are among ``data``, ``fsdp``, ``seq`` and
  ``expert``, and ``tensor`` for a model that splits its blocks (GPT,
  BERT, ViT, MLP, ResNet), trains the plain module under
  ``DistributedDataParallel`` or FSDP2 over the batch axes
  (:func:`parallel.mesh.data_parallel`, which first splits the MoE
  blocks' experts over ``expert`` and the blocks' heads and FFN, the
  MLP's first pair of hidden layers and each ResNet block's first two
  convs over ``tensor``, and hands the modules their groups and the
  mesh): the batch is each rank's part as plain tensors,
  the loss an all-reduce of the ranks' means over the batch group on the
  device (every rank holds as many tokens), and the parameters that FSDP2
  leaves whole have their gradients averaged here; the parameters that
  stay whole across ``tensor`` and ``expert`` get equal gradients on
  every rank of those groups by construction, and the clip sums the
  squares of the split ones over the group of their split. It runs as on
  one card: staging, a
  fused ``capturable`` optimizer with a device learning rate, and on an
  NCCL group the step captured as a CUDA graph with the collectives inside
  it (the ring's hops, Ulysses' all-to-alls, the experts' all-gathers
  and the ``tensor`` pairs' all-reduces too), after ``MESH_GRAPH_WARMUP``
  eager steps. A gloo collective cannot
  be captured, so a gloo group runs its steps eagerly.
- a mesh with ``pipe`` above 1 (or ``tensor`` for a model that does not
  split) places the parameters and the whole optimizer state as DTensors
  (:func:`parallel.mesh.sharding_for_tree`), and each rank's batch as a
  DTensor laid out as above; DTensor's propagation places the collectives
  (attention runs on local blocks, see :mod:`ops.attention`). It runs its
  steps eagerly: no CUDA graph, no staging thread, and the optimizer
  without ``capturable``, its learning rate a float.

A save gathers every tensor
whole on every rank (the ``tensor`` and ``expert`` pieces over their
groups) and rank 0 alone writes it; a restore places each tensor of the
(full-tensor) checkpoint as the live one is placed, a piece cut from it
first, so a
checkpoint saved at one world size or mesh resumes at another
(:meth:`workloads.checkpoint.CheckpointStore.restore_resharded`). Every
rank reads the store itself, so the ranks must share it: the constructor
raises on every rank when they restored different steps.

Multi-step dispatch (``TrainConfig.steps_per_call``): the JAX package scans
K steps inside one program. On the card the port captures ONE step as a
CUDA graph (:class:`parallel.overlap.StepGraph`) and replays it K times per
call; on the CPU a call runs its K steps eagerly. A call of one step is the
eager step. The math and the data stream are those of one step per call:
step i of a call takes the batch it would have taken as a call of its own,
and the learning rate of its own step count.

On the card the optimizer is always fused (AdamW with ``capturable=True``)
and its learning rate is a device tensor, filled from :meth:`TrainConfig.
lr_at` before each step, so that an eager step and a replayed one run the
same arithmetic. The first step of a run's first multi-step call runs
eagerly as the graph's warm-up (the kernels' build, the cuBLAS handles and
the optimizer's state come to exist there) and consumes its batch; the
capture after it runs nothing. So the first call's wall time, which the
JAX package reports as its compile time, holds the kernels' build (unless
prebuilt), the warm-up and the capture.

The optimizer follows optax: AdamW with its defaults (b1 0.9, b2 0.999, eps
1e-8) and ``TrainConfig.weight_decay``, or SGD with momentum 0.9; the
learning rate is evaluated at the optimizer's pre-increment step count, as
optax's schedules are; ``decay_mask`` selects parameters by the rank of
their flax shape; the clip is ``optax.clip_by_global_norm`` (no epsilon
added to the norm, unlike ``torch.nn.utils.clip_grad_norm_``).

Checkpoints (``Trainer(..., checkpoint=store)``, a
:class:`workloads.checkpoint.CheckpointStore`): the constructor restores
the newest step before any step, warm-up or capture, so that a captured
step holds the restored tensors' addresses (a load copies into the live
tensors; the optimizer's state is built by ``load_state_dict`` before the
first step creates any). A call whose steps cross a ``save_every``
multiple ends with a save: the parameters, the optimizer's whole state
(fused AdamW's device ``step`` tensors too), the step count and the fused
data generator's state are copied to the host in stream order after the
call's last step, and the copy is waited for before the next call is
enqueued; the store writes it from a thread of its own. ``run`` cuts its
calls at ``save_every`` multiples so that a save lands on its step. After a
resume, fused data continues its stream where it stopped (the restored
generator state), as the JAX package's ``fold_in(data_seed, step)`` does;
``data=device`` and ``data=host`` streams start again from their first
batch, as the JAX package's do.

:meth:`Trainer.flops_per_step` counts a step's model FLOPs once, on the
``meta`` device (see its docstring), for the ``mfu`` and
``flops_accounting`` params.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint

from cron_operator_tpu_torch.models.convert import flax_rank
from cron_operator_tpu_torch.ops.attention import count_attention_flops
from cron_operator_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    MESH_ATTACHMENTS,
    SEQ_AXIS,
    axis_sizes,
    batch_placements,
    data_parallel,
    distribute_parameters,
    plain_axes,
)
from cron_operator_tpu_torch.parallel.overlap import StepGraph, chunk_schedule
from cron_operator_tpu_torch.workloads.checkpoint import Piece, place_like
from cron_operator_tpu_torch.workloads.data import (
    ChunkStager,
    Prefetcher,
    grouped,
    local_rows,
)

ADAM_BETAS = (0.9, 0.999)  # optax.adamw's b1, b2
ADAM_EPS = 1e-8  # optax.adamw's eps (eps_root 0)
SGD_MOMENTUM = 0.9
# steps_per_call="auto": steps per call, or save_every when a checkpoint
# store is set and save_every is smaller (the JAX package's _AUTO_MAX_CHUNK)
AUTO_STEPS_PER_CALL = 8
# Eager steps before a meshed step is captured over NCCL (StepGraph's
# warmup): DistributedDataParallel rebuilds its buckets after its first
# step and times its first 10 iterations with CUDA events that it reads
# back at the next forward (``set_runtime_stats_and_log``), which a capture
# refuses. Under torch 2.11 DDP captures after 11 and not after 1, 2, 3, 6
# or 10; FSDP2 after 1 (hack/torch_graph_warmup_probe.py). Both take 11.
MESH_GRAPH_WARMUP = 11


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; labels are int classes, any leading dims."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


@dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    optimizer: str = "adamw"  # adamw | sgd
    # "constant", "cosine" (to 0 over schedule_steps) or "warmup_cosine"
    # (linear 0 -> lr over warmup_steps, then cosine to 0 at schedule_steps)
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    schedule_steps: int = 0
    grad_clip_norm: float = 0.0  # global-norm clip before the optimizer; 0 off
    # AdamW weight decay only on parameters whose flax shape has rank >= 2
    decay_mask: bool = False
    remat: bool = False  # recompute the forward in the backward
    seq_dim_in_batch: Optional[int] = None  # dim of x split over `seq`
    labels_follow_seq: bool = False  # labels carry the seq dim too (LM, MLM)
    sync_every: int = 1  # fetch the loss (a device sync) every N steps
    save_every: int = 0  # checkpoint cadence in steps (0 = never)
    # The model returns (output, aux); the scalar aux (the MoE router balance
    # loss, already weighted by the model) is added to the task loss.
    aux_loss_in_output: bool = False
    # Batches placed ahead on the device by a background thread (0 = off).
    prefetch: int = 0
    # Seed of the generator that fused data (Trainer sample_fn) draws from.
    data_seed: int = 0
    # Optimizer steps per call, or "auto" (AUTO_STEPS_PER_CALL). A stop
    # request lands between calls, so a run may go up to K-1 steps past it.
    steps_per_call: Union[int, str] = 1
    # Stage external batches (or chunks) from a background thread, two
    # ahead; prefetch > 0 sets the depth, False stages inline.
    stage_async: bool = True

    def lr_at(self) -> Callable[[int], float]:
        """The learning rate as a function of the optimizer's step count,
        value for value the optax schedule the JAX package builds."""
        lr = self.learning_rate
        if self.lr_schedule == "constant":
            return lambda count: lr
        if self.lr_schedule not in ("cosine", "warmup_cosine"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if self.schedule_steps <= 0:
            raise ValueError(
                f"lr_schedule={self.lr_schedule!r} needs schedule_steps > 0"
            )

        def cosine(peak: float, decay_steps: int):
            if decay_steps <= 0:
                raise ValueError(
                    f"the cosine decay needs positive decay steps, got "
                    f"{decay_steps}"
                )

            def at(count):
                count = min(count, decay_steps)
                return peak * 0.5 * (1 + math.cos(math.pi * count / decay_steps))
            return at

        if self.lr_schedule == "cosine":
            return cosine(lr, self.schedule_steps)
        # optax.warmup_cosine_decay_schedule(0, lr, max(1, warmup),
        # max(warmup + 1, schedule_steps)): a linear ramp joined to a cosine
        # that starts at the boundary.
        warmup = max(1, self.warmup_steps)
        decay = cosine(lr, max(self.warmup_steps + 1, self.schedule_steps)
                       - warmup)

        def at(count):
            if count < warmup:
                return lr * min(max(count, 0), warmup) / warmup
            return decay(count - warmup)
        return at

    def make_optimizer(self, model: nn.Module,
                       placed: Optional[bool] = None) -> torch.optim.Optimizer:
        """optax's ``adamw`` (masked by flax rank when ``decay_mask``) or
        ``sgd(momentum=0.9)`` over ``model``'s parameters. On the card it is
        fused (AdamW also ``capturable``) and its learning rate is one f32
        device tensor that every parameter group shares; on the CPU a float.
        Over ``placed`` parameters (the DTensor path of a mesh; default:
        whether the first parameter is a DTensor) it is not ``capturable``
        and its learning rate is a float, since the steps run eagerly;
        AdamW stays fused on the card (the fused kernel takes DTensors) and
        SGD, and AdamW on the CPU, take the foreach implementation. FSDP2's
        sharded parameters are DTensors but not ``placed``: that path runs
        as one card's. The Trainer sets the learning rate before each
        step."""
        if self.decay_mask and self.optimizer != "adamw":
            raise ValueError(
                "decay_mask requires the adamw optimizer "
                f"(got {self.optimizer!r})"
            )
        params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        if placed is None:
            placed = bool(params) and isinstance(params[0][1], DTensor)
        is_cuda = bool(params) and params[0][1].is_cuda
        on_card = is_cuda and not placed  # capturable, a device lr
        lr = (torch.tensor(self.learning_rate, dtype=torch.float32,
                           device=params[0][1].device)
              if on_card else self.learning_rate)
        if self.optimizer == "adamw":
            if self.decay_mask:
                groups = [
                    {"params": [p for n, p in params if flax_rank(n, p) >= 2]},
                    {"params": [p for n, p in params if flax_rank(n, p) < 2],
                     "weight_decay": 0.0},
                ]
                groups = [g for g in groups if g["params"]]
            else:
                groups = [{"params": [p for _, p in params]}]
            return torch.optim.AdamW(
                groups, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                weight_decay=self.weight_decay, fused=is_cuda or None,
                capturable=on_card, foreach=(placed and not is_cuda) or None,
            )
        if self.optimizer == "sgd":
            return torch.optim.SGD(
                [p for _, p in params], lr=lr, momentum=SGD_MOMENTUM,
                fused=on_card or None, foreach=placed or None,
            )
        raise ValueError(f"unknown optimizer {self.optimizer!r}")


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a partial sum reduced) on every rank; a
    plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _same_step_on_every_rank(step: Optional[int]) -> None:
    """Raises on every rank unless every rank restored the same step (None:
    no checkpoint). Each rank reads its own view of the store (a node-local
    root differs between nodes), and the shards of a placed state must all
    come from one state."""
    steps: List[Optional[int]] = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(steps, step)
    if len(set(steps)) > 1:
        raise RuntimeError(
            f"the ranks restored different checkpoint steps {steps} (by "
            "rank; None: no checkpoint): every rank must read the same "
            "store")


def _average_(grads: List[torch.Tensor], group) -> None:
    """Each of ``grads`` (this rank's, whole) replaced by its mean over
    ``group``'s ranks, in one all-reduce of their concatenation."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _mean_over(value: torch.Tensor, group) -> torch.Tensor:
    """``value``'s mean over ``group``'s ranks, in place: NCCL's average
    (one collective, a kernel even at one rank), or gloo's sum, which has
    no average, divided by the ranks."""
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(value, op=dist.ReduceOp.AVG, group=group)
        return value
    dist.all_reduce(value, group=group)
    return value.div_(dist.get_world_size(group))


@contextlib.contextmanager
def _cudnn_deterministic(on: bool):
    """The block run on cuDNN's deterministic kernels when ``on``
    (``torch.backends.cudnn.deterministic``, the process's own value
    restored after it); nothing changed otherwise. A captured step keeps
    the kernels it was captured with."""
    if not on:
        yield
        return
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


@contextlib.contextmanager
def _as_one_device(model: nn.Module):
    """``model`` as one device runs it, for the block's duration: every
    module without its forward hooks (FSDP2's all-gathers) and without its
    mesh attachments (``parallel.mesh.MESH_ATTACHMENTS``: the MoE block's
    routing over the ranks, a block of positions over ``seq``)."""
    saved = [(m, m._forward_pre_hooks, m._forward_hooks,
              {a: getattr(m, a) for a in MESH_ATTACHMENTS
               if getattr(m, a, None) is not None})
             for m in model.modules()]
    for m, _, _, attached in saved:
        m._forward_pre_hooks, m._forward_hooks = OrderedDict(), OrderedDict()
        for name in attached:
            setattr(m, name, None)
    try:
        yield
    finally:
        for m, pre, post, attached in saved:
            m._forward_pre_hooks, m._forward_hooks = pre, post
            for name, value in attached.items():
                setattr(m, name, value)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                          groups: Optional[List[Any]] = None) -> None:
    """``optax.clip_by_global_norm`` in place: when the global norm reaches
    ``max_norm``, every gradient is scaled by ``max_norm / norm``. No
    epsilon is added to the norm (``clip_grad_norm_`` adds 1e-6), and the
    decision stays on the device. A sharded gradient's norm is reduced over
    its shards, so the norm is the global one on every rank. ``groups``
    (one entry a gradient) names the group (``tensor`` or ``expert``) whose
    ranks hold the pieces of a split parameter's gradient: the squares of
    each group's pieces are summed over it, and a gradient whose entry is
    None, whole on every rank of those groups, counts once."""
    norms = [_whole(torch.linalg.vector_norm(g.float())) for g in grads]
    if groups is None:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        squares: Dict[Any, torch.Tensor] = {}  # by group, first seen first
        for n, group in zip(norms, groups):
            squares[group] = squares.get(group, n.new_zeros(())) + n.square()
        total = squares.pop(None, norms[0].new_zeros(()))
        for group, split in squares.items():
            dist.all_reduce(split, group=group)
            total = total + split
        norm = torch.sqrt(total)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))


@dataclass
class StepStats:
    step: int
    loss: Optional[float]  # None on async (non-synced) steps
    step_time_s: float  # per step: the call's wall / chunk
    chunk: int = 1  # optimizer steps this call carried
    # Phase walls of the call, in seconds: data = putting the batches on
    # the device (or waiting for the stager), dispatch = enqueueing the
    # steps, sync = waiting for the loss (0.0 on async calls), ckpt = the
    # checkpoint stall (the copy to the host, and the wait for the previous
    # save's write; not in step_time_s).
    data_s: float = 0.0
    dispatch_s: float = 0.0
    sync_s: float = 0.0
    ckpt_s: float = 0.0
    compiled: bool = False  # the first call (kernel build, warm-up, capture)


class _Placed(dict):
    """A batch on the trainer's device. ``ready`` is the event that its
    copies from pinned host memory recorded on the copy stream, or None
    when it was placed in the stream order of its user."""

    ready: Optional[torch.cuda.Event] = None

    def wait(self, device: torch.device) -> "_Placed":
        """Orders ``device``'s current stream after the batch's copies, and
        ties its memory to that stream, so that the copy stream's allocator
        reuses it only after the step that reads it."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(self.ready)
            for t in self.values():
                t.record_stream(stream)
            self.ready = None
        return self


class Trainer:
    """Owns a model, its optimizer and the step loop.

    ``model(x)`` gives the output ``loss_fn(output, y)`` reads (or, under
    ``config.aux_loss_in_output``, that output and an aux loss to add). The
    model's parameters stay where they are; batches go to their device.

    ``sample_fn`` (``generator -> batch``, e.g. ``data.token_sample``)
    switches to fused data: every step draws its own batch inside the step,
    from a generator on the model's device seeded with
    ``config.data_seed``, and ``run`` takes empty batches
    (``itertools.repeat({})``).

    ``checkpoint`` (a ``CheckpointStore``) restores the newest saved step
    here, before anything runs, and saves every ``config.save_every``
    steps (see the module docstring).

    ``mesh`` (a ``DeviceMesh``) wraps the model here
    (:func:`parallel.mesh.data_parallel`: the plain path, which an
    ``expert`` mesh takes for every model and a ``tensor`` mesh for GPT,
    BERT and ViT) or places its parameters
    (:func:`parallel.mesh.distribute_parameters`), and trains over it (see
    the module docstring); None trains on one device. ``self.model`` stays
    the model itself, whose state dict, gathered whole, a checkpoint
    holds.
    """

    def __init__(
        self,
        model: nn.Module,
        config: Optional[TrainConfig] = None,
        loss_fn: Callable[[Any, torch.Tensor], torch.Tensor] = cross_entropy_loss,
        sample_fn: Optional[Callable[[torch.Generator],
                                     Dict[str, torch.Tensor]]] = None,
        checkpoint: Optional[Any] = None,
        mesh: Optional[Any] = None,
    ):
        self.mesh = mesh
        self.config = config or TrainConfig()
        self.device = next(model.parameters()).device
        # The plain data-parallel path: what a step calls, the batch axes'
        # group, the parameters whose gradients are averaged here, and the
        # split over expert and tensor (parallel.mesh.TensorParallel, or
        # None).
        self._plain = mesh is not None and plain_axes(mesh, model)
        self._forward: nn.Module = model
        self._group = None
        self._replicated: List[nn.Parameter] = []
        self._tensor = None
        self._deterministic = False  # cuDNN held deterministic in a step
        # The plain path's steps run on a stream of their own on the card,
        # the one DDP is built on: DDP keeps the parameters' gradient
        # accumulators, which carry the stream they were made on, and a
        # backward whose accumulators are on another stream (the default
        # one) syncs with it, which a capture refuses.
        self._stream = (torch.cuda.Stream(self.device)
                        if self._plain and self.device.type == "cuda"
                        else None)
        if self._plain:
            with self._on_stream():
                wrapped = data_parallel(model, mesh)
            self._forward = wrapped.module
            self._group = wrapped.group
            self._replicated = wrapped.replicated
            self._tensor = wrapped.tensor
            self._deterministic = wrapped.deterministic
        elif mesh is not None:
            distribute_parameters(model, mesh)
        # Rank 0 alone writes checkpoints; every rank gathers them.
        self._writes = mesh is None or mesh.get_rank() == 0
        self.model = model
        self.loss_fn = loss_fn
        self.sample_fn = sample_fn
        self.checkpoint = checkpoint
        spc = self.config.steps_per_call
        if not (spc == "auto" or isinstance(spc, int)):
            raise ValueError(
                f"steps_per_call must be an int or 'auto' (got {spc!r})"
            )
        self.optimizer = self.config.make_optimizer(
            model, placed=mesh is not None and not self._plain)
        lr = self.optimizer.param_groups[0]["lr"]
        self._lr = lr if torch.is_tensor(lr) else None  # the card's
        self._lr_at = self.config.lr_at()
        self._data_gen = (
            torch.Generator(device=self.device).manual_seed(
                self.config.data_seed)
            if sample_fn is not None else None
        )
        on_card = self.device.type == "cuda" and (mesh is None or self._plain)
        self._copy_stream = torch.cuda.Stream(self.device) if on_card else None
        # A call of several steps replays a captured step: on one card, or
        # on the plain path over NCCL after MESH_GRAPH_WARMUP eager steps.
        self._captures = on_card and (
            mesh is None or dist.get_backend(self._group) == "nccl")
        self._graph: Optional[StepGraph] = None
        self.steps_done = 0
        if checkpoint is not None:
            # Resume before any step, warm-up or capture, falling back past
            # unreadable steps as the JAX package's store does.
            restored = (checkpoint.restore_latest(
                like={"params": self._params_like()})
                if checkpoint.latest_step() is not None else None)
            if mesh is not None:
                _same_step_on_every_rank(
                    None if restored is None else restored[0])
            if restored is not None:
                self.load_state(restored[1])
        # Shapes and dtypes of one step's batch, noted at the first step
        # (flops_per_step's input), and the count, made once.
        self._batch_struct: Optional[Dict[str, Any]] = None
        self._flops_per_step: Optional[float] = None
        self._flops_counted = False
        # Wall time of the first call (see the module docstring).
        self.first_dispatch_time_s: Optional[float] = None

    @property
    def replayed_steps(self) -> int:
        """Steps run as replays of the captured step graph so far."""
        return 0 if self._graph is None else self._graph.replays

    @property
    def resolved_steps_per_call(self) -> int:
        """``config.steps_per_call`` with ``"auto"`` resolved: calls of
        ``min(8, save_every)`` steps when checkpointing (``run`` cuts calls
        at save_every multiples, so a longer call would only fragment into
        the same pieces), 8 otherwise."""
        spc = self.config.steps_per_call
        if spc == "auto":
            se = self.config.save_every
            spc = (min(AUTO_STEPS_PER_CALL, se)
                   if self.checkpoint is not None and se > 0
                   else AUTO_STEPS_PER_CALL)
        return max(1, int(spc))

    def host_state(self) -> Dict[str, Any]:
        """The trainer's state as host tensors and plain values, what a save
        writes: ``params`` (the model's state dict), ``optimizer`` (its whole
        state dict; the learning rate, which the trainer sets before every
        step, as a float), ``step`` and ``data_gen`` (the fused data
        generator's state, or None). Card tensors are copied into pinned
        memory in the current stream's order, after every step enqueued so
        far, and the copies are waited for here, so that the next step
        cannot overwrite them. Under a mesh every rank gathers each tensor
        whole (a collective: every rank calls this), a ``tensor`` or
        ``expert`` piece over its group, and the state is the one-device
        state."""
        opt = self.optimizer.state_dict()
        opt["param_groups"] = [
            {**g, "lr": float(g["lr"])} for g in opt["param_groups"]]
        names = self._param_names()
        opt["state"] = {i: {k: self._gathered(names[int(i)], v)
                            for k, v in entry.items()}
                        for i, entry in opt["state"].items()}
        params = {k: self._gathered(k, v)
                  for k, v in self.model.state_dict().items()}
        state = {
            "params": _to_host(params),
            "optimizer": _to_host(opt),
            "step": self.steps_done,
            "data_gen": (self._data_gen.get_state()
                         if self._data_gen is not None else None),
        }
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return state

    def load_state(self, state: Dict[str, Any]) -> None:
        """Loads a :meth:`host_state` into the live model (copied into its
        tensors), the optimizer and the data generator, and sets
        ``steps_done``. Only before the step is captured: a captured step
        holds the addresses of the optimizer state, which the load builds
        anew. Under a mesh the state's whole tensors are placed as the live
        ones are (:meth:`_placed_like`), whatever world size saved them."""
        if self._graph is not None:
            raise RuntimeError("load_state after the step graph's capture")
        if self.mesh is not None:
            state = place_like(state, self._placed_like(state))
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
        lr = self._lr if self._lr is not None else self.config.learning_rate
        for group in self.optimizer.param_groups:
            group["lr"] = lr  # the card's shared lr tensor, as at creation
        if self._data_gen is not None and state.get("data_gen") is not None:
            self._data_gen.set_state(state["data_gen"])
        self.steps_done = int(state["step"])

    def _placed_like(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The placements a restored state takes under the mesh, as a
        ``like`` of :func:`workloads.checkpoint.place_like`: the parameters
        as the live ones (:meth:`_params_like`), and each optimizer state
        tensor shaped like its parameter's whole as that parameter (the
        optimizer's state mirrors it, as the JAX ``sharding_for_tree``
        places it); scalars (a step count) stay as they are."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        names = self._param_names()
        opt_like = {}
        for i, entry in state["optimizer"].get("state", {}).items():
            p, name = params[int(i)], names[int(i)]
            like = self._like(name, p)
            opt_like[i] = {k: like for k, v in entry.items()
                           if torch.is_tensor(v) and v.ndim
                           and tuple(v.shape) == self._whole_shape(name, p)}
        return {"params": self._params_like(),
                "optimizer": {"state": opt_like}}

    def _param_names(self) -> List[str]:
        """The parameters' names in the optimizer's order (its state
        dict's indices)."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for g in self.optimizer.param_groups
                for p in g["params"]]

    def _whole_shape(self, name: str, t: torch.Tensor) -> tuple:
        """The whole shape of parameter ``name`` (or state shaped like
        it), held as ``t``: a ``tensor`` or ``expert`` piece's whole."""
        if self._tensor is None:
            return tuple(t.shape)
        return self._tensor.whole_shape(name, t.shape)

    def _like(self, name: str, t: torch.Tensor) -> Any:
        """The ``like`` of parameter ``name`` (or state shaped like it),
        held as ``t``: ``t``, or for a ``tensor`` or ``expert`` piece a
        :class:`workloads.checkpoint.Piece` that cuts it from the whole."""
        if self._tensor is None or name not in self._tensor.splits:
            return t
        return Piece(t, self._whole_shape(name, t),
                     lambda whole: self._tensor.take(name, whole))

    def _params_like(self) -> Dict[str, Any]:
        """The model's state dict as a ``like`` (:meth:`_like`)."""
        return {n: self._like(n, t) for n, t in self.model.state_dict().items()}

    def _gathered(self, name: str, t: Any) -> Any:
        """``t`` (parameter ``name``, or state shaped like it) whole over
        its split's group (``tensor`` or ``expert``) when it is a piece (a
        collective of the group), else as it is."""
        if (self._tensor is None or name not in self._tensor.splits
                or not torch.is_tensor(t) or t.shape
                != self.model.get_parameter(name).shape):
            return t  # whole, or a scalar of the state (a step count)
        return self._tensor.gather(name, _whole(t.detach()))

    def flops_per_step(self) -> Optional[float]:
        """Model FLOPs of one optimizer step at the batch shapes trained:
        the forward and backward of the loss, counted once and lazily (None
        before the first step, or when the count fails).

        The count runs on the ``meta`` device, on meta copies of the
        parameters (``torch.func.functional_call``), so that it touches
        neither the live gradients nor the optimizer state that a captured
        step reads, and moves no data: ``FlopCounterMode`` counts the
        matmuls and convolutions, and attention, which reaches the hand
        kernels (invisible to ``FlopCounterMode``) on the card and full
        s x s products on the CPU, is counted by one formula on every
        device (:func:`ops.attention.count_attention_flops`). Neither
        ``remat``'s recompute nor the P that the backward kernels recompute
        is counted, nor the optimizer's elementwise update; the chunked
        cross-entropy's backward, which recomputes its logits with aten
        matmuls, is. On the plain meshed path the model is counted as one
        device runs it (no hooks, no mesh attachments), at the global
        batch's shapes (:meth:`_global_shape`), with every parameter whole
        (a ``tensor`` or ``expert`` piece at its whole shape), as the JAX
        package counts its program."""
        if self._flops_counted or self._batch_struct is None:
            return self._flops_per_step
        self._flops_counted = True
        try:
            meta = {  # whole shapes: a step's FLOPs over the mesh
                name: torch.empty(self._whole_shape(name, t), dtype=t.dtype,
                                  device="meta").requires_grad_(
                    t.requires_grad)
                for name, t in itertools.chain(self.model.named_parameters(),
                                               self.model.named_buffers())
            }
            batch = {k: torch.empty(shape, dtype=dtype, device="meta")
                     for k, (shape, dtype) in self._batch_struct.items()}
            from torch.func import functional_call
            from torch.utils.flop_counter import FlopCounterMode

            one_device = (_as_one_device(self.model) if self._plain
                          else contextlib.nullcontext())
            with FlopCounterMode(display=False) as counter, \
                    count_attention_flops() as attention, one_device:
                out = functional_call(self.model, meta, (batch["x"],))
                self._objective(out, batch["y"]).backward()
            flops = counter.get_total_flops() + attention.flops
            self._flops_per_step = float(flops) if flops else None
        except Exception:  # noqa: BLE001 -- a diagnostic must not fail
            self._flops_per_step = None  # the training run
        return self._flops_per_step

    def put_batch(self, batch: Dict[str, Any]) -> _Placed:
        """``batch`` on the trainer's device. On the card, host arrays go
        through pinned memory and are copied on the trainer's copy stream
        (the step waits for them, :meth:`_Placed.wait`); tensors already on
        the card pass as they are. This is the Prefetcher's ``place``: it
        runs on the staging thread. Under a mesh each value is the global
        batch, of which this rank keeps its part (:meth:`_seq_dim`): plain
        on the plain path, else a DTensor laid out by
        :func:`parallel.mesh.batch_placements`."""
        if isinstance(batch, _Placed):
            return batch
        if self.mesh is not None and not self._plain:
            return _Placed({k: v if isinstance(v, DTensor) else self._local(
                k, torch.as_tensor(v)) for k, v in batch.items()})
        placed = _Placed()
        host = {}
        for k, v in batch.items():
            if self._plain:
                v = local_rows(torch.as_tensor(v), self.mesh,
                               self._seq_dim(k))
            if torch.is_tensor(v) and v.device == self.device:
                placed[k] = v
            else:
                host[k] = torch.as_tensor(v)
        if not host:
            return placed
        if self._copy_stream is None:
            placed.update({k: v.to(self.device) for k, v in host.items()})
            return placed
        with torch.cuda.stream(self._copy_stream):
            for k, v in host.items():
                placed[k] = v.pin_memory().to(self.device, non_blocking=True)
            placed.ready = torch.cuda.Event()
            placed.ready.record(self._copy_stream)
        return placed

    def _seq_dim(self, key: str) -> Optional[int]:
        """The dim of the batch value ``key`` split over ``seq``: the
        ``seq_dim_in_batch`` dim for ``x`` (for ``y`` too under
        ``labels_follow_seq``), the JAX Trainer's batch shardings; None for
        a value split by rows alone."""
        cfg = self.config
        if key != "y" or cfg.labels_follow_seq:
            return cfg.seq_dim_in_batch
        return None

    def _local(self, key: str, value: torch.Tensor) -> DTensor:
        """This rank's block of the global batch value ``key`` as a DTensor
        laid out by :func:`parallel.mesh.batch_placements`: rows over the
        batch axes, and the :meth:`_seq_dim` dim over ``seq``."""
        seq_dim = self._seq_dim(key)
        return DTensor.from_local(
            local_rows(value, self.mesh, seq_dim).to(self.device), self.mesh,
            batch_placements(self.mesh, seq_dim=seq_dim), run_check=False)

    def _global_shape(self, key: str, value: torch.Tensor) -> tuple:
        """The global batch's shape of ``key`` from this rank's ``value``:
        on the plain path its rows times the batch axes' shards and its
        :meth:`_seq_dim` dim times ``seq``; a DTensor's own shape."""
        shape = list(value.shape)
        if self._plain:
            sizes = axis_sizes(self.mesh)
            for axis in BATCH_AXES:
                shape[0] *= sizes.get(axis, 1)
            dim = self._seq_dim(key)
            if dim is not None:
                shape[dim] *= sizes.get(SEQ_AXIS, 1)
        return tuple(shape)

    def put_chunk(self, group: List[Dict[str, Any]]) -> List[_Placed]:
        """K batches on the device, one call's worth: step i of the call
        takes batch i. The ChunkStager's ``place``."""
        if not group:
            raise ValueError("put_chunk needs a non-empty batch group")
        return [self.put_batch(b) for b in group]

    def _set_lr(self, count: int) -> None:
        """The learning rate at optimizer step ``count`` (optax: the
        pre-increment count): the card's tensor is filled in stream order."""
        lr = self._lr_at(count)
        if self._lr is not None:
            self._lr.fill_(lr)
        else:
            for group in self.optimizer.param_groups:
                group["lr"] = lr

    def _objective(self, out: Any, y: torch.Tensor) -> torch.Tensor:
        """The loss of the model's output: ``loss_fn``, plus the aux loss
        the model returns beside its output under ``aux_loss_in_output``."""
        if self.config.aux_loss_in_output:
            out, aux = out
            return self.loss_fn(out, y) + aux
        return self.loss_fn(out, y)

    def _loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.config.remat:
            # The models draw no random numbers in their forward, so the
            # recompute needs no saved RNG state (whose read would be a
            # host call that a CUDA graph capture refuses).
            out = checkpoint(self._forward, batch["x"], use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = self._forward(batch["x"])
        return self._objective(out, batch["y"])

    def _update(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One step, all enqueued, at the learning rate set before it:
        (the fused draw,) forward, backward, clip and optimizer step.
        Returns the loss on the device. This is what the graph captures."""
        if self.sample_fn is not None:
            batch = self.sample_fn(self._data_gen)
            if self.mesh is not None:
                batch = self.put_batch(batch)
        if self._batch_struct is None:  # the global batch's shapes
            self._batch_struct = {k: (self._global_shape(k, v), v.dtype)
                                  for k, v in batch.items()}
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(batch)
        loss.backward()
        _average_([p.grad for p in self._replicated if p.grad is not None],
                  self._group)
        if self.config.grad_clip_norm > 0:
            named = [(n, p.grad) for n, p in zip(
                self._param_names(), (p for g in self.optimizer.param_groups
                                      for p in g["params"]))
                     if p.grad is not None]
            split = self._tensor
            clip_by_global_norm_(
                [g for _, g in named], self.config.grad_clip_norm,
                None if split is None else [split.group_of(n)
                                            for n, _ in named])
        if not self._plain:
            self.optimizer.step()
            return _whole(loss.detach())
        # FSDP2's shards are DTensors and the parameters it leaves whole
        # are not: the fused update takes both as one list.
        with implicit_replication():
            self.optimizer.step()
        return _mean_over(loss.detach().clone(), self._group)

    def _steps(self, batches: List[_Placed]) -> torch.Tensor:
        """Enqueues one step per batch; returns the last one's loss. On the
        card (or the plain meshed path over NCCL) a call of more than one
        step replays the step graph, captured after the eager warm-up steps
        of the first such calls (one on one card, ``MESH_GRAPH_WARMUP`` on a
        mesh)."""
        graph = None
        if self._captures and len(batches) > 1:
            if self._graph is None:
                self._graph = StepGraph(
                    self._update,
                    generators=(() if self._data_gen is None
                                else (self._data_gen,)),
                    warmup=1 if self.mesh is None else MESH_GRAPH_WARMUP,
                    stream=self._stream,
                )
            graph = self._graph
        loss = None
        with self._on_stream(), _cudnn_deterministic(self._deterministic):
            for i, batch in enumerate(batches):
                self._set_lr(self.steps_done + i)
                batch = batch.wait(self.device)
                loss = (graph(batch) if graph is not None
                        else self._update(batch))
        return loss

    @contextlib.contextmanager
    def _on_stream(self):
        """The block on the plain path's stream, ordered after the current
        stream's work and before its later work (nothing without one)."""
        if self._stream is None:
            yield
            return
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            yield
        current.wait_stream(self._stream)

    def step(
        self,
        batch: Union[Dict[str, Any], List[Dict[str, Any]]],
        sync: bool = True,
        chunk: int = 1,
    ) -> StepStats:
        """One call of ``chunk`` optimizer steps. ``batch`` is one batch
        (fused data: ``{}``, and ``chunk`` steps each draw their own), or a
        list of batches (:meth:`put_chunk`), one per step, whose length is
        the chunk. ``step_time_s`` is per step (the call's wall / chunk);
        ``loss`` is the last step's, and ``sync=False`` leaves it on the
        device (``loss=None``) so that the caller can amortise the round
        trip (``TrainConfig.sync_every``)."""
        compiled = self.first_dispatch_time_s is None
        t0 = time.perf_counter()
        if isinstance(batch, list):
            batches = [self.put_batch(b) for b in batch]
        elif chunk > 1 and self.sample_fn is None:
            # One external batch must not stand for every step of a call:
            # a call of K steps takes K batches (put_chunk).
            raise ValueError(
                "chunk > 1 requires fused data (sample_fn): one external "
                "batch cannot feed several steps; pass a list of batches "
                "(put_chunk) instead"
            )
        else:
            batches = [self.put_batch(batch)] * max(1, chunk)
        chunk = len(batches)
        t_data = time.perf_counter()
        loss = self._steps(batches)
        t_disp = time.perf_counter()
        loss = float(loss) if sync else None
        wall = time.perf_counter() - t0
        sync_s = time.perf_counter() - t_disp if sync else 0.0
        if compiled:
            self.first_dispatch_time_s = wall
        before = self.steps_done
        self.steps_done += chunk
        ckpt_s = 0.0
        se = self.config.save_every
        if (self.checkpoint is not None and se > 0
                and self.steps_done // se > before // se):
            # The call crossed a save_every multiple: save (the host copy
            # is the stall; the store writes it to disk on its own thread).
            t_ckpt = time.perf_counter()
            state = self.host_state()
            if self._writes:
                self.checkpoint.save(self.steps_done, state)
            ckpt_s = time.perf_counter() - t_ckpt
        return StepStats(
            self.steps_done, loss, wall / chunk,
            chunk=chunk,
            data_s=t_data - t0,
            dispatch_s=t_disp - t_data,
            sync_s=sync_s,
            ckpt_s=ckpt_s,
            compiled=compiled,
        )

    @staticmethod
    def per_step_stats(s: StepStats) -> List[StepStats]:
        """A call's StepStats divided into per-step records, what ``run``
        feeds ``on_step`` so that the step timeline stays per step: the
        call's phase walls split evenly, the loss (the only one the call
        fetched) and the checkpoint stall on the last step."""
        k = s.chunk
        if k <= 1:
            return [s]
        out = []
        for i in range(k):
            last = i == k - 1
            out.append(StepStats(
                step=s.step - (k - 1 - i),
                loss=s.loss if last else None,
                step_time_s=s.step_time_s,  # already per step
                chunk=1,
                data_s=s.data_s / k,
                dispatch_s=s.dispatch_s / k,
                sync_s=s.sync_s / k,
                ckpt_s=s.ckpt_s if last else 0.0,
                compiled=s.compiled,
            ))
        return out

    def run(
        self,
        batches: Iterator[Dict[str, Any]],
        steps: int,
        should_stop: Optional[Callable[[], bool]] = None,
        on_step: Optional[Callable[[StepStats], None]] = None,
    ) -> List[StepStats]:
        """Train until ``steps_done`` reaches ``steps`` (a total-step
        target, so a restored trainer runs only the remainder), in calls of
        ``resolved_steps_per_call`` steps cut by
        :func:`parallel.overlap.chunk_schedule` so that the run never
        overshoots the target and, with a checkpoint store, no call crosses
        a ``save_every`` multiple. The store is waited for at the end.

        External batches in calls of several steps are grouped and placed
        by a background ChunkStager (chunk N+1 is on the card while chunk N
        runs); single-step calls stage batch-ahead through the Prefetcher;
        ``stage_async=False`` stages inline; fused data needs no staging.
        The first and the last call, and every call that crosses a
        ``sync_every`` multiple (counted in steps from the first), fetch the
        loss; after an early exit behind async calls the device is drained
        and the drain charged to the last call. ``on_step`` receives
        per-step stats (:meth:`per_step_stats`); the returned list holds one
        record per call."""
        se = max(1, self.config.sync_every)
        spc = self.resolved_steps_per_call
        external = self.sample_fn is None
        boundary = (self.config.save_every
                    if self.checkpoint is not None
                    and self.config.save_every > 0 else 0)
        depth = (
            self.config.prefetch if self.config.prefetch > 0
            else (2 if self.config.stage_async else 0)
        )
        if self.mesh is not None and not self._plain:
            depth = 0  # one thread issues a rank's collectives
        stager = None
        prefetcher = None
        chunks = None  # iterator of placed chunks (external multi-step)
        sched: List[int] = []
        # Lazy: a run with nothing to do must not consume and place batches.
        pending = self.steps_done < steps
        if pending and external and spc > 1:
            schedule = chunk_schedule(self.steps_done, steps, spc, boundary)
            if depth > 0:
                stager = ChunkStager(batches, schedule, self.put_chunk, depth)
                chunks = stager
            else:
                chunks = (self.put_chunk(g) for g in grouped(batches, schedule))
        elif pending and depth > 0 and (external or self.config.prefetch > 0):
            prefetcher = Prefetcher(batches, self.put_batch, depth)
            batches = prefetcher
        elif pending and not external and spc > 1:
            sched = chunk_schedule(self.steps_done, steps, spc, boundary)
        first = self.steps_done + 1
        stats: List[StepStats] = []
        try:
            while self.steps_done < steps:
                if should_stop is not None and should_stop():
                    break
                nxt = self.steps_done + 1
                placed = None
                wait_s = 0.0
                if chunks is not None:
                    t_wait = time.perf_counter()
                    placed = next(chunks)  # StopIteration: the stream ended
                    wait_s = time.perf_counter() - t_wait
                    chunk = len(placed)
                elif sched:
                    chunk = min(sched.pop(0), steps - self.steps_done)
                else:
                    chunk = min(spc, steps - self.steps_done)
                last_of_call = self.steps_done + chunk
                sync = (
                    nxt == first or last_of_call >= steps
                    or (last_of_call - first + 1) // se > (nxt - first) // se
                )
                if placed is not None:
                    s = self.step(placed, sync=sync)
                    if wait_s:
                        # The stager wait is the part of the host's data
                        # work that staging did not hide: charge it where
                        # put_batch's time would have gone.
                        s.data_s += wait_s
                        s.step_time_s += wait_s / s.chunk
                else:
                    s = self.step(next(batches), sync=sync, chunk=chunk)
                stats.append(s)
                if on_step is not None:
                    for ps in self.per_step_stats(s):
                        on_step(ps)
        finally:
            if stats and stats[-1].loss is None and self.device.type == "cuda":
                t0 = time.perf_counter()
                torch.cuda.synchronize(self.device)
                stats[-1].step_time_s += (
                    (time.perf_counter() - t0) / stats[-1].chunk
                )
            if stager is not None:
                stager.close()
            if prefetcher is not None:
                prefetcher.close()
        if self.checkpoint is not None:
            self.checkpoint.wait()
            if self.mesh is not None:
                # The other ranks return once rank 0's writes are on disk.
                torch.distributed.barrier()
        return stats


def _to_host(x: Any) -> Any:
    """``x`` (tensors in dicts, lists and tuples) with every tensor copied
    to the host: a card tensor into pinned memory, without waiting (the
    caller synchronises), a CPU tensor cloned, a DTensor gathered whole
    first."""
    if torch.is_tensor(x):
        x = _whole(x.detach())
        if x.is_cuda:
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return out.copy_(x, non_blocking=True)
        return x.clone()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


__all__ = [
    "AUTO_STEPS_PER_CALL",
    "MESH_GRAPH_WARMUP",
    "StepStats",
    "TrainConfig",
    "Trainer",
    "clip_by_global_norm_",
    "cross_entropy_loss",
]
