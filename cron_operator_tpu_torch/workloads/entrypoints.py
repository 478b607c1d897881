"""Entrypoints of the port, as in ``cron_operator_tpu/workloads/entrypoints.py``.

An entrypoint takes a job context (``params``, ``progress``, ``publish``,
``should_stop``: the port's :class:`backends.registry.JobContext` or the
JAX executor's, which has the same fields) and runs one workload, publishing
progress into ``ctx.progress``. The operator reaches them by
``module:function`` string, e.g. a ``PyTorchJob`` annotated
``tpu.kubedl.io/entrypoint:
cron_operator_tpu_torch.workloads.entrypoints:generate_job``.

Common params: ``platform`` (unset = the CUDA card; ``cpu`` on request),
``devices`` (the world size: one rank per device, ``cuda:$LOCAL_RANK``;
another count raises ``ValueError``); for training, ``steps``,
``batch_size``, ``data`` (``device`` default | ``host`` | ``fused``),
``steps_per_call`` (``auto`` default: 8 steps per call, one CUDA graph of
the step replayed per step on the card), ``prefetch``, ``stage_async``,
``lr``/``lr_schedule``/``warmup_steps``/``schedule_steps``/``grad_clip``/
``decay_mask``/``sync_every``/``save_every`` (see :func:`_train_kwargs`).
Every training job's weights come from seed 0, and besides the JAX
``_run``'s progress keys it publishes ``n_params``.

The one-card job contract of the JAX package holds: ``checkpoint=1`` saves
every ``save_every`` steps into a :class:`workloads.checkpoint.CheckpointStore`
(``checkpoint_job``, ``checkpoint_lineage``, ``checkpoint_keep``,
``checkpoint_dir``) and a re-run resumes from the newest step
(:func:`_checkpoint_store`); ``generate_job`` serves a lineage's latest
parameters (``checkpoint_from``); ``mfu=1`` publishes a rolling and a final
MFU against the card's peak (:mod:`backends.gpu`, or
``peak_flops_per_chip``), ``flops_accounting=1`` the step's FLOPs as
``xla_flops_per_step``, and ``profile_dir`` takes a ``torch.profiler``
trace of the steady-state calls (:func:`_run`). Each entrypoint registers
under the JAX package's short name (``gpt``, ``bert``, ``mnist``,
``resnet50``, ``vit``, ``generate``) for :func:`backends.registry.
resolve_entrypoint` and the port runner.

``moe_every``/``num_experts`` put Switch-MoE blocks into ``gpt`` and
``generate_job``; the other jobs ignore them, as the JAX jobs do. The
training jobs run over a device mesh when the process has a process group
(``tensor``, ``seq``, ``fsdp``, ``expert`` and ``slices`` factor its
world, ``data`` takes the rest: :func:`_train_device`);
``generate_job`` serves on each rank's card alone. ``gpt`` and ``bert``
split their sequences over ``seq`` and take ``attention=ring|ulysses``
(:mod:`parallel.ring`, :mod:`parallel.ulysses`), as the JAX jobs do; the
other training jobs refuse those attentions (``ValueError``). ``pipe > 1``
raises ``ValueError`` for good, as in the JAX package: pipelining is the
:func:`parallel.pipeline.spmd_pipeline` primitive for custom entrypoints.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from dataclasses import replace
from typing import Any, Callable, Dict, Iterator, Optional

import torch
from torch import nn

from cron_operator_tpu_torch.backends.gpu import peak_flops_per_chip
from cron_operator_tpu_torch.backends.registry import register_entrypoint
from cron_operator_tpu_torch.models.bert import Bert, BertConfig
from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
from cron_operator_tpu_torch.models.mlp import MLP
from cron_operator_tpu_torch.models.resnet import ResNet50
from cron_operator_tpu_torch.models.vit import ViT, ViTConfig
from cron_operator_tpu_torch.ops.xent import (
    chunked_cross_entropy,
    tied_cross_entropy,
)
from cron_operator_tpu_torch.parallel.mesh import (
    group_devices_by_slice,
    hybrid_mesh_for_slices,
    mesh_for_devices,
    plain_axes,
    plan_for_devices,
)
from cron_operator_tpu_torch.utils.device import resolve_device, world_size
from cron_operator_tpu_torch.workloads import data as datasets
from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
from cron_operator_tpu_torch.workloads.generate import generate
from cron_operator_tpu_torch.workloads.train import (
    StepStats,
    TrainConfig,
    Trainer,
    cross_entropy_loss,
)


def _gqa_rope_kwargs(ctx) -> dict:
    """param.kv_heads / param.rope, parsed as the JAX entrypoints do."""
    return {
        "num_kv_heads": int(ctx.params.get("kv_heads", 0)),
        "rope": ctx.params.get("rope", "0") in ("1", "true"),
    }


def _moe_kwargs(ctx) -> dict:
    """param.moe_every / param.num_experts, parsed as the JAX ``gpt`` and
    ``generate`` entrypoints do."""
    return {
        "moe_every": int(ctx.params.get("moe_every", 0)),
        "num_experts": int(ctx.params.get("num_experts", 8)),
    }


def _steps_per_call(ctx):
    """param.steps_per_call: ``"auto"`` (the default execution mode, 8
    steps per call, or save_every when checkpointing:
    ``Trainer.resolved_steps_per_call``) or an int. A profiled run
    (``param.profile_dir``) pins "auto" to 1, as the JAX package does: the
    profiler starts after the first call, and eager steps show every
    kernel."""
    raw = ctx.params.get("steps_per_call", "auto")
    if raw != "auto":
        return int(raw)
    return 1 if ctx.params.get("profile_dir") else "auto"


def _checkpoint_store(ctx) -> Optional[CheckpointStore]:
    """The job's CheckpointStore when it opts in (``param.checkpoint=1``):
    the preemption-recovery path, where the re-run of a preempted job
    resumes from the last saved step. ``checkpoint_lineage`` (``job``
    default, ``family`` to continue one run across Forbid ticks),
    ``checkpoint_job`` (another job's lineage), ``checkpoint_keep`` (steps
    retained, 3) and ``checkpoint_dir`` (the root), as in the JAX
    package."""
    if ctx.params.get("checkpoint", "0") not in ("1", "true", "yes"):
        return None
    return CheckpointStore(
        ctx.namespace or "default",
        ctx.params.get("checkpoint_job") or ctx.name,
        root=ctx.params.get("checkpoint_dir"),
        max_to_keep=int(ctx.params.get("checkpoint_keep", 3)),
        lineage=ctx.params.get("checkpoint_lineage", "job"),
    )


def _train_kwargs(ctx, steps: int, **defaults) -> dict:
    """TrainConfig kwargs: per-entrypoint defaults overridden by the common
    ``param.*`` surface, as in the JAX package: ``lr``, ``lr_schedule``
    (constant|cosine|warmup_cosine), ``warmup_steps``, ``schedule_steps``
    (default: the run's step target), ``grad_clip`` (0 = off),
    ``decay_mask``, ``save_every`` (=10: the checkpoint cadence),
    ``prefetch`` (=0), ``sync_every``, ``steps_per_call`` (="auto") and
    ``stage_async`` (="1": background staging of external batches)."""
    kw = dict(defaults)
    kw.update(
        save_every=int(ctx.params.get("save_every", 10)),
        prefetch=int(ctx.params.get("prefetch", 0)),
        sync_every=int(ctx.params.get("sync_every", 1)),
        steps_per_call=_steps_per_call(ctx),
        stage_async=ctx.params.get("stage_async", "1") in ("1", "true"),
        lr_schedule=ctx.params.get("lr_schedule", "constant"),
        warmup_steps=int(ctx.params.get("warmup_steps", 0)),
        schedule_steps=int(ctx.params.get("schedule_steps", steps)),
        grad_clip_norm=float(ctx.params.get("grad_clip", 0)),
        decay_mask=ctx.params.get("decay_mask", "0") in ("1", "true"),
    )
    if "lr" in ctx.params:
        kw["learning_rate"] = float(ctx.params["lr"])
    return kw


def _device(ctx) -> torch.device:
    """The device of this rank for the job's platform (``param.platform``):
    :func:`utils.device.resolve_device`, which holds ``param.devices`` to
    the world size (one rank per device; the JAX ``_devices`` caps one
    controller's devices instead)."""
    return resolve_device(ctx.params.get("platform"),
                          ctx.params.get("devices"))


def _train_device(ctx, sequence_parallel: bool = False):
    """``(device, mesh)`` of a training job, after the checks of the JAX
    ``_devices`` and ``_mesh``: ``param.pipe > 1`` raises ``ValueError``
    for good (the standard jobs train one step; pipelining is the
    ``spmd_pipeline`` primitive for custom entrypoints), and
    ``attention=ring|ulysses`` raises ``ValueError`` unless the job is
    ``sequence_parallel`` (``gpt``, ``bert``). The mesh factors the world
    by ``tensor``, ``seq``, ``fsdp`` and ``expert``
    (:func:`parallel.mesh.mesh_for_devices`), or with ``slices > 1``
    groups it by node (:func:`parallel.mesh.hybrid_mesh_for_slices`); one
    process without a process group trains unwrapped (mesh None: ring and
    Ulysses are then plain attention, as over the JAX job's one-device
    mesh), a process group of one rank over a one-rank mesh (the plain
    data-parallel path, as the JAX trainer always trains over a mesh), and
    axes that do not divide the world raise ``ValueError``, as in the JAX
    package."""
    device = _device(ctx)
    p = ctx.params
    if int(p.get("pipe", 1)) > 1:
        raise ValueError(
            "param.pipe is not supported by the standard entrypoints — "
            "pipeline parallelism requires a staged model via "
            "cron_operator_tpu_torch.parallel.spmd_pipeline"
        )
    if p.get("attention") in ("ring", "ulysses") and not sequence_parallel:
        raise ValueError(
            f"param.attention={p['attention']} applies to the gpt and bert "
            "jobs only (sequence-parallel attention)"
        )
    axes = {axis: int(p.get(axis, 1))
            for axis in ("tensor", "seq", "fsdp", "expert")}
    slices = int(p.get("slices", 1))
    world = world_size()
    if world == 1 and not torch.distributed.is_initialized():
        # the JAX package's errors for axes that one device cannot hold
        plan_for_devices(1, **axes)
        group_devices_by_slice([device], slices)
        return device, None
    kind = "cpu" if device.type == "cpu" else "cuda"
    if slices > 1:
        return device, hybrid_mesh_for_slices(slices, device_type=kind, **axes)
    return device, mesh_for_devices(device_type=kind, **axes)


def _batches(ctx, host_factory, device_factory) -> Iterator[Dict[str, Any]]:
    """``param.data``: ``device`` (default) draws batches on the device from
    a torch.Generator; ``host`` keeps the JAX package's numpy streams;
    ``fused`` draws inside the step (the Trainer's ``sample_fn``), so the
    stream is empty batches."""
    mode = ctx.params.get("data", "device")
    if mode == "host":
        return host_factory()
    if mode == "fused":
        return itertools.repeat({})
    return device_factory()


def _tied_loss(out, y):
    hidden, table = out  # return_hidden: the model hands back both (a
    # tensor rank its VocabPiece of the table)
    return tied_cross_entropy(hidden, table, y)


def _chunked_loss(out, y):
    hidden, table = out
    return chunked_cross_entropy(hidden, table, y)


def lm_loss(mesh=None, fused_xent: bool = False):
    """``(return_hidden, loss_fn)`` of the ``gpt`` and ``bert`` jobs: the
    model's ``return_hidden`` and the loss of its output.

    - ``fused_xent``: :func:`ops.xent.chunked_cross_entropy` of the final
      hidden states against the tied table, no logits built (under a
      ``tensor`` axis over the rank's vocab rows, merged over the group).
    - Otherwise, without a mesh or over a mesh of ``data``, ``fsdp``,
      ``seq``, ``expert`` and ``tensor`` axes (``plain_axes`` for the LM
      models, whose blocks split over ``tensor``: DDP or FSDP2 on plain
      modules, each rank's loss over its own rows and block of positions,
      the same rows on every rank of a ``tensor`` or ``expert`` group):
      :func:`ops.xent.tied_cross_entropy`, the padded bf16 product and the
      loss kernels of ``ops/csrc/xent.cu`` on the card. Under a ``tensor``
      axis the model hands its rank's block of the vocab rows
      (``models.layers.VocabPiece``) in place of the table, and the loss
      is the vocab-parallel one (:func:`ops.xent.
      vocab_parallel_cross_entropy`): the product on the rank's rows and
      the kernels on its ``[T, V / t]`` columns, each row merged over the
      group.
    - A mesh that places DTensors (``pipe`` above 1, which the jobs
      refuse): the model's f32 logits and ``cross_entropy_loss``, the
      former path."""
    if fused_xent:
        return True, _chunked_loss
    if mesh is not None and not plain_axes(mesh, GPT):  # BERT splits alike
        return False, cross_entropy_loss
    return True, _tied_loss


def _remat(ctx) -> bool:
    return ctx.params.get("remat", "0") in ("1", "true")


def _seeded(model: nn.Module, device: torch.device) -> nn.Module:
    """``model`` with flax-scale random weights from seed 0."""
    return model.init_weights(torch.Generator(device=device).manual_seed(0))


def _train_job(
    ctx,
    model: nn.Module,
    steps: int,
    host_factory: Callable[[], Iterator],
    sample: Callable[[torch.Generator], Dict[str, torch.Tensor]],
    tokens_per_step: Optional[int] = None,
    loss_fn=cross_entropy_loss,
    mesh=None,
    **train_defaults,
) -> None:
    """Publish ``n_params``, then train ``model`` through :func:`_run` on
    the batches ``param.data`` picks (``sample`` draws the device and fused
    ones), with ``train_defaults`` under the common optimizer params, over
    ``mesh`` when the world has more than one rank."""
    ctx.progress["n_params"] = sum(p.numel() for p in model.parameters())
    device = next(model.parameters()).device
    fused = ctx.params.get("data", "device") == "fused"
    store = _checkpoint_store(ctx)
    try:
        trainer = Trainer(
            model, TrainConfig(**_train_kwargs(ctx, steps, **train_defaults)),
            loss_fn=loss_fn, sample_fn=sample if fused else None,
            checkpoint=store, mesh=mesh,
        )
    except BaseException:
        if store is not None:
            store.close()
        raise
    batches = _batches(
        ctx, host_factory,
        lambda: datasets.device_batches(sample, device=device))
    _run(ctx, trainer, batches, steps, tokens_per_step=tokens_per_step)


def _peak_flops(ctx, device: torch.device) -> Optional[float]:
    """The MFU denominator: ``param.peak_flops_per_chip``, else the card's
    peak by its name (:func:`backends.gpu.peak_flops_per_chip`); None on
    the CPU or an unknown card."""
    try:
        if ctx.params.get("peak_flops_per_chip"):
            return float(ctx.params["peak_flops_per_chip"])
    except (TypeError, ValueError):
        return None
    if device.type != "cuda":
        return None
    return peak_flops_per_chip(torch.cuda.get_device_name(device))


def _start_profile(ctx, device: torch.device, profile_dir: str):
    """A started ``torch.profiler`` (host and, on the card, CUDA activity)
    for ``profile_dir``, or None after publishing ``profile_error``: the
    profiler is process-wide, and a diagnostic never fails the job."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.start()
    except Exception as exc:  # noqa: BLE001
        ctx.progress["profile_error"] = str(exc)
        return None
    ctx.progress["profile_dir"] = profile_dir
    return prof


def _stop_profile(ctx, prof, profile_dir: str) -> None:
    """Stops ``prof`` and writes its trace (Chrome trace JSON) into
    ``profile_dir``; a failure goes into ``profile_error``."""
    try:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(
            profile_dir, f"{ctx.name}.{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(path)
        ctx.progress["profile_trace"] = path
    except Exception as exc:  # noqa: BLE001
        ctx.progress["profile_error"] = str(exc)


def _run(
    ctx,
    trainer: Trainer,
    batches: Iterator[Dict[str, Any]],
    steps: int,
    tokens_per_step: Optional[int] = None,
) -> None:
    """Drive ``trainer`` and publish the JAX ``_run``'s progress keys through
    the ctx: ``started_at``, ``steps_per_call``, ``data_mode``,
    ``resumed_from_step`` (with ``steps_done``, up front, on a resume),
    ``first_step_at``, ``first_step_latency_s``, ``compile_time_s`` (the
    first call's wall), ``steps_done``, ``step_timeline``, ``last_loss``,
    ``last_step_time_s``, ``tokens_per_s``, ``avg_step_time_s``,
    ``steps_per_s``, ``data_stall_ms_p50``, under ``sync_every > 1``
    ``async_dispatch_ms_p50``, under ``mfu=1`` ``mfu`` (rolling at synced
    steps after the first call, then the steady-state average's), under
    ``flops_accounting=1`` ``xla_flops_per_step`` (the JAX key, which the
    executor reads: here :meth:`Trainer.flops_per_step`), and under
    ``profile_dir`` ``profile_dir`` and ``profile_trace`` (or
    ``profile_error``). Beats ``ctx.watchdog`` after every step and
    honours ``ctx.hang``. The checkpoint store is closed (its writes
    drained) before this returns, whatever happens."""
    ctx.progress["started_at"] = time.time()
    ctx.progress["steps_per_call"] = trainer.resolved_steps_per_call
    ctx.progress["data_mode"] = ctx.params.get("data", "device")
    started_mono = time.monotonic()
    if trainer.steps_done:
        # The restored steps are done: publish them up front, since a
        # resume at or past the target runs nothing.
        ctx.progress["resumed_from_step"] = trainer.steps_done
        ctx.progress["steps_done"] = trainer.steps_done
    last_publish = [0.0]
    # param.step_delay_s paces the loop (keeps a short job in flight long
    # enough to be preempted mid-run)
    step_delay_s = float(ctx.params.get("step_delay_s", 0) or 0)
    profile_dir = ctx.params.get("profile_dir")
    profiler = [None]
    window = [0.0, 0]  # wall time and step count since the last synced step
    timeline: deque = deque(
        maxlen=max(1, int(ctx.params.get("timeline_steps", 64) or 64))
    )
    mfu_on = str(ctx.params.get("mfu", "0")).lower() in ("1", "true")
    peak = _peak_flops(ctx, trainer.device) if mfu_on else None
    if peak and trainer.mesh is not None:
        peak *= trainer.mesh.size()  # a step's FLOPs are the whole mesh's

    def _mfu(step_avg_s: float) -> Optional[float]:
        if not (peak and step_avg_s > 0):
            return None
        flops = trainer.flops_per_step()
        return round(flops / (step_avg_s * peak), 4) if flops else None

    def on_step(s: StepStats) -> None:
        first_call = "first_step_at" not in ctx.progress
        if first_call:
            ctx.progress["first_step_at"] = time.time()
            ctx.progress["first_step_latency_s"] = round(
                time.monotonic() - started_mono, 6
            )
            ctx.progress["compile_time_s"] = round(
                trainer.first_dispatch_time_s, 4
            )
            if profile_dir:
                profiler[0] = _start_profile(ctx, trainer.device, profile_dir)
        ctx.progress["steps_done"] = s.step
        timeline.append({
            "step": s.step,
            "t": round(time.monotonic() - started_mono, 4),
            "step_s": round(s.step_time_s, 6),
            "data_s": round(s.data_s, 6),
            "dispatch_s": round(s.dispatch_s, 6),
            "device_s": round(s.sync_s, 6),
            "ckpt_s": round(s.ckpt_s, 6),
            "compile": s.compiled,
        })
        # Under sync_every > 1 an async step's wall is dispatch only and the
        # next synced step absorbs the window's device work: publish the
        # window's average at each synced step, weighted by chunk.
        window[0] += s.step_time_s * s.chunk
        window[1] += s.chunk
        if s.loss is not None:
            win_avg = window[0] / window[1]
            ctx.progress["last_loss"] = s.loss
            ctx.progress["last_step_time_s"] = round(win_avg, 4)
            if tokens_per_step and win_avg > 0:
                ctx.progress["tokens_per_s"] = round(
                    tokens_per_step / win_avg, 1
                )
            if mfu_on and not s.compiled:
                # rolling, over the synced window; the first call holds
                # the build, warm-up and capture
                mfu = _mfu(win_avg)
                if mfu is not None:
                    ctx.progress["mfu"] = mfu
            window[0], window[1] = 0.0, 0
        if step_delay_s:
            time.sleep(step_delay_s)
        now = time.time()
        if ctx.publish is not None and (
            first_call or now - last_publish[0] > 1.0
        ):
            last_publish[0] = now
            ctx.progress["step_timeline"] = list(timeline)
            ctx.publish()
        wd = getattr(ctx, "watchdog", None)
        if wd is not None:
            wd.beat()
        hang = getattr(ctx, "hang", None)
        if hang is not None and hang.is_set():
            # Injected gray failure: alive, no error, no further progress,
            # until the watchdog's preemption cancels the run.
            ctx.progress["hang_injected_at"] = time.time()
            ctx.cancel.wait()

    try:
        stats = trainer.run(
            batches, steps, should_stop=ctx.should_stop, on_step=on_step
        )
    finally:
        if profiler[0] is not None:
            _stop_profile(ctx, profiler[0], profile_dir)
        if trainer.checkpoint is not None:
            # The last save is on disk when the entrypoint returns: the
            # executor's preempt flush never sees a port store.
            trainer.checkpoint.close()
    if timeline:
        ctx.progress["step_timeline"] = list(timeline)
    # Steady state: the first call (kernel build, warm-up, capture) is left
    # out; chunk-weighted, since calls may carry unequal chunks.
    tail = stats[1:] if len(stats) > 1 else stats
    n_steps = sum(s.chunk for s in tail)
    if tail and n_steps:
        avg = sum(s.step_time_s * s.chunk for s in tail) / n_steps
        ctx.progress["avg_step_time_s"] = round(avg, 4)
        ctx.progress["steps_per_s"] = round(1.0 / avg, 4) if avg > 0 else None
        if tokens_per_step and avg > 0:
            ctx.progress["tokens_per_s"] = round(tokens_per_step / avg, 1)
        if mfu_on:
            mfu = _mfu(avg)
            if mfu is not None:
                ctx.progress["mfu"] = mfu
    # Dispatch-only walls of the async calls, whole (x chunk: the call is
    # what the host pays for); the last call is left out, since an early
    # exit charges the device drain to it.
    async_ms = sorted(s.step_time_s * s.chunk * 1e3 for s in tail[:-1]
                      if s.loss is None)
    if async_ms:
        ctx.progress["async_dispatch_ms_p50"] = round(
            async_ms[len(async_ms) // 2], 2
        )
    stall_ms = sorted(s.data_s / s.chunk * 1e3 for s in tail)
    if stall_ms:
        ctx.progress["data_stall_ms_p50"] = round(
            stall_ms[len(stall_ms) // 2], 3
        )
    if ctx.params.get("flops_accounting", "0") in ("1", "true"):
        flops = trainer.flops_per_step()
        if flops:
            ctx.progress["xla_flops_per_step"] = flops


@register_entrypoint("mnist")
def mnist(ctx) -> None:
    """MLP on synthetic MNIST, as the JAX ``mnist`` entrypoint. Params:
    steps(=20), batch_size(=256), SGD at lr 0.01 unless ``param.lr``, and
    the mesh axes fsdp/tensor/expert (under ``tensor`` each rank keeps its
    slice of the first pair of hidden layers: ``MLP.tensor_splits``)."""
    steps = int(ctx.params.get("steps", 20))
    batch_size = int(ctx.params.get("batch_size", 256))
    device, mesh = _train_device(ctx)
    _train_job(
        ctx, _seeded(MLP(device=device), device), steps,
        lambda: datasets.mnist_batches(batch_size),
        datasets.mnist_sample(batch_size),
        optimizer="sgd", learning_rate=0.01, mesh=mesh,
    )


@register_entrypoint("resnet50")
def resnet50(ctx) -> None:
    """ResNet-50 on synthetic ImageNet, the JAX package's north-star
    workload. Params: steps(=10), batch_size(=128), image_size(=224), SGD
    at lr 0.1 unless ``param.lr``, and the mesh axes fsdp/tensor/expert
    (under ``tensor`` each block keeps its slice of its first two convs,
    split at its first norm's group boundaries:
    ``resnet._Block.tensor_splits``)."""
    steps = int(ctx.params.get("steps", 10))
    batch_size = int(ctx.params.get("batch_size", 128))
    image_size = int(ctx.params.get("image_size", 224))
    device, mesh = _train_device(ctx)
    _train_job(
        ctx, _seeded(ResNet50(device=device), device), steps,
        lambda: datasets.imagenet_batches(batch_size, image_size),
        datasets.imagenet_sample(batch_size, image_size),
        optimizer="sgd", learning_rate=0.1, mesh=mesh,
    )


@register_entrypoint("bert")
def bert(ctx) -> None:
    """BERT MLM on synthetic tokens, as the JAX ``bert`` entrypoint.

    Params: steps(=10), batch_size(=8), seq_len(=512, the model's max_len),
    size(=base|tiny), attention(=auto|flash|xla|ring|ulysses: ``auto`` runs
    the Hopper flash kernels, non-causal, on the card, and ring attention
    under ``seq > 1``), the mesh axes
    seq/tensor/fsdp (the sequence split over ``seq``), remat(=0),
    kv_heads(=0: MHA), rope(=0|1). AdamW at lr 1e-3; targets are the inputs
    (``token_batches``). The loss is :func:`lm_loss`'s: the padded product's
    softmax cross-entropy through the loss kernels (a ``seq`` mesh too, on
    each rank's block of positions, an ``expert`` mesh whole on each rank,
    and a ``tensor`` mesh on each rank's block of the vocab, merged over
    the group).
    """
    steps = int(ctx.params.get("steps", 10))
    batch_size = int(ctx.params.get("batch_size", 8))
    seq_len = int(ctx.params.get("seq_len", 512))
    size = ctx.params.get("size", "base")
    device, mesh = _train_device(ctx, sequence_parallel=True)
    maker = BertConfig.tiny if size == "tiny" else BertConfig.base
    return_hidden, loss_fn = lm_loss(mesh)
    cfg = maker(max_len=seq_len,
                attention_impl=ctx.params.get("attention", "auto"),
                return_hidden=return_hidden, **_gqa_rope_kwargs(ctx))
    _train_job(
        ctx, _seeded(Bert(cfg, device=device), device), steps,
        lambda: datasets.token_batches(batch_size, seq_len, cfg.vocab_size),
        datasets.token_sample(batch_size, seq_len, cfg.vocab_size),
        tokens_per_step=batch_size * seq_len, loss_fn=loss_fn,
        remat=_remat(ctx), mesh=mesh, seq_dim_in_batch=1,
        labels_follow_seq=True,
    )


@register_entrypoint("gpt")
def gpt(ctx) -> None:
    """GPT causal LM on synthetic tokens, as the JAX ``gpt`` entrypoint.

    Params: steps(=10), batch_size(=8), seq_len(=1024), size(=base|tiny),
    attention(=auto|flash|xla|ring|ulysses), the mesh axes
    seq/tensor/fsdp/expert (the sequence split over ``seq``), moe_every(=0:
    dense; k > 0 makes every k-th block's FFN a Switch-MoE layer),
    num_experts(=8), remat(=0),
    fused_xent(=0: the loss is :func:`ops.xent.tied_cross_entropy`, the
    whole padded bf16 logits through the loss kernels, a ``seq`` mesh's on
    each rank's block of positions, an ``expert`` mesh's whole on each
    rank, a ``tensor`` mesh's on each rank's block of the vocab merged
    over the group;
    when 1 it is :func:`ops.xent.chunked_cross_entropy` against the tied
    embedding (a ``tensor`` rank's block of it) and the ``[b, s, vocab]``
    logits are never built; :func:`lm_loss`),
    kv_heads(=0: MHA), rope(=0|1), data(=device|host|fused), platform,
    and the params of :func:`_train_kwargs` (AdamW at lr 1e-3 by
    default). Targets are next-token shifted; an MoE model's weighted
    router balance loss is added to the task loss.
    """
    steps = int(ctx.params.get("steps", 10))
    batch_size = int(ctx.params.get("batch_size", 8))
    seq_len = int(ctx.params.get("seq_len", 1024))
    size = ctx.params.get("size", "base")
    fused_xent = ctx.params.get("fused_xent", "0") in ("1", "true")
    device, mesh = _train_device(ctx, sequence_parallel=True)
    maker = GPTConfig.tiny if size == "tiny" else GPTConfig
    return_hidden, loss_fn = lm_loss(mesh, fused_xent)
    cfg = maker(
        max_len=seq_len, attention_impl=ctx.params.get("attention", "auto"),
        return_hidden=return_hidden, **_moe_kwargs(ctx),
        **_gqa_rope_kwargs(ctx),
    )
    model = _seeded(GPT(cfg, device=device), device)
    _train_job(
        ctx, model, steps,
        lambda: datasets.causal_token_batches(
            batch_size, seq_len, cfg.vocab_size),
        datasets.causal_token_sample(batch_size, seq_len, cfg.vocab_size),
        tokens_per_step=batch_size * seq_len, loss_fn=loss_fn,
        remat=_remat(ctx), mesh=mesh, seq_dim_in_batch=1,
        labels_follow_seq=True,
        # the JAX job sets it always; the port's dense GPT returns no aux
        aux_loss_in_output=model.has_moe,
    )


@register_entrypoint("vit")
def vit(ctx) -> None:
    """ViT classification on synthetic ImageNet, as the JAX ``vit``
    entrypoint. Params: steps(=10), batch_size(=64), image_size(=the
    config's: 224 base, 32 tiny), size(=base|tiny), remat(=0),
    kv_heads(=0: MHA), rope(=0|1: rotary over the flattened patch index,
    replacing the learned table). AdamW at lr 1e-3. Attention runs the
    Hopper flash kernels on the card at the (size/patch)^2 + 1 tokens (197
    at base), and the plain f32 path on the CPU.
    ``attention=ring|ulysses`` raises ``ValueError`` (the JAX job ignores
    it).
    """
    steps = int(ctx.params.get("steps", 10))
    batch_size = int(ctx.params.get("batch_size", 64))
    size = ctx.params.get("size", "base")
    device, mesh = _train_device(ctx)
    maker = ViTConfig.tiny if size == "tiny" else ViTConfig.base
    cfg = maker(**_gqa_rope_kwargs(ctx))
    cfg = replace(cfg, image_size=int(ctx.params.get("image_size",
                                                     cfg.image_size)))
    _train_job(
        ctx, _seeded(ViT(cfg, device=device), device), steps,
        lambda: datasets.imagenet_batches(batch_size, cfg.image_size,
                                          num_classes=cfg.num_classes),
        datasets.imagenet_sample(batch_size, cfg.image_size,
                                 cfg.num_classes),
        remat=_remat(ctx), mesh=mesh,
    )


@register_entrypoint("generate")
def generate_job(ctx) -> None:
    """Scheduled batch inference: GPT KV-cache generation as a Cron
    workload. Each round generates a batch of continuations from random
    prompts; progress reports rounds and sustained tokens/s.

    Params: rounds(=1), batch_size(=8), prompt_len(=32), max_new(=128),
    temperature(=0 → greedy), size(=base|tiny), seq_len(=prompt_len+max_new:
    the model's max_len), kv_heads(=0: MHA), rope(=0|1), moe_every(=0) and
    num_experts(=8) (Switch-MoE blocks, as the ``gpt`` job's), seed(=0: the
    prompts' seed; weights come from seed 0 as in the JAX job), platform,
    devices (serving uses the first), checkpoint_from (=unset: random
    weights; a job or family name serves the newest parameters that
    training lineage saved, the train-nightly to serve-nightly pairing;
    the GPTConfig params, ``seq_len`` and the MoE params among them, must
    match the training job's) and checkpoint_dir (=the store root). On the
    card the decode steps replay one captured CUDA graph
    (:func:`workloads.generate.generate`).
    """
    rounds = int(ctx.params.get("rounds", 1))
    batch_size = int(ctx.params.get("batch_size", 8))
    prompt_len = int(ctx.params.get("prompt_len", 32))
    max_new = int(ctx.params.get("max_new", 128))
    temperature = float(ctx.params.get("temperature", 0))
    size = ctx.params.get("size", "base")
    device = _device(ctx)
    maker = GPTConfig.tiny if size == "tiny" else GPTConfig
    cfg = maker(
        max_len=int(ctx.params.get("seq_len", prompt_len + max_new)),
        **_gqa_rope_kwargs(ctx), **_moe_kwargs(ctx),
    )
    # Serving keeps the parameters in cfg.dtype: the cast at use that a
    # training model's f32 masters go through gives the same values.
    model = GPT(cfg, device=device, param_dtype=cfg.dtype)
    ckpt_from = ctx.params.get("checkpoint_from")
    if ckpt_from:
        # Restored weights replace the init, which is skipped.
        store = CheckpointStore(
            ctx.namespace or "default", ckpt_from,
            root=ctx.params.get("checkpoint_dir"),
            create=False,  # read-only: a mistyped name must raise
        )
        try:
            # Pin the step before restoring: a training tick may save a
            # newer one meanwhile, and the served step must be the one
            # reported.
            step = store.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"lineage {ckpt_from!r} has no completed checkpoint yet"
                )
            model.load_state_dict(store.restore_params(step))
            ctx.progress["restored_from_step"] = step
        finally:
            store.close()
        model = model.eval()
    else:
        weights_rng = torch.Generator(device=device).manual_seed(0)
        model = model.init_weights(weights_rng).eval()

    # Decode is HBM-bandwidth-bound: each step reads the parameters once for
    # the whole batch (every expert, as the JAX count of the tree's leaves)
    # plus every item's full static KV cache ([b, max_len, kv_h, d] K and V
    # per layer, masked, not truncated, in the JAX job; the port's decode
    # kernel reads only the positions written, so this is its most).
    # Published so a consumer can place tokens/s against the card's memory
    # roofline.
    n_params = sum(p.numel() for p in model.parameters())
    kv_heads = cfg.num_kv_heads or cfg.num_heads
    head_dim = cfg.hidden_size // cfg.num_heads
    dsize = torch.empty((), dtype=cfg.dtype).element_size()
    ctx.progress["n_params"] = n_params
    ctx.progress["decode_read_bytes_per_step"] = (
        n_params * dsize
        + 2 * cfg.num_layers * batch_size * cfg.max_len
        * kv_heads * head_dim * dsize
    )
    # Prompts come from a torch.Generator seeded with param.seed; its stream
    # differs from the jax.random stream the JAX job draws from.
    prompt_rng = torch.Generator(device=device).manual_seed(
        int(ctx.params.get("seed", 0))
    )
    ctx.progress["started_at"] = time.time()
    started_mono = time.monotonic()
    total_tokens = 0
    steady_t0 = None
    for r in range(rounds):
        if ctx.should_stop is not None and ctx.should_stop():
            break
        prompt = torch.randint(
            0, cfg.vocab_size, (batch_size, prompt_len),
            generator=prompt_rng, device=device,
        )
        generate(
            cfg, model, prompt, max_new,
            temperature=temperature,
            generator=prompt_rng if temperature > 0 else None,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.time()
        if r == 0:
            # Round 0 carries the kernel build and warm-up; steady
            # throughput starts after it, as in the JAX job.
            ctx.progress["first_step_at"] = now
            ctx.progress["first_step_latency_s"] = round(
                time.monotonic() - started_mono, 6
            )
            steady_t0 = now
        else:
            total_tokens += batch_size * max_new
            elapsed = now - steady_t0
            if elapsed > 0:
                ctx.progress["tokens_per_s"] = round(
                    total_tokens / elapsed, 1
                )
        ctx.progress["steps_done"] = r + 1
        ctx.progress["tokens_generated"] = (r + 1) * batch_size * max_new
        if ctx.publish is not None:
            ctx.publish()


__all__ = ["bert", "generate_job", "gpt", "mnist", "resnet50", "vit"]
