"""Entrypoints of the port, as in ``cron_operator_tpu/workloads/entrypoints.py``.

An entrypoint takes a job context (``params``, ``progress``, ``publish``,
``should_stop``: the port's :class:`backends.registry.JobContext` or the
JAX executor's, which has the same fields) and runs one workload, publishing
progress into ``ctx.progress``. The operator reaches them by
``module:function`` string, e.g. a ``PyTorchJob`` annotated
``tpu.kubedl.io/entrypoint:
cron_operator_tpu_torch.workloads.entrypoints:generate_job``.

Common params: ``platform`` (unset = the CUDA card; ``cpu`` on request),
``devices`` (the first N devices of the platform, as the JAX ``_devices``:
more than are visible raise ``ValueError``); for training, ``steps``,
``batch_size``, ``data`` (``device`` default | ``host`` | ``fused``),
``steps_per_call`` (``auto`` default: 8 steps per call, one CUDA graph of
the step replayed per step on the card), ``prefetch``, ``stage_async``,
``lr``/``lr_schedule``/``warmup_steps``/``schedule_steps``/``grad_clip``/
``decay_mask``/``sync_every``/``save_every`` (see :func:`_train_kwargs`).
Every training job's weights come from seed 0, and besides the JAX
``_run``'s progress keys it publishes ``n_params``. ``pipe > 1`` raises
``ValueError`` for good, as in the JAX package. The mesh params (and
``devices`` > 1), MoE, ring/Ulysses attention, checkpoints, ``mfu``,
``flops_accounting`` and ``profile_dir`` raise ``NotImplementedError``
until their slice (:func:`_train_device`).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import replace
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch import nn

from cron_operator_tpu_torch.models.bert import Bert, BertConfig
from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
from cron_operator_tpu_torch.models.mlp import MLP
from cron_operator_tpu_torch.models.resnet import ResNet50
from cron_operator_tpu_torch.models.vit import ViT, ViTConfig
from cron_operator_tpu_torch.utils.device import resolve_device
from cron_operator_tpu_torch.workloads import data as datasets
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


def _steps_per_call(ctx):
    """param.steps_per_call: ``"auto"`` (the default execution mode, 8
    steps per call: ``Trainer.resolved_steps_per_call``) or an int."""
    raw = ctx.params.get("steps_per_call", "auto")
    return raw if raw == "auto" else int(raw)


def _train_kwargs(ctx, steps: int, **defaults) -> dict:
    """TrainConfig kwargs: per-entrypoint defaults overridden by the common
    ``param.*`` surface, as in the JAX package: ``lr``, ``lr_schedule``
    (constant|cosine|warmup_cosine), ``warmup_steps``, ``schedule_steps``
    (default: the run's step target), ``grad_clip`` (0 = off),
    ``decay_mask``, ``save_every`` (=10; read once checkpoints exist),
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


# Params of the JAX training entrypoints that later slices bring, each with
# the ROADMAP.md queue 1 item it waits for.
_LATER = "waits for ROADMAP.md queue 1 item"


def _devices(ctx) -> List[torch.device]:
    """The devices torch sees for the job's platform (``param.platform``),
    capped to the first ``param.devices`` of them, as the JAX ``_devices``:
    more than are visible raise ``ValueError``."""
    device = resolve_device(ctx.params.get("platform"))
    if device.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [device]
    want = int(ctx.params.get("devices", 0) or 0)
    if want > 0:
        if want > len(devs):
            raise ValueError(
                f"param.devices={want} but only {len(devs)} device(s) visible"
            )
        devs = devs[:want]
    return devs


def _train_device(ctx) -> torch.device:
    """The device a training job runs on, after the checks of the JAX
    ``_devices`` and ``_mesh``: ``param.pipe > 1`` raises ``ValueError``
    for good (the standard jobs train one step; pipelining is a primitive
    for custom entrypoints), and the params of later slices raise
    ``NotImplementedError``, ``param.devices > 1`` among them (a mesh)."""
    devs = _devices(ctx)
    p = ctx.params
    if int(p.get("pipe", 1)) > 1:
        raise ValueError(
            "param.pipe is not supported by the standard entrypoints — "
            "pipeline parallelism requires a staged model"
        )
    if int(p.get("devices", 0) or 0) > 1:
        raise NotImplementedError(
            f"param.devices > 1 (a device mesh) {_LATER} 7"
        )
    for axis in ("tensor", "seq", "fsdp", "expert", "slices"):
        if int(p.get(axis, 1)) > 1:
            raise NotImplementedError(
                f"param.{axis} > 1 (a device mesh) {_LATER} 7"
            )
    if int(p.get("moe_every", 0)) > 0:
        raise NotImplementedError(f"param.moe_every (MoE) {_LATER} 9")
    if p.get("attention") in ("ring", "ulysses"):
        raise NotImplementedError(
            f"param.attention={p['attention']} (sequence parallel) {_LATER} 8"
        )
    if p.get("checkpoint", "0") in ("1", "true", "yes"):
        raise NotImplementedError(f"param.checkpoint (checkpoints) {_LATER} 5")
    for key in ("mfu", "flops_accounting"):
        if p.get(key, "0") in ("1", "true"):
            raise NotImplementedError(f"param.{key} (perf tooling) {_LATER} 12")
    if p.get("profile_dir"):
        raise NotImplementedError(f"param.profile_dir (perf tooling) {_LATER} 12")
    return devs[0]


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
    **train_defaults,
) -> None:
    """Publish ``n_params``, then train ``model`` through :func:`_run` on
    the batches ``param.data`` picks (``sample`` draws the device and fused
    ones), with ``train_defaults`` under the common optimizer params."""
    ctx.progress["n_params"] = sum(p.numel() for p in model.parameters())
    device = next(model.parameters()).device
    fused = ctx.params.get("data", "device") == "fused"
    trainer = Trainer(
        model, TrainConfig(**_train_kwargs(ctx, steps, **train_defaults)),
        loss_fn=loss_fn, sample_fn=sample if fused else None,
    )
    batches = _batches(
        ctx, host_factory,
        lambda: datasets.device_batches(sample, device=device))
    _run(ctx, trainer, batches, steps, tokens_per_step=tokens_per_step)


def _run(
    ctx,
    trainer: Trainer,
    batches: Iterator[Dict[str, Any]],
    steps: int,
    tokens_per_step: Optional[int] = None,
) -> None:
    """Drive ``trainer`` and publish the JAX ``_run``'s progress keys through
    the ctx: ``started_at``, ``steps_per_call``, ``data_mode``,
    ``first_step_at``, ``first_step_latency_s``, ``compile_time_s`` (the
    first step's wall), ``steps_done``, ``step_timeline``, ``last_loss``,
    ``last_step_time_s``, ``tokens_per_s``, ``avg_step_time_s``,
    ``steps_per_s``, ``data_stall_ms_p50`` and, under ``sync_every > 1``,
    ``async_dispatch_ms_p50``. Beats ``ctx.watchdog`` after every step and
    honours ``ctx.hang``."""
    ctx.progress["started_at"] = time.time()
    ctx.progress["steps_per_call"] = trainer.resolved_steps_per_call
    ctx.progress["data_mode"] = ctx.params.get("data", "device")
    started_mono = time.monotonic()
    last_publish = [0.0]
    # param.step_delay_s paces the loop (keeps a short job in flight long
    # enough to be preempted mid-run)
    step_delay_s = float(ctx.params.get("step_delay_s", 0) or 0)
    window = [0.0, 0]  # wall time and step count since the last synced step
    timeline: deque = deque(
        maxlen=max(1, int(ctx.params.get("timeline_steps", 64) or 64))
    )

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

    stats = trainer.run(
        batches, steps, should_stop=ctx.should_stop, on_step=on_step
    )
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


def mnist(ctx) -> None:
    """MLP on synthetic MNIST, as the JAX ``mnist`` entrypoint. Params:
    steps(=20), batch_size(=256), SGD at lr 0.01 unless ``param.lr``."""
    steps = int(ctx.params.get("steps", 20))
    batch_size = int(ctx.params.get("batch_size", 256))
    device = _train_device(ctx)
    _train_job(
        ctx, _seeded(MLP(device=device), device), steps,
        lambda: datasets.mnist_batches(batch_size),
        datasets.mnist_sample(batch_size),
        optimizer="sgd", learning_rate=0.01,
    )


def resnet50(ctx) -> None:
    """ResNet-50 on synthetic ImageNet, the JAX package's north-star
    workload. Params: steps(=10), batch_size(=128), image_size(=224), SGD
    at lr 0.1 unless ``param.lr``."""
    steps = int(ctx.params.get("steps", 10))
    batch_size = int(ctx.params.get("batch_size", 128))
    image_size = int(ctx.params.get("image_size", 224))
    device = _train_device(ctx)
    _train_job(
        ctx, _seeded(ResNet50(device=device), device), steps,
        lambda: datasets.imagenet_batches(batch_size, image_size),
        datasets.imagenet_sample(batch_size, image_size),
        optimizer="sgd", learning_rate=0.1,
    )


def bert(ctx) -> None:
    """BERT MLM on synthetic tokens, as the JAX ``bert`` entrypoint.

    Params: steps(=10), batch_size(=8), seq_len(=512, the model's max_len),
    size(=base|tiny), attention(=auto|flash|xla: ``auto`` runs the Hopper
    flash kernels, non-causal, on the card when seq_len is a multiple of
    128), remat(=0), kv_heads(=0: MHA), rope(=0|1). AdamW at lr 1e-3;
    targets are the inputs (``token_batches``).
    """
    steps = int(ctx.params.get("steps", 10))
    batch_size = int(ctx.params.get("batch_size", 8))
    seq_len = int(ctx.params.get("seq_len", 512))
    size = ctx.params.get("size", "base")
    device = _train_device(ctx)
    maker = BertConfig.tiny if size == "tiny" else BertConfig.base
    cfg = maker(max_len=seq_len,
                attention_impl=ctx.params.get("attention", "auto"),
                **_gqa_rope_kwargs(ctx))
    _train_job(
        ctx, _seeded(Bert(cfg, device=device), device), steps,
        lambda: datasets.token_batches(batch_size, seq_len, cfg.vocab_size),
        datasets.token_sample(batch_size, seq_len, cfg.vocab_size),
        tokens_per_step=batch_size * seq_len, remat=_remat(ctx),
    )


def gpt(ctx) -> None:
    """GPT causal LM on synthetic tokens, as the JAX ``gpt`` entrypoint.

    Params: steps(=10), batch_size(=8), seq_len(=1024), size(=base|tiny),
    attention(=auto|flash|xla), remat(=0), fused_xent(=0: when 1 the loss is
    :func:`ops.xent.chunked_cross_entropy` against the tied embedding and
    the ``[b, s, vocab]`` logits are never built), kv_heads(=0: MHA),
    rope(=0|1), data(=device|host|fused), platform, and the params of
    :func:`_train_kwargs` (AdamW at lr 1e-3 by default). Targets are
    next-token shifted.
    """
    steps = int(ctx.params.get("steps", 10))
    batch_size = int(ctx.params.get("batch_size", 8))
    seq_len = int(ctx.params.get("seq_len", 1024))
    size = ctx.params.get("size", "base")
    fused_xent = ctx.params.get("fused_xent", "0") in ("1", "true")
    device = _train_device(ctx)
    maker = GPTConfig.tiny if size == "tiny" else GPTConfig
    cfg = maker(
        max_len=seq_len, attention_impl=ctx.params.get("attention", "auto"),
        return_hidden=fused_xent, **_gqa_rope_kwargs(ctx),
    )
    if fused_xent:
        from cron_operator_tpu_torch.ops.xent import chunked_cross_entropy

        def loss_fn(out, y):
            hidden, table = out  # return_hidden: the model hands back both
            return chunked_cross_entropy(hidden, table, y)
    else:
        loss_fn = cross_entropy_loss
    _train_job(
        ctx, _seeded(GPT(cfg, device=device), device), steps,
        lambda: datasets.causal_token_batches(
            batch_size, seq_len, cfg.vocab_size),
        datasets.causal_token_sample(batch_size, seq_len, cfg.vocab_size),
        tokens_per_step=batch_size * seq_len, loss_fn=loss_fn,
        remat=_remat(ctx),
    )


def vit(ctx) -> None:
    """ViT classification on synthetic ImageNet, as the JAX ``vit``
    entrypoint. Params: steps(=10), batch_size(=64), image_size(=the
    config's: 224 base, 32 tiny), size(=base|tiny), remat(=0),
    kv_heads(=0: MHA), rope(=0|1: rotary over the flattened patch index,
    replacing the learned table). AdamW at lr 1e-3. Attention is the plain
    path: (size/patch)^2 + 1 tokens are never a multiple of 128.
    """
    steps = int(ctx.params.get("steps", 10))
    batch_size = int(ctx.params.get("batch_size", 64))
    size = ctx.params.get("size", "base")
    device = _train_device(ctx)
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
        remat=_remat(ctx),
    )


def generate_job(ctx) -> None:
    """Scheduled batch inference: GPT KV-cache generation as a Cron
    workload. Each round generates a batch of continuations from random
    prompts; progress reports rounds and sustained tokens/s.

    Params: rounds(=1), batch_size(=8), prompt_len(=32), max_new(=128),
    temperature(=0 → greedy), size(=base|tiny), seq_len(=prompt_len+max_new:
    the model's max_len), kv_heads(=0: MHA), rope(=0|1), seed(=0: the
    prompts' seed; weights come from seed 0 as in the JAX job), platform,
    devices (serving uses the first). On the card the decode steps replay
    one captured CUDA graph (:func:`workloads.generate.generate`).
    ``checkpoint_from`` and ``moe_every`` wait for later slices.
    """
    if ctx.params.get("checkpoint_from"):
        raise NotImplementedError(
            "param.checkpoint_from waits for the checkpoint slice "
            "(ROADMAP.md queue 1)"
        )
    if int(ctx.params.get("moe_every", 0)) > 0:
        raise NotImplementedError(
            "param.moe_every waits for the MoE slice (ROADMAP.md queue 1)"
        )
    rounds = int(ctx.params.get("rounds", 1))
    batch_size = int(ctx.params.get("batch_size", 8))
    prompt_len = int(ctx.params.get("prompt_len", 32))
    max_new = int(ctx.params.get("max_new", 128))
    temperature = float(ctx.params.get("temperature", 0))
    size = ctx.params.get("size", "base")
    device = _devices(ctx)[0]
    maker = GPTConfig.tiny if size == "tiny" else GPTConfig
    cfg = maker(
        max_len=int(ctx.params.get("seq_len", prompt_len + max_new)),
        **_gqa_rope_kwargs(ctx),
    )
    weights_rng = torch.Generator(device=device).manual_seed(0)
    # Serving keeps the parameters in cfg.dtype: the cast at use that a
    # training model's f32 masters go through gives the same values.
    model = GPT(cfg, device=device, param_dtype=cfg.dtype)
    model = model.init_weights(weights_rng).eval()

    # Decode is HBM-bandwidth-bound: each step reads the parameters once for
    # the whole batch plus every item's full static KV cache ([b, max_len,
    # kv_h, d] K and V per layer, masked, not truncated). Published so a
    # consumer can place tokens/s against the card's memory roofline.
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
