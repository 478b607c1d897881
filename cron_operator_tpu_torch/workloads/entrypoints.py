"""Entrypoints of the port, as in ``cron_operator_tpu/workloads/entrypoints.py``.

An entrypoint takes a job context (``params``, ``progress``, ``publish``,
``should_stop``: the port's :class:`backends.registry.JobContext` or the
JAX executor's, which has the same fields) and runs one workload, publishing
progress into ``ctx.progress``. The operator reaches them by
``module:function`` string, e.g. a ``PyTorchJob`` annotated
``tpu.kubedl.io/entrypoint:
cron_operator_tpu_torch.workloads.entrypoints:generate_job``.

Common params: ``platform`` (unset = the CUDA card; ``cpu`` on request).
"""

from __future__ import annotations

import time

import torch

from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
from cron_operator_tpu_torch.utils.device import resolve_device
from cron_operator_tpu_torch.workloads.generate import generate


def _gqa_rope_kwargs(ctx) -> dict:
    """param.kv_heads / param.rope, parsed as the JAX entrypoints do."""
    return {
        "num_kv_heads": int(ctx.params.get("kv_heads", 0)),
        "rope": ctx.params.get("rope", "0") in ("1", "true"),
    }


def generate_job(ctx) -> None:
    """Scheduled batch inference: GPT KV-cache generation as a Cron
    workload. Each round generates a batch of continuations from random
    prompts; progress reports rounds and sustained tokens/s.

    Params: rounds(=1), batch_size(=8), prompt_len(=32), max_new(=128),
    temperature(=0 → greedy), size(=base|tiny), seq_len(=prompt_len+max_new:
    the model's max_len), kv_heads(=0: MHA), rope(=0|1), seed(=0: the
    prompts' seed; weights come from seed 0 as in the JAX job), platform.
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
    device = resolve_device(ctx.params.get("platform"))
    maker = GPTConfig.tiny if size == "tiny" else GPTConfig
    cfg = maker(
        max_len=int(ctx.params.get("seq_len", prompt_len + max_new)),
        **_gqa_rope_kwargs(ctx),
    )
    weights_rng = torch.Generator(device=device).manual_seed(0)
    model = GPT(cfg, device=device).init_weights(weights_rng).eval()

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


__all__ = ["generate_job"]
