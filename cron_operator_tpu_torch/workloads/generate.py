"""Autoregressive generation — the serving path for the GPT family.

The prompt is consumed by one batched causal pass that fills the KV cache
(prefill, through the flash kernel on the card), then ``max_new - 1``
single-token decode steps follow in a Python loop, sampling from each step's
logits. The JAX package compiles the whole generation into one XLA program
and keeps an LRU of compiled functions (``_COMPILED``); eager PyTorch
compiles nothing, so the port has no counterpart of that cache.

Decode is bandwidth-bound (every step reads the parameters and the whole
static KV cache); batch is the throughput lever.
"""

from __future__ import annotations

from typing import Optional

import torch

from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig


@torch.inference_mode()
def generate(
    cfg: GPTConfig,
    model: GPT,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Greedy (``temperature=0``) or sampled continuation of each prompt.

    ``prompt_ids`` is ``[batch, prompt_len]`` on the model's device; returns
    ``[batch, prompt_len + max_new_tokens]``. Sampling draws from
    ``generator``, so one seed gives one continuation.
    """
    b, p = prompt_ids.shape
    if p < 1:
        raise ValueError("empty prompt")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if p + max_new_tokens > cfg.max_len:
        raise ValueError(
            f"prompt {p} + {max_new_tokens} new tokens exceeds "
            f"max_len {cfg.max_len}"
        )
    if temperature < 0:
        raise ValueError("temperature must be >= 0")
    greedy = temperature == 0.0
    if not greedy and generator is None:
        raise ValueError(
            "sampling (temperature > 0) needs an rng: pass a torch.Generator"
        )
    if model.config != cfg:
        raise ValueError("cfg differs from the model's config")

    def sample(logits: torch.Tensor) -> torch.Tensor:
        if greedy:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    cache = model.new_cache(b)
    tok = sample(model.prefill(prompt_ids, cache))
    toks = [tok]
    # Step-then-sample: exactly max_new - 1 decode forwards after the
    # prefill (the last sampled token never needs a forward of its own).
    for _ in range(max_new_tokens - 1):
        tok = sample(model.decode(tok[:, None], cache))
        toks.append(tok)
    new = torch.stack(toks, dim=1).to(prompt_ids.dtype)
    return torch.cat([prompt_ids, new], dim=1)


__all__ = ["generate"]
