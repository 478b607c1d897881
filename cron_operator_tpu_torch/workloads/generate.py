"""Autoregressive generation — the serving path for the GPT family.

The prompt is consumed by one batched causal pass that fills the KV cache
(prefill, through the flash kernel on the card), then ``max_new - 1``
single-token decode steps follow, each sampling from its logits. The JAX
package compiles the whole generation into one program (the prefill, then
a ``lax.scan`` over the decode steps, under one ``jax.jit``) and keeps an
LRU of compiled functions (``_COMPILED``, keyed by config, ``max_new`` and
greedy; jit specialises on the prompt's shape). On the card the port
captures the prefill with its sampling of the first token, and one decode
step with its sampling, as CUDA graphs
(:class:`parallel.overlap.StepGraph`), and replays them: the prefill once
a generation, the decode step for every new token. The graphs live in an
LRU of ``_DECODERS_CAP`` entries, one per (model, batch, greedy), each
with the static KV cache its graphs write and one graph memory pool that
they share (they run one after another under the entry's lock, never at
once); an entry keeps the prefill graphs of its last ``_PREFILLS_CAP``
prompt lengths. A lock guards the LRU, since the executor runs jobs on
threads. On the CPU, and with ``captured=False`` on the card, the same
prefill and steps run eagerly. A failed capture or replay raises; nothing
falls back to eager.

Decode is bandwidth-bound (every step reads the parameters and the whole
static KV cache); batch is the throughput lever.

MoE models: a decode step routes its batch with no-drop capacity (the
factor raised to ``num_experts``), while prefill keeps the configured
``moe_capacity_factor``, as in the JAX package. Cached decode and a full
forward therefore agree token for token only when ``moe_capacity_factor >=
num_experts``; below it a token dropped by the full forward's router but
routed by decode's (or the reverse) may legitimately change the output.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, Optional

import torch

from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
from cron_operator_tpu_torch.parallel.overlap import StepGraph

# (id(model), batch, greedy) -> _Decoder. LRU-bounded: a long-lived
# executor serving many jobs must not keep every job's graph and cache.
_DECODERS_CAP = 8
_DECODERS: "OrderedDict[tuple, _Decoder]" = OrderedDict()
_DECODERS_LOCK = threading.Lock()
# Prompt lengths whose captured prefill an entry keeps, least recently used
# dropped first: a long-lived executor must not keep a graph for every
# length it has served.
_PREFILLS_CAP = 4


def _sample(logits: torch.Tensor, temperature: Optional[torch.Tensor],
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """The argmax token (``temperature`` None), or a draw from
    ``softmax(logits / temperature)``: the exponential race (``p / q`` with
    ``q ~ Exp(1)``, argmax) that ``torch.multinomial`` runs for one sample,
    written out since ``multinomial`` checks its input on the host, which a
    graph capture refuses."""
    if temperature is None:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / q).argmax(dim=-1)


class _Decoder:
    """A model's prefill and decode step, each with its sampling, for
    ``batch`` sequences, on a KV cache of its own: each captured at its
    first use and replayed after, the prefill once per prompt length
    (:meth:`prefill`). Sampling draws from ``generator``, registered with
    the graphs; the temperature is a device tensor filled before each
    generation. The graphs share one memory pool (made on the card only).
    The model is held weakly: a decoder whose model is gone is dropped."""

    def __init__(self, model: GPT, batch: int, greedy: bool,
                 generator: Optional[torch.Generator]):
        self.model = weakref.ref(model)
        self.generator = generator
        self.lock = threading.Lock()  # one generation at a time on the cache
        self.cache = model.new_cache(batch)
        self.temperature = (None if greedy else
                            torch.ones((), device=self.cache.pos.device))
        self.generators = () if greedy else (generator,)
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.cache.pos.is_cuda else None)
        self.step = StepGraph(self._decode, generators=self.generators,
                              pool=self.pool)
        self.prefills: "OrderedDict[int, StepGraph]" = OrderedDict()

    def _decode(self, inputs):
        logits = self.model().decode(inputs["token"], self.cache)
        return _sample(logits, self.temperature, self.generator)

    def _prefill(self, inputs):
        logits = self.model().prefill(inputs["prompt"], self.cache)
        return _sample(logits, self.temperature, self.generator)

    def prefill(self, prompt_len: int) -> StepGraph:
        """The prefill graph of prompts of ``prompt_len`` tokens (new, or
        the one kept), most recently used now; past :data:`_PREFILLS_CAP`
        lengths the least recently used is dropped. Called under
        :attr:`lock`."""
        graph = self.prefills.get(prompt_len)
        if graph is None:
            graph = self.prefills[prompt_len] = StepGraph(
                self._prefill, generators=self.generators, pool=self.pool)
            while len(self.prefills) > _PREFILLS_CAP:
                self.prefills.popitem(last=False)
        self.prefills.move_to_end(prompt_len)
        return graph


def _decoder(model: GPT, batch: int, greedy: bool,
             generator: Optional[torch.Generator]) -> _Decoder:
    key = (id(model), batch, greedy)
    with _DECODERS_LOCK:
        entry = _DECODERS.get(key)
        if (entry is not None and entry.model() is model
                and (greedy or entry.generator is generator)):
            _DECODERS.move_to_end(key)
            return entry
        for gone in [k for k, e in _DECODERS.items() if e.model() is None]:
            del _DECODERS[gone]
        entry = _DECODERS[key] = _Decoder(model, batch, greedy, generator)
        _DECODERS.move_to_end(key)
        while len(_DECODERS) > _DECODERS_CAP:
            _DECODERS.popitem(last=False)
    return entry


@torch.inference_mode()
def generate(
    cfg: GPTConfig,
    model: GPT,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    captured: bool = True,
) -> torch.Tensor:
    """Greedy (``temperature=0``) or sampled continuation of each prompt.

    ``prompt_ids`` is ``[batch, prompt_len]`` on the model's device; returns
    ``[batch, prompt_len + max_new_tokens]``. Sampling draws from
    ``generator``, so one seed gives one continuation. On the card the
    decode steps replay a captured CUDA graph unless ``captured=False``,
    which runs them eagerly (the reference the graph is held against); both
    give the same tokens.
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

    if prompt_ids.is_cuda and captured:
        decoder = _decoder(model, b, greedy, generator)
        with decoder.lock:
            if decoder.temperature is not None:
                decoder.temperature.fill_(temperature)
            prefill = decoder.prefill(p)
            # a replay runs no Python: a weight restored in place since the
            # last call gets its padded table here
            model.refresh_vocab_table()
            # each graph's output: the next replay rewrites it
            return _generate(
                prompt_ids, max_new_tokens,
                lambda: prefill({"prompt": prompt_ids}).clone(),
                lambda inputs: decoder.step(inputs).clone())
    cache = model.new_cache(b)
    temp = (None if greedy else
            torch.tensor(temperature, device=prompt_ids.device))

    def step(inputs):
        return _sample(model.decode(inputs["token"], cache), temp, generator)

    return _generate(
        prompt_ids, max_new_tokens,
        lambda: _sample(model.prefill(prompt_ids, cache), temp, generator),
        step)


def _generate(prompt_ids: torch.Tensor, max_new_tokens: int,
              first: Callable, step: Callable) -> torch.Tensor:
    """``first()``, the prefill and its sampled token, then
    ``max_new_tokens - 1`` calls of ``step`` (each feeds the previous token
    and samples from the fresh logits: the last sampled token never needs a
    forward of its own)."""
    tok = first()
    toks = [tok]
    for _ in range(max_new_tokens - 1):
        tok = step({"token": tok[:, None]})
        toks.append(tok)
    new = torch.stack(toks, dim=1).to(prompt_ids.dtype)
    return torch.cat([prompt_ids, new], dim=1)


__all__ = ["generate"]
