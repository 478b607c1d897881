"""Synthetic token batches, as in ``cron_operator_tpu/workloads/data.py``.

``data=host`` (the numpy streams) is copied as it is: the same seed gives
the JAX package's batches, token for token, which is what the parity tests
feed both sides. ``data=device`` (the JAX default) draws the same shapes on
the card from a ``torch.Generator``; its stream differs from the JAX
package's Threefry stream for the same seed. ``data=fused`` (generation
inside the step) waits for the multi-step dispatch slice.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


def token_batches(
    batch_size: int, seq_len: int, vocab_size: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Token-id sequences with MLM-style targets (predict every position)."""
    rng = np.random.default_rng(seed)
    while True:
        ids = rng.integers(0, vocab_size, size=(batch_size, seq_len),
                           dtype=np.int32)
        yield {"x": ids, "y": ids}


def causal_token_batches(
    batch_size: int, seq_len: int, vocab_size: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Next-token pairs for causal LMs: draw ``seq_len + 1`` tokens and
    shift, ``y[t] = x[t + 1]``."""
    rng = np.random.default_rng(seed)
    while True:
        ids = rng.integers(0, vocab_size, size=(batch_size, seq_len + 1),
                           dtype=np.int32)
        yield {"x": ids[:, :-1], "y": ids[:, 1:]}


def device_causal_token_batches(
    batch_size: int, seq_len: int, vocab_size: int, *, device, seed: int = 0
) -> Iterator[Dict[str, torch.Tensor]]:
    """:func:`causal_token_batches`' shifted pairs, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        ids = torch.randint(0, vocab_size, (batch_size, seq_len + 1),
                            generator=gen, device=device)
        yield {"x": ids[:, :-1], "y": ids[:, 1:]}


__all__ = [
    "causal_token_batches",
    "device_causal_token_batches",
    "token_batches",
]
