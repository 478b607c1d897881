"""Synthetic batches, as in ``cron_operator_tpu/workloads/data.py``: MNIST
images, ImageNet-shaped NHWC crops and token ids.

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


def mnist_batches(batch_size: int, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """28×28 grayscale images, 10 classes."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "x": rng.standard_normal((batch_size, 28, 28, 1), dtype=np.float32),
            "y": rng.integers(0, 10, size=(batch_size,), dtype=np.int32),
        }


def imagenet_batches(
    batch_size: int, image_size: int = 224, num_classes: int = 1000,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """NHWC float images, ImageNet-shaped."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "x": rng.standard_normal(
                (batch_size, image_size, image_size, 3), dtype=np.float32
            ),
            "y": rng.integers(0, num_classes, size=(batch_size,), dtype=np.int32),
        }


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


def device_mnist_batches(
    batch_size: int, *, device, seed: int = 0
) -> Iterator[Dict[str, torch.Tensor]]:
    """:func:`mnist_batches`' shapes, drawn on ``device``."""
    return _device_image_batches(batch_size, 28, 1, 10, device=device,
                                seed=seed)


def device_imagenet_batches(
    batch_size: int, image_size: int = 224, num_classes: int = 1000, *,
    device, seed: int = 0,
) -> Iterator[Dict[str, torch.Tensor]]:
    """:func:`imagenet_batches`' shapes, drawn on ``device``."""
    return _device_image_batches(batch_size, image_size, 3, num_classes,
                                device=device, seed=seed)


def _device_image_batches(
    batch_size: int, image_size: int, channels: int, num_classes: int, *,
    device, seed: int = 0,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Standard-normal NHWC f32 images and int32 labels, drawn on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (batch_size, image_size, image_size, channels)
    while True:
        x = torch.randn(shape, generator=gen, device=device)
        y = torch.randint(0, num_classes, (batch_size,), generator=gen,
                          device=device, dtype=torch.int32)
        yield {"x": x, "y": y}


def device_token_batches(
    batch_size: int, seq_len: int, vocab_size: int, *, device, seed: int = 0
) -> Iterator[Dict[str, torch.Tensor]]:
    """:func:`token_batches`' MLM pairs, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        ids = torch.randint(0, vocab_size, (batch_size, seq_len),
                            generator=gen, device=device, dtype=torch.int32)
        yield {"x": ids, "y": ids}


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
    "device_imagenet_batches",
    "device_mnist_batches",
    "device_token_batches",
    "imagenet_batches",
    "mnist_batches",
    "token_batches",
]
