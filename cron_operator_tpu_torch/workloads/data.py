"""Synthetic batches, as in ``cron_operator_tpu/workloads/data.py``: MNIST
images, ImageNet-shaped NHWC crops and token ids.

``data=host`` (the numpy streams) is copied as it is: the same seed gives
the JAX package's batches, token for token, which is what the parity tests
feed both sides. ``data=device`` (the JAX default) draws the same shapes on
the card from a ``torch.Generator`` (``device_*_batches``), and
``data=fused`` draws them inside the training step; both go through the
``*_sample`` functions, so one seed gives both the same batches. That
stream differs from the JAX package's Threefry stream for the same seed.
``Prefetcher`` and ``ChunkStager`` stage batches from a producer thread.

Over a device mesh every rank draws the same global batch from the same
seed, whatever the mode, and keeps its rows (:func:`local_rows`), and
under sequence parallelism its block of their positions, so that a sharded
run trains on exactly the one-process batches.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch

from cron_operator_tpu_torch.parallel.mesh import batch_rows, seq_block
from cron_operator_tpu_torch.parallel.overlap import DoubleBuffer


def local_rows(batch: torch.Tensor, mesh, seq_dim=None) -> torch.Tensor:
    """This rank's rows of a global ``batch`` under ``mesh``
    (:func:`parallel.mesh.batch_rows`: split over ``data``, then
    ``fsdp``), and with ``seq_dim`` its block of that dim
    (:func:`parallel.mesh.seq_block`), as ``batch_placements(mesh,
    seq_dim=seq_dim)`` lays a batch out."""
    rows = batch[batch_rows(mesh, batch.shape[0])]
    if seq_dim is None:
        return rows
    block = seq_block(mesh, rows.shape[seq_dim])
    return rows.narrow(seq_dim, block.start, block.stop - block.start)


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


def mnist_sample(batch_size: int):
    """``generator -> batch`` of :func:`mnist_batches`' shapes, drawn on the
    generator's device: the sample function that :func:`device_batches`
    (one draw per batch) and the Trainer's fused data mode (the draw inside
    the step, ``train.Trainer(sample_fn=...)``) share, so that both draw the
    same values from the same seed. Inside a CUDA graph the draw allocates
    from the graph's pool, whose addresses stay fixed across replays."""
    return _image_sample(batch_size, 28, 1, 10)


def imagenet_sample(batch_size: int, image_size: int = 224,
                    num_classes: int = 1000):
    """``generator -> batch`` of :func:`imagenet_batches`' shapes (see
    :func:`mnist_sample`)."""
    return _image_sample(batch_size, image_size, 3, num_classes)


def _image_sample(batch_size: int, image_size: int, channels: int,
                  num_classes: int):
    """Standard-normal NHWC f32 images and int32 labels."""
    shape = (batch_size, image_size, image_size, channels)

    def sample(gen: torch.Generator) -> Dict[str, torch.Tensor]:
        x = torch.randn(shape, generator=gen, device=gen.device)
        y = torch.randint(0, num_classes, (batch_size,), generator=gen,
                          device=gen.device, dtype=torch.int32)
        return {"x": x, "y": y}

    return sample


def token_sample(batch_size: int, seq_len: int, vocab_size: int):
    """``generator -> batch`` of :func:`token_batches`' MLM pairs (see
    :func:`mnist_sample`)."""
    def sample(gen: torch.Generator) -> Dict[str, torch.Tensor]:
        ids = torch.randint(0, vocab_size, (batch_size, seq_len),
                            generator=gen, device=gen.device,
                            dtype=torch.int32)
        return {"x": ids, "y": ids}

    return sample


def causal_token_sample(batch_size: int, seq_len: int, vocab_size: int):
    """``generator -> batch`` of :func:`causal_token_batches`' shifted pairs
    (see :func:`mnist_sample`)."""
    def sample(gen: torch.Generator) -> Dict[str, torch.Tensor]:
        ids = torch.randint(0, vocab_size, (batch_size, seq_len + 1),
                            generator=gen, device=gen.device)
        return {"x": ids[:, :-1], "y": ids[:, 1:]}

    return sample


def device_batches(sample_fn, *, device, seed: int = 0
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches drawn on ``device`` by ``sample_fn`` from a
    ``torch.Generator`` seeded with ``seed``, one draw per batch."""
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        yield sample_fn(gen)


def device_mnist_batches(batch_size: int, *, device, seed: int = 0):
    """:func:`mnist_batches`' shapes, drawn on ``device``."""
    return device_batches(mnist_sample(batch_size), device=device, seed=seed)


def device_imagenet_batches(
    batch_size: int, image_size: int = 224, num_classes: int = 1000, *,
    device, seed: int = 0,
):
    """:func:`imagenet_batches`' shapes, drawn on ``device``."""
    return device_batches(imagenet_sample(batch_size, image_size, num_classes),
                          device=device, seed=seed)


def device_token_batches(
    batch_size: int, seq_len: int, vocab_size: int, *, device, seed: int = 0
):
    """:func:`token_batches`' MLM pairs, drawn on ``device``."""
    return device_batches(token_sample(batch_size, seq_len, vocab_size),
                          device=device, seed=seed)


def device_causal_token_batches(
    batch_size: int, seq_len: int, vocab_size: int, *, device, seed: int = 0
):
    """:func:`causal_token_batches`' shifted pairs, drawn on ``device``."""
    return device_batches(
        causal_token_sample(batch_size, seq_len, vocab_size),
        device=device, seed=seed)


class Prefetcher(DoubleBuffer):
    """Background batch placement: the next batch is put on the card
    (``place``, the Trainer's ``put_batch``) by a producer thread while the
    current step runs. ``depth`` bounds the memory spent on staged batches.
    Must be :meth:`close`'d (the Trainer does, in ``run``'s finally)."""

    def __init__(self, batches, place, depth: int = 2):
        super().__init__(batches, place, depth, name="batch-prefetch")


def grouped(batches: Iterator[Dict[str, Any]], schedule) -> Iterator[list]:
    """Group a batch stream into lists sized by ``schedule`` (an iterable of
    chunk lengths, e.g. :func:`parallel.overlap.chunk_schedule`). A stream
    that ends mid-group yields the partial group and stops: the consumer
    trains what exists rather than dropping staged work."""
    it = iter(batches)
    for k in schedule:
        group = []
        # Inside a generator an escaping StopIteration is a RuntimeError
        # (PEP 479), not the end of the stream.
        try:
            for _ in range(max(1, k)):
                group.append(next(it))
        except StopIteration:
            if group:
                yield group
            return
        yield group


class ChunkStager(DoubleBuffer):
    """Background chunk staging for multi-step dispatch: groups the batch
    stream into ``schedule``-sized chunks and runs ``place_chunk`` (the
    Trainer's ``put_chunk``) on a producer thread, so that chunk N+1 is on
    the card while chunk N's steps run. ``depth`` bounds the staged-ahead
    chunks; the memory cost is ``depth * K`` batches."""

    def __init__(self, batches, schedule, place_chunk, depth: int = 2):
        super().__init__(grouped(batches, schedule), place_chunk, depth,
                         name="chunk-stager")


__all__ = [
    "ChunkStager",
    "Prefetcher",
    "causal_token_batches",
    "causal_token_sample",
    "device_batches",
    "device_causal_token_batches",
    "device_imagenet_batches",
    "device_mnist_batches",
    "device_token_batches",
    "grouped",
    "imagenet_batches",
    "imagenet_sample",
    "local_rows",
    "mnist_batches",
    "mnist_sample",
    "token_batches",
    "token_sample",
]
