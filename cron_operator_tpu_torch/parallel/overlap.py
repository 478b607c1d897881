"""Overlap primitives: background staging and multi-step dispatch, as in
``cron_operator_tpu/parallel/overlap.py``.

- :class:`DoubleBuffer` runs a ``stage`` callable (host batch build and
  placement on the card) over an iterator from a producer thread, so that
  item N+1 is staged while item N computes. ``workloads.data.Prefetcher``
  (single batches) and ``workloads.data.ChunkStager`` (chunks of K batches)
  are thin facades over it. A copy of the JAX package's class, pure Python.
- :class:`StepGraph` is the counterpart of ``chain_steps``. The JAX package
  scans K optimizer steps inside one jitted program; the port captures ONE
  step as a CUDA graph and replays it K times per call, so that a step
  costs one graph launch from the host instead of hundreds of kernel
  launches. The math and the data stream stay those of one step per call.
- :func:`chunk_schedule` cuts a run into calls of up to K steps, a copy of
  the JAX package's function.

``stacked_shardings`` has no counterpart: no chunk is stacked. Each step of
a meshed call takes its own batch, this rank's rows of it
(``workloads.data.local_rows``), and a meshed step is captured only on the
plain data-parallel path over NCCL (``workloads.train``).
"""

from __future__ import annotations

import inspect
import logging
import queue
import threading
import weakref
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import torch

from cron_operator_tpu_torch.ops.flash_attention import (
    capture_launches,
    count_replays,
)


class DoubleBuffer:
    """Background staging: overlap ``stage(item)`` with the consumer.

    The producer thread pulls from ``items``, applies ``stage`` (placement on
    the card happens on that thread) and parks the result in a bounded queue
    (``depth`` caps the memory spent on staged-ahead work). With ``depth >=
    2`` the next item is staged while the current one is consumed.

    Must be :meth:`close`'d (the Trainer does, in ``run``'s finally): the
    producer of an infinite generator would otherwise park forever. A
    ``stage``/generator exception is re-raised on the consumer at
    ``next()``; after exhaustion or :meth:`close` the iterator keeps raising
    ``StopIteration`` (it never parks on a dead producer).
    """

    _DONE = object()

    def __init__(
        self,
        items: Iterable[Any],
        stage: Callable[[Any], Any],
        depth: int = 2,
        name: str = "stage-ahead",
    ):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._exc: Optional[Exception] = None
        self._finished = False  # terminal: next() keeps raising StopIteration
        self._items = items
        self._stage = stage
        self._thread = threading.Thread(target=self._fill, name=name,
                                        daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        def offer(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for item in self._items:
                if not offer(self._stage(item)):
                    return
                if self._stop.is_set():
                    return
        except Exception as exc:  # noqa: BLE001 — re-raised on the consumer
            self._exc = exc
        offer(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._finished = True
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        self._finished = True
        # Unblock a producer parked on a full queue; only Empty ends the
        # drain.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            logging.getLogger("parallel.overlap").warning(
                "stage-ahead producer thread still alive 5s after close(); "
                "a stage()/generator call is blocked — leaking the thread"
            )


class StepGraph:
    """``fn(inputs) -> outputs`` on the card, captured once as a CUDA graph
    and replayed.

    ``inputs`` is a dict of tensors (possibly empty) and ``fn`` must do the
    same work for any values of them: no host sync, no Python decision on a
    device value, every varying scalar (a learning rate, a temperature) in a
    device tensor that the caller fills before the call.

    The first ``warmup`` calls run ``fn`` eagerly on a side stream, real
    steps that consume their ``inputs`` and return their own outputs: they
    build the kernels, set their shared-memory limits, create the cuBLAS
    and cuDNN handles, the optimizer's state and the NCCL communicators,
    and let ``DistributedDataParallel`` rebuild its buckets and pass its
    first iterations' timing, none of which may happen inside a capture.
    The last of them then captures ``fn`` on the same stream over static
    copies of the inputs, which records and runs nothing. Every later call copies
    ``inputs`` into those static buffers, in stream order behind the replay
    before, and replays the graph; its outputs are the tensors the capture
    returned, overwritten by each replay. Every address the graph holds
    (static inputs, parameters, optimizer state, the graph's own pool, the
    kernels' TMA descriptors encoded at capture) stays fixed while it
    lives, and nothing here reallocates them.

    ``stream`` is the stream the warm-up and the capture run on (default:
    a side stream of the graph's own). A caller whose modules keep
    per-stream state, such as ``DistributedDataParallel``'s gradient
    accumulators, passes the stream it built them and runs its eager
    steps on.

    ``generators`` (torch.Generators on the card) are registered with the
    graph, so each replay draws what the eager call would have drawn at
    that point of the generator's stream. ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) is the memory pool the capture
    allocates from, shared with the other graphs given it; a caller shares
    one only between graphs that never run at the same time. By default
    the graph has a pool of its own. The capture runs with
    ``capture_error_mode="thread_local"``: other threads of the process
    (a staging thread, other jobs) keep using the card meanwhile.

    The flash kernels that the capture records on its stream (the
    backward's too, which the autograd engine launches from its own thread)
    are counted apart (:func:`ops.flash_attention.capture_launches`) and
    added to the wrappers' counts once per replay. A failed capture or replay raises;
    nothing falls back to eager execution.
    """

    def __init__(self, fn: Callable[[Dict[str, torch.Tensor]], Any],
                 generators: Sequence[torch.Generator] = (),
                 warmup: int = 1,
                 stream: Optional[torch.cuda.Stream] = None,
                 pool: Optional[tuple] = None):
        # A bound method (the Trainer's step) is held weakly: its owner
        # holds this graph, and a strong reference back would make a cycle
        # that keeps a deleted owner's graph, and its memory pool, alive
        # until the cycle collector runs.
        self._fn = (weakref.WeakMethod(fn) if inspect.ismethod(fn)
                    else lambda: fn)
        self._generators = tuple(generators)
        self._warmup = max(1, int(warmup))
        self._side = stream
        self._pool = pool
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._inputs: Dict[str, torch.Tensor] = {}
        self._outputs: Any = None
        self._launches: Dict[Any, int] = {}
        self.replays = 0

    def __call__(self, inputs: Dict[str, torch.Tensor]) -> Any:
        if self._graph is None:
            self._warmup -= 1
            return self._warm_up(inputs, capture=self._warmup == 0)
        for name, value in inputs.items():
            self._inputs[name].copy_(value)
        self._graph.replay()
        count_replays(self._launches, 1)
        self.replays += 1
        return self._outputs

    def _warm_up(self, inputs: Dict[str, torch.Tensor], capture: bool) -> Any:
        """One eager call on the side stream, then the capture if
        ``capture``."""
        device = next(iter(inputs.values())).device if inputs else None
        main = torch.cuda.current_stream(device)
        if self._side is None:
            self._side = torch.cuda.Stream(device)
        side = self._side
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn = self._fn()
            outputs = fn(inputs)
            if not capture:
                main.wait_stream(side)
                return outputs
            self._inputs = {name: torch.empty_like(value)
                            for name, value in inputs.items()}
            graph = torch.cuda.CUDAGraph()
            for gen in self._generators:
                graph.register_generator_state(gen)
            with capture_launches(side.cuda_stream) as launches, \
                    torch.cuda.graph(graph, pool=self._pool, stream=side,
                                     capture_error_mode="thread_local"):
                self._outputs = fn(self._inputs)
        main.wait_stream(side)
        self._graph = graph
        self._launches = launches
        return outputs


def chunk_schedule(
    start: int, target: int, steps_per_call: int, boundary: int = 0
) -> list:
    """Chunk sizes for a multi-step run from ``start`` to ``target`` total
    steps: each call carries up to ``steps_per_call`` steps but never
    crosses a ``boundary`` multiple (checkpoint ``save_every``: a save must
    land ON its step) and never overshoots ``target``. ``boundary=0``
    disables snapping."""
    out = []
    done = max(0, int(start))
    target = int(target)
    spc = max(1, int(steps_per_call))
    while done < target:
        chunk = min(spc, target - done)
        if boundary and boundary > 0:
            to_boundary = boundary - (done % boundary)
            chunk = min(chunk, to_boundary)
        out.append(chunk)
        done += chunk
    return out


__all__ = ["DoubleBuffer", "StepGraph", "chunk_schedule"]
