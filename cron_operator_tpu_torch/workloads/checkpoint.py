"""Checkpoints and resume, as in ``cron_operator_tpu/workloads/checkpoint.py``.

The recovery half of preemption: a training job that checkpoints saves its
whole state (parameters, optimizer state, step count, the fused-data
generator) every ``save_every`` steps; the executor's re-run of a preempted
job restores the newest step and trains only the steps that remain.

Layout: ``<root>/<namespace>/<lineage>/<step>/state.pt``. The lineage is
the full job name by default (a restart re-runs the same name and finds its
own checkpoints; concurrent ticks get directories of their own), or with
``lineage="family"`` the name without its per-tick unix suffix, so that
successive Forbid ticks continue one run.

Over a device mesh every rank gathers the state whole and rank 0 alone
writes it (the trainer's choice; the store is the same), so a checkpoint
is the one-device state whatever world size saved it, and
:meth:`CheckpointStore.restore_resharded` places it onto any mesh: a
tensor that the live model holds in pieces over ``tensor`` or ``expert``
(a :class:`Piece` in ``like``) is cut to this rank's piece first, so a
step saved under ``data 2 x expert 2`` restores on one rank and back.

Format: the port's own, not Orbax. A step is a directory written under a
temporary name and committed by ``os.replace``, so a listed step was
written whole; its payload is ``torch.save`` of CPU tensors and plain
Python values, read back with ``torch.load(weights_only=True)``. A save
takes host tensors (the caller copies off the card) and writes them from a
background thread: :meth:`CheckpointStore.wait`, :meth:`CheckpointStore.close`
and :func:`flush_open_stores` drain it. Retention (``max_to_keep``) applies
only after a save has committed.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

logger = logging.getLogger("workloads.checkpoint")

# Every open store, so that a preemption path can drain its saves without a
# reference to the entrypoint's store (weak: a collected store has nothing
# in flight).
_OPEN_LOCK = threading.Lock()
_OPEN_STORES: "weakref.WeakSet[CheckpointStore]" = weakref.WeakSet()

DEFAULT_ROOT = os.environ.get("TPU_CHECKPOINT_DIR", "/tmp/cron-operator-tpu/ckpt")

_TICK_SUFFIX = re.compile(r"-\d{9,11}$")  # "<cron>-<unixTs>" -> "<cron>"
PAYLOAD = "state.pt"


def job_family(name: str) -> str:
    """The job name without its per-tick unix-timestamp suffix, so that
    successive runs share a checkpoint lineage."""
    return _TICK_SUFFIX.sub("", name) or name


@dataclass(frozen=True)
class Piece:
    """A ``like`` entry for a tensor that the live model holds in pieces
    (a parameter split over ``tensor`` or ``expert``, or state shaped like
    it): the payload holds it whole, of ``shape``; ``take`` cuts the whole
    tensor to this rank's piece, which is then placed as ``like``."""

    like: torch.Tensor
    shape: Tuple[int, ...]
    take: Callable[[torch.Tensor], torch.Tensor]


def _check_like(payload: Any, like: Any, path: str = "") -> None:
    """Raises ``ValueError`` unless every tensor of ``like`` is in
    ``payload`` at the same path with the same shape and dtype (a
    :class:`Piece`'s whole shape)."""
    if torch.is_tensor(like) or isinstance(like, Piece):
        shape = like.shape if torch.is_tensor(like) else torch.Size(
            like.shape)
        dtype = (like if torch.is_tensor(like) else like.like).dtype
        if not (torch.is_tensor(payload) and payload.shape == shape
                and payload.dtype == dtype):
            got = (f"{tuple(payload.shape)} {payload.dtype}"
                   if torch.is_tensor(payload) else type(payload).__name__)
            raise ValueError(
                f"checkpoint entry {path or '/'} is {got}, expected "
                f"{tuple(shape)} {dtype}"
            )
    elif isinstance(like, dict):
        if not isinstance(payload, dict):
            raise ValueError(f"checkpoint entry {path or '/'} is not a dict")
        for key, value in like.items():
            if key not in payload:
                raise ValueError(f"checkpoint has no entry {path}/{key}")
            _check_like(payload[key], value, f"{path}/{key}")


def place_like(payload: Any, like: Any) -> Any:
    """``payload`` (nested dicts of whole CPU tensors and plain values) with
    every tensor that ``like`` holds at the same path placed as that one:
    a DTensor ``like`` gives a DTensor on its mesh with its placements,
    each rank keeping its own shard of the whole tensor (nothing is sent),
    a plain tensor ``like`` gives a tensor on its device, a :class:`Piece`
    this rank's piece, placed as its ``like``. Entries that ``like`` does
    not name stay as they are. Shapes and dtypes must agree."""
    if isinstance(like, Piece):
        _check_like(payload, like)
        return place_like(like.take(payload), like.like)
    if torch.is_tensor(like):
        _check_like(payload, like)
        if isinstance(like, DTensor):
            return distribute_tensor(payload.to(like.device), like.device_mesh,
                                     like.placements, src_data_rank=None)
        return payload.to(like.device)
    if isinstance(like, dict) and isinstance(payload, dict):
        return {k: place_like(v, like[k]) if k in like else v
                for k, v in payload.items()}
    return payload


class CheckpointStore:
    """The saved steps of one lineage, and a background writer."""

    def __init__(
        self,
        namespace: str,
        job_name: str,
        root: Optional[str] = None,
        max_to_keep: int = 3,
        lineage: str = "job",  # "job" | "family": see the module docstring
        create: bool = True,  # False opens read-only (serving): a mistyped
        # lineage raises and leaves no empty directory behind
    ):
        if lineage not in ("job", "family"):
            raise ValueError(f"unknown checkpoint lineage {lineage!r}")
        key = job_family(job_name) if lineage == "family" else job_name
        self.directory = os.path.join(root or DEFAULT_ROOT, namespace, key)
        if create:
            os.makedirs(self.directory, exist_ok=True)
        elif not os.path.isdir(self.directory):
            raise FileNotFoundError(
                f"no checkpoint lineage at {self.directory}"
            )
        self.namespace = namespace
        self.job_name = job_name
        self.max_to_keep = max(1, int(max_to_keep))
        self.read_only = not create
        #: Restores served from an older retained step after a newer one
        #: failed to load.
        self.fallbacks = 0
        self._metrics: Optional[Any] = None
        self._writer: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []
        self._lock = threading.Lock()
        self._serial = 0
        with _OPEN_LOCK:
            _OPEN_STORES.add(self)

    def instrument(self, metrics: Any) -> None:
        """Attach a metrics sink (``.inc(series)``) for fallback counts."""
        self._metrics = metrics

    def _count(self, series: str, value: int = 1) -> None:
        if self._metrics is not None:
            try:
                self._metrics.inc(series, value)
            except Exception:  # a sink must never break the restore
                logger.debug("metrics sink failed for %s", series)

    def all_steps(self) -> List[int]:
        """The committed steps, oldest first."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Queues ``state`` (CPU tensors and plain values, which the caller
        must not change afterwards) to be written as ``step``, after the
        write before it has finished (so that at most two states are held
        in host memory). The write runs on the store's writer thread; a
        failed write raises at the next :meth:`save` or :meth:`wait`."""
        if self.read_only:
            raise PermissionError(f"{self.directory} was opened read-only")
        self.wait()
        with self._lock:
            if self._writer is None:
                self._writer = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-writer")
            self._serial += 1
            self._pending.append(self._writer.submit(
                self._write, int(step), state, self._serial))

    def _write(self, step: int, state: Any, serial: int) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}-{serial}")
        os.makedirs(tmp)
        try:
            torch.save(state, os.path.join(tmp, PAYLOAD))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def _raise_failed(self) -> None:
        """Drops finished writes; re-raises the first that failed."""
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()

    def restore(self, step: int, like: Any = None) -> Any:
        """The payload of ``step``, checked against ``like`` (a nested dict
        of tensors whose shapes and dtypes the payload must hold, or None)."""
        path = os.path.join(self.directory, str(step), PAYLOAD)
        # mapped, not read: the tensors are copied once, to their device
        payload = torch.load(path, map_location="cpu", weights_only=True,
                             mmap=True)
        if like is not None:
            _check_like(payload, like)
        return payload

    def restore_latest(self, like: Any = None) -> Tuple[int, Any]:
        """``(step, payload)`` of the newest step that restores.

        A save torn by a preemption, or a disk fault, can leave the newest
        retained step unreadable while older ones are whole: walk
        :meth:`all_steps` newest to oldest, counting every skipped step in
        :attr:`fallbacks` and ``workload_checkpoint_fallbacks_total``.
        Raises ``FileNotFoundError`` when there is no step, and the last
        error when every step fails."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}"
            )
        last_err: Optional[BaseException] = None
        for step in reversed(steps):
            try:
                return step, self.restore(step, like)
            except Exception as err:
                last_err = err
                self.fallbacks += 1
                self._count("workload_checkpoint_fallbacks_total")
                logger.warning(
                    "checkpoint step %s unreadable (%s); falling back to "
                    "an older retained step", step, err,
                )
        raise last_err  # type: ignore[misc]  # the loop ran at least once

    def restore_resharded(self, step: int, like: Any) -> Any:
        """Restore across device meshes: the checkpoint holds whole tensors
        keyed by name, whatever world size saved it, and each tensor that
        ``like`` declares is placed as ``like``'s is (:func:`place_like`):
        a DTensor's shards onto its mesh, a plain tensor onto its device, a
        :class:`Piece` this rank's piece of a ``tensor`` or ``expert``
        split.
        The JAX package's Tenplex plan, restricted to this format."""
        return place_like(self.restore(step, like), like)

    def restore_params(self, step: Optional[int] = None) -> Any:
        """The ``params`` part of ``step`` (default: the newest) for
        serving, which needs no optimizer state."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}"
            )
        return self.restore(step)["params"]

    def wait(self) -> None:
        """Blocks until every save queued so far is on disk; re-raises a
        failed write."""
        with self._lock:
            pending = list(self._pending)
        for f in pending:
            f.result()
        with self._lock:
            self._raise_failed()

    def close(self) -> None:
        """Drains the writer, then releases it. A job torn down between a
        save and its write keeps that step as long as ``close()`` (or
        :func:`flush_open_stores`) runs first."""
        try:
            self.wait()
        except Exception:
            logger.warning("checkpoint write failed before close",
                           exc_info=True)
        finally:
            with self._lock:
                if self._writer is not None:
                    self._writer.shutdown(wait=True)
                    self._writer = None
                self._pending = []
            with _OPEN_LOCK:
                _OPEN_STORES.discard(self)


def flush_open_stores(
    namespace: Optional[str] = None, job_name: Optional[str] = None
) -> int:
    """Drains the writes of every open store, optionally of one namespace
    and/or job, so that the last ``save()`` is on disk before the job dies;
    returns how many stores were flushed."""
    with _OPEN_LOCK:
        stores = [
            s for s in list(_OPEN_STORES)
            if (namespace is None or s.namespace == namespace)
            and (job_name is None or s.job_name == job_name)
        ]
    flushed = 0
    for store in stores:
        try:
            store.wait()
            flushed += 1
        except Exception:
            logger.warning(
                "checkpoint flush failed for %s", store.directory,
                exc_info=True,
            )
    return flushed


__all__ = [
    "CheckpointStore",
    "DEFAULT_ROOT",
    "Piece",
    "flush_open_stores",
    "job_family",
    "place_like",
]
