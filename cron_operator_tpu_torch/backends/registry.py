"""The port's copy of the entrypoint contract of
``cron_operator_tpu/backends/registry.py``.

Port entrypoints only duck-type their ``ctx`` (``params``, ``progress``,
``publish``, ``should_stop``), so the JAX executor's ``JobContext`` works as
well as this one. This copy holds the fields the port's entrypoints read
and lets a caller outside the operator (a script, ``chip_smoke.py``, a
test) build a context without importing the JAX package. ``watchdog`` and
``hang`` are the JAX context's optional step-watchdog channels that the
training loop reads; ``slice_spec`` and ``trace_id`` come with the slices
that read them.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


def normalize_param_key(key: str) -> str:
    """Canonical param-key form shared by every producer and consumer:
    lowercase, non-identifier characters become ``_``."""
    return re.sub(r"[^a-z0-9_]", "_", key.lower())


@dataclass
class JobContext:
    """Everything an entrypoint gets about its job."""

    name: str
    namespace: str
    job: Dict[str, Any]  # full unstructured workload
    # tpu.kubedl.io/param.* annotations, keys normalized on construction
    params: Dict[str, str]
    cancel: threading.Event = field(default_factory=threading.Event)
    # progress the entrypoint publishes; the executor folds it into the
    # workload's status.trainingProgress
    progress: Dict[str, Any] = field(default_factory=dict)
    # set by the executor: flushes `progress` into the status mid-run
    publish: Optional[Callable[[], None]] = None
    # step-progress watchdog: the training loop calls .beat() after every
    # step; None = not armed
    watchdog: Optional[Any] = None
    # injected gray failure: once set, the training loop stops progressing
    # until the job is cancelled; None = no injection channel
    hang: Optional[threading.Event] = None

    def __post_init__(self) -> None:
        self.params = {
            normalize_param_key(k): str(v) for k, v in self.params.items()
        }

    def should_stop(self) -> bool:
        return self.cancel.is_set()


__all__ = ["JobContext", "normalize_param_key"]
