"""The port's copy of the entrypoint contract of
``cron_operator_tpu/backends/registry.py``.

Port entrypoints only duck-type their ``ctx`` (``params``, ``progress``,
``publish``, ``should_stop``), so the JAX executor's ``JobContext`` works as
well as this one. This copy holds the fields the port's entrypoints read
and lets a caller outside the operator (a script, ``chip_smoke.py``, a
test) build a context without importing the JAX package. ``watchdog`` and
``hang`` are the JAX context's optional step-watchdog channels that the
training loop reads; ``trace_id`` is the id of the tick that created the
job (the port runner reads it from ``TPU_TRACE_ID``); ``slice_spec`` comes
with the device mesh.

:func:`register_entrypoint` and :func:`resolve_entrypoint` are the
counterparts of the JAX registry's: a short name (``gpt``, ``bert``,
``mnist``, ``resnet50``, ``vit``, ``generate``) resolves to the port's
entrypoint, a ``module.path:function`` ref is imported.
"""

from __future__ import annotations

import importlib
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, Callable[["JobContext"], Any]] = {}


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
    # trace id of the cron tick that created this workload
    trace_id: Optional[str] = None
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


def register_entrypoint(name: str, fn: Optional[Callable] = None):
    """Register an entrypoint under a short name; a decorator
    (``@register_entrypoint("mnist")``) or a call."""

    def _register(f):
        _REGISTRY[name] = f
        return f

    if fn is not None:
        return _register(fn)
    return _register


def resolve_entrypoint(ref: str) -> Callable[[JobContext], Any]:
    """The entrypoint a registered short name or a ``module.path:function``
    ref names. The port's standard entrypoints register on first use; an
    unknown name raises ``ValueError`` listing the registered ones."""
    if ref not in _REGISTRY and ":" not in ref:
        importlib.import_module("cron_operator_tpu_torch.workloads.entrypoints")
    if ref in _REGISTRY:
        return _REGISTRY[ref]
    if ":" in ref:
        module_name, fn_name = ref.split(":", 1)
        fn = getattr(importlib.import_module(module_name), fn_name, None)
        if fn is None:
            raise ValueError(f"no function {fn_name!r} in module {module_name!r}")
        return fn
    raise ValueError(
        f"unknown entrypoint {ref!r}; registered: {sorted(_REGISTRY)} "
        "(or use 'module.path:function')"
    )


__all__ = [
    "JobContext",
    "normalize_param_key",
    "register_entrypoint",
    "resolve_entrypoint",
]
