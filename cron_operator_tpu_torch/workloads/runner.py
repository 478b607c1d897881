"""The port's workload runner: the entrypoint of a PyTorchJob's pod, as
``cron_operator_tpu/workloads/runner.py`` is a JAXJob's.

    python -m cron_operator_tpu_torch.workloads.runner <entrypoint> [key=value ...]

``<entrypoint>`` is a registered short name (``gpt``, ``bert``, ``mnist``,
``resnet50``, ``vit``, ``generate``) or a ``module.path:function`` ref.
The runner:

1. gathers the params from ``TPU_PARAM_<KEY>`` env vars and ``key=value``
   args (args win), through :func:`backends.registry.normalize_param_key`;
2. when the world has more than one process, initialises
   ``torch.distributed`` (gloo with ``param.platform=cpu``, NCCL on the
   card) from ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``, or
   from the ``JAX_COORDINATOR_ADDRESS`` (``host:port``)/
   ``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID`` that the operator renders for
   a slice, and destroys the group on exit;
3. builds a :class:`backends.registry.JobContext` from ``TPU_JOB_NAME``,
   ``TPU_JOB_NAMESPACE`` and ``TPU_TRACE_ID``, and runs the entrypoint.

It speaks the JAX runner's protocol on stdout: JSON frames after the
``@@CRON_TPU@@ `` prefix, of type ``progress`` (each ``ctx.publish()``),
``error`` (the error, its traceback and the progress), ``spans`` (one
``runner`` span, when there is a trace id) and ``done`` (the progress and
whether the run was cancelled); values that JSON cannot hold (a tensor, a
numpy scalar) are cast at the frame. SIGTERM asks for a graceful stop
(``ctx.cancel``: a trainer stops between calls, and the checkpoint store is
drained before ``done``). Exit codes: 0 on success or a graceful stop, 1
when the entrypoint fails, 2 on a usage error.
"""

from __future__ import annotations

import json
import logging
import os
import random
import signal
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

logger = logging.getLogger("workloads.runner")

# Prefix of the machine-readable lines on stdout (everything else the
# workload prints passes through untouched); the JAX runner's.
PROGRESS_PREFIX = "@@CRON_TPU@@ "
# The env var that carries the creating tick's trace id; the JAX package's.
ENV_TRACE_ID = "TPU_TRACE_ID"

_rng = random.Random()


def new_span_id() -> str:
    """A 8-hex-char span id, as the JAX package's telemetry mints them."""
    return f"{_rng.getrandbits(32):08x}"


def _gather_params(argv: List[str]) -> Dict[str, str]:
    from cron_operator_tpu_torch.backends.registry import normalize_param_key

    params: Dict[str, str] = {}
    for key, value in os.environ.items():
        if key.startswith("TPU_PARAM_"):
            params[normalize_param_key(key[len("TPU_PARAM_"):])] = value
    for arg in argv:
        if "=" in arg:
            k, v = arg.split("=", 1)
            params[normalize_param_key(k)] = v  # the env's normalisation
    return params


def _world() -> Optional[Dict[str, Any]]:
    """``torch.distributed`` settings from the env, or None for one
    process: ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``, else
    the ``JAX_*`` names that the operator renders for a slice."""
    world = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if world > 1 and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
        rank = int(os.environ.get("RANK", "0") or 0)
        return {"init_method": f"tcp://{addr}", "world_size": world,
                "rank": rank}
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    world = int(os.environ.get("JAX_NUM_PROCESSES", "1") or 1)
    if coordinator and world > 1:
        rank = int(os.environ.get("JAX_PROCESS_ID", "0") or 0)
        return {"init_method": f"tcp://{coordinator}", "world_size": world,
                "rank": rank}
    return None


def _maybe_init_distributed(params: Dict[str, str]) -> bool:
    """Initialises the process group when the world has more than one
    process; returns whether it did."""
    world = _world()
    if world is None:
        return False
    import torch.distributed as dist

    backend = "gloo" if params.get("platform") == "cpu" else "nccl"
    if backend == "nccl":
        # NCCL's asynchronous error handling watches each collective's
        # events from a thread of its own, which a CUDA graph capture of
        # the meshed step refuses (PyTorch's recipe for DDP under graphs).
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    logger.info("initialising torch.distributed: %s %s rank %d of %d",
                backend, world["init_method"], world["rank"],
                world["world_size"])
    dist.init_process_group(backend, **world)
    return True


def _jsonable(value: Any) -> Any:
    """``json.dumps``'s fallback: a tensor or numpy value as a number or a
    list, anything else as its string."""
    if hasattr(value, "tolist"):
        return value.tolist()
    if hasattr(value, "item"):
        return value.item()
    return str(value)


def _emit(kind: str, payload: Dict) -> None:
    print(PROGRESS_PREFIX + json.dumps({"type": kind, **payload},
                                       default=_jsonable), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s\t%(levelname)s\t%(name)s\t%(message)s",
    )
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(
            "usage: python -m cron_operator_tpu_torch.workloads.runner "
            "<entrypoint> [key=value ...]",
            file=sys.stderr,
        )
        return 2
    entry_name, rest = argv[0], argv[1:]

    from cron_operator_tpu_torch.backends.registry import (
        JobContext,
        resolve_entrypoint,
    )

    params = _gather_params(rest)
    name = os.environ.get("TPU_JOB_NAME", entry_name)
    ctx = JobContext(
        name=name,
        namespace=os.environ.get("TPU_JOB_NAMESPACE", "default"),
        job={"metadata": {"name": name}},
        params=params,
        trace_id=os.environ.get(ENV_TRACE_ID) or None,
    )
    ctx.publish = lambda: _emit("progress", {"progress": ctx.progress})
    # SIGTERM = a graceful stop: the trainer exits between calls.
    signal.signal(signal.SIGTERM, lambda *_: ctx.cancel.set())

    t_run = time.time()
    distributed = False
    try:
        distributed = _maybe_init_distributed(params)
        resolve_entrypoint(entry_name)(ctx)
    except Exception as err:  # noqa: BLE001 -- report, then exit non-zero
        _emit("error", {
            "error": f"{type(err).__name__}: {err}",
            "traceback": traceback.format_exc(),
            "progress": ctx.progress,
        })
        return 1
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    if ctx.trace_id:
        # This process's span, shipped home over the progress stream.
        _emit("spans", {"spans": [{
            "name": "runner",
            "trace_id": ctx.trace_id,
            "span_id": new_span_id(),
            "parent_id": None,
            "start_s": t_run,
            "end_s": time.time(),
            "attrs": {
                "pid": os.getpid(),
                "proc": "runner",
                "entrypoint": entry_name,
            },
        }]})
    _emit("done", {"progress": ctx.progress, "cancelled": ctx.should_stop()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
