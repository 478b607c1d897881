"""Workload-facing backend pieces of the port: the ``JobContext`` an
entrypoint receives, the entrypoint registry (short names and
``module:function`` refs) and the card's peak FLOP/s for MFU. The executor
itself is the JAX package's ``LocalExecutor``, which reaches port
entrypoints by ``module:function``; a PyTorchJob's pod runs the port's
runner (``workloads/runner.py``)."""

from cron_operator_tpu_torch.backends.gpu import peak_flops_per_chip
from cron_operator_tpu_torch.backends.registry import (
    JobContext,
    register_entrypoint,
    resolve_entrypoint,
)

__all__ = ["JobContext", "peak_flops_per_chip", "register_entrypoint",
           "resolve_entrypoint"]
