"""Workload-facing backend pieces of the port: the ``JobContext`` an
entrypoint receives. The executor itself is the JAX package's
``LocalExecutor``, which reaches port entrypoints by ``module:function``."""

from cron_operator_tpu_torch.backends.registry import JobContext

__all__ = ["JobContext"]
