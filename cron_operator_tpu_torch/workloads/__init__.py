"""Schedulable workloads of the port: KV-cache generation and its
``generate_job`` entrypoint, the training harness and the ``gpt`` training
entrypoint. Importing this package builds nothing."""

from cron_operator_tpu_torch.workloads.entrypoints import generate_job, gpt
from cron_operator_tpu_torch.workloads.generate import generate

__all__ = ["generate", "generate_job", "gpt"]
