"""Schedulable workloads of the port: KV-cache generation and its
``generate_job`` entrypoint, the training harness, checkpoints, the
training entrypoints (``gpt``, ``bert``, ``mnist``, ``resnet50``, ``vit``)
and the pod runner (``python -m cron_operator_tpu_torch.workloads.runner``).
Importing this package builds nothing."""

from cron_operator_tpu_torch.workloads.checkpoint import (
    CheckpointStore,
    flush_open_stores,
)
from cron_operator_tpu_torch.workloads.entrypoints import (
    bert,
    generate_job,
    gpt,
    mnist,
    resnet50,
    vit,
)
from cron_operator_tpu_torch.workloads.generate import generate

__all__ = ["CheckpointStore", "bert", "flush_open_stores", "generate",
           "generate_job", "gpt", "mnist", "resnet50", "vit"]
