"""Models of the port: the GPT family (dense blocks) and the flax-to-torch
weight converter. Other families come with later slices."""

from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig

__all__ = ["GPT", "GPTConfig"]
