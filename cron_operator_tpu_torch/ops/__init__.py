"""Hot-op layer of the port: the hand-written Hopper flash-attention
forward (``csrc/flash_fwd.cu``) with its plain PyTorch version, the
attention dispatcher and RoPE."""

from cron_operator_tpu_torch.ops.attention import (
    multi_head_attention,
    reference_attention,
)
from cron_operator_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["multi_head_attention", "reference_attention", "flash_attention"]
