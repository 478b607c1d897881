"""Hot-op layer of the port: the hand-written Hopper flash-attention
kernels (forward ``csrc/flash_fwd.cu``, backward ``csrc/flash_bwd.cu``)
with their plain PyTorch versions, the attention dispatcher, RoPE and the
chunked cross-entropy."""

from cron_operator_tpu_torch.ops.attention import (
    multi_head_attention,
    reference_attention,
)
from cron_operator_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["multi_head_attention", "reference_attention", "flash_attention"]
