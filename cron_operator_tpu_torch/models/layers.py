"""Shared Q/K/V projection, as in ``cron_operator_tpu/models/layers.py``.

Fused ``qkv`` projection to ``(3, heads, head_dim)`` for MHA; split ``q``
(``(heads, head_dim)``) and ``kv`` (``(2, kv_heads, head_dim)``) for
grouped-query configs; RoPE on Q/K when the config asks for it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cron_operator_tpu_torch.ops.rope import apply_rope


class GroupedQKVProjection(nn.Module):
    """``y [b, s, hidden]`` -> (q, k, v), each ``[b, s, heads, head_dim]``
    with k/v at ``kv_heads``. The counterpart of ``grouped_qkv_projection``.

    ``cfg`` needs ``hidden_size``, ``num_heads``, ``num_kv_heads`` (0 = MHA),
    ``dtype`` and ``rope``. When ``cfg.rope``, Q/K rotate at
    ``rope_positions`` (default ``arange(s)``; decode passes its one cache
    position). For MHA, q/k/v are strided views of one fused output.
    """

    def __init__(self, cfg, device=None):
        super().__init__()
        self.heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.kv_heads = cfg.num_kv_heads or cfg.num_heads
        self.rope = cfg.rope
        if self.kv_heads < 1 or cfg.num_heads % self.kv_heads:
            raise ValueError(
                f"num_kv_heads {self.kv_heads} must be a positive divisor of "
                f"num_heads {cfg.num_heads}"
            )
        kw = dict(device=device, dtype=cfg.dtype)
        width = self.heads * self.head_dim
        if self.kv_heads == self.heads:
            self.qkv = nn.Linear(cfg.hidden_size, 3 * width, **kw)
        else:
            self.q = nn.Linear(cfg.hidden_size, width, **kw)
            self.kv = nn.Linear(
                cfg.hidden_size, 2 * self.kv_heads * self.head_dim, **kw
            )

    def forward(
        self, y: torch.Tensor, rope_positions: Optional[torch.Tensor] = None
    ):
        b, s, _ = y.shape
        d = self.head_dim
        if self.kv_heads == self.heads:
            q, k, v = self.qkv(y).view(b, s, 3, self.heads, d).unbind(2)
        else:
            q = self.q(y).view(b, s, self.heads, d)
            k, v = self.kv(y).view(b, s, 2, self.kv_heads, d).unbind(2)
        if self.rope:
            positions = (
                torch.arange(s, device=y.device) if rope_positions is None
                else rope_positions
            )
            q = apply_rope(q, positions)
            k = apply_rope(k, positions)
        return q, k, v


__all__ = ["GroupedQKVProjection"]
