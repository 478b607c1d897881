"""Shared Q/K/V projection, as in ``cron_operator_tpu/models/layers.py``,
and the layers that keep flax's split between parameter and compute dtype.

Fused ``qkv`` projection to ``(3, heads, head_dim)`` for MHA; split ``q``
(``(heads, head_dim)``) and ``kv`` (``(2, kv_heads, head_dim)``) for
grouped-query configs; RoPE on Q/K when the config asks for it.

Flax modules keep their parameters in ``param_dtype`` (f32 by default) and
cast them to ``dtype`` where they are used; :class:`Linear` and
:class:`LayerNorm` do the same with explicit casts. ``torch.autocast`` is
not used: it returns f32 from ``layer_norm``, where flax's LayerNorm
normalises in f32 and rounds its output to ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cron_operator_tpu_torch.ops.rope import apply_rope


class Linear(nn.Linear):
    """``nn.Linear`` with parameters in ``param_dtype`` and the product in
    ``compute_dtype`` (flax ``nn.Dense(dtype=..., param_dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, *,
                 compute_dtype: torch.dtype, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, device=device,
                         dtype=param_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that normalises in f32 with its parameters and
    rounds the result to ``compute_dtype``, as flax's ``nn.LayerNorm(dtype=
    ...)`` does."""

    def __init__(self, features: int, *, eps: float,
                 compute_dtype: torch.dtype, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps, device=device, dtype=param_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class GroupedQKVProjection(nn.Module):
    """``y [b, s, hidden]`` -> (q, k, v), each ``[b, s, heads, head_dim]``
    with k/v at ``kv_heads``. The counterpart of ``grouped_qkv_projection``.

    ``cfg`` needs ``hidden_size``, ``num_heads``, ``num_kv_heads`` (0 = MHA),
    ``dtype`` (of the products) and ``rope``. When ``cfg.rope``, Q/K rotate
    at ``rope_positions`` (default ``arange(s)``; decode passes its one cache
    position). For MHA, q/k/v are strided views of one fused output.
    """

    def __init__(self, cfg, device=None, param_dtype=torch.float32):
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
        kw = dict(device=device, compute_dtype=cfg.dtype,
                  param_dtype=param_dtype)
        width = self.heads * self.head_dim
        if self.kv_heads == self.heads:
            self.qkv = Linear(cfg.hidden_size, 3 * width, **kw)
        else:
            self.q = Linear(cfg.hidden_size, width, **kw)
            self.kv = Linear(
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


__all__ = ["GroupedQKVProjection", "LayerNorm", "Linear"]
