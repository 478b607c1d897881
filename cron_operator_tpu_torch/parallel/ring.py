"""Dense single-device attention — the port's counterpart of the one piece
of ``cron_operator_tpu/parallel/ring.py`` the serving slice runs.

Ring attention proper (sequence parallelism over a mesh axis) waits for the
sequence-parallel slice (ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch


def _single_device_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool
) -> torch.Tensor:
    """Plain attention on ``[b, s, h, d]`` (K/V at full head count), f32
    products and softmax, ``-inf`` causal mask; returns ``q``'s dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        keep = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


__all__: list = []
