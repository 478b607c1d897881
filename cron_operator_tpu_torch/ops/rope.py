"""Rotary position embeddings (RoPE), as in ``cron_operator_tpu/ops/rope.py``.

Rotates each (even, odd) feature pair of Q and K by a position- and
frequency-dependent angle, in f32. The same function serves the full
forward (``positions = arange(seq)``) and a decode step (``positions =
[current_index]``). ``positions`` are always global: on the plain
meshed path ``x`` is this rank's block of a sequence split over ``seq``,
and the caller passes the block's own positions (``models.gpt.DecoderLayer``
from ``parallel.mesh.local_positions``); over a DTensor mesh ``x`` is a
DTensor whose sequence may be split over ``seq``, the tables enter as
replicated DTensors and each rank rotates its block at its own global
positions. Either way, as JAX rotates before the sequence is split.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate


def rope_angles(
    positions: torch.Tensor, head_dim: int, theta: float = 10000.0
) -> tuple:
    """(cos, sin) tables ``[len(positions), head_dim // 2]`` in f32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = theta ** (-exponent)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
) -> torch.Tensor:
    """Rotate ``x [batch, seq, heads, head_dim]`` at ``positions [seq]``
    (plain, global positions, also for a DTensor ``x``).

    head_dim must be even. Returns x's dtype (rotation in f32).
    """
    b, s, h, d = x.shape
    if d % 2:
        raise ValueError(f"head_dim {d} must be even for RoPE")
    cos, sin = rope_angles(positions, d, theta)
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    if isinstance(x, DTensor):
        rep = [Replicate()] * x.device_mesh.ndim
        cos, sin = (DTensor.from_local(t, x.device_mesh, rep, run_check=False)
                    for t in (cos, sin))
    xf = x.to(torch.float32).reshape(b, s, h, d // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.reshape(b, s, h, d).to(x.dtype)


__all__ = ["apply_rope", "rope_angles"]
