"""MNIST-scale MLP, as in ``cron_operator_tpu/models/mlp.py``: Dense and
relu over images flattened in NHWC order, f32 logits."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cron_operator_tpu_torch.models.layers import Linear, init_flax_layers_

# flax infers the first Dense's fan-in from its input; the port builds it for
# the mnist job's 28x28x1 images.
MNIST_PIXELS = 28 * 28


class MLP(nn.Module):
    """NHWC images ``[b, 28, 28, 1]`` -> logits ``[b, num_classes]`` in f32.
    ``dense.{i}`` is flax's ``Dense_{i}``; the last one is the head."""

    def __init__(self, features: Sequence[int] = (512, 256),
                 num_classes: int = 10, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [MNIST_PIXELS, *features, num_classes]
        self.dense = nn.ModuleList(
            Linear(a, b, compute_dtype=dtype, device=device,
                   param_dtype=param_dtype)
            for a, b in zip(widths, widths[1:])
        )
        self.dtype = dtype

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MLP":
        init_flax_layers_(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for layer in self.dense[:-1]:
            x = F.relu(layer(x))
        return self.dense[-1](x).float()


__all__ = ["MLP"]
