"""MNIST-scale MLP, as in ``cron_operator_tpu/models/mlp.py``: Dense and
relu over images flattened in NHWC order, f32 logits.

Under a ``tensor`` mesh the first two hidden layers split as a column/row
pair, the Megatron MLP (:meth:`MLP.tensor_splits`); the JAX package splits
every kernel's output features and lets GSPMD place the collectives."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cron_operator_tpu_torch.models.layers import (
    Linear,
    init_flax_layers_,
    split_group,
)
from cron_operator_tpu_torch.parallel.mesh import TensorSplit, copy_to_tensor

# flax infers the first Dense's fan-in from its input; the port builds it for
# the mnist job's 28x28x1 images.
MNIST_PIXELS = 28 * 28


class MLP(nn.Module):
    """NHWC images ``[b, 28, 28, 1]`` -> logits ``[b, num_classes]`` in f32.
    ``dense.{i}`` is flax's ``Dense_{i}``; the last one is the head.

    Its first two hidden layers split over ``tensor``
    (``splits_over_tensor``) as a pair (:meth:`tensor_splits`): under
    ``tensor_group`` (set by ``parallel.mesh.data_parallel``) the pair's
    input enters through ``copy_to_tensor``, the first layer gives the
    rank's slice of its features, the relu runs on that slice, and the
    second layer's partial products are summed over the group before its
    bias (``Linear(tensor_group=)``). Later layers and the head stay
    whole."""

    splits_over_tensor = True
    tensor_group = None

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

    def tensor_splits(self, t: int) -> dict:
        """The first pair of hidden layers over a ``tensor`` group of ``t``
        ranks (``parallel.mesh.split_over_tensor``): ``dense.0``'s weight
        and bias by output features (column-parallel), ``dense.1``'s
        weight by input features (row-parallel; its bias whole). Nothing
        for fewer than two hidden layers, or features that ``t`` does not
        divide: the MLP stays whole."""
        if len(self.dense) < 3 or self.dense[0].out_features % t:
            return {}
        return {"dense.0.weight": TensorSplit(0),
                "dense.0.bias": TensorSplit(0),
                "dense.1.weight": TensorSplit(1)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        group = split_group(self.tensor_group, self.tensor_splits)
        x = copy_to_tensor(x, group)
        for i, layer in enumerate(self.dense[:-1]):
            x = F.relu(layer(x, tensor_group=group if i == 1 else None))
        return self.dense[-1](x).float()


__all__ = ["MLP"]
