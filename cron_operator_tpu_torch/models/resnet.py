"""ResNet (v1.5) with GroupNorm, as in ``cron_operator_tpu/models/resnet.py``.

Images arrive NHWC ``[b, H, W, 3]``, as in the JAX package; the model
permutes them to an NCHW-shaped view with channels-last strides, and the
conv weights are channels-last too, so cuDNN runs NHWC convolutions. Convs
have no bias and pad by flax's ``"SAME"`` rule (:class:`layers.Conv2d`);
the stride sits on the 3x3 (v1.5). A block takes a projection shortcut
(strided 1x1 conv and GroupNorm) when its output shape differs from its
input's: when the channels change or the stride is above 1. The stem is a
7x7 stride-2 conv with explicit (3, 3) padding, then a 3x3 stride-2 max
pool padded (1, 1) with -inf; the head is a mean over H and W in ``dtype``,
then Dense in ``dtype``, with f32 logits.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from cron_operator_tpu_torch.models.layers import (
    Conv2d,
    GroupNorm,
    Linear,
    init_flax_layers_,
)


class _Block(nn.Module):
    """A residual block: ``convs`` (each followed by a GroupNorm, relu
    between), plus the projection shortcut when the shape changes; the
    output is relu(shortcut + the last norm). The relus and the add run in
    the norms' epilogues (``GroupNorm(relu=, residual=)``). The convs and
    norms are numbered as flax numbers ``Conv_i``/``GroupNorm_i`` in
    creation order, the shortcut's pair last."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, stride: int,
                 convs, *, dtype: torch.dtype, device=None):
        super().__init__()
        kw = dict(compute_dtype=dtype, device=device)
        out = filters * self.expansion
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        cin = in_channels
        for cout, k, s in convs:
            self.convs.append(Conv2d(cin, cout, k, s, **kw))
            self.norms.append(GroupNorm(cout, **kw))
            cin = cout
        if in_channels != out or stride != 1:
            self.convs.append(Conv2d(in_channels, out, 1, stride, **kw))
            self.norms.append(GroupNorm(out, **kw))
        self.n_main = len(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        last = self.n_main - 1
        for i in range(last):
            y = self.norms[i](self.convs[i](y), relu=True)
        residual = x
        if len(self.convs) > self.n_main:
            residual = self.norms[-1](self.convs[-1](x))
        # relu(residual + norm(conv(y))), the add and relu in the norm's
        # epilogue
        return self.norms[last](self.convs[last](y), residual=residual,
                                relu=True)


class BottleneckBlock(_Block):
    """1x1 -> 3x3 (strided) -> 1x1 to ``4 * filters`` channels."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int = 1, *,
                 dtype: torch.dtype, device=None):
        super().__init__(in_channels, filters, stride, [
            (filters, 1, 1), (filters, 3, stride), (4 * filters, 1, 1)
        ], dtype=dtype, device=device)


class BasicBlock(_Block):
    """Two 3x3 convs (ResNet-18/34), the first strided."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1, *,
                 dtype: torch.dtype, device=None):
        super().__init__(in_channels, filters, stride, [
            (filters, 3, stride), (filters, 3, 1)
        ], dtype=dtype, device=device)


class ResNet(nn.Module):
    """NHWC images ``[b, H, W, 3]`` -> logits ``[b, num_classes]`` in f32.
    ``blocks.{j}`` is flax's ``<Block>_{j}``, ``stem``/``stem_norm`` its
    ``Conv_0``/``GroupNorm_0`` and ``head`` its ``Dense_0``."""

    def __init__(self, stage_sizes: Sequence[int],
                 block: Type[_Block] = BottleneckBlock,
                 num_classes: int = 1000, width: int = 64, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        kw = dict(compute_dtype=dtype, device=device)
        self.dtype = dtype
        self.stem = Conv2d(3, width, 7, 2, padding=((3, 3), (3, 3)), **kw)
        self.stem_norm = GroupNorm(width, **kw)
        self.blocks = nn.ModuleList()
        cin = width
        for stage, n_blocks in enumerate(stage_sizes):
            filters = width * 2 ** stage
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                self.blocks.append(
                    block(cin, filters, stride, dtype=dtype, device=device)
                )
                cin = filters * block.expansion
        self.head = Linear(cin, num_classes, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ResNet":
        init_flax_layers_(self, generator)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(self.dtype)  # NHWC strides
        x = self.stem_norm(self.stem(x), relu=True)
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean((2, 3))).float()


ResNet18 = partial(ResNet, (2, 2, 2, 2), BasicBlock)
ResNet50 = partial(ResNet, (3, 4, 6, 3), BottleneckBlock)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "ResNet18", "ResNet50"]
