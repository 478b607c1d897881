"""Vision Transformer, as in ``cron_operator_tpu/models/vit.py``.

NHWC images -> one strided conv onto the hidden width (the patches, flax's
``"SAME"`` padding, which is none when the image divides by the patch), a
zero-initialised CLS token in front, a learned ``pos_emb`` over the
``n + 1`` tokens (absent under ``rope``), BERT's
:class:`~cron_operator_tpu_torch.models.bert.EncoderLayer` stack, a final
LayerNorm, and an f32 Dense head on the CLS row. The ``(size/patch)^2 + 1``
tokens are never a multiple of 128: ``auto`` attention runs the flash
kernels K1-K3 on the card at that length all the same (bf16, P rounded to
bf16 before P V, as the kernels do), and the plain f32 attention on the
CPU, as the JAX ViT does everywhere. ``attention_impl="flash"`` keeps the
JAX package's refusal of a sequence that its blocks do not divide.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from cron_operator_tpu_torch.models.bert import EncoderLayer
from cron_operator_tpu_torch.models.gpt import LN_EPS, fold_blocks
from cron_operator_tpu_torch.models.layers import (
    Conv2d,
    LayerNorm,
    Linear,
    draw_,
    init_flax_layers_,
)


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"  # auto | flash | xla
    # As BertConfig (the encoder layer is shared): GQA head grouping and
    # rotary positions over the flattened patch index, CLS at 0.
    num_kv_heads: int = 0
    rope: bool = False

    @staticmethod
    def base(**overrides) -> "ViTConfig":
        return ViTConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "ViTConfig":
        defaults = dict(
            image_size=32, patch_size=8, num_classes=10, hidden_size=64,
            num_layers=2, num_heads=4, mlp_dim=256,
        )
        defaults.update(overrides)
        return ViTConfig(**defaults)


class ViT(nn.Module):
    """NHWC images ``[b, size, size, 3]`` -> logits ``[b, classes]`` in
    f32. Its blocks split over ``tensor`` as GPT's (``splits_over_tensor``),
    so a ``tensor`` mesh trains plain modules; the patch embedding, the
    CLS token, the positions, the norms and the head stay whole on every
    rank."""

    splits_over_tensor = True

    def __init__(self, config: ViTConfig = ViTConfig(), *, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        kw = dict(device=device, param_dtype=param_dtype)
        self.patch_embed = Conv2d(
            3, cfg.hidden_size, cfg.patch_size, cfg.patch_size, bias=True,
            compute_dtype=cfg.dtype, **kw,
        )
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, cfg.hidden_size, device=device, dtype=param_dtype)
        )
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.pos_emb = None if cfg.rope else nn.Parameter(
            torch.empty(n + 1, cfg.hidden_size, device=device,
                        dtype=param_dtype)
        )
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, **kw) for _ in range(cfg.num_layers)
        )
        self.ln_f = LayerNorm(cfg.hidden_size, eps=LN_EPS,
                              compute_dtype=cfg.dtype, **kw)
        self.head = Linear(cfg.hidden_size, cfg.num_classes,
                           compute_dtype=torch.float32, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ViT":
        """flax's scales: cls_token 0, pos_emb normal(0.02), then the
        layers' (the patch conv's fan-in is patch^2 * 3)."""
        self.cls_token.zero_()
        if self.pos_emb is not None:
            draw_(self.pos_emb, 0.02, generator)
        init_flax_layers_(self, generator)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if images.shape[1] % cfg.patch_size or images.shape[2] % cfg.patch_size:
            raise ValueError(
                f"image {images.shape[1]}x{images.shape[2]} not divisible "
                f"by patch size {cfg.patch_size}"
            )
        x = self.patch_embed(images.permute(0, 3, 1, 2))  # [b, hidden, h, w]
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [b, n, hidden], row-major patches
        cls = self.cls_token.to(cfg.dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
        if self.pos_emb is not None:
            x = x + self.pos_emb.to(cfg.dtype)[None]
        # each block's input add folded into its first norm, the last
        # block's into ln_f (gpt.fold_blocks)
        x, r, _ = fold_blocks(self.layers, x)
        return self.head(self.ln_f.add_norm(x, r)[1][:, 0].float())


__all__ = ["ViT", "ViTConfig"]
