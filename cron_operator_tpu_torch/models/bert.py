"""BERT encoder, as in ``cron_operator_tpu/models/bert.py``.

Token ids ``[batch, seq]`` -> masked-LM logits ``[b, s, vocab]`` in f32
through a tied output embedding. The encoder block is GPT's
:class:`~cron_operator_tpu_torch.models.gpt.DecoderLayer` with non-causal
attention, which :func:`ops.attention.multi_head_attention` sends to the
Hopper flash kernels on the card (head dim 32/64/128/256, any sequence
length) and to plain attention on the CPU. Parameter names match
GPT's, so ``models/convert.py:params_from_flax`` serves both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from cron_operator_tpu_torch.models.gpt import LN_EPS, DecoderLayer, fold_blocks
from cron_operator_tpu_torch.models.layers import (
    LayerNorm,
    VocabPiece,
    add_positions,
    draw_,
    init_flax_layers_,
    tied_logits,
    vocab_parallel_embedding,
    vocab_piece,
    vocab_split,
)
from cron_operator_tpu_torch.parallel.mesh import local_positions


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"  # auto | flash | xla
    # Grouped-query attention (0 = MHA) and rotary positions, as GPTConfig.
    num_kv_heads: int = 0
    rope: bool = False
    # forward returns (hidden, embedding table) for a loss that takes the
    # product itself (the bert job's ops.xent.tied_cross_entropy), as GPT's
    return_hidden: bool = False

    @staticmethod
    def base(**overrides) -> "BertConfig":
        return BertConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "BertConfig":
        defaults = dict(
            vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
            mlp_dim=512, max_len=512,
        )
        defaults.update(overrides)
        return BertConfig(**defaults)


class EncoderLayer(DecoderLayer):
    """The pre-LN block with bidirectional attention (BERT, ViT)."""

    causal = False


class Bert(nn.Module):
    """Token ids ``[batch, seq]`` -> MLM logits ``[b, s, vocab]`` in f32
    (or ``(hidden, embedding table)`` with ``cfg.return_hidden``).
    ``pos_emb`` is ``[max_len, hidden]``, sliced to the sequence (to this
    rank's block of positions under ``seq_mesh``, set by
    ``parallel.mesh.data_parallel``), and absent under ``rope``. Its
    blocks split over ``tensor`` as GPT's (``splits_over_tensor``), so a
    ``tensor`` mesh trains plain modules, and so does its tied table, by
    vocab rows as GPT's (``GPT.tensor_splits``): each rank embeds the
    tokens of its rows and multiplies by them alone, and with
    ``return_hidden`` hands a ``layers.VocabPiece`` in place of the table.
    The learned positions and the norms stay whole on every rank."""

    seq_mesh = None
    splits_over_tensor = True
    tensor_group = None

    def __init__(self, config: BertConfig = BertConfig(), *, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=param_dtype)
        self.tok_emb = nn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.pos_emb = None if config.rope else nn.Parameter(
            torch.empty(config.max_len, config.hidden_size, **kw)
        )
        self.layers = nn.ModuleList(
            EncoderLayer(config, device=device, param_dtype=param_dtype)
            for _ in range(config.num_layers)
        )
        self.ln_f = LayerNorm(config.hidden_size, eps=LN_EPS, device=device,
                              compute_dtype=config.dtype,
                              param_dtype=param_dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Bert":
        """flax's scales, as :meth:`GPT.init_weights`: token embedding std
        1/sqrt(hidden), pos_emb normal(0.02), then the layers'."""
        draw_(self.tok_emb.weight, 1.0 / math.sqrt(self.config.hidden_size),
              generator)
        if self.pos_emb is not None:
            draw_(self.pos_emb, 0.02, generator)
        init_flax_layers_(self, generator)
        return self

    def tensor_splits(self, t: int) -> dict:
        """The tied table's vocab rows over a ``tensor`` group, as
        ``GPT.tensor_splits``."""
        return {"tok_emb.weight": vocab_split(self.config.vocab_size)}

    def forward(self, input_ids: torch.Tensor):
        dt = self.config.dtype
        table = vocab_piece(self.tok_emb.weight, self.config.vocab_size,
                            self.tensor_group)
        x = (vocab_parallel_embedding(input_ids, table, dt)
             if isinstance(table, VocabPiece)
             else self.tok_emb(input_ids).to(dt))
        if self.pos_emb is not None:
            block = local_positions(self.seq_mesh, input_ids.shape[1])
            x = add_positions(x, self.pos_emb[block].to(dt))
        # each block's input add folded into its first norm, the last
        # block's into ln_f (gpt.fold_blocks)
        x, r, _ = fold_blocks(self.layers, x)
        h = self.ln_f.add_norm(x, r)[1]
        if self.config.return_hidden:
            return h, table
        # tied output embedding (flax tok.attend) in cfg.dtype, then f32,
        # through a zero-padded table (layers.tied_logits; a rank's columns
        # gathered whole under tensor)
        return tied_logits(h, table, dt)


__all__ = ["Bert", "BertConfig", "EncoderLayer"]
