"""GPT-style decoder, as in ``cron_operator_tpu/models/gpt.py``.

Causal attention goes through :func:`ops.attention.multi_head_attention`
(the Hopper flash kernels on the card, plain attention on the CPU); the
output embedding is tied. Parameters live in ``param_dtype`` (f32 by
default, as flax's ``param_dtype``) and are cast to ``cfg.dtype`` where
they are used, so a bf16 model trains f32 masters; a serving model may keep
bf16 parameters, which the cast at use would give anyway. LayerNorm
epsilon (1e-6) and the tanh-approximate gelu are flax's, not torch's
defaults. With ``moe_every = k > 0`` every k-th block's FFN is a Switch
top-1 mixture of experts (:class:`MoEBlock`, :mod:`parallel.moe`), and the
forward returns ``(output, aux)``, the weighted router balance loss beside
the output, which the trainer adds to the task loss
(``TrainConfig.aux_loss_in_output``). A dense model returns the output
alone: the JAX model's aux is always 0 there.

Serving: :meth:`GPT.prefill` consumes a whole prompt in one batched causal
pass and writes every layer's K/V into a :class:`KVCache`;
:meth:`GPT.decode` then takes one token per call against it. The cache is a
static ``[b, max_len, kv_heads, head_dim]`` buffer per layer, updated in
place (JAX returns a new one per step), with one position counter at the
model level. The counter is a 0-d int64 tensor on the cache's device, and
every use of it in a decode step is an op on that device: a decode step
never waits for the host, so it can be captured in a CUDA graph and
replayed (``workloads.generate``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.fsdp import FSDPModule

from cron_operator_tpu_torch.models.layers import (
    GroupedQKVProjection,
    LayerNorm,
    Linear,
    PaddedTable,
    VocabPiece,
    add_positions,
    draw_,
    init_flax_layers_,
    row_parallel,
    tied_logits,
    vocab_parallel_embedding,
    vocab_piece,
    vocab_split,
)
from cron_operator_tpu_torch.ops.attention import (
    decode_attention,
    multi_head_attention,
)
from cron_operator_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    TensorSplit,
    axis_sizes,
    copy_to_tensor,
    local_positions,
)
from cron_operator_tpu_torch.parallel.moe import moe_ffn

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch defaults to 1e-5)


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"  # auto | flash | xla
    # Grouped-query attention: 0 means MHA (fused qkv projection); a divisor
    # of num_heads shares each K/V head across num_heads/num_kv_heads query
    # heads, and the KV cache shrinks by that factor.
    num_kv_heads: int = 0
    # Rotary position embeddings on Q/K; the learned pos_emb is then absent.
    rope: bool = False
    # MoE: 0 disables; k > 0 replaces every k-th block's FFN with a
    # Switch-MoE layer of num_experts experts. moe_aux_weight scales the
    # summed router balance loss that the model returns beside its output.
    moe_every: int = 0
    num_experts: int = 8
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # Return (final hidden states, tied embedding table) instead of logits.
    return_hidden: bool = False

    @staticmethod
    def tiny(**overrides) -> "GPTConfig":
        defaults = dict(
            vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
            mlp_dim=512, max_len=512,
        )
        defaults.update(overrides)
        return GPTConfig(**defaults)


@dataclass
class KVCache:
    """Per-layer K/V buffers ``[b, max_len, kv_heads, head_dim]`` and the
    number of positions written so far, a 0-d int64 tensor beside them."""

    k: List[torch.Tensor] = field(default_factory=list)
    v: List[torch.Tensor] = field(default_factory=list)
    pos: Optional[torch.Tensor] = None


class MoEBlock(nn.Module):
    """Switch-MoE FFN around :func:`parallel.moe.moe_ffn`, as the JAX
    ``MoEBlock``: parameters ``router [d, E]``, ``wi [E, d, mlp]`` and
    ``wo [E, mlp, d]`` in JAX's layout, no biases. Routing runs in f32, the
    expert products in ``cfg.dtype``, and the output is cast to it.

    Decode steps route a batch-sized token pool, where the training
    capacity factor would drop colliding tokens (capacity 1): decode raises
    the factor to ``num_experts``, so the capacity is the batch and no token
    is dropped. Prefill keeps the training factor, as in the JAX package.

    ``token_group`` is None, or on the plain meshed path the process group
    of the batch axes (``parallel.mesh.data_parallel`` sets it, and
    ``seq_mesh`` under a ``seq`` axis): training steps then route among
    every rank's tokens, in the one-device order (row, position) when the
    positions are split over ``seq``. ``expert_group`` (an ``expert``
    mesh, on the plain path) splits ``wi`` and ``wo`` on the experts
    (:meth:`expert_splits`, JAX's ``P('expert')``): the ranks of the group
    hold the same tokens and route them alike, the router whole, each runs
    its E/n experts, and their outputs are gathered over the group.
    ``tensor_group`` (a ``tensor`` mesh, on the plain path) splits them on
    the FFN's width instead (:meth:`tensor_splits`) when ``expert`` leaves
    them whole, and the experts' outputs are summed over the group; under
    ``tensor x expert`` the experts split over ``expert`` alone, at full
    width, and the block runs whole on each ``tensor`` rank.
    """

    token_group = None
    seq_mesh = None
    tensor_group = None
    expert_group = None

    def __init__(self, cfg: GPTConfig, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = cfg
        d, e, f = cfg.hidden_size, cfg.num_experts, cfg.mlp_dim
        kw = dict(device=device, dtype=param_dtype)
        self.router = nn.Parameter(torch.empty(d, e, **kw))
        self.wi = nn.Parameter(torch.empty(e, d, f, **kw))
        self.wo = nn.Parameter(torch.empty(e, f, d, **kw))

    def expert_splits(self, n: int) -> dict:
        """``wi [E, d, f]`` and ``wo [E, f, d]`` split on ``E`` over an
        ``expert`` group of ``n`` ranks (``parallel.mesh.
        split_over_tensor``); none when ``n`` does not divide ``E``, as
        JAX's ``expert_stacked`` leaves them whole."""
        if self.config.num_experts % n:
            return {}
        return {"wi": TensorSplit(0), "wo": TensorSplit(0)}

    def tensor_splits(self, t: int) -> dict:
        """``wi [E, d, f]`` and ``wo [E, f, d]`` split on ``f`` over a
        ``tensor`` group of ``t`` ranks (``parallel.mesh.
        split_over_tensor``, which skips them when ``expert`` split them);
        none when ``t`` does not divide ``f``."""
        if self.config.mlp_dim % t:
            return {}
        return {"wi": TensorSplit(2), "wo": TensorSplit(1)}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers: the router normal(0.02); ``wi`` and ``wo``
        truncated lecun-normal, whose fan-in on ``(E, in, out)`` counts the
        expert axis (E * in), as flax's ``lecun_normal`` does."""
        e = self.config.num_experts
        draw_(self.router, 0.02, generator)
        for w in (self.wi, self.wo):
            draw_(w, 1.0 / math.sqrt(e * w.shape[1]), generator,
                  truncated=True)

    def forward(self, x: torch.Tensor, decode: bool = False):
        """``x [b, s, d]`` -> (``[b, s, d]`` in ``cfg.dtype``, aux loss);
        tokens are routed in row-major ``b * s`` order, as in JAX."""
        cfg = self.config
        b, s, d = x.shape
        cf = cfg.moe_capacity_factor
        if decode:
            cf = max(cf, float(cfg.num_experts))
        params = {"router": self.router, "wi": self.wi, "wo": self.wo}
        seq = 1 if self.seq_mesh is None else axis_sizes(
            self.seq_mesh)[SEQ_AXIS]
        experts = _split_group(self.expert_group, self.expert_splits)
        width = None if experts is not None else _split_group(
            self.tensor_group, self.tensor_splits)
        y, aux = moe_ffn(params, x.reshape(b * s, d), capacity_factor=cf,
                         compute_dtype=cfg.dtype,
                         group=None if decode else self.token_group,
                         rows=b, seq_blocks=seq, tensor_group=width,
                         expert_group=experts)
        return y.reshape(b, s, d).to(cfg.dtype), aux


def _split_group(group, rule):
    """``group`` (a ``tensor`` or ``expert`` group, or None) when ``rule``
    (a module's ``tensor_splits`` or ``expert_splits``) splits parameters
    over its ranks, else None: a part whose parameters stay whole runs
    whole on every rank."""
    if group is None or not rule(dist.get_world_size(group)):
        return None
    return group


class DecoderLayer(nn.Module):
    """Pre-LN block: attention (causal here; BERT's and ViT's
    :class:`~cron_operator_tpu_torch.models.bert.EncoderLayer` is this block
    with ``causal = False``), then the tanh-gelu FFN, or with ``use_moe``
    the :class:`MoEBlock` in its place. ``seq_mesh`` (set by
    ``parallel.mesh.data_parallel`` under a ``seq`` axis) makes the block's
    input this rank's block of positions: rotary positions at the block's
    global offset, and attention across the blocks
    (:func:`ops.attention.multi_head_attention` with ``mesh``).

    ``tensor_group`` (set by ``data_parallel`` under a ``tensor`` axis, on
    the parameters that :meth:`tensor_splits` split) runs the Megatron
    block: this rank's heads (the QKV projection's rows, ``out``'s input
    columns) and its slice of the FFN (``fc_in``'s rows, ``fc_out``'s
    input columns); ``parallel.mesh.copy_to_tensor`` in front of the QKV
    projection and ``fc_in``, and ``out``'s and ``fc_out``'s partial
    products summed over the group before their bias
    (:func:`layers.row_parallel`). Both branches are whole again where the
    norms add them, and the norms and the residual stream stay whole on
    every rank."""

    causal = True
    seq_mesh = None
    tensor_group = None

    def __init__(self, cfg: GPTConfig, device=None,
                 param_dtype: torch.dtype = torch.float32,
                 use_moe: bool = False):
        super().__init__()
        self.config = cfg
        kw = dict(device=device, compute_dtype=cfg.dtype,
                  param_dtype=param_dtype)
        self.ln_attn = LayerNorm(cfg.hidden_size, eps=LN_EPS, **kw)
        self.attn = GroupedQKVProjection(cfg, device=device,
                                         param_dtype=param_dtype)
        self.out = Linear(
            self.attn.heads * self.attn.head_dim, cfg.hidden_size, **kw
        )
        self.ln_mlp = LayerNorm(cfg.hidden_size, eps=LN_EPS, **kw)
        self.moe = None
        if use_moe:
            self.moe = MoEBlock(cfg, device=device, param_dtype=param_dtype)
        else:
            self.fc_in = Linear(cfg.hidden_size, cfg.mlp_dim, **kw)
            self.fc_out = Linear(cfg.mlp_dim, cfg.hidden_size, **kw)

    def tensor_splits(self, t: int) -> dict:
        """The block's own products over a ``tensor`` group of ``t`` ranks
        (``parallel.mesh.split_over_tensor``; the QKV projection and the
        MoE block name theirs): ``out``'s input columns with the heads
        (when :meth:`GroupedQKVProjection.splits_heads`), and a dense FFN's
        ``fc_in`` rows and ``fc_out`` input columns when ``t`` divides
        ``mlp_dim``. The biases of ``out`` and ``fc_out`` stay whole."""
        out = {}
        if self.attn.splits_heads(t):
            out["out.weight"] = TensorSplit(1)
        if self.moe is None and self.config.mlp_dim % t == 0:
            out.update({"fc_in.weight": TensorSplit(0),
                        "fc_in.bias": TensorSplit(0),
                        "fc_out.weight": TensorSplit(1)})
        return out

    def forward(
        self,
        x: torch.Tensor,
        cache_k: Optional[torch.Tensor] = None,
        cache_v: Optional[torch.Tensor] = None,
        pos: Optional[torch.Tensor] = None,
        r: Optional[torch.Tensor] = None,
        fold: bool = False,
    ) -> tuple:
        """Full pass when ``pos`` is None (writing the prompt's K/V into the
        cache buffers when given: prefill); one-token decode at cache
        position ``pos`` (a 1-element int64 tensor) otherwise. Returns the
        block's output and the MoE block's aux loss (None for a dense
        FFN).

        With ``fold`` the residual adds are left to the norms: the block's
        input is ``x + r`` (``r`` the previous block's MLP branch, None for
        the first block), which ``ln_attn`` adds as it normalises, as
        ``ln_mlp`` adds the attention branch; the block returns the
        residual stream before its last add, the MLP branch that the next
        norm adds (the next block's ``ln_attn``, or the model's ``ln_f``)
        and the aux loss. XLA fuses each add into the norm after it in the
        reference (``cron_operator_tpu/models/gpt.py:164-166, 174``)."""
        cfg = self.config
        b, s, _ = x.shape
        x, y = self.ln_attn.add_norm(x, r)
        decode = pos is not None
        at = pos
        if not decode and cfg.rope and self.seq_mesh is not None:
            block = local_positions(self.seq_mesh, s)
            at = torch.arange(block.start, block.stop, device=x.device)
        heads = _split_group(self.tensor_group, self.attn.tensor_splits)
        q, k, v = self.attn(copy_to_tensor(y, heads), rope_positions=at)
        if decode:
            attn = self._decode_attention(q, k, v, cache_k, cache_v, pos)
        else:
            attn = multi_head_attention(
                q, k, v, causal=self.causal, impl=cfg.attention_impl,
                mesh=self.seq_mesh)
            if cache_k is not None:
                cache_k[:, :s] = k
                cache_v[:, :s] = v
        x, y = self.ln_mlp.add_norm(
            x, row_parallel(self.out, attn.reshape(b, s, -1), heads))
        aux = None
        if self.moe is not None:
            y, aux = self.moe(y, decode=decode)
        else:
            ffn = self._ffn_group()
            h = F.gelu(self.fc_in(copy_to_tensor(y, ffn)), approximate="tanh")
            y = row_parallel(self.fc_out, h, ffn)
        return (x, y, aux) if fold else (x + y, aux)

    def _ffn_group(self):
        """``tensor_group`` when it splits the dense FFN, else None."""
        return _split_group(self.tensor_group, lambda t: (
            "fc_in.weight" in self.tensor_splits(t)))

    def _decode_attention(self, q, k, v, cache_k, cache_v, pos):
        """One-token attention against the layer's cache: the new K/V land
        at ``pos``, then :func:`ops.attention.decode_attention` (the decode
        kernel on the card, the JAX decode's arithmetic on the CPU) attends
        over the positions written."""
        cache_k.index_copy_(1, pos, k)
        cache_v.index_copy_(1, pos, v)
        return decode_attention(q, cache_k, cache_v, pos)


def fold_blocks(layers, x: torch.Tensor, caches=None,
                pos: Optional[torch.Tensor] = None):
    """``layers`` (pre-LN blocks) over the embedded ``x``, each block's
    input add folded into its first norm (``DecoderLayer`` with ``fold``,
    called as a module so that its hooks run: FSDP2 gathers a block's
    parameters in one), with
    the caches' ``(k, v)`` a layer and ``pos`` when serving. Returns the
    residual stream and the last MLP branch, which the final norm adds
    (``LayerNorm.add_norm``), and the summed aux loss (None for dense
    blocks)."""
    r, aux = None, None
    caches = caches or [(None, None)] * len(layers)
    for layer, (ck, cv) in zip(layers, caches):
        x, r, layer_aux = layer(x, ck, cv, pos, r=r, fold=True)
        if layer_aux is not None:
            aux = layer_aux if aux is None else aux + layer_aux
    return x, r, aux


class GPT(nn.Module):
    """Token ids ``[batch, seq]`` -> next-token logits ``[b, s, vocab]`` in
    f32 (or ``(hidden, embedding table)`` with ``cfg.return_hidden``). With
    MoE blocks (:attr:`has_moe`) the forward returns ``(output, aux)``:
    ``aux`` is the layers' summed router balance loss times
    ``moe_aux_weight``, an f32 scalar. The JAX model returns the pair
    always, with aux 0 for dense blocks; the port's dense model returns the
    output alone. Under ``seq_mesh`` (``parallel.mesh.data_parallel``) the
    ids are this rank's block of positions, which take the learned
    positions at its global offset. Its blocks split over ``tensor``
    (``splits_over_tensor``: :class:`DecoderLayer`), so a ``tensor`` mesh
    trains plain modules, and its MoE blocks' experts over ``expert``
    (:meth:`MoEBlock.expert_splits`). Under ``tensor`` the tied table
    splits too (:meth:`tensor_splits`, the Megatron vocab-parallel
    layout): each rank keeps its block of the vocab's rows, embeds the
    tokens that fall in it (``layers.vocab_parallel_embedding``, summed
    over the group) and multiplies by its rows alone; with
    ``return_hidden`` it hands the loss a ``layers.VocabPiece`` in place of
    the table, and its logits are the ranks' columns gathered whole. The
    learned positions and the norms stay whole on every rank."""

    seq_mesh = None
    splits_over_tensor = True
    tensor_group = None

    def __init__(self, config: GPTConfig = GPTConfig(), *, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=param_dtype)
        self.tok_emb = nn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.pos_emb = None if config.rope else nn.Parameter(
            torch.empty(config.max_len, config.hidden_size, **kw)
        )
        every = config.moe_every
        self.layers = nn.ModuleList(
            DecoderLayer(config, device=device, param_dtype=param_dtype,
                         use_moe=every > 0 and (i + 1) % every == 0)
            for i in range(config.num_layers)
        )
        self.has_moe = any(layer.moe is not None for layer in self.layers)
        self.ln_f = LayerNorm(config.hidden_size, eps=LN_EPS, device=device,
                              compute_dtype=config.dtype,
                              param_dtype=param_dtype)
        self._vocab_table = PaddedTable()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "GPT":
        """Random weights at flax's initializer scales, drawn from
        ``generator`` (which must live on the parameters' device): token
        embedding normal with std 1/sqrt(hidden) (flax's default embed
        init), pos_emb normal(0.02), then :func:`init_flax_layers_` and the
        MoE blocks' own draws (:meth:`MoEBlock.init_weights`)."""
        draw_(self.tok_emb.weight, 1.0 / math.sqrt(self.config.hidden_size),
              generator)
        if self.pos_emb is not None:
            draw_(self.pos_emb, 0.02, generator)
        init_flax_layers_(self, generator)
        for layer in self.layers:
            if layer.moe is not None:
                layer.moe.init_weights(generator)
        return self

    def tensor_splits(self, t: int) -> dict:
        """The tied table over a ``tensor`` group (``parallel.mesh.
        split_over_tensor``): its vocab rows, ``layers.vocab_split``."""
        return {"tok_emb.weight": vocab_split(self.config.vocab_size)}

    def _table(self):
        """The tied table: ``tok_emb.weight``, or under ``tensor_group``
        this rank's ``layers.VocabPiece`` of it."""
        return vocab_piece(self.tok_emb.weight, self.config.vocab_size,
                           self.tensor_group)

    def new_cache(self, batch: int) -> KVCache:
        """Zeroed per-layer K/V buffers for ``batch`` sequences."""
        cfg = self.config
        kv_heads = cfg.num_kv_heads or cfg.num_heads
        shape = (batch, cfg.max_len, kv_heads, cfg.hidden_size // cfg.num_heads)
        dev = self.tok_emb.weight.device
        cache = KVCache(pos=torch.zeros((), dtype=torch.int64, device=dev))
        for _ in range(cfg.num_layers):
            cache.k.append(torch.zeros(shape, dtype=cfg.dtype, device=dev))
            cache.v.append(torch.zeros(shape, dtype=cfg.dtype, device=dev))
        return cache

    def _embed(self, input_ids: torch.Tensor,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings plus the learned positions ``0..s-1`` (this
        rank's block of them under ``seq_mesh``), or ``pos`` (a 1-element
        tensor) for a decode step."""
        dt = self.config.dtype
        tok = self._table()
        x = (vocab_parallel_embedding(input_ids, tok, dt)
             if isinstance(tok, VocabPiece)
             else self.tok_emb(input_ids).to(dt))
        if self.pos_emb is not None:
            table = (self.pos_emb[local_positions(self.seq_mesh,
                                                  input_ids.shape[1])]
                     if pos is None else self.pos_emb.index_select(0, pos))
            x = add_positions(x, table.to(dt))
        return x

    def _logits(self, x: torch.Tensor,
                r: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The tied output embedding (flax ``tok.attend``) in ``cfg.dtype``,
        then f32, through a zero-padded table (:func:`layers.tied_logits`),
        of ``ln_f(x + r)``, the last block's add folded into the norm.
        Serving (no autograd) keeps its padded table across calls, so a
        decode step copies none. FSDP2 writes the gathered weight without
        bumping its version counter, so a model it wraps pads at use."""
        cache = None if isinstance(self, FSDPModule) else self._vocab_table
        return tied_logits(self.ln_f.add_norm(x, r)[1], self._table(),
                           self.config.dtype, cache)

    def refresh_vocab_table(self) -> None:
        """Refills the padded vocab table now if the weight changed since
        it was filled (a restore, a training step): a replayed prefill or
        decode step reads the table in place and runs no Python that could
        refill it."""
        if not isinstance(self, FSDPModule):
            self._vocab_table.get(self.tok_emb.weight, self.config.dtype)

    def forward(self, input_ids: torch.Tensor):
        x, r, aux = fold_blocks(self.layers, self._embed(input_ids))
        if self.config.return_hidden:
            out = self.ln_f.add_norm(x, r)[1], self._table()
        else:
            out = self._logits(x, r)
        if not self.has_moe:
            return out
        return out, self.config.moe_aux_weight * aux

    def prefill(self, input_ids: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """One batched causal pass over the prompt ``[b, p]`` that fills every
        layer's cache; returns the last position's logits ``[b, vocab]``."""
        x, r, _ = fold_blocks(self.layers, self._embed(input_ids),
                              list(zip(cache.k, cache.v)))
        cache.pos.fill_(input_ids.shape[1])
        return self._logits(x[:, -1:], r[:, -1:])[:, 0]

    def decode(self, token: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """One token ``[b, 1]`` at the cache's next position; returns its
        logits ``[b, vocab]`` and advances the position, on the device."""
        pos = cache.pos.reshape(1)
        x, r, _ = fold_blocks(self.layers, self._embed(token, pos),
                              list(zip(cache.k, cache.v)), pos)
        cache.pos.add_(1)
        return self._logits(x, r)[:, 0]


__all__ = ["GPT", "GPTConfig", "DecoderLayer", "KVCache", "MoEBlock",
           "fold_blocks"]
