"""Shared Q/K/V projection, as in ``cron_operator_tpu/models/layers.py``,
the layers that keep flax's split between parameter and compute dtype, and
flax's initializer scales.

Fused ``qkv`` projection to ``(3, heads, head_dim)`` for MHA; split ``q``
(``(heads, head_dim)``) and ``kv`` (``(2, kv_heads, head_dim)``) for
grouped-query configs; RoPE on Q/K when the config asks for it.

Flax modules keep their parameters in ``param_dtype`` (f32 by default) and
cast them to ``dtype`` where they are used; :class:`Linear`,
:class:`Conv2d`, :class:`LayerNorm` and :class:`GroupNorm` do the same with
explicit casts. ``torch.autocast`` is not used: it returns f32 from
``layer_norm``, where flax's LayerNorm normalises in f32 and rounds its
output to ``dtype``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from cron_operator_tpu_torch.ops.group_norm import group_norm
from cron_operator_tpu_torch.ops.layer_norm import add_layer_norm, layer_norm
from cron_operator_tpu_torch.ops.rope import apply_rope
from cron_operator_tpu_torch.parallel.mesh import (
    TensorSplit,
    VocabSplit,
    copy_to_tensor,
    gather_from_tensor,
    on_local_rows,
    on_own_rows,
    reduce_from_tensor,
)


class Linear(nn.Linear):
    """``nn.Linear`` with parameters in ``param_dtype`` and the product in
    ``compute_dtype`` (flax ``nn.Dense(dtype=..., param_dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, *,
                 compute_dtype: torch.dtype, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, device=device,
                         dtype=param_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, tensor_group=None) -> torch.Tensor:
        """``tensor_group``: row-parallel over that group (this layer
        keeps the input features of the rank's slice): the partial
        products summed over the group (``parallel.mesh.
        reduce_from_tensor``), then the whole bias added once."""
        dt = self.compute_dtype
        if tensor_group is not None:
            partial = F.linear(x.to(dt), self.weight.to(dt))
            return reduce_from_tensor(partial, tensor_group) + self.bias.to(dt)
        return linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def split_group(group, rule):
    """``group`` (a ``tensor`` or ``expert`` group, or None) when ``rule``
    (a module's ``tensor_splits`` or ``expert_splits``) splits parameters
    over its ranks, else None: a part whose parameters stay whole runs
    whole on every rank."""
    if group is None or not rule(dist.get_world_size(group)):
        return None
    return group


def split_inside(x: torch.Tensor) -> bool:
    """Whether ``x`` is a DTensor split on a dim between its first and its
    last: a ``[b, s, ...]`` activation whose sequence lies on ``seq``."""
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and 0 < p.dim % x.ndim < x.ndim - 1
        for p in x.placements)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear``; on an activation split inside (:func:`split_inside`),
    by :func:`_linear_on_blocks`."""
    if split_inside(x):
        return _linear_on_blocks(x, weight, bias)
    return F.linear(x, weight, bias)


def add_positions(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``x [b, s, d] + table[None]`` (``table [s, d]``, learned positions).
    On an activation split inside (:func:`split_inside`) each rank adds the
    block of the whole table at its own global positions (and features,
    where ``tensor`` splits them), and the table's gradient is a partial
    sum over the axes that split ``x``: DTensor's own rule leaves the
    table's gradient split over ``seq`` and gathers it, through the
    functional all-gather that gloo cannot run on CUDA tensors
    (``chip_smoke.py``'s ``MESH_LEFT_OUT``)."""
    if not split_inside(x):
        return x + table[None]
    mesh = x.device_mesh
    grads = [Partial() if isinstance(p, Shard) else Replicate()
             for p in x.placements]
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grads)
    local = x.to_local()
    _, offset = compute_local_shape_and_global_offset(
        x.shape, mesh, x.placements)
    block = whole.narrow(0, offset[1], local.shape[1]).narrow(
        1, offset[2], local.shape[2])  # its positions and its features
    return DTensor.from_local(local + block[None], mesh, x.placements,
                              run_check=False)


def _linear_on_blocks(x: DTensor, weight: DTensor,
                      bias: Optional[DTensor]) -> DTensor:
    """``F.linear`` on each rank's block of a ``[b, s, in]`` DTensor split
    over the batch and ``seq`` axes. DTensor's own rule flattens ``[b, s]``
    into a strided split, gathers the sequence for a biased product, and
    searches its strategies for up to a minute an op on a three-axis mesh
    (torch 2.13 on the CPU). Here the product is the column-parallel one:
    ``x`` keeps its row and position splits and is whole along every other
    axis; the weight (and bias) keep a split of their output features
    (dim 0) on an axis where ``x`` is whole, which splits the output's last
    dim there, and are gathered along every other axis. Gradients: the
    weight's and bias's sum over the axes that split ``x`` (each rank saw
    its tokens), ``x``'s over the axes that split the output features."""
    mesh = x.device_mesh
    last = x.ndim - 1
    xp, wp, outp, xg, wg = [], [], [], [], []
    for px, pw in zip(x.placements, weight.placements):
        if isinstance(px, Shard) and px.dim % x.ndim < last:
            xp.append(px)
            wp.append(Replicate())
            outp.append(px)
            xg.append(px)
            wg.append(Partial())
        elif isinstance(pw, Shard) and pw.dim == 0:
            xp.append(Replicate())
            wp.append(pw)
            outp.append(Shard(last))
            xg.append(Partial())
            wg.append(pw)
        else:
            for out in (xp, wp, outp, xg, wg):
                out.append(Replicate())
    local = F.linear(
        x.redistribute(mesh, xp).to_local(grad_placements=xg),
        weight.redistribute(mesh, wp).to_local(grad_placements=wg),
        None if bias is None else
        bias.redistribute(mesh, wp).to_local(grad_placements=wg))
    return DTensor.from_local(local, mesh, outp, run_check=False)


VOCAB_ROWS_MULTIPLE = 64  # the tied output table's rows, padded


def padded_vocab(v: int) -> int:
    """``v`` rounded up to a multiple of :data:`VOCAB_ROWS_MULTIPLE`."""
    return -(-v // VOCAB_ROWS_MULTIPLE) * VOCAB_ROWS_MULTIPLE


def _pad_rows(weight: torch.Tensor, dtype: torch.dtype,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``weight [V, E]`` cast to ``dtype`` into the first V rows of a table
    of :func:`padded_vocab` rows whose rest is zero (``out``, when given):
    the cast at use and the padding in one pass over the weight. Under
    autograd the weight's gradient is the table's first V rows, ``[V, E]``
    in the weight's dtype."""
    v, e = weight.shape
    if out is None:
        out = torch.empty((padded_vocab(v), e), dtype=dtype,
                          device=weight.device)
        out[v:].zero_()
    out[:v].copy_(weight)
    return out


class PaddedTable:
    """A model's padded copy of its tied output table for steps without
    autograd (serving), made by :func:`_pad_rows` once and reused while the
    weight is unchanged: a decode step then reads it and copies nothing.

    The copy is keyed on the weight (its object, storage and version
    counter, which every in-place write such as ``load_state_dict`` or an
    optimizer step bumps), so a restored or retrained weight is never
    served stale. It is refilled in place, so a CUDA graph captured over it
    reads the new values at its next replay once an eager call (a prefill)
    has refilled it. A capture never fills it: a stale key there gives no
    table, and the caller pads at use."""

    def __init__(self) -> None:
        self._table: Optional[torch.Tensor] = None
        self._key = None

    def get(self, weight: torch.Tensor,
            dtype: torch.dtype) -> Optional[torch.Tensor]:
        if weight.is_inference():  # no version counter to key on
            return None
        key = (id(weight), weight.data_ptr(), weight._version, dtype)
        if key == self._key:
            return self._table
        if weight.is_cuda and torch.cuda.is_current_stream_capturing():
            return None
        table = self._table
        shape = (padded_vocab(weight.shape[0]), weight.shape[1])
        if table is None or (table.shape, table.dtype, table.device) != (
                shape, dtype, weight.device):
            table = None
        # a normal tensor without a graph, even under inference_mode: it
        # outlives the call and is refilled in place by later ones
        with torch.inference_mode(False), torch.no_grad():
            self._table = _pad_rows(weight, dtype, table)
        self._key = key
        return self._table


def vocab_split(vocab: int) -> VocabSplit:
    """The tied table's split over a ``tensor`` group (``parallel.mesh.
    split_over_tensor``): its ``vocab`` rows by the Megatron vocab-parallel
    layout, each rank's block a multiple of :data:`VOCAB_ROWS_MULTIPLE`
    rows (GPT-2's 50257 at 2 ranks: 25152 rows a rank, 25105 of them real
    on rank 1)."""
    return VocabSplit(0, rows=vocab, multiple=VOCAB_ROWS_MULTIPLE)


@dataclass(frozen=True)
class VocabPiece:
    """A ``tensor`` rank's block of a tied table split by :func:`vocab_split`:
    ``weight [rows, E]`` (the rank's parameter) holds the global rows
    ``lo .. lo + rows - 1``, of which the first :attr:`real` lie below
    ``vocab`` (the rest are zero padding); ``group`` is the ``tensor``
    group. A model under ``tensor`` hands this beside its hidden states
    for the loss (``ops.xent.vocab_parallel_cross_entropy``)."""

    weight: torch.Tensor
    lo: int
    vocab: int
    group: Any

    @property
    def real(self) -> int:
        """The count of this rank's rows that lie below ``vocab``."""
        return max(0, min(self.weight.shape[0], self.vocab - self.lo))


def vocab_piece(weight: torch.Tensor, vocab: int, group) -> Any:
    """``weight`` as the :class:`VocabPiece` of this rank of ``group`` (a
    table of ``vocab`` rows split by :func:`vocab_split`: the blocks are
    equal, rank i's from row ``i * rows`` on); ``weight`` itself when
    ``group`` is None (the table whole)."""
    if group is None:
        return weight
    return VocabPiece(weight, dist.get_rank(group) * weight.shape[0], vocab,
                      group)


def vocab_parallel_embedding(ids: torch.Tensor, table: VocabPiece,
                             dtype: torch.dtype) -> torch.Tensor:
    """The token embedding of ``ids`` in ``dtype`` from a rank's
    :class:`VocabPiece`: each rank looks up the ids in its rows and writes
    zeros for the others, and the sum over the group
    (``reduce_from_tensor``: one all-reduce in ``dtype``, exact, one term
    non-zero) is the whole table's lookup; its gradient passes through, so
    each rank's rows get exactly their own tokens' gradient."""
    rows = table.weight.shape[0]
    local = ids - table.lo
    inside = (local >= 0) & (local < rows)
    out = F.embedding(torch.where(inside, local, 0), table.weight).to(dtype)
    return reduce_from_tensor(out.masked_fill(~inside[..., None], 0),
                              table.group)


def vocab_parallel_product(x: torch.Tensor, table: VocabPiece,
                           dtype: torch.dtype) -> torch.Tensor:
    """The tied product on a rank's rows: ``x @ weight.T`` in ``dtype``,
    ``[..., rows]`` (column ``j`` is global column ``lo + j``; the padding
    rows give zero columns). ``x`` enters through ``copy_to_tensor``, so
    its gradient is summed over the group."""
    return F.linear(copy_to_tensor(x, table.group).to(dtype),
                    table.weight.to(dtype))


def tied_product(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype,
                 cache: Optional[PaddedTable] = None) -> torch.Tensor:
    """The tied output embedding's product (flax ``tok.attend``) ``x @
    weight.T`` in ``dtype``, ``[..., Vp]``.

    A vocab that is not a multiple of :data:`VOCAB_ROWS_MULTIPLE` (GPT-2's
    50257, BERT's 30522) gives cuBLAS an output row of odd or 2-element
    alignment, and it picks its slowest GEMMs for it. So the product runs
    against a table padded with zero rows (:func:`_pad_rows`), Vp =
    :func:`padded_vocab` columns, the padded ones zero. Without autograd
    the padded table comes from ``cache`` (a :class:`PaddedTable`). A
    DTensor operand (a mesh that places DTensors: ``pipe`` above 1; an
    ``expert`` or ``tensor`` mesh trains the transformers' plain modules,
    a ``tensor`` rank its :class:`VocabPiece` of the table, through
    :func:`vocab_parallel_product`) and the ``meta`` device (the FLOP
    count, which stays at the true vocab) take the product unpadded, Vp =
    V."""
    v = weight.shape[0]
    if (v % VOCAB_ROWS_MULTIPLE == 0 or weight.is_meta
            or isinstance(weight, DTensor) or isinstance(x, DTensor)):
        return linear(x, weight.to(dtype))
    table = None
    if cache is not None and not torch.is_grad_enabled():
        table = cache.get(weight, dtype)
    if table is None:
        table = _pad_rows(weight, dtype)
    return F.linear(x, table)


def tied_logits(x: torch.Tensor, weight: Any, dtype: torch.dtype,
                cache: Optional[PaddedTable] = None) -> torch.Tensor:
    """The tied output embedding (flax ``tok.attend``): ``x @ weight.T`` in
    ``dtype`` (:func:`tied_product`), returned in f32 ``[..., V]``: a padded
    product is cut back to V columns before the f32 cast, so no caller sees
    a padded column (an argmax over all-negative logits would pick one).
    On a :class:`VocabPiece` each rank's ``[..., rows]`` product
    (:func:`vocab_parallel_product`) is gathered over the group
    (``gather_from_tensor``: its gradient each rank's own columns) and cut
    to V: the whole logits on every rank."""
    if isinstance(weight, VocabPiece):
        v = weight.vocab
        logits = gather_from_tensor(
            vocab_parallel_product(x, weight, dtype), weight.group)
    else:
        v = weight.shape[0]
        logits = tied_product(x, weight, dtype, cache)
    if logits.shape[-1] == v:
        return logits.float()
    logits = logits[..., :v]
    # a fresh f32 tensor, as the unpadded product's .float() gives: in f32
    # .float() would return a view of the padded logits
    if logits.dtype == torch.float32:
        return logits.contiguous()
    return logits.float()


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that normalises in f32 with its parameters and
    rounds the result to ``compute_dtype``, as flax's ``nn.LayerNorm(dtype=
    ...)`` does: through :func:`ops.layer_norm.layer_norm` (the kernel pair
    of ``csrc/layer_norm.cu`` on the card, which reads x and writes y in
    their own dtypes; on the CPU the former arithmetic, to the bit). On a
    DTensor (a mesh that places DTensors: ``pipe`` above 1) each rank
    normalises its own rows (``on_own_rows``): no mesh splits
    the features. The plain ``tensor`` path keeps the norms whole on every
    rank, their inputs whole once the branches are summed.

    :meth:`add_norm` takes the residual add before the norm into the same
    kernels (``ops.layer_norm.add_layer_norm``), as a pre-LN block's add
    and the next norm; on a DTensor the add stays torch's, then the norm on
    each rank's own rows."""

    def __init__(self, features: int, *, eps: float,
                 compute_dtype: torch.dtype, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps, device=device, dtype=param_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(x, DTensor):
            return on_own_rows(self._norm, x, self.weight, self.bias)
        return self._norm(x, self.weight, self.bias)

    def add_norm(self, x: torch.Tensor, r: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(s, norm(s))`` with ``s = x + r``, the residual stream and its
        norm (``r`` None: ``(x, norm(x))``)."""
        if r is None:
            return x, self(x)
        if isinstance(x, DTensor) or isinstance(r, DTensor):
            s = x + r
            return s, self(s)
        return add_layer_norm(x, r, self.weight, self.bias, eps=self.eps,
                              out_dtype=self.compute_dtype)

    def _norm(self, x, weight, bias):
        return layer_norm(x, weight, bias, eps=self.eps,
                          out_dtype=self.compute_dtype)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's ``"SAME"`` padding of one spatial axis, (before, after): the
    output has ceil(size / stride) positions and the odd pixel of an odd
    total goes after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv(dtype=..., param_dtype=...)`` over NCHW-shaped tensors:
    parameters in ``param_dtype`` (the weight ``channels_last``, as flax's
    NHWC), the product in ``compute_dtype``.

    ``padding`` is ``"SAME"`` (flax's default, by :func:`same_padding` on
    each axis at call time; an asymmetric pad is applied with ``F.pad``) or
    explicit ``((top, bottom), (left, right))``. torch's ``padding=1`` on a
    stride-2 3x3 over an even map pads (1, 1) where flax pads (0, 1).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, *, compute_dtype: torch.dtype,
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 bias: bool = False, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         bias=bias, device=device, dtype=param_dtype)
        self.weight = nn.Parameter(
            self.weight.detach().contiguous(memory_format=torch.channels_last)
        )
        self.flax_padding = padding
        self.compute_dtype = compute_dtype

    def _pads(self, hw) -> Sequence[Tuple[int, int]]:
        if self.flax_padding != "SAME":
            return self.flax_padding
        return [same_padding(n, k, s) for n, k, s in
                zip(hw, self.kernel_size, self.stride)]

    def forward(self, x: torch.Tensor, tensor_group=None) -> torch.Tensor:
        """``tensor_group``: row-parallel over that group (this conv keeps
        the input channels of the rank's groups): the partial map, dense
        in the input's memory format (channels-last stays so), summed
        over the group in place (``parallel.mesh.reduce_from_tensor``),
        then the whole bias, if any, added once."""
        if isinstance(x, DTensor):
            # DTensor has no placement rule for a strided NCHW conv
            return on_local_rows(self._conv, x, self.weight, self.bias)
        if tensor_group is not None:
            out = reduce_from_tensor(self._conv(x, self.weight, None),
                                     tensor_group)
            if self.bias is not None:
                out = out + self.bias.to(out.dtype)[:, None, None]
            return out
        return self._conv(x, self.weight, self.bias)

    def _conv(self, x, weight, bias):
        dt = self.compute_dtype
        x = x.to(dt)
        (top, bottom), (left, right) = self._pads(x.shape[-2:])
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
        bias = None if bias is None else bias.to(dt)
        return F.conv2d(x, weight.to(dt), bias, self.stride, padding)


NORM_GROUPS = 32  # flax nn.GroupNorm's default num_groups


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(dtype=...)``: 32 groups of consecutive channels,
    epsilon 1e-6, normalised in f32 with f32 parameters and rounded to
    ``compute_dtype``. The variance is E[(x - E[x])^2] (``F.group_norm``'s
    on the CPU, Chan's combination in the kernel on the card); flax computes
    E[x^2] - E[x]^2 (``use_fast_variance``), which loses digits to
    cancellation when a group's mean is large beside its spread. The norm
    runs through ``ops.group_norm.group_norm``: the hand kernels on a
    channels-last CUDA tensor, the plain versions on the CPU. ``relu`` and
    ``residual`` (ResNet's ``relu(y + residual)``) run in the kernels'
    epilogues; on a DTensor they follow the norm as DTensor ops, since
    ``on_local_rows`` takes its extra arguments for weights.

    Split over a ``tensor`` group at group boundaries (a ResNet block's
    first norm: ``parallel.mesh.split_over_tensor``), a rank keeps
    ``num_groups / t`` of the groups and their channels. The groups of a
    call follow the scale it is given at the module's group width, so
    the whole scale (the FLOP count's, with every parameter whole) takes
    every group."""

    def __init__(self, channels: int, *, compute_dtype: torch.dtype,
                 device=None, param_dtype: torch.dtype = torch.float32):
        super().__init__(NORM_GROUPS, channels, eps=1e-6, device=device,
                         dtype=param_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
        if isinstance(x, DTensor):
            y = on_local_rows(self._norm, x, self.weight, self.bias)
            if residual is not None:
                y = residual + y
            return F.relu(y) if relu else y
        return self._norm(x, self.weight, self.bias, residual, relu)

    def _norm(self, x, weight, bias, residual=None, relu=False):
        groups = weight.shape[0] * self.num_groups // self.num_channels
        return group_norm(x, weight, bias, groups=groups,
                          eps=self.eps, out_dtype=self.compute_dtype,
                          relu=relu, residual=residual)


# flax's lecun_normal: a standard normal truncated to [-2, 2], scaled so the
# truncated draw keeps the variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def draw_(param: torch.Tensor, std: float, generator: torch.Generator,
          truncated: bool = False) -> None:
    """Fill ``param`` from normal(0, std) drawn by ``generator`` (which must
    live on the parameter's device), truncated at 2 std as flax's
    ``lecun_normal`` draws when ``truncated``."""
    t = torch.empty(param.shape, dtype=torch.float32, device=param.device)
    if truncated:
        nn.init.trunc_normal_(t, generator=generator)
        t *= std / _TRUNC_STD
    else:
        nn.init.normal_(t, std=std, generator=generator)
    param.copy_(t)


@torch.no_grad()
def init_flax_layers_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers for every layer of ``model``, in module
    order: ``Linear`` and ``Conv2d`` kernels truncated lecun-normal over
    their fan-in (a conv's is kh * kw * in_channels), biases 0, norm scales
    1 and biases 0."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            fan_in = module.weight[0].numel()
            draw_(module.weight, 1.0 / math.sqrt(fan_in), generator,
                  truncated=True)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()


def unsplit_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last dim whole on every rank: a DTensor split there
    (on a mesh that places DTensors, a projection whose output features
    lie on ``tensor`` or ``fsdp``) is gathered over those mesh axes, since
    a flattened ``(3, heads, head_dim)`` split has no placement after the
    view. A plain tensor (the transformers' ``tensor`` meshes train plain
    modules, each rank's projection giving its own heads), or a DTensor
    whole there, passes as it is."""
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    placements = [Replicate() if isinstance(p, Shard) and p.dim % x.ndim == last
                  else p for p in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


class GroupedQKVProjection(nn.Module):
    """``y [b, s, hidden]`` -> (q, k, v), each ``[b, s, heads, head_dim]``
    with k/v at ``kv_heads``. The counterpart of ``grouped_qkv_projection``.

    ``cfg`` needs ``hidden_size``, ``num_heads``, ``num_kv_heads`` (0 = MHA),
    ``dtype`` (of the products) and ``rope``. When ``cfg.rope``, Q/K rotate
    at ``rope_positions`` (default ``arange(s)``; decode passes its one cache
    position). For MHA, q/k/v are strided views of one fused output. Split
    over a ``tensor`` group (:meth:`tensor_splits`), each rank's projection
    gives its own heads, ``heads / t`` and ``kv_heads / t`` of them.
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

    def splits_heads(self, t: int) -> bool:
        """Whether a ``tensor`` group of ``t`` ranks splits the heads: when
        ``t`` divides both head counts, as the JAX sharded flash path
        splits them; else every rank keeps them all."""
        return self.heads % t == 0 and self.kv_heads % t == 0

    def tensor_splits(self, t: int) -> dict:
        """The projection's parameters over a ``tensor`` group of ``t``
        ranks (``parallel.mesh.split_over_tensor``), each rank keeping the
        rows of its heads: the fused ``qkv`` rows, laid out ``(3, heads,
        head_dim)``, by head within each of q, k and v (not a contiguous
        block of rows), or ``q`` by query heads and ``kv`` (``(2, kv_heads,
        head_dim)``) by K/V heads, which keeps each rank's query heads with
        the K/V heads they share. None when the heads stay whole
        (:meth:`splits_heads`)."""
        if not self.splits_heads(t):
            return {}
        if self.kv_heads == self.heads:
            return {"qkv.weight": TensorSplit(0, 3),
                    "qkv.bias": TensorSplit(0, 3)}
        return {"q.weight": TensorSplit(0), "q.bias": TensorSplit(0),
                "kv.weight": TensorSplit(0, 2), "kv.bias": TensorSplit(0, 2)}

    def forward(
        self, y: torch.Tensor, rope_positions: Optional[torch.Tensor] = None
    ):
        b, s, _ = y.shape
        d = self.head_dim
        # -1 heads: all of them, or this rank's under a tensor split
        if self.kv_heads == self.heads:
            q, k, v = unsplit_last(self.qkv(y)).view(
                b, s, 3, -1, d).unbind(2)
        else:
            q = unsplit_last(self.q(y)).view(b, s, -1, d)
            k, v = unsplit_last(self.kv(y)).view(b, s, 2, -1, d).unbind(2)
        if self.rope:
            positions = (
                torch.arange(s, device=y.device) if rope_positions is None
                else rope_positions
            )
            q = apply_rope(q, positions)
            k = apply_rope(k, positions)
        return q, k, v


__all__ = [
    "Conv2d",
    "GroupNorm",
    "GroupedQKVProjection",
    "LayerNorm",
    "Linear",
    "NORM_GROUPS",
    "PaddedTable",
    "VocabPiece",
    "add_positions",
    "draw_",
    "init_flax_layers_",
    "linear",
    "padded_vocab",
    "same_padding",
    "split_group",
    "tied_logits",
    "tied_product",
    "vocab_parallel_embedding",
    "vocab_parallel_product",
    "vocab_piece",
    "vocab_split",
]
