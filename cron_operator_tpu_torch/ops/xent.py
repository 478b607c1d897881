"""Softmax cross-entropy over a large vocab: the training loss of the
``gpt`` and ``bert`` jobs, as in ``cron_operator_tpu/workloads/train.py``
and ``cron_operator_tpu/ops/xent.py``.

Two losses live here.

:func:`tied_cross_entropy` is the jobs' default. It runs the tied output
embedding's product ``hidden @ table.T`` in the hidden states' dtype
against the table padded to :data:`models.layers.VOCAB_ROWS_MULTIPLE`
rows, then :func:`softmax_cross_entropy` on that padded product itself, an
autograd Function over the CUDA pair of ``csrc/xent.cu``: its forward reads
the logits once for each row's f32 logsumexp and loss, its backward reads
them once and writes their gradient once, in the logits' dtype, zero in
the padded columns. No f32 ``[T, V]`` tensor and no cut copy of the logits
is made, forward or backward. The JAX package has no Pallas kernel here:
XLA fuses its ``cross_entropy_loss`` (``workloads/train.py:44-49``) into
reductions over the bf16 logits. :func:`softmax_cross_entropy_reference` is
the plain version, the port's former arithmetic op for op.

:func:`chunked_cross_entropy` never builds the full logits: its forward
keeps an online logsumexp over vocab chunks and picks out the label's
logit, and its backward recomputes each chunk's softmax slice and
accumulates ``dhidden`` and ``dtable`` chunk by chunk, so the extra memory
is ``[T, chunk]``. The JAX version is ``jnp`` under ``lax.scan``, not a
Pallas kernel, so this one is plain PyTorch in a Python loop over the
chunks. It serves the ``gpt`` entrypoint's ``param.fused_xent=1``.

The JAX version's two edge rules hold: the chunk size is clamped to the
vocab size, and the rows of the final chunk past the vocab's end contribute
nothing. JAX pads that chunk to the chunk size and masks the padding to
``-inf``. Here a chunk whose row count is not a multiple of 64 (the final
chunk of an odd vocab: 1105 rows of GPT-2's 50257 at chunk 8192) is padded
with zero rows to the next multiple of 64, which keeps cuBLAS off its
unaligned GEMMs, and its padded columns are masked to ``-inf`` before the
logsumexp and kept out of ``dhidden`` and ``dtable``. Products and the
logsumexp run in f32 whatever the inputs' type.

Under a ``tensor`` axis a GPT or BERT rank keeps its block of the tied
table's vocab rows (``models.layers.VocabPiece``, the Megatron
vocab-parallel layout) and both losses run on its columns alone:
:func:`vocab_parallel_cross_entropy` multiplies by the rank's rows and runs
the kernel pair on that slice, whose forward writes each row's logsumexp
over the slice and the label's logit where the label falls in it; the
ranks merge both over the group (:func:`_merge_over`: the logsumexp by max
then sum of exponentials in f32, the label's logit by a sum), and the
backward kernel takes the merged logsumexp. :func:`chunked_cross_entropy`
chunks over the rank's rows at their offset and merges alike. The JAX
package splits the table's hidden dim over ``tensor`` instead and lets
GSPMD divide the product.

Over a mesh that places DTensors the hidden states and labels are
DTensors, their rows split over the batch axes and, under sequence
parallelism, their positions over ``seq``: each rank runs the chunked loss
on its own tokens against the whole table, and the mean over the global
tokens is the sum of the ranks' shares (:func:`_sharded_cross_entropy`).
:func:`softmax_cross_entropy` refuses DTensors: the jobs keep
``cross_entropy_loss`` on the f32 logits for a mesh that places DTensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from cron_operator_tpu_torch.models.layers import (
    VocabPiece,
    tied_product,
    vocab_parallel_product,
)
from cron_operator_tpu_torch.ops import _build
from cron_operator_tpu_torch.ops.flash_attention import (
    _DTYPE_CODES,
    _count,
    _raise_on,
)
from cron_operator_tpu_torch.parallel.mesh import (
    batch_placements,
    copy_to_tensor,
)


ROWS_MULTIPLE = 64  # a chunk's table rows, padded


def _chunks(v: int, chunk_size: int):
    """``(start, end)`` of each vocab chunk, the size clamped to ``v``
    (none for ``v`` 0)."""
    chunk_size = max(1, min(chunk_size, v))
    return [(i, min(i + chunk_size, v)) for i in range(0, v, chunk_size)]


def _chunk_table(table: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Rows ``[start, end)`` of ``table`` in f32, with zero rows after them
    up to a multiple of ``ROWS_MULTIPLE`` (the cast and the padding in one
    pass over the rows). On the ``meta`` device (the FLOP count) the rows
    stay unpadded, so the count stays at the true vocab."""
    n = end - start
    padded = -(-n // ROWS_MULTIPLE) * ROWS_MULTIPLE
    if padded == n or table.is_meta:
        return table[start:end].float()
    tbl = torch.empty((padded, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    tbl[n:].zero_()
    tbl[:n].copy_(table[start:end])
    return tbl


def _chunk_logits(h: torch.Tensor, tbl: torch.Tensor, n: int) -> torch.Tensor:
    """``h @ tbl.T`` ``[T, padded]``, its columns past the chunk's ``n``
    rows masked to ``-inf``."""
    s = h @ tbl.T
    s[:, n:] = float("-inf")
    return s


def _label_slot(y: torch.Tensor, start: int, end: int):
    """Which rows' labels fall in ``[start, end)`` and their column there."""
    in_chunk = (y >= start) & (y < end)
    return in_chunk, (y - start).clamp(0, end - start - 1)


class _ChunkedCrossEntropy(torch.autograd.Function):
    """The chunked loss of ``hidden`` against ``table``'s rows, global
    rows ``lo`` on of a vocab of ``vocab`` (the whole table: ``lo`` 0,
    ``vocab`` its rows), merged over ``group`` (a ``tensor`` group, or
    None) by :func:`_merge_over`."""

    @staticmethod
    def forward(ctx, hidden, table, labels, chunk_size, lo, vocab, group):
        d = hidden.shape[-1]
        h = hidden.reshape(-1, d).float()
        y = labels.reshape(-1).long()
        t = h.shape[0]
        real = max(0, min(table.shape[0], vocab - lo))
        m = torch.full((t,), float("-inf"), device=h.device)
        l = torch.zeros(t, device=h.device)
        label_logit = torch.zeros(t, device=h.device)
        for start, end in _chunks(real, chunk_size):
            s = _chunk_logits(h, _chunk_table(table, start, end),
                              end - start)  # [T, chunk padded]
            m_new = torch.maximum(m, s.amax(dim=-1))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(-1)
            m = m_new
            in_chunk, local = _label_slot(y, lo + start, lo + end)
            picked = s.gather(1, local[:, None])[:, 0]
            label_logit = torch.where(in_chunk, picked, label_logit)
        lse = m + torch.log(l)  # -inf for a slice with no real row
        if group is not None:
            lse, label_logit = _merge_over(lse, label_logit, group)
        ctx.save_for_backward(hidden, table, labels, lse)
        ctx.chunk_size, ctx.lo, ctx.real = chunk_size, lo, real
        return (lse - label_logit).mean()

    @staticmethod
    def backward(ctx, g):
        hidden, table, labels, lse = ctx.saved_tensors
        d = hidden.shape[-1]
        h = hidden.reshape(-1, d).float()
        y = labels.reshape(-1).long()
        t = h.shape[0]
        scale = g.float() / t  # d(mean)/d(per-token)
        dh = torch.zeros_like(h)
        real = ctx.real
        # the padding rows past the vocab get no gradient
        dtable = (torch.empty if real == table.shape[0] else torch.zeros)(
            table.shape, dtype=torch.float32, device=table.device)
        rows = torch.arange(t, device=h.device)
        for start, end in _chunks(real, ctx.chunk_size):
            n = end - start
            tbl = _chunk_table(table, start, end)
            # softmax slice [T, chunk padded], 0 in the padded columns
            p = torch.exp(_chunk_logits(h, tbl, n) - lse[:, None])
            in_chunk, local = _label_slot(y, ctx.lo + start, ctx.lo + end)
            p[rows, local] -= in_chunk.float()  # minus the one-hot label
            dlogits = p * scale
            dh += dlogits @ tbl
            dtable[start:end] = (dlogits.T @ h)[:n]
        return (dh.reshape(hidden.shape).to(hidden.dtype),
                dtable.to(table.dtype), None, None, None, None, None)


def chunked_cross_entropy(
    hidden: torch.Tensor,
    table,
    labels: torch.Tensor,
    chunk_size: int = 8192,
) -> torch.Tensor:
    """Mean softmax cross-entropy of ``hidden @ table.T`` against integer
    ``labels``, never materialising the full logits.

    ``hidden``: ``[..., d]`` (any leading dims); ``table``: ``[V, d]`` (the
    tied output embedding), or a ``tensor`` rank's
    ``models.layers.VocabPiece`` of it: the chunks then run over the rank's
    real rows at their global offset, each row's logsumexp and label logit
    are merged over the group (:func:`_merge_over`), and ``hidden``'s
    gradient is summed over it (``copy_to_tensor``); ``labels``: ``[...]``
    int. Returns a scalar.
    """
    if isinstance(table, VocabPiece):
        return _ChunkedCrossEntropy.apply(
            copy_to_tensor(hidden, table.group), table.weight, labels,
            chunk_size, table.lo, table.vocab, table.group)
    if isinstance(hidden, DTensor):
        return _sharded_cross_entropy(hidden, table, labels, chunk_size)
    return _ChunkedCrossEntropy.apply(hidden, table, labels, chunk_size, 0,
                                      table.shape[0], None)


def _sharded_cross_entropy(hidden, table, labels, chunk_size: int):
    """The loss of DTensor ``hidden [b, s, d]`` and ``labels [b, s]``: each
    rank's tokens (rows over the batch axes, positions over ``seq``) against
    the table gathered whole, scaled by its share of the tokens; the result
    is a ``Partial`` sum over the axes that split the tokens, and the
    table's gradient a partial sum over them too."""
    mesh = hidden.device_mesh
    tokens = list(batch_placements(mesh, seq_dim=1))
    split = [Partial() if isinstance(p, Shard) else Replicate()
             for p in tokens]
    table = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=split)
    h = hidden.redistribute(mesh, tokens).to_local()
    y = labels.redistribute(mesh, tokens).to_local()
    loss = _ChunkedCrossEntropy.apply(h, table, y, chunk_size, 0,
                                      table.shape[0], None)
    loss = loss * (y.numel() / labels.numel())
    return DTensor.from_local(loss, mesh, split, run_check=False)


def _merge_over(lse: torch.Tensor, picked: torch.Tensor,
                group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's logsumexp and label logit over the whole vocab from the
    ``tensor`` group's slices, ``(lse, picked)`` f32 ``[T]`` on every rank:
    the slices' logsumexps by their max (one all-reduce) then the sum of
    their exponentials about it (a second, with the label logits, which
    the one slice that holds the label gives and the others give as 0).
    In f32, on the device, allocating nothing on the host: a captured step
    holds the two all-reduces."""
    top = lse.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    both = torch.stack((torch.exp(lse - top), picked))
    dist.all_reduce(both, group=group)
    return top + torch.log(both[0]), both[1]


def merge_slices(lse: torch.Tensor, picked: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_merge_over`'s arithmetic on one process: ``lse`` and
    ``picked`` ``[t, T]``, the t slices' forward results; returns each
    row's ``(loss, lse)`` over the whole vocab, f32 ``[T]``."""
    top = lse.amax(dim=0)
    merged = top + torch.log(torch.exp(lse - top).sum(dim=0))
    return merged - picked.sum(dim=0), merged


# ------------------------------------------- softmax cross-entropy kernels

# The kernels' one design (csrc/xent.cu): one block of 256 threads a row,
# 16-byte vectors strided by the block.
XENT_DESIGNS = ("row",)
_THREADS = 256
# The label dtypes the kernels read, by their byte widths.
_LABEL_BYTES = {torch.int32: 4, torch.int64: 8}
# The plain versions' devices: the CPU, and ``meta`` for a FLOP count's
# shapes (``Trainer.flops_per_step``).
_PLAIN_DEVICES = ("cpu", "meta")
# f32 unit roundoff, and the depth assumed of the plain version's f32 sums
# (torch's log_softmax and mean sum each row or the T losses in per-thread
# chains and trees of no more than 2^8 sequential additions).
_U = 2.0 ** -24
_PLAIN_DEPTH = 2 ** 8
# One unit in the last place relative to the value: a rounding flip of the
# result between two neighbours.
_ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}


def softmax_cross_entropy_reference(logits: torch.Tensor, labels: torch.Tensor,
                                    vocab: int) -> torch.Tensor:
    """The plain loss, differentiable: the mean over the rows of ``logits
    [..., Vp]`` of the softmax cross-entropy of their first ``vocab``
    columns against ``labels [...]``. It is the port's former arithmetic
    op for op: ``F.log_softmax`` of the cut logits cast to f32, the
    label's entry gathered, the mean negated (``workloads/train.py``
    ``cross_entropy_loss`` of ``tied_logits``'s f32 ``[..., V]``)."""
    logp = F.log_softmax(logits[..., :vocab].float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


def _whole_row(vocab: int, lo: int, total: Optional[int]) -> bool:
    """Whether a slice of ``vocab`` real columns from global column ``lo``
    of a vocab of ``total`` (None: ``lo + vocab``) is the whole row."""
    return lo == 0 and (total is None or total == vocab)


def softmax_xent_forward_reference(
        logits: torch.Tensor, labels: torch.Tensor, vocab: int, lo: int = 0,
        total: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward of ``logits [T, Vp]`` and ``labels [T]``: ``(loss,
    lse)``, f32 ``[T]``: each row's loss ``-log_softmax(x)[label]`` (the
    former ops, so the mean of the losses is
    :func:`softmax_cross_entropy_reference`'s bits) and its logsumexp.

    A slice of the vocab (``lo`` the global column of column 0, ``total``
    the whole vocab; None: ``lo + vocab``): ``(picked, lse)``, the
    logsumexp over the slice's ``vocab`` real columns (-inf for none) and
    the label's logit where ``lo <= label < lo + vocab``, else 0, NaN for a
    label outside ``[0, total)``; :func:`merge_slices` merges t of them.
    The whole row (``lo`` 0, ``total`` ``vocab``) is the function above."""
    x = logits[:, :vocab].float()
    if _whole_row(vocab, lo, total):
        logp = F.log_softmax(x, dim=-1)
        loss = -logp.gather(1, labels.long()[:, None])[:, 0]
        return loss, torch.logsumexp(x, dim=-1)
    total = lo + vocab if total is None else total
    y = labels.long()
    local = y - lo
    inside = (local >= 0) & (local < vocab)
    picked = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    if vocab:
        picked = torch.where(
            inside, x.gather(1, local.clamp(0, vocab - 1)[:, None])[:, 0],
            picked)
    picked = picked.masked_fill((y < 0) | (y >= total), float("nan"))
    return picked, torch.logsumexp(x, dim=-1)


def softmax_xent_backward_reference(logits: torch.Tensor, labels: torch.Tensor,
                                    g: torch.Tensor, vocab: int,
                                    lo: int = 0,
                                    lse: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """The plain backward: the gradient of the mean loss times ``g`` with
    respect to ``logits [T, Vp]``, in the logits' dtype, zero past
    ``vocab``. It runs what autograd ran on the former path, op for op and
    to the bit: the mean's and the negation's ``-g / T`` scattered into a
    zeroed f32 ``[T, V]`` at the labels, log-softmax's backward against its
    output (recomputed: it reads no logsumexp), the cast to the logits'
    dtype and the cut's padding back to Vp columns.

    A slice of the vocab (``lse`` given: each row's logsumexp merged over
    every slice; ``lo`` the slice's first global column): ``(exp(x - lse)
    - [j + lo == label]) * g / T`` on the ``vocab`` real columns in f32,
    rounded to the logits' dtype, zeros past them."""
    t = labels.numel()
    if lse is not None:
        x = logits[:, :vocab].float()
        p = torch.exp(x - lse.float()[:, None])
        local = labels.long() - lo
        hit = (local >= 0) & (local < vocab)
        if vocab:
            p.scatter_add_(1, local.clamp(0, vocab - 1)[:, None],
                           -hit.float()[:, None])
        out = torch.zeros(logits.shape, dtype=logits.dtype,
                          device=logits.device)
        out[:, :vocab] = p * (g.float() / t)
        return out
    logp = F.log_softmax(logits[:, :vocab].float(), dim=-1)
    grad = torch.zeros_like(logp)
    grad.scatter_(1, labels.long()[:, None], (-g.float() / t).expand(t, 1))
    dx = torch._log_softmax_backward_data(grad, logp, 1, torch.float32)
    out = torch.zeros(logits.shape, dtype=logits.dtype, device=logits.device)
    out[:, :vocab] = dx
    return out


def _sum_depth(vp: int, dtype: torch.dtype) -> int:
    """The most sequential f32 additions in the kernel's row sum: a
    thread's vectors, the warp's 5 shuffles and the 8 warps."""
    vec = 16 // dtype.itemsize
    return -(-vp // (_THREADS * vec)) * vec + 5 + 8


def xent_tolerance(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                   loss: torch.Tensor, lse: torch.Tensor,
                   g: Optional[torch.Tensor] = None,
                   dlogits: Optional[torch.Tensor] = None, lo: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """Elementwise bounds on ``|kernel - plain|`` from the plain version's
    results on ``logits [T, Vp]`` and ``labels [T]`` (``loss`` and ``lse``
    ``[T]``; with ``g``, also the plain ``dlogits``): keys ``lse``,
    ``loss`` (each row's), ``mean`` and with ``g`` also ``dlogits``
    ``[T, V]`` (the padded columns are exact zeros on both sides). A slice
    of the vocab (at least one real column) passes its first global column
    ``lo``, the slice's logsumexp as ``lse`` for the forward (its label
    logit is a read of x, the same bits on both sides) and the merged one
    for the gradient, which both sides are given.

    Both sides sum the same positive terms exp(x - m) in f32 in other
    orders: the kernel's chains are :func:`_sum_depth` deep, the plain
    version's at most 2^8, so the sums differ by up to (d_k + d_p)·u of
    themselves, u = 2^-24. Each term carries exp2f's 2 ulp and the
    rounding of (x - m) and of its product by log2 e, about 2u·|x - m| of
    itself; the log and the add of m round by u of |lse| each side. So
    lse may differ by e_lse = (d_k + d_p)·u + 2^-21 + 2^-22·(R + |lse|), R
    the row's largest |x - lse|; a row's loss by e_lse + 2^-22·|loss|; the
    mean (one torch sum over T each side, the same order) by the mean of
    those plus 2·2^8·u of the mean |loss|. The gradient (p - [j = label])
    ·g/T, p = exp(x - lse), by |g/T|·(p·(e_lse + 2^-21·(1 + |x - lse|))
    + 2^-22·(p + [j = label])) in f32, then one unit in the last place of
    the logits' dtype at |dlogits| (bf16: 2^-7 |d|, a rounding flip)."""
    ct = torch.float32
    x = logits[:, :vocab].to(ct)
    lse = lse.to(ct)
    gap = (x - lse[:, None]).abs()
    depth = _sum_depth(logits.shape[1], logits.dtype) + _PLAIN_DEPTH
    e_lse = (depth * _U + 2.0 ** -21
             + 2.0 ** -22 * (gap.amax(dim=1) + lse.abs()))
    e_loss = e_lse + 2.0 ** -22 * loss.to(ct).abs()
    bounds = {
        "lse": e_lse,
        "loss": e_loss,
        "mean": (e_loss.mean()
                 + 2 * _PLAIN_DEPTH * _U * loss.to(ct).abs().mean()),
    }
    if g is not None:
        scale = g.to(ct).abs() / labels.numel()
        p = torch.exp(-gap)
        hot = torch.zeros_like(p)
        local = labels.long() - lo
        hot.scatter_(1, local.clamp(0, vocab - 1)[:, None],
                     ((local >= 0) & (local < vocab)).to(ct)[:, None])
        e_f32 = scale * (p * (e_lse[:, None] + 2.0 ** -21 * (1 + gap))
                         + 2.0 ** -22 * (p + hot))
        bounds["dlogits"] = (_ULP[dlogits.dtype]
                             * dlogits[:, :vocab].to(ct).abs() + e_f32)
    return bounds


def merge_tolerance(bounds: Dict[str, torch.Tensor], lses: torch.Tensor,
                    lse: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Bounds on ``|merge - whole|``, each row's logsumexp (``lse``) and
    loss (``loss``), between :func:`merge_slices` of t slices' forward
    results (``lses [t, T]``, kernel or plain) and the whole row's (``lse
    [T]``), from :func:`xent_tolerance`'s ``bounds`` of the whole row.

    The merge sums the same positive terms as the whole row in another
    grouping, each slice's chains no deeper than the whole row's plus the
    t slices, so while d_slice + t <= 2^8 the whole row's e_lse covers
    the orders. The merge itself rounds each lse_r - M (u·|lse_r - M|),
    each exp (2 ulp), the t-term sum (t·u), the log and the add of M
    (u·|lse| and u): e_lse + (t + 3)·u + 2^-22·(S + |lse|), S the row's
    largest |lse_r - lse| over the slices with a real column (a slice
    without one adds an exact 0). The label logits sum to one non-zero
    term, exactly."""
    ct = torch.float32
    lse = lse.to(ct)
    gap = (lses.to(ct) - lse).abs()
    spread = torch.where(torch.isfinite(gap), gap,
                         torch.zeros_like(gap)).amax(dim=0)
    extra = (lses.shape[0] + 3) * _U + 2.0 ** -22 * (spread + lse.abs())
    return {"lse": bounds["lse"] + extra, "loss": bounds["loss"] + extra}


_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    """The built loss library, with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load("xent")
        lib.xent_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.xent_fwd.restype = ctypes.c_int
        lib.xent_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.xent_bwd.restype = ctypes.c_int
        lib.xent_error_string.argtypes = [ctypes.c_int]
        lib.xent_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_kernel_inputs(logits: torch.Tensor, labels: torch.Tensor,
                         vocab: int, lo: int, total: int) -> None:
    """Refuses what the kernels cannot read in place, before anything is
    built: a hidden copy of the logits would be the very pass the kernels
    exist to remove."""
    if logits.dtype not in _DTYPE_CODES:
        raise ValueError(f"the loss kernels take float32 or bfloat16 logits, "
                         f"not {logits.dtype}")
    t, vp = logits.shape
    # a slice without a real column may start past the vocab's end
    if not (0 <= vocab <= vp and lo >= 0 and total > 0
            and (vocab == 0 or lo + vocab <= total)):
        raise ValueError(f"vocab {vocab} (real columns from column {lo} of "
                         f"{total}) does not fit logits [{t}, {vp}]")
    vec = 16 // logits.element_size()
    if (logits.stride() != (vp, 1) or vp % vec or logits.data_ptr() % 16):
        raise ValueError(
            f"logits [{t}, {vp}] must be contiguous rows of whole 16-byte "
            "vectors at a 16-byte aligned address: the loss kernels read "
            "them in place")
    if (labels.dtype not in _LABEL_BYTES or labels.shape != (t,)
            or labels.stride() != (1,) or labels.device != logits.device):
        raise ValueError(f"labels must be contiguous int32 or int64 [{t}] on "
                         f"the logits' device, not {labels.dtype} "
                         f"{tuple(labels.shape)} on {labels.device}")


def _launch_forward(logits, labels, vocab, lo, total):
    _check_kernel_inputs(logits, labels, vocab, lo, total)
    t, vp = logits.shape
    out = torch.empty((2, t), dtype=torch.float32, device=logits.device)
    lib = _kernel()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.xent_fwd(logits.data_ptr(), labels.data_ptr(),
                           out[1].data_ptr(), out[0].data_ptr(),
                           _DTYPE_CODES[logits.dtype],
                           _LABEL_BYTES[labels.dtype], t, vp, vocab, lo,
                           total, stream)
    _raise_on(err, lib, "xent_fwd", "xent_error_string")
    _count(softmax_xent_forward, "row", stream)
    return out[0], out[1]


def _launch_backward(logits, labels, lse, g, vocab, lo, total):
    _check_kernel_inputs(logits, labels, vocab, lo, total)
    t, vp = logits.shape
    if (lse.shape != (t,) or lse.dtype != torch.float32
            or lse.stride() != (1,) or lse.device != logits.device):
        raise ValueError(f"lse must be contiguous float32 [{t}] on the "
                         "logits' device")
    g = g.detach().to(device=logits.device, dtype=torch.float32).reshape(())
    dlogits = torch.empty_like(logits, memory_format=torch.contiguous_format)
    lib = _kernel()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.xent_bwd(logits.data_ptr(), labels.data_ptr(),
                           lse.data_ptr(), g.data_ptr(), dlogits.data_ptr(),
                           _DTYPE_CODES[logits.dtype],
                           _LABEL_BYTES[labels.dtype], t, vp, vocab, lo,
                           total, stream)
    _raise_on(err, lib, "xent_bwd", "xent_error_string")
    _count(softmax_xent_backward, "row", stream)
    return dlogits


def _refuse_dtensor(*tensors) -> None:
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            "softmax_cross_entropy takes local tensors, not DTensors: a mesh "
            "that places DTensors keeps cross_entropy_loss on the f32 logits")


def softmax_xent_forward(logits: torch.Tensor, labels: torch.Tensor,
                         vocab: int, lo: int = 0, total: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)``, f32 ``[T]``, of ``logits [T, Vp]`` (the first
    ``vocab`` columns count) and ``labels [T]``: the forward kernel on a
    CUDA tensor (or raises), :func:`softmax_xent_forward_reference` on a
    CPU or meta tensor. No autograd. Its bound is bytes: the logits read
    once (0.246 ms at GPT-2 small's b 8 x 1024 in bf16 on an H100).

    A slice of the vocab (``lo`` its first global column, ``total`` the
    whole vocab; None: ``lo + vocab``) gives ``(picked, lse)`` over its
    ``vocab`` real columns (0 to Vp), as the plain version's slice form;
    :func:`_merge_over` merges the slices of a group. The whole row (``lo``
    0, ``total`` ``vocab``) is the function above."""
    _refuse_dtensor(logits, labels)
    total = lo + vocab if total is None else total
    with torch.no_grad():
        if logits.is_cuda:
            return _launch_forward(logits, labels, vocab, lo, total)
        if logits.device.type in _PLAIN_DEVICES:
            return softmax_xent_forward_reference(logits, labels, vocab, lo,
                                                  total)
    raise ValueError(f"the loss runs on CUDA, CPU or meta, not "
                     f"{logits.device}")


def softmax_xent_backward(logits: torch.Tensor, labels: torch.Tensor,
                          lse: torch.Tensor, g: torch.Tensor,
                          vocab: int, lo: int = 0,
                          total: Optional[int] = None) -> torch.Tensor:
    """The gradient of the mean loss times ``g`` (a one-element tensor)
    with respect to ``logits [T, Vp]``, in their dtype, exact zeros past
    ``vocab``: the backward kernel on a CUDA tensor (or raises), from the
    forward's ``lse``; :func:`softmax_xent_backward_reference` on a CPU or
    meta tensor. No autograd. Its bound is bytes: the logits read once and
    the gradient written once (0.492 ms at GPT-2 small's b 8 x 1024). A
    slice (``lo``, ``total`` as :func:`softmax_xent_forward`'s) takes the
    logsumexp merged over the slices and writes its real columns'
    gradient."""
    _refuse_dtensor(logits, labels, lse, g)
    total = lo + vocab if total is None else total
    with torch.no_grad():
        if logits.is_cuda:
            return _launch_backward(logits, labels, lse, g, vocab, lo, total)
        if logits.device.type in _PLAIN_DEVICES:
            return softmax_xent_backward_reference(
                logits, labels, g, vocab, lo,
                None if _whole_row(vocab, lo, total) else lse)
    raise ValueError(f"the loss runs on CUDA, CPU or meta, not "
                     f"{logits.device}")


softmax_xent_forward.launches = 0
softmax_xent_forward.launches_by_design = dict.fromkeys(XENT_DESIGNS, 0)
softmax_xent_backward.launches = 0
softmax_xent_backward.launches_by_design = dict.fromkeys(XENT_DESIGNS, 0)


class _SoftmaxCrossEntropy(torch.autograd.Function):
    """The mean loss of ``logits [T, Vp]``; saves the logits (the product,
    alive anyway until the GEMM's backward has run), the labels and the
    f32 ``lse [T]``, no f32 copy of the logits."""

    @staticmethod
    def forward(ctx, logits, labels, vocab):
        loss, lse = softmax_xent_forward(logits, labels, vocab)
        ctx.vocab = vocab
        ctx.save_for_backward(logits, labels, lse)
        return loss.mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return (softmax_xent_backward(logits, labels, lse, g, ctx.vocab),
                None, None)


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """The mean loss of a ``tensor`` rank's slice ``logits [T, rows]``
    (global columns ``lo`` on, ``real`` of them below ``vocab``): the
    forward kernel on the slice, :func:`_merge_over` over ``group``, the
    mean of ``lse - picked``; backward the kernel from the merged
    ``lse``. Saves the slice, the labels and the merged f32 ``lse [T]``."""

    @staticmethod
    def forward(ctx, logits, labels, lo, real, vocab, group):
        picked, lse = softmax_xent_forward(logits, labels, real, lo, vocab)
        lse, picked = _merge_over(lse, picked, group)
        ctx.slice = (real, lo, vocab)
        ctx.save_for_backward(logits, labels, lse)
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return (softmax_xent_backward(logits, labels, lse, g, *ctx.slice),
                None, None, None, None, None)


def _check_logits(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                  least: int = 1) -> None:
    """Refuses labels that do not fit ``logits [..., Vp]``, ``vocab``
    columns that count outside ``[least, Vp]``, and non-contiguous CUDA
    logits."""
    vp = logits.shape[-1]
    if not least <= vocab <= vp or labels.shape != logits.shape[:-1]:
        raise ValueError(f"labels {tuple(labels.shape)} and vocab {vocab} do "
                         f"not fit logits {tuple(logits.shape)}")
    if logits.is_cuda and not logits.is_contiguous():
        raise ValueError("CUDA logits must be contiguous: the loss kernels "
                         "read them in place")


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab: int) -> torch.Tensor:
    """Mean softmax cross-entropy of the first ``vocab`` columns of
    ``logits [..., Vp]`` against integer ``labels [...]``, differentiable
    in the logits: the kernels of ``csrc/xent.cu`` on a CUDA tensor (which
    must be contiguous: nothing is copied to fit), the plain versions on a
    CPU or meta one, the same bits as
    :func:`softmax_cross_entropy_reference` there, loss and gradient. A
    DTensor raises ``TypeError``. Each wrapper counts its launches
    (``softmax_xent_forward.launches``, ``softmax_xent_backward.launches``),
    once per replay where a graph capture recorded it."""
    _refuse_dtensor(logits, labels)
    _check_logits(logits, labels, vocab)
    vp = logits.shape[-1]
    return _SoftmaxCrossEntropy.apply(logits.reshape(-1, vp),
                                      labels.reshape(-1), vocab)


def vocab_parallel_cross_entropy(hidden: torch.Tensor, table: VocabPiece,
                                 labels: torch.Tensor) -> torch.Tensor:
    """The ``gpt`` and ``bert`` jobs' loss on a ``tensor`` rank: the tied
    product on the rank's rows (``models.layers.vocab_parallel_product``,
    in the hidden states' dtype, ``[..., rows]``: no padding, the block is
    a multiple of 64 rows; the hidden states' gradient summed over the
    group), the forward kernel on that slice, each row's logsumexp and
    label logit merged over the group (:func:`_merge_over`), the mean of
    the rows' losses; backward the kernel from the merged logsumexp
    (``exp(x - lse) - [j + lo == label]``, exact zeros past the real
    columns) and the product's backward. ``hidden [..., d]``, ``table`` a
    ``VocabPiece``, ``labels [...]``; a scalar, the same on every rank of
    the group. The plain versions on the CPU; a CUDA tensor launches the
    kernels or raises."""
    logits = vocab_parallel_product(hidden, table, hidden.dtype)
    _refuse_dtensor(logits, labels)
    _check_logits(logits, labels, table.real, least=0)
    rows = logits.shape[-1]
    return _VocabParallelCrossEntropy.apply(
        logits.reshape(-1, rows), labels.reshape(-1), table.lo, table.real,
        table.vocab, table.group)


def tied_cross_entropy(hidden: torch.Tensor, table,
                       labels: torch.Tensor) -> torch.Tensor:
    """The ``gpt`` and ``bert`` jobs' loss: the tied output embedding's
    product ``hidden @ table.T`` (flax ``tok.attend``) in the hidden states'
    dtype against the table padded with zero rows
    (``models.layers.tied_product``, as ``tied_logits`` runs it), and
    :func:`softmax_cross_entropy` on the padded product ``[..., Vp]``
    itself. ``hidden [..., d]``, ``table [V, d]``, ``labels [...]``; a
    scalar. On the ``meta`` device (the FLOP count) the product stays at
    the true vocab. A ``tensor`` rank's ``models.layers.VocabPiece`` in
    place of the table takes :func:`vocab_parallel_cross_entropy`."""
    if isinstance(table, VocabPiece):
        return vocab_parallel_cross_entropy(hidden, table, labels)
    return softmax_cross_entropy(tied_product(hidden, table, hidden.dtype),
                                 labels, table.shape[0])


__all__ = ["XENT_DESIGNS", "chunked_cross_entropy", "merge_slices",
           "merge_tolerance", "softmax_cross_entropy",
           "softmax_cross_entropy_reference", "softmax_xent_backward",
           "softmax_xent_backward_reference", "softmax_xent_forward",
           "softmax_xent_forward_reference", "tied_cross_entropy",
           "vocab_parallel_cross_entropy", "xent_tolerance"]
