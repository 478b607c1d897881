"""Chunked softmax cross-entropy over a large vocab, as in
``cron_operator_tpu/ops/xent.py``.

For a causal LM the loss path ``hidden @ table.T -> [T, V] logits -> softmax
CE`` builds the biggest tensor of the step. :func:`chunked_cross_entropy`
never does: its forward keeps an online logsumexp over vocab chunks and
picks out the label's logit, and its backward recomputes each chunk's
softmax slice and accumulates ``dhidden`` and ``dtable`` chunk by chunk, so
the extra memory is ``[T, chunk]``. The JAX version is ``jnp`` under
``lax.scan``, not a Pallas kernel, so this one is plain PyTorch in a Python
loop over the chunks. It serves the ``gpt`` entrypoint's
``param.fused_xent=1``.

The JAX version's two edge rules hold: the chunk size is clamped to the
vocab size, and the rows of the final chunk past the vocab's end contribute
nothing. JAX pads that chunk to the chunk size and masks the padding to
``-inf``. Here a chunk whose row count is not a multiple of 64 (the final
chunk of an odd vocab: 1105 rows of GPT-2's 50257 at chunk 8192) is padded
with zero rows to the next multiple of 64, which keeps cuBLAS off its
unaligned GEMMs, and its padded columns are masked to ``-inf`` before the
logsumexp and kept out of ``dhidden`` and ``dtable``. Products and the
logsumexp run in f32 whatever the inputs' type.

Over a mesh the hidden states and labels are DTensors, their rows split
over the batch axes and, under sequence parallelism, their positions over
``seq``: each rank runs the chunked loss on its own tokens against the
whole table, and the mean over the global tokens is the sum of the ranks'
shares (:func:`_sharded_cross_entropy`).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from cron_operator_tpu_torch.parallel.mesh import batch_placements


ROWS_MULTIPLE = 64  # a chunk's table rows, padded


def _chunks(v: int, chunk_size: int):
    """``(start, end)`` of each vocab chunk, the size clamped to ``v``."""
    chunk_size = min(chunk_size, v)
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
    @staticmethod
    def forward(ctx, hidden, table, labels, chunk_size):
        d = hidden.shape[-1]
        h = hidden.reshape(-1, d).float()
        y = labels.reshape(-1).long()
        t = h.shape[0]
        m = torch.full((t,), float("-inf"), device=h.device)
        l = torch.zeros(t, device=h.device)
        label_logit = torch.zeros(t, device=h.device)
        for start, end in _chunks(table.shape[0], chunk_size):
            s = _chunk_logits(h, _chunk_table(table, start, end),
                              end - start)  # [T, chunk padded]
            m_new = torch.maximum(m, s.amax(dim=-1))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(-1)
            m = m_new
            in_chunk, local = _label_slot(y, start, end)
            picked = s.gather(1, local[:, None])[:, 0]
            label_logit = torch.where(in_chunk, picked, label_logit)
        lse = m + torch.log(l)
        ctx.save_for_backward(hidden, table, labels, lse)
        ctx.chunk_size = chunk_size
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
        dtable = torch.empty(table.shape, dtype=torch.float32,
                             device=table.device)
        rows = torch.arange(t, device=h.device)
        for start, end in _chunks(table.shape[0], ctx.chunk_size):
            n = end - start
            tbl = _chunk_table(table, start, end)
            # softmax slice [T, chunk padded], 0 in the padded columns
            p = torch.exp(_chunk_logits(h, tbl, n) - lse[:, None])
            in_chunk, local = _label_slot(y, start, end)
            p[rows, local] -= in_chunk.float()  # minus the one-hot label
            dlogits = p * scale
            dh += dlogits @ tbl
            dtable[start:end] = (dlogits.T @ h)[:n]
        return (dh.reshape(hidden.shape).to(hidden.dtype),
                dtable.to(table.dtype), None, None)


def chunked_cross_entropy(
    hidden: torch.Tensor,
    table: torch.Tensor,
    labels: torch.Tensor,
    chunk_size: int = 8192,
) -> torch.Tensor:
    """Mean softmax cross-entropy of ``hidden @ table.T`` against integer
    ``labels``, never materialising the full logits.

    ``hidden``: ``[..., d]`` (any leading dims); ``table``: ``[V, d]`` (the
    tied output embedding); ``labels``: ``[...]`` int. Returns a scalar.
    """
    if isinstance(hidden, DTensor):
        return _sharded_cross_entropy(hidden, table, labels, chunk_size)
    return _ChunkedCrossEntropy.apply(hidden, table, labels, chunk_size)


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
    loss = _ChunkedCrossEntropy.apply(h, table, y, chunk_size)
    loss = loss * (y.numel() / labels.numel())
    return DTensor.from_local(loss, mesh, split, run_check=False)


__all__ = ["chunked_cross_entropy"]
