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
nothing (JAX pads that chunk and masks the padding to ``-inf``; here the
final chunk is cut at the vocab's end, which leaves the same rows out).
Products and the logsumexp run in f32 whatever the inputs' type.

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


def _chunks(v: int, chunk_size: int):
    """``(start, end)`` of each vocab chunk, the size clamped to ``v``."""
    chunk_size = min(chunk_size, v)
    return [(i, min(i + chunk_size, v)) for i in range(0, v, chunk_size)]


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
            s = h @ table[start:end].float().T  # [T, chunk]
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
            tbl = table[start:end].float()
            p = torch.exp(h @ tbl.T - lse[:, None])  # softmax slice [T, chunk]
            in_chunk, local = _label_slot(y, start, end)
            p[rows, local] -= in_chunk.float()  # minus the one-hot label
            dlogits = p * scale
            dh += dlogits @ tbl
            dtable[start:end] = dlogits.T @ h
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
