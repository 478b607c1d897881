"""Flash attention: CUDA kernels for Hopper, their plain versions, and the
autograd Function that joins them.

The kernels replace the JAX package's three Pallas kernels in
``cron_operator_tpu/ops/flash_attention.py``: K1 ``_flash_kernel``, the
online-softmax forward (``csrc/flash_fwd.cu``), and the backward pair K2
``_bwd_dq_kernel`` (dQ) and K3 ``_bwd_dkv_kernel`` (dK, dV) in
``csrc/flash_bwd.cu``. The s x s score matrix never reaches HBM in either
direction. The source files' headers state each kernel's bound and design.

:func:`flash_attention_fwd`, :func:`flash_attention_dq` and
:func:`flash_attention_dkv` launch their kernel for a CUDA tensor and run the
same function in plain PyTorch for a CPU tensor; there is no fallback from
one to the other. The kernels read Q, K, V and dO through their strides (so
the ``qkv[:, :, i]`` slices of the fused projection go in without a copy;
only a last dimension that is not unit-stride is made contiguous) and write
fresh contiguous outputs.

:func:`flash_attention` is differentiable: its Function saves ``(q, k, v,
o, lse)`` from the forward, and its backward computes ``Delta = rowsum(dO *
O)`` in plain PyTorch (as the JAX package does in XLA) and then runs K2 and
K3. It composes with ``torch.utils.checkpoint(use_reentrant=False)``, which
reruns the forward.

The shape rules are the JAX package's: ``seq`` must divide by the block
edges, which default to :func:`_default_block` (multiples of 128), and K/V
may carry a positive divisor of the query heads. The kernels' own tiles are
64 rows (32 for the backward at head dim 256), which divide every accepted
``seq``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from cron_operator_tpu_torch.ops import _build

_MAX_DEFAULT_BLOCK = 512
NEG_INF = -1e30  # masked score: exp() underflows to exactly 0, no inf - inf
# LSE of a row that saw no key: exp(s - LSE_MASKED) is 0 for any finite s.
LSE_MASKED = 1e30
KERNEL_TILE = 64  # query and key rows per tile inside the kernel
HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernel is compiled for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()


def _default_block(s: int) -> int:
    """Largest block edge <= 512 in steps of 128 that divides ``s`` (seq 640
    gets 128, not an indivisible 512); 128 when none does, which
    :func:`_check_shapes` then refuses."""
    for b in range(_MAX_DEFAULT_BLOCK, 127, -128):
        if s % b == 0:
            return b
    return 128


def _check_shapes(s: int, block_q: int, block_k: int) -> None:
    if s % block_q or s % block_k:
        raise ValueError(
            f"seq length {s} must be a multiple of block sizes "
            f"({block_q}, {block_k})"
        )


def _gqa_layout(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, int, int]:
    """(h, kv_h, group): query head ``i`` reads K/V head ``i // group``."""
    h, kv_h = q.shape[2], k.shape[2]
    if kv_h < 1 or h % kv_h:
        raise ValueError(
            f"k/v heads {kv_h} must be a positive divisor of q heads {h}"
        )
    return h, kv_h, h // kv_h


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``(o, lse)`` with ``o`` in
    ``q``'s layout and type and ``lse`` as ``[b*h, s, 1]`` f32. Softmax in
    f32 with the same ``NEG_INF`` mask and the same masked-row convention
    (O = 0, LSE = ``LSE_MASKED`` where no key was seen)."""
    b, s, h, d = q.shape
    _, _, group = _gqa_layout(q, k)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / d ** 0.5)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    masked = l == 0
    l = torch.where(masked, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.permute(0, 2, 1, 3)
    lse = torch.where(masked, torch.full_like(l, LSE_MASKED), m + torch.log(l))
    return o.to(q.dtype), lse.reshape(b * h, s, 1)


_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load("flash_fwd")
        lib.flash_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 12
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_kernel_inputs(q, k, v) -> None:
    """Refuses what the kernels do not take, before anything is built."""
    s, d = q.shape[1], q.shape[3]
    _gqa_layout(q, k)
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, not {d}")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(
            f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not fit q "
            f"{tuple(q.shape)}"
        )
    if s % KERNEL_TILE:
        raise ValueError(
            f"flash kernel needs seq length a multiple of {KERNEL_TILE}, "
            f"not {s}"
        )
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")


def _launch(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, d = q.shape
    _check_kernel_inputs(q, k, v)
    kv_h = k.shape[2]
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s, 1), dtype=torch.float32, device=q.device)
    lib = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _DTYPE_CODES[q.dtype], b, s, h, kv_h, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            int(causal), 1.0 / d ** 0.5, stream,
        )
    if err != 0:
        raise RuntimeError(
            "flash_fwd launch failed: "
            + lib.flash_fwd_error_string(err).decode()
        )
    with _count_lock:
        flash_attention.launches += 1
    return o, lse


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` for ``[batch, seq, heads, head_dim]`` inputs; ``lse`` is
    ``[b*h, s, 1]`` f32 as in the JAX package's ``_forward``. A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes the plain version.
    The outputs carry no autograd graph: :func:`flash_attention` is the
    differentiable entry."""
    s = q.shape[1]
    _check_shapes(s, block_q or _default_block(s), block_k or _default_block(s))
    with torch.no_grad():
        if q.is_cuda:
            return _launch(q, k, v, causal)
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, causal=causal)
    raise ValueError(f"flash attention runs on CUDA or CPU, not {q.device}")


# ---------------------------------------------------------------- backward


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``Delta = rowsum(dO * O)`` in f32, in the ``[b*h, s, 1]`` layout of
    the LSE (the JAX package's ``_flash_bwd`` computes it the same way)."""
    b, s, h, _ = o.shape
    d = (do.float() * o.float()).sum(-1)  # [b, s, h]
    return d.permute(0, 2, 1).reshape(b * h, s, 1).contiguous()


def _reference_p_ds(q, k, v, do, lse, delta, causal: bool):
    """P and dS ``[b, h, s_q, s_k]`` in f32, recomputed from the LSE as the
    kernels do, plus the f32 K/V repeated to the query heads."""
    b, s, h, d = q.shape
    _, _, group = _gqa_layout(q, k)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / d ** 0.5)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    p = torch.exp(scores - lse.reshape(b, h, s, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    ds = p * (dp - delta.reshape(b, h, s, 1))
    return p, ds, kf


def flash_attention_dq_reference(q, k, v, do, lse, delta, *, causal=False):
    """K2's function in plain PyTorch: dQ in ``q``'s layout and type."""
    d = q.shape[-1]
    _, ds, kf = _reference_p_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * (1.0 / d ** 0.5)
    return dq.to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta, *, causal=False):
    """K3's function in plain PyTorch: ``(dk, dv)`` at the K/V head count,
    each query head's share summed over its group in f32."""
    b, s, h, d = q.shape
    _, kv_h, group = _gqa_layout(q, k)
    p, ds, _ = _reference_p_ds(q, k, v, do, lse, delta, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * (1.0 / d ** 0.5)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = dk.reshape(b, s, kv_h, group, d).sum(3)
    dv = dv.reshape(b, s, kv_h, group, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False):
    """The backward in plain PyTorch, step by step: ``(dq, dk, dv)`` from
    the forward's residuals and dO, with ``P = exp(S - LSE)``, the same
    ``NEG_INF`` mask and the same masked-row convention as the kernels."""
    delta = _delta(o, do)
    dq = flash_attention_dq_reference(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_attention_dkv_reference(
        q, k, v, do, lse, delta, causal=causal
    )
    return dq, dk, dv


_bwd_lib: Optional[ctypes.CDLL] = None


def _bwd_kernel() -> ctypes.CDLL:
    """The built backward library, with its C signatures declared."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("flash_bwd")
        lib.flash_bwd_dq.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 15
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_bwd_dkv.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 18
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_bwd_dq.restype = ctypes.c_int
        lib.flash_bwd_dkv.restype = ctypes.c_int
        lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _bwd_args(q, k, v, do, lse, delta, outs):
    """Checks the backward's inputs as :func:`_launch` checks the forward's;
    returns the unit-stride inputs, then the C interface's shape arguments
    and the strides of the inputs and ``outs``, in its order."""
    _check_kernel_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("dO must match q in shape, dtype and device")
    b, s, h, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (b * h, s, 1)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous f32 [b*h, s, 1]")
    q, k, v, do = (x if x.stride(-1) == 1 else x.contiguous()
                   for x in (q, k, v, do))
    strides = [st for x in (q, k, v, do, *outs) for st in x.stride()[:3]]
    head = [_DTYPE_CODES[q.dtype], b, s, h, k.shape[2], d]
    return (q, k, v, do), head, strides


def _bwd_call(fn_name: str, q, k, v, do, lse, delta, outs, causal: bool):
    (q, k, v, do), head, strides = _bwd_args(q, k, v, do, lse, delta, outs)
    lib = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            *head, *strides, int(causal), 1.0 / q.shape[-1] ** 0.5, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{fn_name} launch failed: "
            + lib.flash_bwd_error_string(err).decode()
        )


def flash_attention_dq(q, k, v, do, lse, delta, *, causal=False):
    """dQ (kernel K2) from the forward's LSE and ``Delta``: a CUDA tensor
    launches the kernel (or raises), a CPU tensor takes
    :func:`flash_attention_dq_reference`. ``flash_attention_dq.launches``
    counts the kernel's launches."""
    if q.device.type == "cpu":
        return flash_attention_dq_reference(
            q, k, v, do, lse, delta, causal=causal
        )
    if not q.is_cuda:
        raise ValueError(f"flash attention runs on CUDA or CPU, not {q.device}")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_call("flash_bwd_dq", q, k, v, do, lse, delta, (dq,), causal)
    with _count_lock:
        flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal=False):
    """``(dk, dv)`` (kernel K3) at the K/V head count, each summed over the
    query heads of its group inside the kernel: a CUDA tensor launches the
    kernel (or raises), a CPU tensor takes
    :func:`flash_attention_dkv_reference`. ``flash_attention_dkv.launches``
    counts the kernel's launches."""
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(
            q, k, v, do, lse, delta, causal=causal
        )
    if not q.is_cuda:
        raise ValueError(f"flash attention runs on CUDA or CPU, not {q.device}")
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_call("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), causal)
    with _count_lock:
        flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=False):
    """``(dq, dk, dv)`` from the forward's residuals and dO: ``Delta`` in
    plain PyTorch, then K2 and K3 (their plain versions on the CPU)."""
    delta = _delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2/K3 backward; saves ``(q, k, v, o, lse)`` as the JAX
    package's ``_flash_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Differentiable flash attention on ``[batch, seq, heads, head_dim]``
    tensors; K/V may carry fewer heads than Q (a positive divisor), and
    their grads come back at that head count. ``flash_attention.launches``
    counts the forward kernel's launches."""
    s = q.shape[1]
    _check_shapes(s, block_q or _default_block(s), block_k or _default_block(s))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal=causal)[0]


flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0

__all__ = [
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_dkv",
    "flash_attention_dkv_reference",
    "flash_attention_dq",
    "flash_attention_dq_reference",
    "flash_attention_fwd",
    "flash_attention_reference",
]
