"""Flash attention forward: a CUDA kernel for Hopper and its plain version.

The kernel (``csrc/flash_fwd.cu``) replaces K1 of the JAX package,
``cron_operator_tpu/ops/flash_attention.py`` ``_flash_kernel``: online-
softmax attention whose s x s score matrix never reaches HBM. It is the
serving path's only kernel (the prefill of ``workloads/generate.py``, one
launch per layer). The source file's header states its bound and design.

:func:`flash_attention_fwd` launches the kernel for a CUDA tensor and runs
:func:`flash_attention_reference`, the same function in plain PyTorch, for a
CPU tensor; there is no fallback from one to the other. The kernel reads
Q, K and V through their strides (so the ``qkv[:, :, i]`` slices of the
fused projection go in without a copy; only a last dimension that is not
unit-stride is made contiguous) and writes a fresh contiguous O.

The shape rules are the JAX package's: ``seq`` must divide by the block
edges, which default to :func:`_default_block` (multiples of 128), and K/V
may carry a positive divisor of the query heads. The kernel's own tile is
64 rows, which divides every accepted ``seq``. Only the forward exists: the
backward kernels K2/K3 come with the training slice, so a call that would
need a gradient raises.
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


def _launch(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, d = q.shape
    _, kv_h, _ = _gqa_layout(q, k)
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
    launches the kernel (or raises); a CPU tensor takes the plain version."""
    s = q.shape[1]
    _check_shapes(s, block_q or _default_block(s), block_k or _default_block(s))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward yet: kernels K2/K3 come with "
            "the training slice (ROADMAP.md queue 2)"
        )
    if q.is_cuda:
        return _launch(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    raise ValueError(f"flash attention runs on CUDA or CPU, not {q.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention on ``[batch, seq, heads, head_dim]`` tensors; K/V may
    carry fewer heads than Q (a positive divisor). ``flash_attention.launches``
    counts the kernel's launches."""
    return flash_attention_fwd(
        q, k, v, causal=causal, block_q=block_q, block_k=block_k
    )[0]


flash_attention.launches = 0

__all__ = [
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_reference",
]
