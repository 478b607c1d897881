"""Flash attention: CUDA kernels for Hopper, their plain versions, and the
autograd Function that joins them.

The kernels replace the JAX package's three Pallas kernels in
``cron_operator_tpu/ops/flash_attention.py``: K1 ``_flash_kernel``, the
online-softmax forward, and the backward pair K2 ``_bwd_dq_kernel`` (dQ) and
K3 ``_bwd_dkv_kernel`` (dK, dV). The s x s score matrix never reaches HBM in
either direction. Each kernel comes in two designs, chosen by :func:`_design`
from the dtype and head dim before anything launches:

- ``sm90``, for bf16 at head dim 64 or 128: bf16 ``wgmma`` tiles fed by TMA
  through a ring of mbarrier-guarded stages (``csrc/flash_fwd_sm90.cu``,
  ``csrc/flash_bwd_dq_sm90.cu``, ``csrc/flash_bwd_dkv_sm90.cu``, helpers in
  ``csrc/sm90.cuh``). They round P (K1, K3) and dS (K2, K3) to bf16 before
  the product that takes it, as the TPU kernels do.
- ``fma``, for f32 and head dims 32 and 256: f32 FMAs on f32 shared-memory
  tiles (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), which keep P and dS
  in f32.

The source files' headers state each kernel's bound and design. Every
wrapper counts its launches (``.launches``) and its launches per design
(``.launches_by_design``); a launch recorded by a CUDA graph capture counts
once per replay of the graph (:func:`capture_launches`,
:func:`count_replays`). :func:`forward_tolerance`,
:func:`dq_tolerance` and :func:`dkv_tolerance` state how far a kernel may lie
from the plain version.

:func:`flash_attention_fwd`, :func:`flash_attention_dq` and
:func:`flash_attention_dkv` launch their kernel for a CUDA tensor and run the
same function in plain PyTorch for a CPU tensor; there is no fallback from
one to the other. The kernels read Q, K, V and dO through their strides (so
the ``qkv[:, :, i]`` slices of the fused projection go in without a copy;
only a last dimension that is not unit-stride is made contiguous; the sm90
design also copies an input whose base or strides TMA cannot take, see
:func:`_tma_ready`) and write fresh contiguous outputs.

:func:`flash_attention` is differentiable: its Function saves ``(q, k, v,
o, lse)`` from the forward, and its backward computes ``Delta = rowsum(dO *
O)`` in plain PyTorch (as the JAX package does in XLA) and then runs K2 and
K3. It composes with ``torch.utils.checkpoint(use_reentrant=False)``, which
reruns the forward. :func:`flash_attention_block` returns ``(o, lse)``,
both differentiable (K2 and K3 take ``Delta - dlse``): the block that the
sequence-parallel bodies (``parallel.ring``, ``parallel.ulysses``) run on
a rank's local blocks and merge by their LSEs.

The public entries keep the JAX package's shape rules: ``seq`` must divide
by the block edges, which default to :func:`_default_block` (multiples of
128), and K/V may carry a positive divisor of the query heads. The kernels
themselves take any ``seq`` >= 1: their tiles (64 rows; 32 for the fma
backward at head dim 256 and for the sm90 K3's query tiles at head dim 128;
the sm90 K1's blocks of 128 rows at head dim 128) round up, the last tile
of each side may be partial, and a key or query row past ``seq`` gets P = 0
by its index (in the sm90 designs, a second instantiation of each kernel
that a ``seq`` not a multiple of 64 launches). The LSE and ``Delta`` stay
contiguous f32 ``[b*h, s, 1]``; the kernels bound their reads of them by
``seq`` (the sources' headers). :func:`_flash_attention_any_length` is the
differentiable entry without the block rule, which
``ops.attention.multi_head_attention`` takes on the card (ViT-B/16's 197
tokens).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch

from cron_operator_tpu_torch.ops import _build

_MAX_DEFAULT_BLOCK = 512
NEG_INF = -1e30  # masked score: exp() underflows to exactly 0, no inf - inf
# LSE of a row that saw no key: exp(s - LSE_MASKED) is 0 for any finite s.
LSE_MASKED = 1e30
HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernel is compiled for
SM90_HEAD_DIMS = (64, 128)  # head dims of the bf16 wgmma/TMA design
DESIGNS = ("sm90", "fma")
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


def _refuse_placed(*tensors) -> None:
    """The kernels read local memory: a DTensor (a tensor over a device
    mesh) is refused, never gathered quietly. ``ops.attention`` hands the
    kernels each rank's local block through ``local_map``."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            "the flash kernels take local tensors, not DTensors: call "
            "ops.attention.multi_head_attention, which runs them on each "
            "rank's block"
        )


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


def _design(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel design K1, K2 and K3 take: ``"sm90"`` (bf16 wgmma tiles fed by
    TMA) for bf16 at head dim 64 or 128, ``"fma"`` for everything else the
    kernels accept. The route follows from dtype and head dim alone; no
    launch is ever retried on the other design."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    return "fma"


def _tma_ready(x: torch.Tensor) -> bool:
    """Whether TMA can read ``x`` in place: a 16-byte aligned base, a unit
    last stride, and batch, seq and head strides that are positive multiples
    of 16 bytes."""
    return (x.data_ptr() % 16 == 0 and x.stride(-1) == 1
            and all(st > 0 and st * x.element_size() % 16 == 0
                    for st in x.stride()[:-1]))


def _for_tma(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, or a fresh contiguous copy (an aligned allocation, even
    where ``x`` is contiguous already) where TMA cannot read it."""
    if _tma_ready(x):
        return x
    return x.clone(memory_format=torch.contiguous_format)


# The launches recorded by each CUDA graph capture in progress, by the
# handle of the stream it captures: a capture records a kernel without
# running it. Keyed by stream, not by thread: the backward of a captured
# step launches on the autograd engine's thread, on the capture's stream.
_capture_tallies: Dict[int, Dict[Tuple[object, ...], int]] = {}


def _count(fn, design: str, stream: int,
           epilogue: Optional[str] = None) -> None:
    """One launch of ``fn``'s kernel on ``stream`` (a CUDA stream handle),
    or one recorded by the capture of that stream; with ``epilogue``, also
    counted in ``fn.launches_by_epilogue``."""
    key = (fn, design) if epilogue is None else (fn, design, epilogue)
    with _count_lock:
        tally = _capture_tallies.get(stream)
        if tally is not None:
            tally[key] = tally.get(key, 0) + 1
            return
        _add_launches(key, 1)


def _add_launches(key: Tuple[object, ...], n: int) -> None:
    fn, design = key[:2]
    fn.launches += n
    fn.launches_by_design[design] += n
    if len(key) == 3:
        fn.launches_by_epilogue[key[2]] += n


@contextlib.contextmanager
def capture_launches(stream: int) -> Iterator[Dict[Tuple[object, ...], int]]:
    """Around a CUDA graph capture of ``stream`` (its handle,
    ``torch.cuda.Stream.cuda_stream``): the wrappers' launches on that
    stream go into the yielded tally (``(wrapper, design) -> launches``, or
    ``(wrapper, design, epilogue)`` for a wrapper that counts epilogues)
    instead of their counts, since the capture only records them. Each
    replay of the graph then adds them through :func:`count_replays`."""
    tally: Dict[Tuple[object, ...], int] = {}
    with _count_lock:
        _capture_tallies[stream] = tally
    try:
        yield tally
    finally:
        with _count_lock:
            del _capture_tallies[stream]


def count_replays(tally: Dict[Tuple[object, ...], int], replays: int) -> None:
    """Adds ``replays`` replays of a graph whose capture recorded ``tally``
    to the wrappers' ``launches``, ``launches_by_design`` and, where
    counted, ``launches_by_epilogue``."""
    with _count_lock:
        for key, n in tally.items():
            _add_launches(key, n * replays)


_lib: Optional[ctypes.CDLL] = None
_sm90_lib: Optional[ctypes.CDLL] = None


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
    if s < 1:
        raise ValueError(f"flash kernel needs seq length >= 1, not {s}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")


def _kernel_sm90() -> ctypes.CDLL:
    """The built sm90 forward library, with its C signature declared."""
    global _sm90_lib
    if _sm90_lib is None:
        lib = _build.load("flash_fwd_sm90")
        lib.flash_fwd_sm90.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_fwd_sm90.restype = ctypes.c_int
        lib.flash_fwd_sm90_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_sm90_error_string.restype = ctypes.c_char_p
        _sm90_lib = lib
    return _sm90_lib


def _raise_on(err: int, lib: ctypes.CDLL, fn: str,
              error_string: Optional[str] = None) -> None:
    """Raises unless the C function ``fn`` returned 0 (cudaSuccess), with
    the message of the library's ``<fn>_error_string`` (or the one named)."""
    if err != 0:
        name = error_string or f"{fn}_error_string"
        message = getattr(lib, name)(err).decode()
        raise RuntimeError(f"{fn} launch failed: {message}")


def _launch(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on the card, in the design of :func:`_design`."""
    b, s, h, d = q.shape
    _check_kernel_inputs(q, k, v)
    kv_h = k.shape[2]
    design = _design(q.dtype, d)
    if design == "sm90":
        q, k, v = (_for_tma(x) for x in (q, k, v))
    else:
        q, k, v = (x if x.stride(-1) == 1 else x.contiguous()
                   for x in (q, k, v))
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s, 1), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr())
    strides = [st for x in (q, k, v, o) for st in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if design == "sm90":
            lib, fn = _kernel_sm90(), "flash_fwd_sm90"
            err = lib.flash_fwd_sm90(*ptrs, b, s, h, kv_h, d, *strides,
                                     int(causal), 1.0 / d ** 0.5, stream)
        else:
            lib, fn = _kernel(), "flash_fwd"
            err = lib.flash_fwd(*ptrs, _DTYPE_CODES[q.dtype], b, s, h, kv_h,
                                d, *strides, int(causal), 1.0 / d ** 0.5,
                                stream)
    _raise_on(err, lib, fn)
    _count(flash_attention, design, stream)
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
    _refuse_placed(q, k, v)
    s = q.shape[1]
    _check_shapes(s, block_q or _default_block(s), block_k or _default_block(s))
    return _forward(q, k, v, causal)


def _forward(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 for a CUDA tensor, its plain version for a CPU tensor, at any
    ``seq``; no autograd graph."""
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


def _reference_scores(q, k, causal: bool) -> torch.Tensor:
    """Scaled f32 scores ``[b, h, s_q, s_k]`` with the ``NEG_INF`` mask."""
    b, s, h, d = q.shape
    _, _, group = _gqa_layout(q, k)
    kf = k.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / d ** 0.5)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    return scores


def _reference_p_ds(q, k, v, do, lse, delta, causal: bool):
    """P and dS ``[b, h, s_q, s_k]`` in f32, recomputed from the LSE as the
    kernels do, plus the f32 K/V repeated to the query heads."""
    b, s, h, d = q.shape
    _, _, group = _gqa_layout(q, k)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    p = torch.exp(_reference_scores(q, k, causal) - lse.reshape(b, h, s, 1))
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


# ------------------------------------------------------------- tolerances
#
# How far a kernel's result may lie from its plain version on the same
# inputs, by the design :func:`_design` picks for them. In f32 (fma) the two
# differ only in summation order: 1e-4 for O, 1e-4 max|ref| for dQ, dK and
# dV. The fma kernels in bf16 keep P and dS in f32 and round each result
# once, so they may differ by one bf16 ulp on top: 2^-7 |O_ref| + 1e-4 for
# O, 2^-7 |ref| + 1e-4 max|ref| for dQ, dK and dV. The sm90 kernels round P
# (and dS) to bf16 before the second product, as the TPU kernels do, where
# the plain versions keep f32: each rounded term is off by at most 2^-9 of
# itself, so the sum is off by at most 2^-9 of the sum of the terms'
# magnitudes. With the final rounding to bf16 (2^-8 of the result) and room
# for the f32 summation order, their bounds are, with P and dS the plain
# version's f32 values and l the row sum:
#   O:  2^-7 |O_ref| + 2^-8 (P |V|) / l + 1e-4 max|O_ref|
#   dQ: 2^-7 |dQ_ref| + 2^-8 scale sum_k |dS| |K| + 1e-4 max|dQ_ref|
#   dV: 2^-7 |dV_ref| + 2^-8 sum_q P |dO| + 1e-4 max|dV_ref|
#   dK: 2^-7 |dK_ref| + 2^-8 scale sum_q |dS| |Q| + 1e-4 max|dK_ref|


def forward_tolerance(q, k, v, o_ref, lse_ref, *, causal=False):
    """The bound on ``|O - O_ref|`` per element, for K1's ``o`` against
    :func:`flash_attention_reference`'s ``(o_ref, lse_ref)`` on the same
    inputs, for the design that K1 takes for them (see the note above)."""
    o_abs = o_ref.float().abs()
    if q.dtype != torch.bfloat16:
        return torch.full_like(o_abs, 1e-4)
    b, s, h, d = q.shape
    if _design(q.dtype, d) == "fma":
        return 2.0 ** -7 * o_abs + 1e-4
    _, _, group = _gqa_layout(q, k)
    p = torch.exp(_reference_scores(q, k, causal)
                  - lse_ref.reshape(b, h, s, 1))  # P / l
    v_abs = v.float().abs().repeat_interleave(group, dim=2)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_abs)
    return 2.0 ** -7 * o_abs + 2.0 ** -8 * pv + 1e-4 * o_abs.max()


def dq_tolerance(q, k, v, do, lse, delta, dq_ref, *, causal=False):
    """The bound on ``|dQ - dQ_ref|`` per element, for K2's ``dq`` against
    :func:`flash_attention_dq_reference`'s on the same inputs, for the
    design that K2 takes for them (see the note above)."""
    dq_abs = dq_ref.float().abs()
    floor = 1e-4 * dq_abs.max().item()
    if q.dtype != torch.bfloat16:
        return torch.full_like(dq_abs, floor)
    d = q.shape[-1]
    if _design(q.dtype, d) == "fma":
        return 2.0 ** -7 * dq_abs + floor
    _, ds, kf = _reference_p_ds(q, k, v, do, lse, delta, causal)
    ds_k = torch.einsum("bhqk,bkhd->bqhd", ds.abs(), kf.abs()) * (1.0 / d ** 0.5)
    return 2.0 ** -7 * dq_abs + 2.0 ** -8 * ds_k + floor


def dkv_tolerance(q, k, v, do, lse, delta, dk_ref, dv_ref, *, causal=False):
    """The bounds on ``|dK - dK_ref|`` and ``|dV - dV_ref|`` per element,
    for K3's ``(dk, dv)`` against :func:`flash_attention_dkv_reference`'s
    on the same inputs, for the design that K3 takes for them (see the note
    above)."""
    dk_abs, dv_abs = dk_ref.float().abs(), dv_ref.float().abs()
    dk_floor = 1e-4 * dk_abs.max().item()
    dv_floor = 1e-4 * dv_abs.max().item()
    if q.dtype != torch.bfloat16:
        return torch.full_like(dk_abs, dk_floor), torch.full_like(dv_abs,
                                                                  dv_floor)
    b, s, h, d = q.shape
    if _design(q.dtype, d) == "fma":
        return (2.0 ** -7 * dk_abs + dk_floor, 2.0 ** -7 * dv_abs + dv_floor)
    _, kv_h, group = _gqa_layout(q, k)
    p, ds, _ = _reference_p_ds(q, k, v, do, lse, delta, causal)
    p_do = torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs())
    ds_q = torch.einsum("bhqk,bqhd->bkhd", ds.abs(), q.float().abs())
    p_do = p_do.reshape(b, s, kv_h, group, d).sum(3)
    ds_q = ds_q.reshape(b, s, kv_h, group, d).sum(3) * (1.0 / d ** 0.5)
    return (2.0 ** -7 * dk_abs + 2.0 ** -8 * ds_q + dk_floor,
            2.0 ** -7 * dv_abs + 2.0 ** -8 * p_do + dv_floor)


def vanishing_grad_floor(q, k, v, do, lse, *, causal=False):
    """Floors for ``|dQ - dQ_ref|`` and ``|dK - dK_ref|`` where dQ and dK
    vanish in exact arithmetic: at ``seq`` 1 the one key takes all of each
    row's mass, so dS = P (dP - Delta) is rounding residue on both sides and
    the floors of :func:`dq_tolerance` and :func:`dkv_tolerance`, 1e-4
    max|ref|, scale with that residue instead of the terms. Each floor here
    is 1e-4 of the largest sum of the magnitudes of the gradient's terms:
    ``scale sum_k P (sum_d |dO| |V| + |Delta|) |K|`` for dQ and the same
    over the queries with ``|Q|`` for dK (summed over the GQA group).
    ``Delta``'s magnitude is bounded by ``sum_d |dO| |V|`` for a row with
    one key, so that sum stands for both."""
    b, s, h, d = q.shape
    _, kv_h, group = _gqa_layout(q, k)
    kf, vf = (x.float().abs().repeat_interleave(group, dim=2) for x in (k, v))
    p = torch.exp(_reference_scores(q, k, causal) - lse.reshape(b, h, s, 1))
    terms = 2 * p * torch.einsum("bqhd,bkhd->bhqk", do.float().abs(), vf)
    scale = 1.0 / d ** 0.5
    dq = torch.einsum("bhqk,bkhd->bqhd", terms, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", terms, q.float().abs()) * scale
    dk = dk.reshape(b, s, kv_h, group, d).sum(3)
    return 1e-4 * dq.max().item(), 1e-4 * dk.max().item()


_bwd_lib: Optional[ctypes.CDLL] = None
_bwd_sm90_libs: Dict[str, ctypes.CDLL] = {}
# pointer arguments of each sm90 backward kernel's C function
_SM90_BWD_POINTERS = {"dq": 7, "dkv": 8}


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


def _bwd_sm90_kernel(kernel: str) -> ctypes.CDLL:
    """The built sm90 library of backward kernel ``kernel`` (``"dq"``: K2,
    ``csrc/flash_bwd_dq_sm90.cu``; ``"dkv"``: K3), with the C signature of
    its function declared: the pointers, ``b, s, h, kv_h, d``, three strides
    for each pointer but LSE and Delta, ``causal``, ``scale``, the stream."""
    lib = _bwd_sm90_libs.get(kernel)
    if lib is None:
        name, n_ptrs = f"flash_bwd_{kernel}_sm90", _SM90_BWD_POINTERS[kernel]
        lib = _build.load(name)
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
            + [ctypes.c_int64] * (3 * (n_ptrs - 2))
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        _bwd_sm90_libs[kernel] = lib
    return lib


def _bwd_args(q, k, v, do, lse, delta, outs, design: str = "fma"):
    """Checks the backward's inputs as :func:`_launch` checks the forward's;
    returns the inputs as the design reads them (unit-stride; for sm90 also
    TMA-ready), then the C interface's
    shape arguments and the strides of the inputs and ``outs``, in its
    order."""
    _check_kernel_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("dO must match q in shape, dtype and device")
    b, s, h, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (b * h, s, 1)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous f32 [b*h, s, 1]")
    head = [b, s, h, k.shape[2], d]
    if design == "sm90":
        q, k, v, do = (_for_tma(x) for x in (q, k, v, do))
    else:
        q, k, v, do = (x if x.stride(-1) == 1 else x.contiguous()
                       for x in (q, k, v, do))
        head = [_DTYPE_CODES[q.dtype], *head]
    strides = [st for x in (q, k, v, do, *outs) for st in x.stride()[:3]]
    return (q, k, v, do, lse, delta), head, strides


def _bwd_call(kernel: str, q, k, v, do, lse, delta, outs, causal: bool,
              design: str) -> int:
    """Checks the inputs, then builds (at first use) and launches backward
    kernel ``kernel`` (``"dq"``: K2, ``"dkv"``: K3) of the design's
    library; returns the handle of the stream it launched on."""
    inputs, head, strides = _bwd_args(q, k, v, do, lse, delta, outs, design)
    if design == "sm90":
        fn_name = f"flash_bwd_{kernel}_sm90"
        lib, error_string = _bwd_sm90_kernel(kernel), None
    else:
        fn_name = f"flash_bwd_{kernel}"
        lib, error_string = _bwd_kernel(), "flash_bwd_error_string"
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(
            *(x.data_ptr() for x in inputs), *(o.data_ptr() for o in outs),
            *head, *strides, int(causal), 1.0 / q.shape[-1] ** 0.5, stream,
        )
    _raise_on(err, lib, fn_name, error_string)
    return stream


def _launch_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """K2 on the card, in the design of :func:`_design`."""
    design = _design(q.dtype, q.shape[-1])
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = _bwd_call("dq", q, k, v, do, lse, delta, (dq,), causal, design)
    _count(flash_attention_dq, design, stream)
    return dq


def _launch_dkv(q, k, v, do, lse, delta,
                causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on the card, in the design of :func:`_design`."""
    design = _design(q.dtype, q.shape[-1])
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    stream = _bwd_call("dkv", q, k, v, do, lse, delta, (dk, dv), causal,
                       design)
    _count(flash_attention_dkv, design, stream)
    return dk, dv


def flash_attention_dq(q, k, v, do, lse, delta, *, causal=False):
    """dQ (kernel K2) from the forward's LSE and ``Delta``: a CUDA tensor
    launches the kernel of its :func:`_design` (or raises), a CPU tensor
    takes :func:`flash_attention_dq_reference`.
    ``flash_attention_dq.launches`` counts the kernel's launches,
    ``.launches_by_design`` per design."""
    _refuse_placed(q, k, v, do)
    if q.device.type == "cpu":
        return flash_attention_dq_reference(
            q, k, v, do, lse, delta, causal=causal
        )
    if not q.is_cuda:
        raise ValueError(f"flash attention runs on CUDA or CPU, not {q.device}")
    return _launch_dq(q, k, v, do, lse, delta, causal)


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal=False):
    """``(dk, dv)`` (kernel K3) at the K/V head count, each summed over the
    query heads of its group inside the kernel: a CUDA tensor launches the
    kernel of its :func:`_design` (or raises), a CPU tensor takes
    :func:`flash_attention_dkv_reference`. ``flash_attention_dkv.launches``
    counts the kernel's launches, ``.launches_by_design`` per design."""
    _refuse_placed(q, k, v, do)
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(
            q, k, v, do, lse, delta, causal=causal
        )
    if not q.is_cuda:
        raise ValueError(f"flash attention runs on CUDA or CPU, not {q.device}")
    return _launch_dkv(q, k, v, do, lse, delta, causal)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=False):
    """``(dq, dk, dv)`` from the forward's residuals and dO: ``Delta`` in
    plain PyTorch, then K2 and K3 (their plain versions on the CPU)."""
    delta = _delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv


class _FlashBlock(torch.autograd.Function):
    """K1 forward with both outputs, ``(o, lse)``; K2/K3 backward from the
    gradients of both. Saves ``(q, k, v, o, lse)`` as the JAX package's
    ``_flash_fwd`` does. ``lse = log sum_k exp(s_k)`` has ``d lse / d s =
    P``, so the score gradient is ``dS = P (dP - Delta + dlse)``: K2 and K3
    take ``Delta - dlse`` in Delta's place, which is exact (Delta alone
    where the LSE reached no loss)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.set_materialize_grads(False)
        o, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None and dlse is None:
            return None, None, None, None
        if do is None:
            do = torch.zeros_like(o)
        delta = _delta(o, do)
        if dlse is not None:
            delta = (delta - dlse.reshape(delta.shape)).contiguous()
        dq = flash_attention_dq(q, k, v, do, lse, delta, causal=ctx.causal)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta,
                                     causal=ctx.causal)
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
    counts the forward kernel's launches. A DTensor raises ``TypeError``."""
    _refuse_placed(q, k, v)
    s = q.shape[1]
    _check_shapes(s, block_q or _default_block(s), block_k or _default_block(s))
    return _flash_attention_any_length(q, k, v, causal=causal)


def _flash_attention_any_length(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *,
                                causal: bool = False) -> torch.Tensor:
    """:func:`flash_attention` without the JAX package's block rule: any
    ``seq`` >= 1, which the kernels take (a partial last tile on each side).
    Every other refusal stays. ``ops.attention.multi_head_attention``'s
    ``auto`` takes it for a CUDA tensor; a CPU tensor runs the plain
    versions, as in :func:`flash_attention`."""
    _refuse_placed(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashBlock.apply(q, k, v, causal)[0]
    return _forward(q, k, v, causal)[0]


def flash_attention_block(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of one block of attention, differentiable in both: ``o``
    ``[b, s, h, d]`` in ``q``'s type, ``lse`` ``[b*h, s, 1]`` f32 (the
    kernels' layout), for q, k and v ``[b, s, h, d]`` at any ``s`` >= 1.
    The sequence-parallel bodies (``parallel.ring``, ``parallel.ulysses``)
    run it on a rank's local blocks and merge the blocks' outputs by their
    LSEs. A CUDA tensor launches K1 forward and K2 and K3 backward (or
    raises), a CPU tensor takes :func:`flash_attention_reference` and the
    plain backward; a DTensor raises ``TypeError``. A row that sees no key
    (none here: q and k share their rows, so a causal block keeps the
    diagonal) gives ``o`` 0 and ``lse`` ``LSE_MASKED``."""
    _refuse_placed(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashBlock.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


for _fn in (flash_attention, flash_attention_dq, flash_attention_dkv):
    _fn.launches = 0
    _fn.launches_by_design = dict.fromkeys(DESIGNS, 0)
del _fn

__all__ = [
    "capture_launches",
    "count_replays",
    "dkv_tolerance",
    "dq_tolerance",
    "flash_attention",
    "flash_attention_block",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_dkv",
    "flash_attention_dkv_reference",
    "flash_attention_dq",
    "flash_attention_dq_reference",
    "flash_attention_fwd",
    "flash_attention_reference",
    "forward_tolerance",
    "vanishing_grad_floor",
]
