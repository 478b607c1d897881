"""Attention dispatch, as in ``cron_operator_tpu/ops/attention.py``.

- ``"flash"`` — the hand-written Hopper kernels (:mod:`ops.flash_attention`):
  K1 forward, K2/K3 backward, so gradients pass through. As in the JAX
  package, ``seq`` must divide by the block edges (multiples of 128). The
  automatic pick for a CUDA tensor at a kernel head dim takes the same
  kernels at any ``seq`` (ViT-B/16's 197 tokens).
- ``"xla"`` — plain PyTorch attention with f32 products
  (:func:`parallel.ring._single_device_attention`); the name is kept from the
  JAX package so configs carry over. The CPU path.
- ``"ring"`` — sequence-parallel ring attention over the mesh's ``seq``
  axis (:mod:`parallel.ring`); the automatic pick when the mesh has
  ``seq > 1``. Any head count. Each K/V block runs through K1-K3
  (``flash_attention_block``) on the card and their plain versions on the
  CPU; the blocks merge by their LSEs.
- ``"ulysses"`` — the all-to-all head-scatter variant
  (:mod:`parallel.ulysses`); the head count must divide the ``seq`` axis.
  Between the all-to-alls, K1-K3 over the whole sequence on the local
  heads (their plain versions on the CPU).

One-token decode against a KV cache has its own entry,
:func:`decode_attention`: the hand kernel ``csrc/decode_attn.cu`` on the
card, :func:`decode_attention_reference` on the CPU. It has no counterpart
file in the JAX package, whose decode attention lives inside
``cron_operator_tpu/models/gpt.py`` (``DecoderLayer._decode_attention``),
where XLA compiles it.

Models call :func:`multi_head_attention` and stay strategy-agnostic. On the
``meta`` device (a FLOP count, :func:`count_attention_flops`) attention
computes nothing and is counted by formula, whatever ``impl`` says. On the
plain meshed path (``parallel.mesh.data_parallel``) q, k and v are this
rank's block of positions as plain tensors, and the layer passes the mesh
(its ``seq_mesh``) when ``seq > 1``: :func:`_seq_attention` runs the
sequence-parallel body on the local blocks (``auto`` and ``ring`` the ring,
``ulysses`` Ulysses; ``flash`` and ``xla`` gather the sequence). Over a
DTensor mesh (``pipe``; the tests' placed cases) q, k and v are DTensors
that carry their mesh: each rank runs the dispatch on its local block
(:func:`_sharded_attention`, the JAX ``_sharded_flash``), or under ``seq >
1`` (or an explicit ``ring``/``ulysses``) the sequence-parallel body on its
block of the sequence. A plain tensor without a mesh gives plain attention
for ``ring`` and ``ulysses``: what the JAX dispatch gives under a mesh
without a ``seq`` axis, which is how every JAX job calls it on one device
(JAX raises only when no mesh is passed at all).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Iterator, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from cron_operator_tpu_torch.ops import _build
from cron_operator_tpu_torch.ops.flash_attention import (
    _DTYPE_CODES,
    HEAD_DIMS,
    _count,
    _flash_attention_any_length,
    _raise_on,
    flash_attention,
)
from cron_operator_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    SEQ_AXIS,
    TENSOR_AXIS,
    axis_sizes,
    local_positions,
)
from cron_operator_tpu_torch.parallel.moe import gather_rows
from cron_operator_tpu_torch.parallel.ring import (
    _single_device_attention,
    ring_attention,
    ring_attention_local,
)
from cron_operator_tpu_torch.parallel.ulysses import (
    check_heads,
    ulysses_attention,
    ulysses_attention_local,
)


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """Naive full attention on ``[b, s, h, d]`` — the numeric ground truth."""
    return _single_device_attention(q, k, v, causal=causal)


class AttentionFlops:
    """A running count of attention's model FLOPs."""

    def __init__(self) -> None:
        self.flops = 0


_TALLY: contextvars.ContextVar[Optional[AttentionFlops]] = (
    contextvars.ContextVar("attention_flops", default=None))


@contextlib.contextmanager
def count_attention_flops() -> Iterator[AttentionFlops]:
    """Counts the model FLOPs of the attention that runs on ``meta`` tensors
    in this context: 4 d per (query, key) pair that the mask keeps and per
    query head in the forward (Q K^T and P V), twice that in the backward,
    the convention of ``chip_smoke.py``'s MFU. The kernels' own work is
    larger: K2 and K3 recompute Q K^T (6 d and 8 d a pair, not 8 d)."""
    tally = AttentionFlops()
    token = _TALLY.set(tally)
    try:
        yield tally
    finally:
        _TALLY.reset(token)


class _MetaAttention(torch.autograd.Function):
    """Attention on ``meta`` tensors: the output's shape, no values, and the
    FLOPs into the tally of :func:`count_attention_flops` (taken at the
    forward, since the backward may run on another thread)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        b, s, h, d = q.shape
        pairs = s * (s + 1) // 2 if causal else s * k.shape[1]
        ctx.flops = 4 * d * b * h * pairs
        ctx.tally = _TALLY.get()
        ctx.inputs = [(t.shape, t.dtype) for t in (q, k, v)]
        if ctx.tally is not None:
            ctx.tally.flops += ctx.flops
        return q.new_empty(b, s, h, v.shape[-1])

    @staticmethod
    def backward(ctx, do):
        if ctx.tally is not None:
            ctx.tally.flops += 2 * ctx.flops
        return (*(torch.empty(shape, dtype=dtype, device="meta")
                  for shape, dtype in ctx.inputs), None)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    impl: str = "auto",
    mesh=None,
) -> torch.Tensor:
    """Dispatching attention on ``[batch, seq, heads, head_dim]``.

    ``impl``: ``"auto" | "flash" | "xla" | "ring" | "ulysses"``.
    Grouped-query K/V (fewer heads, a divisor) go to the flash kernel as
    they are; the other impls repeat them here, the sequence-parallel ones
    before the sequence is split. ``mesh`` (plain tensors only): q, k and v
    are this rank's block of a sequence split over the mesh's ``seq`` axis
    (:func:`_seq_attention`); without a ``seq`` axis above 1 it changes
    nothing.
    """
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal=causal, impl=impl)
    if q.is_meta:
        return _MetaAttention.apply(q, k, v, causal)
    if mesh is not None and axis_sizes(mesh).get(SEQ_AXIS, 1) > 1:
        return _seq_attention(q, k, v, mesh, causal=causal, impl=impl)
    if impl == "auto":
        # The kernels on the card at any sequence length: no fallback to the
        # plain body for a CUDA tensor (a shape the kernels refuse raises).
        # The JAX package waits for seq >= 1024 and a multiple of its blocks
        # before it picks its kernel; that crossover was measured on a TPU
        # v5e and does not carry over (PERF.md keeps the kernels' and the
        # plain versions' times on the H100, ViT's 197 tokens among them).
        if q.is_cuda and q.shape[-1] in HEAD_DIMS:
            return _flash_attention_any_length(q, k, v, causal=causal)
        impl = "xla"

    if impl != "flash":
        k, v = _full_heads(q, k, v)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal)
    if impl in ("xla", "ring", "ulysses"):
        return _single_device_attention(q, k, v, causal=causal)
    raise ValueError(f"unknown attention impl {impl!r}")


def _seq_attention(q, k, v, mesh, *, causal: bool, impl: str):
    """Attention of this rank's block ``[b, t, h, d]`` of a sequence split
    over ``seq`` of ``mesh``, plain tensors (the plain meshed path), on
    full-head K/V: ``auto`` and ``ring`` run
    :func:`parallel.ring.ring_attention_local` and ``ulysses``
    :func:`parallel.ulysses.ulysses_attention_local` (K1-K3 inside on the
    card), as the JAX dispatch picks ring for ``auto`` under a ``seq``
    axis. ``flash`` and ``xla`` attend over the whole sequence, as under
    GSPMD: the blocks are gathered over ``seq`` (their gradients summed
    back), the dispatch runs on the whole sequence and each rank keeps its
    rows of the output."""
    if impl not in ("auto", "flash", "xla", "ring", "ulysses"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl in ("flash", "xla"):
        whole = [_gather_seq(t, mesh) for t in (q, k, v)]
        out = multi_head_attention(*whole, causal=causal, impl=impl)
        return out[:, local_positions(mesh, q.shape[1])]
    k, v = _full_heads(q, k, v)
    if impl == "ulysses":
        check_heads(q.shape[2], axis_sizes(mesh)[SEQ_AXIS])
        return ulysses_attention_local(q, k, v, mesh=mesh, causal=causal)
    return ring_attention_local(q, k, v, mesh=mesh, causal=causal)


def _gather_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """``[b, t, ...]`` blocks of every coordinate of ``mesh``'s ``seq``
    axis, in coordinate order: ``[b, seq * t, ...]``, differentiable."""
    rows = gather_rows(x.transpose(0, 1), mesh.get_group(SEQ_AXIS))
    return rows.transpose(0, 1)


def _full_heads(q, k, v):
    """Grouped-query ``k``/``v`` broadcast to ``q``'s head count (each K/V
    head serves ``h / kv_h`` consecutive query heads), as the JAX dispatch's
    ``jnp.repeat``; by ``expand``, which a DTensor split over the batch or
    the sequence takes too."""
    h, kv_h = q.shape[2], k.shape[2]
    if kv_h == h:
        return k, v
    if kv_h < 1 or h % kv_h:
        raise ValueError(
            f"k/v heads {kv_h} must be a positive divisor of q heads {h}"
        )
    b, s, _, d = k.shape

    def repeat(t):
        return t[:, :, :, None, :].expand(b, s, kv_h, h // kv_h, d).reshape(
            b, s, h, d)
    return repeat(k), repeat(v)


def attention_placements(q, k, mesh) -> tuple:
    """Placements of ``[b, s, h, d]`` attention operands on ``mesh``, the
    JAX ``_sharded_flash`` spec: the batch over the batch axes when it
    divides their product, the heads over ``tensor`` when both the q and
    the kv head counts divide it, everything else replicated."""
    sizes = axis_sizes(mesh)
    n_batch = 1
    for name in BATCH_AXES:
        n_batch *= sizes.get(name, 1)
    split_batch = q.shape[0] % n_batch == 0
    t = sizes.get(TENSOR_AXIS, 1)
    split_heads = t > 1 and q.shape[2] % t == 0 and k.shape[2] % t == 0
    out = []
    for name in sizes:
        if name in BATCH_AXES and split_batch:
            out.append(Shard(0))
        elif name == TENSOR_AXIS and split_heads:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out)


def _sharded_attention(q, k, v, *, causal: bool, impl: str):
    """Attention on DTensors. ``auto`` under ``seq > 1`` is ``ring``, as the
    JAX dispatch picks it for a mesh with a ``seq`` axis; ``ring`` and
    ``ulysses`` take full-head K/V and run
    :func:`parallel.ring.ring_attention` or
    :func:`parallel.ulysses.ulysses_attention` over the mesh. Otherwise, as
    the JAX ``_sharded_flash``: q, k and v are laid out by
    :func:`attention_placements` and each rank runs
    :func:`multi_head_attention` (K1-K3 on the card) on its local ``[b/dp,
    s, h/tp, d]`` block, which needs no collective; the output keeps that
    layout. The kernel wrappers only ever see local tensors."""
    mesh = q.device_mesh
    if impl == "auto" and axis_sizes(mesh).get(SEQ_AXIS, 1) > 1:
        impl = "ring"
    if impl in ("ring", "ulysses"):
        k, v = _full_heads(q, k, v)
        fn = ring_attention if impl == "ring" else ulysses_attention
        return fn(q, k, v, mesh, causal=causal)
    spec = list(attention_placements(q, k, mesh))  # a list: ONE output
    fn = local_map(
        lambda q, k, v: multi_head_attention(q, k, v, causal=causal,
                                             impl=impl),
        out_placements=spec, in_placements=(spec, spec, spec),
        redistribute_inputs=True, device_mesh=mesh,
    )
    return fn(q, k, v)


# ------------------------------------------------------------------ decode

DECODE_MASK = -1e30  # decode's score for unwritten cache positions
DECODE_HEAD_DIMS = (32, 64, 128, 256)  # head dims decode_attn is built for
DECODE_MAX_GROUP = 32  # query heads per K/V head the kernel takes
DECODE_CHUNK = 64  # cache positions per block of "fma": CHUNK in the source
# The "cluster" design (csrc/decode_attn.cu): CLUSTER blocks of a (b, kv
# head), TMA boxes of BOX cache rows dealt round them, 128 threads (4
# warps) a block, HEAD_TILE heads accumulated at once, and the dynamic
# shared memory a block may take on an H100. Clusters of 4 keep GPT-2
# small's 96 (b, kv head) pairs resident at once, where clusters of 8 need
# a second wave (hack/torch_cluster_sweep.py; PERF.md section 6).
DECODE_CLUSTER = 4
DECODE_CLUSTERS = (2, 4, 8, 16)  # the sizes the kernel takes
DECODE_BOX = 16
DECODE_WARPS = 4
DECODE_HEAD_TILE = 4
SMEM_LIMIT = 232448
DECODE_DESIGNS = ("cluster", "fma")


def decode_attention_reference(q: torch.Tensor, cache_k: torch.Tensor,
                               cache_v: torch.Tensor,
                               pos: torch.Tensor) -> torch.Tensor:
    """One-token attention of ``q [b, 1, h, d]`` against the caches ``[b,
    max_len, kv_h, d]``, written up to ``pos`` (a 1-element int64 tensor),
    in plain PyTorch: the JAX decode's arithmetic
    (``cron_operator_tpu/models/gpt.py:223-243``). The grouped einsum
    serves ``h // kv_h`` query heads per K/V head with f32 products, the
    positions past ``pos`` are masked (not sliced) with ``DECODE_MASK``, the
    softmax runs in f32 and its probabilities drop to ``q``'s dtype before
    the PV product, which accumulates in f32. Returns ``[b, 1, h, d]`` in
    ``q``'s dtype."""
    b, _, h, d = q.shape
    probs = _decode_probs(q, cache_k, pos).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs.float(), cache_v.float())
    return out.to(q.dtype).reshape(b, 1, h, d)


def _decode_probs(q, cache_k, pos) -> torch.Tensor:
    """The decode's f32 softmax ``[b, kv_h, h // kv_h, max_len]``: the
    grouped scores with f32 products, scaled, the unwritten positions
    masked with ``DECODE_MASK``."""
    b, _, h, d = q.shape
    kv_h = cache_k.shape[2]
    qg = q.reshape(b, kv_h, h // kv_h, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float())
    scores = scores * (1.0 / d ** 0.5)
    written = torch.arange(cache_k.shape[1], device=q.device) <= pos
    scores = scores.masked_fill(~written, DECODE_MASK)
    return torch.softmax(scores, dim=-1)


def decode_tolerance(q, cache_k, cache_v, pos, out_ref) -> torch.Tensor:
    """The bound on ``|out - out_ref|`` per element, for the kernel's
    ``out`` against :func:`decode_attention_reference`'s on the same
    inputs. The two sum in other orders, so their f32 scores, row sums and
    P V sums differ in the last bits. In bf16 that can move a probability
    across a rounding boundary, by one bf16 ulp (at most 2^-7 of it), and
    the output's own rounding by one ulp (2^-7 of it): 2^-7 |out_ref| +
    2^-7 (P |V|) + 1e-4 max|out_ref|, with P the reference's f32
    probabilities. In f32 nothing is rounded to a narrower type, and the
    orders alone give 1e-4 (P |V|) + 1e-5 max|out_ref|."""
    b, _, h, d = q.shape
    written = torch.arange(cache_k.shape[1], device=q.device) <= pos
    v_abs = cache_v.float().abs().masked_fill(~written[None, :, None, None], 0)
    pv = torch.einsum("bkgs,bskd->bkgd", _decode_probs(q, cache_k, pos),
                      v_abs).reshape(b, 1, h, d)
    ref = out_ref.float().abs()
    if q.dtype == torch.bfloat16:
        return 2.0 ** -7 * (ref + pv) + 1e-4 * ref.max()
    return 1e-4 * pv + 1e-5 * ref.max()


_decode_lib: Optional[ctypes.CDLL] = None


def decode_plan(max_len: int, group: int, head_dim: int,
                dtype: torch.dtype, cluster: int = DECODE_CLUSTER) -> dict:
    """The decode kernel's design for a cache of ``max_len`` positions,
    ``group`` query heads per K/V head, ``head_dim`` and ``dtype``: the
    ``"cluster"`` design where a block's shared memory (``ClusterLayout``
    in ``csrc/decode_attn.cu``, mirrored here) fits ``SMEM_LIMIT``, else
    ``"fma"``, the three-pass design, which holds no tile. Keys ``design``,
    ``cluster`` (blocks of a (b, kv head); one of ``DECODE_CLUSTERS``),
    ``slots`` (the boxes of K and of V a block holds), ``span`` (the cache
    rows a block may hold) and ``smem`` (bytes a block)."""
    if cluster not in DECODE_CLUSTERS:
        raise ValueError(f"decode clusters are {DECODE_CLUSTERS} blocks, "
                         f"not {cluster}")
    esize = dtype.itemsize
    boxes = -(-max_len // DECODE_BOX)
    slots = -(-boxes // cluster)
    smem = (slots * DECODE_BOX * head_dim * esize  # K's boxes, then V's
            + group * slots * DECODE_BOX * 4
            + 2 * group * head_dim * 4
            + DECODE_WARPS * min(group, DECODE_HEAD_TILE) * head_dim * 4
            + -(-3 * group * 4 // 16) * 16 + 16)
    design = "cluster" if smem <= SMEM_LIMIT else "fma"
    return {"design": design, "cluster": cluster, "slots": slots,
            "span": slots * DECODE_BOX, "smem": smem}


def _decode_kernel() -> ctypes.CDLL:
    """The built decode library, with its C signature declared."""
    global _decode_lib
    if _decode_lib is None:
        lib = _build.load("decode_attn")
        lib.decode_attn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 10
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.decode_attn.restype = ctypes.c_int
        lib.decode_attn_cluster.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_int64] * 10
            + [ctypes.c_float, ctypes.c_void_p])
        lib.decode_attn_cluster.restype = ctypes.c_int
        lib.decode_attn_cluster_occupancy.argtypes = [ctypes.c_int] * 7
        lib.decode_attn_cluster_occupancy.restype = ctypes.c_int
        lib.decode_attn_error_string.argtypes = [ctypes.c_int]
        lib.decode_attn_error_string.restype = ctypes.c_char_p
        _decode_lib = lib
    return _decode_lib


def _check_decode_inputs(q, cache_k, cache_v, pos) -> None:
    """Refuses what the decode kernel does not take, before anything is
    built: it reads the caches in place with 16-byte loads, so they are
    not copied to fit."""
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError(f"decode attention takes one query position, not {one}")
    if cache_k.shape != cache_v.shape or cache_k.shape[0] != b or (
            cache_k.shape[3] != d):
        raise ValueError(
            f"caches {tuple(cache_k.shape)}/{tuple(cache_v.shape)} do not fit "
            f"q {tuple(q.shape)}")
    kv_h = cache_k.shape[2]
    if kv_h < 1 or h % kv_h or h // kv_h > DECODE_MAX_GROUP:
        raise ValueError(
            f"k/v heads {kv_h} must divide q heads {h} in groups of at most "
            f"{DECODE_MAX_GROUP}")
    if d not in DECODE_HEAD_DIMS:
        raise ValueError(
            f"decode kernel takes head_dim in {DECODE_HEAD_DIMS}, not {d}")
    if q.dtype not in _DTYPE_CODES or cache_k.dtype != q.dtype or (
            cache_v.dtype != q.dtype):
        raise ValueError("q and the caches must share one dtype, float32 or "
                         f"bfloat16, not {q.dtype}/{cache_k.dtype}/"
                         f"{cache_v.dtype}")
    if pos.dtype != torch.int64 or pos.numel() != 1:
        raise ValueError("pos must be a 1-element int64 tensor")
    if any(t.device != q.device for t in (cache_k, cache_v, pos)):
        raise ValueError("q, the caches and pos must lie on one device")
    vec = 16 // q.element_size()
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(st % vec for st in t.stride()[:3])):
            raise ValueError(
                f"{name} must have unit stride in head_dim and 16-byte "
                "aligned rows")


def _launch_decode(q, cache_k, cache_v, pos, design: Optional[str] = None,
                   cluster: int = DECODE_CLUSTER) -> torch.Tensor:
    """The decode kernel on the card, in :func:`decode_plan`'s design
    (``design`` names one, and ``cluster`` another cluster size, to time
    them beside it)."""
    _check_decode_inputs(q, cache_k, cache_v, pos)
    b, _, h, d = q.shape
    max_len, kv_h = cache_k.shape[1], cache_k.shape[2]
    group = h // kv_h
    plan = decode_plan(max_len, group, d, q.dtype, cluster)
    design = design or plan["design"]
    if design not in DECODE_DESIGNS:
        raise ValueError(f"decode design {design!r} is not one of "
                         f"{DECODE_DESIGNS}")
    if q.stride(3) != 1:
        q = q.contiguous()
    dev = q.device
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=dev)
    strides = (q.stride(0), q.stride(2), *cache_k.stride()[:3],
               *cache_v.stride()[:3], out.stride(0), out.stride(2))
    lib = _decode_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design == "cluster":
            err = lib.decode_attn_cluster(
                q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                pos.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype], b,
                max_len, h, kv_h, d, plan["cluster"], plan["slots"], *strides,
                1.0 / d ** 0.5, stream)
        else:
            chunks = -(-max_len // DECODE_CHUNK)
            scores = torch.empty((b, kv_h, group, max_len),
                                 dtype=torch.float32, device=dev)
            partial = torch.empty((b, kv_h, chunks, group, d),
                                  dtype=torch.float32, device=dev)
            err = lib.decode_attn(
                q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                pos.data_ptr(), out.data_ptr(), scores.data_ptr(),
                partial.data_ptr(), _DTYPE_CODES[q.dtype], b, max_len, h,
                kv_h, d, *strides, 1.0 / d ** 0.5, stream)
    _raise_on(err, lib, "decode_attn_cluster" if design == "cluster"
              else "decode_attn", "decode_attn_error_string")
    _count(decode_attention, design, stream)
    return out


def decode_occupancy(q, cache_k, cluster: int = DECODE_CLUSTER) -> int:
    """Clusters of the ``"cluster"`` design (of ``cluster`` blocks) that the
    card holds at once at this shape (``cudaOccupancyMaxActiveClusters``;
    -1 where it cannot run). Builds the kernel."""
    b, _, h, d = q.shape
    kv_h, max_len = cache_k.shape[2], cache_k.shape[1]
    plan = decode_plan(max_len, h // kv_h, d, q.dtype, cluster)
    with torch.cuda.device(q.device):
        return _decode_kernel().decode_attn_cluster_occupancy(
            _DTYPE_CODES[q.dtype], b, kv_h, h // kv_h, d, plan["cluster"],
            plan["slots"])


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One-token attention of ``q [b, 1, h, d]`` against the KV caches
    ``[b, max_len, kv_h, d]`` written up to position ``pos`` (a 1-element
    int64 tensor on their device, read there: a captured decode step
    replays at every position without the host). Returns ``[b, 1, h, d]``
    in ``q``'s dtype.

    A CUDA tensor launches the hand kernel ``csrc/decode_attn.cu`` (or
    raises); a CPU tensor takes :func:`decode_attention_reference`. The
    kernel reads the bf16 (or f32) caches through their strides and only
    the positions up to ``pos``, which is exact (a masked score's
    probability is 0 in f32). Its design is :func:`decode_plan`'s, by
    shape:

    - ``"cluster"``, one launch: a thread-block cluster of 4 per (b, kv
      head) TMA-loads its K and V rows up to ``pos`` into shared memory,
      exchanges the softmax's row max and sum over distributed shared
      memory, and rank 0 sums the blocks' P V partials. Its bound is the
      bytes of K and V up to ``pos`` (4.2 us at GPT-2 small's serving
      shape at pos 575 on an H100).
    - ``"fma"``, three launches through f32 workspaces (scores, then P V
      per chunk, then the chunks' sum), where the cluster design's tiles
      pass a block's shared memory: a long ``max_len`` at a large group or
      head dim.

    A launch counts in ``.launches`` and ``.launches_by_design[design]``,
    once per replay where a graph capture recorded it
    (``ops.flash_attention.capture_launches``). A DTensor is refused:
    serving runs on one device."""
    if any(isinstance(t, DTensor) for t in (q, cache_k, cache_v, pos)):
        raise TypeError("decode attention takes local tensors, not DTensors")
    with torch.no_grad():
        if q.is_cuda:
            return _launch_decode(q, cache_k, cache_v, pos)
        if q.device.type == "cpu":
            return decode_attention_reference(q, cache_k, cache_v, pos)
    raise ValueError(f"decode attention runs on CUDA or CPU, not {q.device}")


decode_attention.launches = 0
decode_attention.launches_by_design = dict.fromkeys(DECODE_DESIGNS, 0)


__all__ = ["DECODE_DESIGNS", "DECODE_MASK", "attention_placements",
           "count_attention_flops", "decode_attention",
           "decode_attention_reference", "decode_occupancy", "decode_plan",
           "decode_tolerance", "multi_head_attention", "reference_attention"]
