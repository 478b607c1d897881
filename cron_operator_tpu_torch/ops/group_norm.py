"""GroupNorm over channels-last tensors: a CUDA kernel pair for Hopper,
their plain versions, and the autograd Function that joins them.

The JAX package has no counterpart module: its ResNet calls flax's
``nn.GroupNorm(dtype=bf16)`` on NHWC activations
(``cron_operator_tpu/models/resnet.py:38``), and XLA fuses that norm into
the convolutions' programs. The port's models keep NCHW-shaped tensors with
channels-last strides (``models/resnet.py``), and ``models/layers.py``
``GroupNorm`` normalises them through :func:`group_norm`.

- On a CUDA tensor :func:`group_norm_forward` launches the forward kernel
  of ``csrc/group_norm.cu`` (the group statistics, then ``y = (x - mean) *
  (rstd * gamma) + beta`` in f32, rounded once) and
  :func:`group_norm_backward` the backward kernel (dx, dgamma and dbeta
  from x, dy and the saved f32 statistics; x̂ is recomputed), each in the
  design :func:`forward_plan` or :func:`backward_plan` picks by shape: on
  ResNet-50's shapes a thread-block cluster that reads x (and dy) once. The
  tensor must be channels-last-contiguous: a hidden ``.contiguous()`` would
  be the very copy the kernels exist to remove, so anything else raises.
- On a CPU tensor the same wrappers run :func:`group_norm_reference` and
  :func:`group_norm_backward_reference` (on a ``meta`` tensor too, whose
  shapes a FLOP count follows); there is no fallback from the card to the
  plain versions.
- A DTensor raises: ``GroupNorm`` hands the rows of a batch-split DTensor
  over as plain tensors (``parallel.mesh.on_local_rows``).

ResNet's ops after a norm run in the kernels' epilogues (:data:`EPILOGUES`):
``relu=True`` gives ``z = relu(y)``, and a ``residual`` (with ``relu``)
``z = relu(y + residual)``, y rounded to its dtype before the add and the
add rounded once, as the bf16 ``+`` and ``F.relu`` the model ran before,
to the bit. The backward of a relu recomputes its mask from x (the kernel
by the forward's expression; the plain version by the plain forward); the
residual's mask is ``threshold_backward`` of the saved z, whose result is
also the residual's gradient.

The Function saves x in its own dtype (not an f32 copy), the f32 ``mean``
and ``rstd`` ``[B, groups]`` and gamma (beta too for a relu, z for a
residual). Each wrapper counts its kernel's launches (``.launches``,
``.launches_by_design``, ``.launches_by_epilogue``), once per replay where
a graph capture recorded it (``ops.flash_attention.capture_launches``).
:func:`group_norm_tolerance` states how far the kernels may lie from the
plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from cron_operator_tpu_torch.ops import _build
from cron_operator_tpu_torch.ops.flash_attention import (
    _DTYPE_CODES,
    _count,
    _raise_on,
)

# The kernels' designs, by direction: "cluster", the tensors a norm reads
# (x forward, x and dy backward) read once into a thread-block cluster's
# shared memory (the main path, where :func:`forward_plan` and
# :func:`backward_plan` fit it), and "two_pass", which reads them twice.
FORWARD_DESIGNS = ("cluster", "two_pass")
BACKWARD_DESIGNS = ("cluster", "two_pass")
# The forward's epilogues (csrc/group_norm.cu EPI_*, in order): y as it
# is, relu(y), relu(y + residual); the backward's: dy as it is, or masked
# by the forward's relu (a residual's mask is applied before the kernel).
EPILOGUES = ("none", "relu", "residual_relu")
BACKWARD_EPILOGUES = ("none", "relu")
# The cluster designs (csrc/group_norm.cu): the cluster sizes they take
# (blocks of a (b, slab); 16 is a non-portable size), 256 threads (8
# warps) a block, TMA boxes of at most 256 pixels, slabs of at most 256
# channels, pixel rows of at least 64 bytes where C allows (a narrower
# slab reads DRAM sectors half used), the dynamic shared memory a block may
# take on an H100, and the most each of two blocks an SM may take (228 KB
# less 1 KB reserved a block, halved).
CLUSTERS = (1, 2, 4, 8, 16)
_WARPS = 8
_MAX_BOX = 256
_MAX_SLAB = 256
_MIN_ROW_BYTES = 64
# a cluster plan's keys, in the C entries' order
_PLAN_KEYS = ("slab", "cluster", "pix", "box_pix", "nbox")
SMEM_LIMIT = 232448
_HALF_SM = 115712
# A blocked f32 sum of at most 2^8 sequential additions, taken in two
# orders (kernel and plain version): their difference is within
# 2 * 2^8 * 2^-24 of the sum of the terms' magnitudes.
SUM_ORDER = 2.0 ** -15
# One unit in the last place relative to the value: a rounding flip of the
# result between two neighbours.
_ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23,
        torch.float64: 2.0 ** -52}
# the plain versions' devices: the CPU, and ``meta`` for a FLOP count's
# shapes (``Trainer.flops_per_step``)
_PLAIN_DEVICES = ("cpu", "meta")


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for bf16 and f32 inputs (flax normalises in f32), f64 for f64."""
    return torch.promote_types(x.dtype, torch.float32)


def _grouped(t: torch.Tensor, groups: int) -> torch.Tensor:
    """``[B, C, H, W]`` as ``[B, groups, C / groups, H * W]`` (a copy for a
    channels-last tensor)."""
    b, c = t.shape[:2]
    return t.reshape(b, groups, c // groups, -1)


def group_stats(x: torch.Tensor, groups: int,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain f32 (f64 for f64) ``mean`` and ``rstd = 1 / sqrt(var + eps)``
    of each (sample, group), ``[B, groups]``, the variance as E[(x -
    E[x])^2]."""
    xg = _grouped(x.to(_compute_dtype(x)), groups)
    mean = xg.mean((2, 3))
    var = (xg - mean[:, :, None, None]).square().mean((2, 3))
    return mean, torch.rsqrt(var + eps)


def _epilogue(relu: bool, residual: Optional[torch.Tensor], x: torch.Tensor,
              out_dtype: torch.dtype) -> str:
    """The name in :data:`EPILOGUES` of ``relu`` and ``residual``; a
    residual without a relu, or one that is not of x's shape and device
    and y's dtype, raises ValueError."""
    if residual is None:
        return "relu" if relu else "none"
    if not relu:
        raise ValueError("a residual is fused only with relu=True: ResNet "
                         "adds it before the block's last relu")
    if (residual.shape != x.shape or residual.dtype != out_dtype
            or residual.device != x.device):
        raise ValueError(
            f"the residual must have x's shape {tuple(x.shape)} and device "
            f"and y's dtype {out_dtype}, not {tuple(residual.shape)} "
            f"{residual.dtype} on {residual.device}")
    return "residual_relu"


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float,
                         out_dtype: torch.dtype, relu: bool = False,
                         residual: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain forward, ``(z, mean, rstd)``: x and the parameters in f32
    (f64 for an f64 x), ``F.group_norm``, then y cast to ``out_dtype`` (the
    port's ``GroupNorm`` did exactly this before the kernels, and gives the
    same bits); with ``residual``, ``y + residual`` in ``out_dtype``; with
    ``relu``, ``F.relu`` of that: the model's former sequence, op for op.
    ``mean`` and ``rstd`` from :func:`group_stats`."""
    _epilogue(relu, residual, x, out_dtype)
    ct = _compute_dtype(x)
    xc = x.to(ct)
    y = F.group_norm(xc, groups, weight.to(ct), bias.to(ct), eps).to(out_dtype)
    if residual is not None:
        y = residual + y
    if relu:
        y = F.relu(y)
    return (y, *group_stats(xc, groups, eps))


def group_norm_backward_reference(
        dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
        rstd: torch.Tensor, weight: torch.Tensor, groups: int,
        relu: bool = False, bias: Optional[torch.Tensor] = None,
        eps: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward, ``(dx, dgamma, dbeta)``, in the kernel's
    arithmetic (f32, f64 for f64), with x̂ = (x − mean_g)·rstd_g:

    - with ``relu``, dy is first masked as autograd masks it behind
      ``F.relu`` (``threshold_backward`` against y > 0), y recomputed from
      x, ``bias`` and ``eps`` by :func:`group_norm_reference` in dy's
      dtype, the plain forward's bits;
    - s1_g = Σ γ_c·dy and s2_g = Σ γ_c·dy·x̂ over each (b, g) of n
      elements;
    - dx = rstd_g·(γ_c·dy − s1_g/n − x̂·s2_g/n), rounded once to x's dtype
      and laid out as x;
    - dγ_c = Σ_{b,h,w} dy·x̂ and dβ_c = Σ_{b,h,w} dy, in the compute dtype.
    """
    if relu:
        if bias is None or eps is None:
            raise ValueError("the relu's mask needs bias and eps: y is "
                             "recomputed from x")
        y = group_norm_reference(x, weight, bias, groups, eps, dy.dtype)[0]
        dy = torch.ops.aten.threshold_backward(dy, y, 0)
    ct = _compute_dtype(x)
    c = x.shape[1]
    xg, dyg = _grouped(x.to(ct), groups), _grouped(dy.to(ct), groups)
    gamma = weight.to(ct).reshape(1, groups, -1, 1)
    xhat = (xg - mean.to(ct)[:, :, None, None]) * rstd.to(ct)[:, :, None, None]
    gdy = gamma * dyg
    n = xg.shape[2] * xg.shape[3]
    s1 = gdy.sum((2, 3), keepdim=True)
    s2 = (gdy * xhat).sum((2, 3), keepdim=True)
    dx = rstd.to(ct)[:, :, None, None] * (gdy - s1 / n - xhat * s2 / n)
    dgamma = (dyg * xhat).sum((0, 3)).reshape(c)
    dbeta = dyg.sum((0, 3)).reshape(c)
    return (torch.empty_like(x).copy_(dx.reshape(x.shape)), dgamma, dbeta)


def group_norm_tolerance(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, mean: torch.Tensor,
                         rstd: torch.Tensor, y: torch.Tensor,
                         dy: Optional[torch.Tensor] = None,
                         dx: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """Elementwise bounds on ``|kernel - plain|`` from the plain version's
    results (``mean``, ``rstd``, ``y``; with ``dy``, also the plain ``dx``),
    each broadcastable to its quantity: keys ``y``, ``mean``, ``rstd`` and
    with ``dy`` also ``dx``, ``dgamma``, ``dbeta``.

    Both sides sum in f32 in other orders (:data:`SUM_ORDER` of the terms'
    magnitudes). The statistics then differ by up to SUM_ORDER of E|x| in
    the mean and of rstd·(1 + E|x|·rstd) in rstd (the centred squares carry
    the mean's rounding, relative to the spread); y by that times
    |γ|·(1 + |x̂|), plus |β|'s rounding, then one unit in the last place of
    y's dtype at |y| (bf16: 2^-7 |y|, a rounding flip). dx: s1 and s2 by
    SUM_ORDER of Σ|γ dy| and Σ|γ dy x̂| over the group, over n, times rstd,
    then one ulp of x's dtype at |dx|; dγ and dβ by SUM_ORDER of Σ|dy x̂| and
    Σ|dy| over (b, h, w), however many terms (up to 128·112² in ResNet-50):
    the bound is on the depth of the sums, not their length."""
    ct = torch.float32
    xg = _grouped(x.to(ct), groups)
    m, r = mean.to(ct)[:, :, None, None], rstd.to(ct)[:, :, None, None]
    abs_mean = xg.abs().mean((2, 3), keepdim=True)
    drift = 1 + abs_mean * r
    xhat = (xg - m) * r
    gamma = weight.to(ct).reshape(1, groups, -1, 1)
    beta = bias.to(ct).reshape(1, groups, -1, 1)
    e_y = SUM_ORDER * (gamma.abs() * drift * (1 + xhat.abs()) + beta.abs())
    bounds = {
        "mean": SUM_ORDER * abs_mean[:, :, 0, 0],
        "rstd": SUM_ORDER * (r * drift)[:, :, 0, 0],
        "y": (_ULP[y.dtype] * _grouped(y.to(ct), groups).abs() + e_y
              ).reshape(x.shape),
    }
    if dy is not None:
        dyg = _grouped(dy.to(ct), groups)
        gdy = (gamma * dyg).abs()
        n = xg.shape[2] * xg.shape[3]
        s1 = gdy.sum((2, 3), keepdim=True) / n
        s2 = (gdy * xhat.abs()).sum((2, 3), keepdim=True) / n
        e_dx = SUM_ORDER * r * (gdy + s1 + (1 + xhat.abs()) * s2)
        bounds["dx"] = (_ULP[dx.dtype] * _grouped(dx.to(ct), groups).abs()
                        + e_dx).reshape(x.shape)
        c = x.shape[1]
        bounds["dgamma"] = SUM_ORDER * (dyg * xhat).abs().sum((0, 3)).reshape(c)
        bounds["dbeta"] = SUM_ORDER * dyg.abs().sum((0, 3)).reshape(c)
    return bounds


# ------------------------------------------------------------------ kernels

_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    """The built GroupNorm library, with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load("group_norm")
        lib.group_norm_tiles.argtypes = [ctypes.c_int] * 4
        lib.group_norm_tiles.restype = ctypes.c_int
        lib.group_norm_fwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.group_norm_fwd.restype = ctypes.c_int
        lib.group_norm_bwd.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.group_norm_bwd.restype = ctypes.c_int
        lib.group_norm_bwd_cluster.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
        lib.group_norm_bwd_cluster.restype = ctypes.c_int
        lib.group_norm_fwd_cluster.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.group_norm_fwd_cluster.restype = ctypes.c_int
        for occupancy in (lib.group_norm_fwd_cluster_occupancy,
                          lib.group_norm_bwd_cluster_occupancy):
            occupancy.argtypes = [ctypes.c_int] * 11
            occupancy.restype = ctypes.c_int
        lib.group_norm_error_string.argtypes = [ctypes.c_int]
        lib.group_norm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _refuse_dtensor(*tensors) -> None:
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            "group_norm takes local tensors, not DTensors: GroupNorm hands a "
            "batch-split DTensor's rows over through on_local_rows")


def _check_activation(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """Refuses an activation the kernels cannot read in place."""
    if t.dim() != 4 or t.shape != like.shape or t.device != like.device:
        raise ValueError(f"{name} must be [B, C, H, W] on x's device, with "
                         f"x's shape {tuple(like.shape)}, not "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} must be float32 or bfloat16, not {t.dtype}")
    if not t.is_contiguous(memory_format=torch.channels_last) or (
            t.data_ptr() % 16):
        raise ValueError(
            f"{name} must be channels-last-contiguous (NHWC in memory) and "
            "16-byte aligned: the GroupNorm kernels read it in place and "
            "copy nothing to fit")


def _power_of_two(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def _tiles(x: torch.Tensor, groups: int) -> int:
    """The kernels' tiles per (sample, slab); a shape they refuse raises
    ValueError before anything is built."""
    b, c, h, w = x.shape
    vec = 16 // x.element_size()
    if not (_power_of_two(c) and _power_of_two(groups) and vec <= c
            and groups <= c and c // groups <= 256 and b * h * w > 0):
        raise ValueError(
            "the GroupNorm kernels take C a power of two of at least one "
            "16-byte vector, groups a power of two with at most 256 "
            f"channels a group, and a non-empty batch and map: not x "
            f"{tuple(x.shape)} {x.dtype} with {groups} groups")
    tiles = _kernel().group_norm_tiles(c, h * w, groups, _DTYPE_CODES[x.dtype])
    if tiles < 0:
        raise RuntimeError(f"group_norm_tiles refused x {tuple(x.shape)} "
                           f"{x.dtype} with {groups} groups")
    return tiles


def forward_plan(b: int, c: int, hw: int, groups: int, x_dtype: torch.dtype,
                 cluster: Optional[int] = None,
                 max_slab: int = _MAX_SLAB) -> dict:
    """The forward kernel's design for ``[b, c, h, w]`` (``hw = h * w``)
    with ``groups`` groups: ``"cluster"`` where a cluster's shared memory
    holds a (b, slab)'s x, else ``"two_pass"``. :func:`backward_plan`'s
    rule for a block that holds x alone (half the bytes a pixel in bf16):
    at ResNet-50's shapes in bf16, 8 blocks of 32 channels at 112², 2 of
    32 at 56², one block of 64 at 28² and of 256 at 14² and 7²."""
    return _plan(c, hw, groups, (x_dtype,), cluster, max_slab)


def backward_plan(b: int, c: int, hw: int, groups: int, x_dtype: torch.dtype,
                  dy_dtype: torch.dtype, cluster: Optional[int] = None,
                  max_slab: int = _MAX_SLAB) -> dict:
    """The backward kernel's design for ``[b, c, h, w]`` (``hw = h * w``)
    with ``groups`` groups: ``"cluster"`` where a cluster's shared memory
    holds a (b, slab)'s x and dy, else ``"two_pass"``. A slab is a power of
    two of at most ``max_slab`` channels, whole groups and whole 16-byte
    vectors of x and dy; a block takes ``pix`` pixels of the map, as
    ``nbox`` TMA boxes of ``box_pix`` (``Layout`` in
    ``csrc/group_norm.cu``, mirrored by ``_fit``).

    With ``cluster`` given, the widest slab that fits a block's shared
    memory at that cluster size. Otherwise the smallest cluster of
    ``CLUSTERS`` whose widest slab fits half an SM's shared memory (two
    blocks an SM, so one block's loads overlap the other's stores) with
    pixel rows of at least ``_MIN_ROW_BYTES`` (or all of C), else the same
    at one block an SM. ``hack/torch_cluster_sweep.py`` measured that rule
    on ResNet-50's shapes (PERF.md section 6). Keys ``design``, and for the
    cluster design ``slab``, ``cluster``, ``pix``, ``box_pix``, ``nbox`` and
    ``smem`` (bytes a block)."""
    return _plan(c, hw, groups, (x_dtype, dy_dtype), cluster, max_slab)


def _plan(c, hw, groups, held, cluster, max_slab):
    """The rule of :func:`backward_plan` for a block that holds tensors of
    the dtypes ``held`` (x first)."""
    if cluster is not None:
        return _fit(c, hw, groups, held, cluster, max_slab,
                    SMEM_LIMIT) or {"design": "two_pass"}
    rows = min(c * held[0].itemsize, _MIN_ROW_BYTES)
    for budget in (_HALF_SM, SMEM_LIMIT):
        for size in CLUSTERS:
            plan = _fit(c, hw, groups, held, size, max_slab, budget)
            if plan and plan["slab"] * held[0].itemsize >= rows:
                return plan
    return {"design": "two_pass"}


def _fit(c, hw, groups, held, cluster, max_slab, budget):
    """The cluster plan with the widest slab whose block, holding tensors
    of the dtypes ``held``, fits ``budget`` bytes of shared memory, or
    None. Each box has its tiles and its mbarrier; each held tensor takes a
    ``[WARPS][slab]`` array of row partials and a ``[slab]`` group tree;
    the block's partials are two ``[slab]`` float arrays whatever it
    holds."""
    sizes = [t.itemsize for t in held]
    pix = -(-hw // cluster)
    nbox = -(-pix // _MAX_BOX)
    box_pix = -(-pix // nbox)
    slab = min(c, max_slab)
    while slab >= c // groups and all(slab * e % 16 == 0 for e in sizes):
        boxes = sum(-(-box_pix * slab * e // 128) * 128 for e in sizes)
        smem = (nbox * (boxes + 8) + len(sizes) * (_WARPS + 1) * slab * 4
                + slab * 8)
        if smem <= budget:
            return {"design": "cluster", "slab": slab, "cluster": cluster,
                    "pix": pix, "box_pix": box_pix, "nbox": nbox,
                    "smem": smem}
        slab //= 2
    return None


def _param(p: torch.Tensor, c: int, device) -> torch.Tensor:
    if p.shape != (c,) or p.device != device:
        raise ValueError(f"gamma and beta must be [{c}] on {device}, not "
                         f"{tuple(p.shape)} on {p.device}")
    return p.detach().float().contiguous()


def _launch_forward(x, weight, bias, groups, eps, out_dtype,
                    plan: Optional[dict] = None, relu: bool = False,
                    residual: Optional[torch.Tensor] = None):
    """The forward kernel on the card, in :func:`forward_plan`'s design
    (``plan`` gives another, to time it beside), with the epilogue of
    ``relu`` and ``residual``."""
    _check_activation("x", x, x)
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, not "
                         f"{out_dtype}")
    epilogue = _epilogue(relu, residual, x, out_dtype)
    if residual is not None:
        _check_activation("residual", residual, x)
    b, c, h, w = x.shape
    gamma, beta = (_param(p, c, x.device) for p in (weight, bias))
    tiles = _tiles(x, groups)
    plan = plan or forward_plan(b, c, h * w, groups, x.dtype)
    y = torch.empty_like(x, dtype=out_dtype, memory_format=torch.channels_last)
    stats = torch.empty((2, b, groups), dtype=torch.float32, device=x.device)
    lib = _kernel()
    ptrs = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            None if residual is None else residual.data_ptr(), y.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr())
    codes = (_DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], b, c, h * w,
             groups, eps, EPILOGUES.index(epilogue))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan["design"] == "cluster":
            fn = "group_norm_fwd_cluster"
            err = lib.group_norm_fwd_cluster(
                *ptrs, *codes, *(plan[k] for k in _PLAN_KEYS), stream)
        else:
            fn = "group_norm_fwd"
            part = torch.empty((b, groups, tiles, 2), dtype=torch.float32,
                               device=x.device)
            err = lib.group_norm_fwd(*ptrs, part.data_ptr(), *codes, stream)
    _raise_on(err, lib, fn, "group_norm_error_string")
    _count(group_norm_forward, plan["design"], stream, epilogue)
    return y, stats[0], stats[1]


def _launch_backward(dy, x, mean, rstd, weight, groups,
                     plan: Optional[dict] = None, relu: bool = False,
                     bias: Optional[torch.Tensor] = None):
    """The backward kernel on the card, in :func:`backward_plan`'s design
    (``plan`` gives another, to time it beside); with ``relu``, dy masked
    by the forward's relu, recomputed from x, gamma and ``bias``."""
    _check_activation("x", x, x)
    _check_activation("dy", dy, x)
    if relu and bias is None:
        raise ValueError("the relu's mask needs bias: y is recomputed "
                         "from x")
    b, c, h, w = x.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.shape != (b, groups) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 [{b}, "
                             f"{groups}] on x's device")
    gamma = _param(weight, c, x.device)
    beta = _param(bias, c, x.device) if relu else None
    tiles = _tiles(x, groups)
    plan = plan or backward_plan(b, c, h * w, groups, x.dtype, dy.dtype)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    grads = torch.empty((2, c), dtype=torch.float32, device=x.device)
    sums = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    lib = _kernel()
    epilogue = "relu" if relu else "none"
    codes = (_DTYPE_CODES[x.dtype], _DTYPE_CODES[dy.dtype], b, c, h * w,
             groups, BACKWARD_EPILOGUES.index(epilogue))
    ptrs = (dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            gamma.data_ptr(), None if beta is None else beta.data_ptr(),
            dx.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan["design"] == "cluster":
            fn = "group_norm_bwd_cluster"
            err = lib.group_norm_bwd_cluster(
                *ptrs, sums.data_ptr(), *codes,
                *(plan[k] for k in _PLAN_KEYS), stream)
        else:
            fn = "group_norm_bwd"
            part = torch.empty((b, tiles, c, 2), dtype=torch.float32,
                               device=x.device)
            coef = torch.empty((b, groups, 2), dtype=torch.float32,
                               device=x.device)
            err = lib.group_norm_bwd(*ptrs, part.data_ptr(), sums.data_ptr(),
                                     coef.data_ptr(), *codes, stream)
    _raise_on(err, lib, fn, "group_norm_error_string")
    _count(group_norm_backward, plan["design"], stream, epilogue)
    return dx, grads[0], grads[1]


def forward_occupancy(x: torch.Tensor, groups: int,
                      plan: Optional[dict] = None) -> int:
    """Clusters of the cluster forward that the card holds at once for
    ``x`` (y of x's dtype) and ``plan`` (:func:`forward_plan`'s by
    default), whatever the epilogue: ``cudaOccupancyMaxActiveClusters``,
    -1 where it cannot run. Builds the kernel."""
    b, c, h, w = x.shape
    plan = plan or forward_plan(b, c, h * w, groups, x.dtype)
    return _occupancy("group_norm_fwd_cluster_occupancy", x, groups, plan)


def backward_occupancy(x: torch.Tensor, groups: int,
                       plan: Optional[dict] = None) -> int:
    """Clusters of the cluster backward that the card holds at once for
    ``x`` (dy of x's dtype) and ``plan`` (:func:`backward_plan`'s by
    default), as :func:`forward_occupancy`."""
    b, c, h, w = x.shape
    plan = plan or backward_plan(b, c, h * w, groups, x.dtype, x.dtype)
    return _occupancy("group_norm_bwd_cluster_occupancy", x, groups, plan)


def _occupancy(fn: str, x: torch.Tensor, groups: int, plan: dict) -> int:
    if plan["design"] != "cluster":
        return -1
    b, c, h, w = x.shape
    code = _DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        return getattr(_kernel(), fn)(code, code, b, c, h * w, groups,
                                      *(plan[k] for k in _PLAN_KEYS))


def group_norm_forward(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, groups: int, eps: float,
                       out_dtype: torch.dtype, relu: bool = False,
                       residual: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(z, mean, rstd)``: the forward kernel on a CUDA tensor (or raises),
    :func:`group_norm_reference` on a CPU or meta tensor. No autograd. z is
    y with the epilogue of ``relu`` and ``residual`` (:data:`EPILOGUES`),
    applied where y is written. Its bound is bytes: x (and the residual)
    read once and z written once (1.699 ms over ResNet-50's 53 norms a step
    at b 128 in bf16 on an H100, 2.121 with the residuals of its 16
    blocks). The design is :func:`forward_plan`'s, by shape:

    - ``"cluster"``: one thread-block cluster of 1 to 16 blocks per
      (sample, slab of channels) TMA-loads the slab's x into shared memory,
      sums each channel there, exchanges the blocks' sums over distributed
      shared memory for each group's mean, then does the same for the
      centred squares (the variance with no cancellation), and writes y from
      the tile it holds: x is read once, the bound's traffic.
    - ``"two_pass"``: per-tile Chan partials, their merge, then y from a
      second read of x (3 units of traffic where the bound needs 2), for a
      shape whose slab does not fit the cluster's shared memory.

    A launch counts under its design in ``.launches_by_design`` and under
    its epilogue in ``.launches_by_epilogue``."""
    _refuse_dtensor(x, weight, bias, residual)
    with torch.no_grad():
        if x.is_cuda:
            return _launch_forward(x, weight, bias, groups, eps, out_dtype,
                                   relu=relu, residual=residual)
        if x.device.type in _PLAIN_DEVICES:
            return group_norm_reference(x, weight, bias, groups, eps,
                                        out_dtype, relu, residual)
    raise ValueError(f"group_norm runs on CUDA, CPU or meta, not {x.device}")


def group_norm_backward(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor, weight: torch.Tensor, groups: int,
                        relu: bool = False,
                        bias: Optional[torch.Tensor] = None,
                        eps: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dgamma, dbeta)``: the backward kernel on a CUDA tensor (or
    raises), :func:`group_norm_backward_reference` on a CPU or meta
    tensor. With ``relu``, of dy masked by the forward's relu, which each
    side recomputes from x, gamma and ``bias`` as its forward computed y
    (the plain version needs ``eps`` too); dy's dtype is then y's. Its
    bound is bytes: x and dy read once and dx written once (2.55 ms over
    ResNet-50's 53 norms a step at b 128 in bf16 on an H100); the mask costs
    arithmetic, no bytes. The design is :func:`backward_plan`'s, by shape:

    - ``"cluster"``: one thread-block cluster of 1 to 16 blocks per
      (sample, slab of channels) TMA-loads the slab's x and dy into shared
      memory, sums each channel's dy·x̂ and dy there, exchanges the blocks'
      sums over distributed shared memory, and writes dx from the tiles it
      holds; a second small launch sums dγ and dβ over the batch. x and dy
      are read once: the bound's traffic.
    - ``"two_pass"``: per-tile sums, their merge, then dx from a second
      read of x and dy (5 units of traffic where the bound needs 3), for a
      shape whose slab does not fit the cluster's shared memory.

    A launch counts under its design in ``.launches_by_design`` and under
    its epilogue in ``.launches_by_epilogue``."""
    _refuse_dtensor(dy, x, mean, rstd, weight, bias)
    with torch.no_grad():
        if x.is_cuda:
            return _launch_backward(dy, x, mean, rstd, weight, groups,
                                    relu=relu, bias=bias)
        if x.device.type in _PLAIN_DEVICES:
            return group_norm_backward_reference(dy, x, mean, rstd, weight,
                                                 groups, relu, bias, eps)
    raise ValueError(f"group_norm runs on CUDA, CPU or meta, not {x.device}")


group_norm_forward.launches = 0
group_norm_forward.launches_by_design = dict.fromkeys(FORWARD_DESIGNS, 0)
group_norm_forward.launches_by_epilogue = dict.fromkeys(EPILOGUES, 0)
group_norm_backward.launches = 0
group_norm_backward.launches_by_design = dict.fromkeys(BACKWARD_DESIGNS, 0)
group_norm_backward.launches_by_epilogue = dict.fromkeys(BACKWARD_EPILOGUES,
                                                         0)


class _GroupNorm(torch.autograd.Function):
    """The norm and its epilogue. A relu's backward runs in the kernel,
    which recomputes the mask from x; a residual's is
    ``threshold_backward`` of the saved z (the next layer's input, alive
    anyway), whose result is the residual's gradient and the kernel's
    unmasked dy."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, groups, eps, out_dtype, relu):
        z, mean, rstd = group_norm_forward(x, weight, bias, groups, eps,
                                           out_dtype, relu, residual)
        ctx.groups, ctx.eps, ctx.bias_dtype = groups, eps, bias.dtype
        ctx.residual = residual is not None
        ctx.relu = relu and not ctx.residual  # the kernel's mask
        ctx.save_for_backward(x, mean, rstd, weight,
                              z if ctx.residual else bias if relu else None)
        return z

    @staticmethod
    def backward(ctx, dz):
        x, mean, rstd, weight, kept = ctx.saved_tensors
        dres = None
        if ctx.residual:
            dz = dres = torch.ops.aten.threshold_backward(dz, kept, 0)
        dx, dgamma, dbeta = group_norm_backward(
            dz, x, mean, rstd, weight, ctx.groups, ctx.relu,
            kept if ctx.relu else None, ctx.eps)
        return (dx, dgamma.to(weight.dtype), dbeta.to(ctx.bias_dtype), dres,
                None, None, None, None)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               groups: int = 32, eps: float = 1e-6,
               out_dtype: Optional[torch.dtype] = None, relu: bool = False,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax ``nn.GroupNorm(num_groups=groups, epsilon=eps, dtype=out_dtype)``
    of ``x [B, C, H, W]`` (channels-last on the card) with f32 ``weight``
    (gamma) and ``bias`` (beta) ``[C]``: normalised in f32, y in
    ``out_dtype`` (x's dtype by default); then, with ``relu``, ``relu(y)``,
    and with a ``residual`` of y's shape and dtype too, ``relu(y +
    residual)``, the same bits as those ops after the norm. Differentiable
    in x, weight, bias and the residual; the kernels on a CUDA tensor, the
    plain versions on a CPU one."""
    return _GroupNorm.apply(x, weight, bias, residual, groups, eps,
                            out_dtype or x.dtype, relu)


__all__ = ["BACKWARD_DESIGNS", "BACKWARD_EPILOGUES", "CLUSTERS",
           "EPILOGUES", "FORWARD_DESIGNS", "SUM_ORDER",
           "backward_occupancy", "backward_plan", "forward_occupancy",
           "forward_plan", "group_norm",
           "group_norm_backward", "group_norm_backward_reference",
           "group_norm_forward", "group_norm_reference",
           "group_norm_tolerance", "group_stats"]
