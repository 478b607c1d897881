"""LayerNorm over the last dimension: a CUDA kernel pair for Hopper, their
plain versions, and the autograd Function that joins them.

The JAX package has no counterpart module: its GPT, BERT and ViT call
flax's ``nn.LayerNorm(dtype=cfg.dtype)`` (``cron_operator_tpu/models/
gpt.py:139, 166, 311``, ``models/bert.py:70, 85, 117``, ``models/vit.py:
106``), and XLA fuses that norm and the casts around it into one pass over
the bf16 activation. ``models/layers.py`` ``LayerNorm`` normalises the
port's plain tensors through :func:`layer_norm`.

- On a CUDA tensor :func:`layer_norm_forward` launches the forward kernel
  of ``csrc/layer_norm.cu`` (each row's f32 mean and variance from one read
  of x, then ``y = (x - mean) * (rstd * gamma) + beta`` in f32, rounded
  once to ``out_dtype``) and :func:`layer_norm_backward` the backward pair
  (dx from x, dy and the saved f32 statistics, x̂ recomputed; dgamma and
  dbeta from per-block partials summed by a second launch), one warp a
  row, in the plan :func:`forward_plan` or :func:`backward_plan` picks by
  width. x
  and dy must be rows of whole 16-byte vectors at an even stride: a hidden
  ``.contiguous()`` would be the very copy the kernels exist to remove, so
  anything else raises.
- On a CPU tensor the same wrappers run :func:`layer_norm_reference` and
  :func:`layer_norm_backward_reference`, the port's former arithmetic to
  the bit (on a ``meta`` tensor too, whose shapes a FLOP count follows);
  there is no fallback from the card to the plain versions.
- A DTensor raises: on a mesh that places DTensors ``LayerNorm`` hands
  each rank's own rows over as plain tensors (``parallel.mesh.
  on_own_rows``).
- :func:`add_layer_norm` folds a pre-LN block's residual add into the
  norm after it (``_AddLayerNorm``): the forward kernel reads the residual
  rows x and the branch rows r and writes s = x + r (torch's bits) and the
  norm of s; the backward adds the residual stream's gradient to dx before
  its one rounding, and x and r both take that dx. XLA fuses the same add
  into the norm's fusion in the reference (``cron_operator_tpu/models/
  gpt.py:164-166, 174``). Its plain versions are torch's add followed by
  the norm's, to the bit.

The Function saves x in its own dtype (not an f32 copy), the f32 ``mean``
and ``rstd`` ``[T]`` and the parameters. Each wrapper counts its kernel's
launches (``.launches``, ``.launches_by_design``), once per replay where a
graph capture recorded it (``ops.flash_attention.capture_launches``).
:func:`layer_norm_tolerance` states how far the kernels may lie from the
plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from cron_operator_tpu_torch.ops import _build
from cron_operator_tpu_torch.ops.flash_attention import (
    _DTYPE_CODES,
    _count,
    _raise_on,
)

# The kernels' one design (csrc/layer_norm.cu): "warp", one warp a row (8
# rows a block), each lane holding ``chunks`` chunks of 8 values of the row
# in registers: 1 for the tiny configs' widths (at most 256), 3 for GPT-2
# small's, BERT-base's and ViT-B's 768, the widest any config holds.
DESIGNS = ("warp",)
# The folded pair's design: the same warps, the residual add before the
# norm (forward) and the residual stream's gradient added to dx (backward).
ADD_DESIGNS = ("warp_add",)
CHUNK = 8
_CHUNKS = (1, 3)
MAX_WIDTH = 32 * _CHUNKS[-1] * CHUNK
# The backward's blocks at most: two on each of an H100's 132 SMs, each
# walking its share of the rows and writing one partial row of dgamma and
# dbeta (2 x 264 x H f32, 1.6 MB at H 768).
BWD_BLOCKS = 264
# A blocked f32 sum of at most 2^8 sequential additions, taken in two
# orders (kernel and plain version): their difference is within
# 2 * 2^8 * 2^-24 of the sum of the terms' magnitudes.
SUM_ORDER = 2.0 ** -15
# rsqrtf's error, 2 units in the last place of f32, relative.
_RSQRT = 2.0 ** -22
# One unit in the last place relative to the value: a rounding flip of the
# result between two neighbours.
_ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}
# the plain versions' devices: the CPU, and ``meta`` for a FLOP count's
# shapes (``Trainer.flops_per_step``)
_PLAIN_DEVICES = ("cpu", "meta")


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float,
                         out_dtype: torch.dtype
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain forward, ``(y, mean, rstd)``: ``torch.native_layer_norm``
    of x and the parameters cast to f32 (``F.layer_norm`` runs just that),
    then y cast to ``out_dtype``: the port's ``LayerNorm`` did exactly this
    before the kernels, and gives the same bits. ``mean`` and ``rstd`` are
    f32 ``[T]``, T the rows of x's leading dims."""
    y, mean, rstd = torch.native_layer_norm(
        x.float(), [x.shape[-1]], weight.float(), bias.float(), eps)
    return y.to(out_dtype), mean.reshape(-1), rstd.reshape(-1)


def layer_norm_backward_reference(
        dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
        rstd: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward, ``(dx, dgamma, dbeta)``: what autograd ran
    through the former forward, op for op and to the bit: dy cast to f32
    (the output cast's backward), ``native_layer_norm_backward`` against
    the f32 casts of x and the parameters and the saved statistics, dx cast
    back to x's dtype and the parameters' gradients to theirs."""
    shape = tuple(x.shape[:-1]) + (1,)  # torch's statistics: [..., 1]
    dx, dgamma, dbeta = torch.ops.aten.native_layer_norm_backward.default(
        dy.float(), x.float(), [x.shape[-1]], mean.reshape(shape),
        rstd.reshape(shape), weight.float(), bias.float(), [True, True, True])
    return dx.to(x.dtype), dgamma.to(weight.dtype), dbeta.to(bias.dtype)


def add_layer_norm_reference(
        x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
        bias: torch.Tensor, eps: float, out_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain folded forward, ``(s, y, mean, rstd)``: torch's add ``s =
    x + r``, then :func:`layer_norm_reference` of s, to the bit what the
    models ran before the fold."""
    s = x + r
    return (s, *layer_norm_reference(s, weight, bias, eps, out_dtype))


def add_layer_norm_backward_reference(
        dy: torch.Tensor, ds: Optional[torch.Tensor], s: torch.Tensor,
        mean: torch.Tensor, rstd: torch.Tensor, weight: torch.Tensor,
        bias: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain folded backward, ``(dx, dgamma, dbeta)``: the norm's
    :func:`layer_norm_backward_reference` at s, its dx rounded to s's dtype
    and then the residual stream's gradient ``ds`` added (when given) in
    that dtype, as autograd summed the two uses of s before the fold; dx is
    the gradient of both x and r."""
    dx, dgamma, dbeta = layer_norm_backward_reference(dy, s, mean, rstd,
                                                      weight, bias)
    return (dx if ds is None else dx + ds), dgamma, dbeta


def layer_norm_tolerance(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, mean: torch.Tensor,
                         rstd: torch.Tensor, y: torch.Tensor,
                         dy: Optional[torch.Tensor] = None,
                         dx: Optional[torch.Tensor] = None,
                         dgamma: Optional[torch.Tensor] = None,
                         dx_norm: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """Elementwise bounds on ``|kernel - plain|`` from the plain version's
    results on x ``[..., H]`` (``mean``, ``rstd`` ``[T]``, ``y``; with
    ``dy``, also the plain ``dx`` and ``dgamma``), each broadcastable to its
    quantity over x's rows ``[T, H]``: keys ``y``, ``mean``, ``rstd`` and
    with ``dy`` also ``dx``, ``dgamma``, ``dbeta``.

    Both sides sum in f32 in other orders (:data:`SUM_ORDER` of the terms'
    magnitudes). The statistics then differ by up to SUM_ORDER of E|x| in
    the mean and of rstd·(1 + E|x|·rstd) in rstd (the centred squares carry
    the mean's rounding, relative to the spread: the drift), plus rsqrtf's
    2 ulp; y by that times |γ|·(1 + |x̂|), plus |β|'s rounding, then one
    unit in the last place of y's dtype at |y| (bf16: 2^-7 |y|, a rounding
    flip). dx: the row sums Σ γ dy and Σ γ dy x̂ by SUM_ORDER of their
    magnitudes over H, x̂ itself by the drift, times rstd, then one ulp of
    x's dtype at |dx|. dγ and dβ by SUM_ORDER of Σ|dy|·(|x̂| + drift) and
    Σ|dy| over the rows, however many (12608 in ViT-B's step): the bound
    is on the depth of the sums, not their length; then one ulp of the
    parameters' dtype at |dγ| and |dβ|.

    The folded pair: x is the sum s (the kernel's s is the plain one's
    bits) and dx the plain folded dx, the norm's dx plus the residual
    stream's gradient. Given ``dx_norm``, the plain norm's dx before that
    add, the bound on dx grows by half an ulp of dx's dtype at |dx_norm|:
    the plain version rounds the norm's dx before the add and rounds the
    sum again, the kernel rounds the f32 sum once."""
    ct = torch.float32
    h = x.shape[-1]
    xr = x.reshape(-1, h).to(ct)
    m, r = mean.to(ct).reshape(-1, 1), rstd.to(ct).reshape(-1, 1)
    abs_mean = xr.abs().mean(1, keepdim=True)
    drift = 1 + abs_mean * r
    xhat = (xr - m) * r
    gamma, beta = weight.to(ct), bias.to(ct)
    e_y = SUM_ORDER * (gamma.abs() * drift * (1 + xhat.abs()) + beta.abs())
    bounds = {
        "mean": SUM_ORDER * abs_mean[:, 0],
        "rstd": ((SUM_ORDER * drift + _RSQRT) * r)[:, 0],
        "y": _ULP[y.dtype] * y.reshape(-1, h).to(ct).abs() + e_y,
    }
    if dy is not None:
        dyr = dy.reshape(-1, h).to(ct)
        gdy = (gamma * dyr).abs()
        s1 = gdy.mean(1, keepdim=True)
        s2 = (gdy * xhat.abs()).mean(1, keepdim=True)
        e_dx = SUM_ORDER * r * drift * (gdy + s1 + (1 + xhat.abs()) * s2)
        bounds["dx"] = _ULP[dx.dtype] * dx.reshape(-1, h).to(ct).abs() + e_dx
        if dx_norm is not None:
            bounds["dx"] = bounds["dx"] + (
                _ULP[dx.dtype] / 2 * dx_norm.reshape(-1, h).to(ct).abs())
        ulp = _ULP[dgamma.dtype]
        bounds["dgamma"] = (
            SUM_ORDER * (dyr.abs() * (xhat.abs() + drift)).sum(0)
            + ulp * dgamma.to(ct).abs())
        bounds["dbeta"] = (SUM_ORDER * dyr.abs().sum(0)
                           + ulp * dyr.sum(0).abs())
    return bounds


# ------------------------------------------------------------------ kernels

def forward_plan(rows: int, h: int, add: bool = False) -> dict:
    """The forward kernel's plan for ``rows`` rows of ``h`` values:
    ``design`` ``"warp"`` (one warp a row, 8 rows a block), or with ``add``
    the folded design ``"warp_add"`` (the same warps, the residual add
    before the norm); ``chunks``, the
    8-value chunks each lane holds (1 to 256 values, 1 at the tiny configs'
    128 and 64; 3 to 768, GPT-2 small's, BERT-base's and ViT-B's);
    ``grid``, the blocks of the launch. A width that is not a multiple of 8
    or is past :data:`MAX_WIDTH` (768), or no rows, raises ValueError."""
    if h <= 0 or h % CHUNK or h > MAX_WIDTH:
        raise ValueError(
            f"the LayerNorm kernels take a width that is a multiple of "
            f"{CHUNK} of at most {MAX_WIDTH}, not {h}")
    if rows <= 0:
        raise ValueError("the LayerNorm kernels take at least one row")
    need = -(-h // (CHUNK * 32))
    return {"design": "warp_add" if add else "warp",
            "chunks": next(c for c in _CHUNKS if c >= need),
            "grid": -(-rows // 8)}


def backward_plan(rows: int, h: int, add: bool = False) -> dict:
    """The backward kernel's design for ``rows`` rows of ``h`` values:
    :func:`forward_plan`'s, with ``grid`` at most :data:`BWD_BLOCKS`
    blocks (read at each call), which walk the rows and write one partial
    row of dgamma and dbeta each (a second launch, the first's programmatic
    dependent, sums them). With ``add`` the folded design, which adds the
    residual stream's gradient to dx."""
    plan = forward_plan(rows, h, add)
    plan["grid"] = min(plan["grid"], BWD_BLOCKS)
    return plan


_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    """The built LayerNorm library, with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load("layer_norm")
        lib.layer_norm_fwd.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int]
            + [ctypes.c_void_p])
        lib.layer_norm_fwd.restype = ctypes.c_int
        lib.layer_norm_add_fwd.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int]
            + [ctypes.c_void_p])
        lib.layer_norm_add_fwd.restype = ctypes.c_int
        lib.layer_norm_bwd.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.layer_norm_bwd.restype = ctypes.c_int
        lib.layer_norm_error_string.argtypes = [ctypes.c_int]
        lib.layer_norm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _refuse_dtensor(*tensors) -> None:
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            "layer_norm takes local tensors, not DTensors: LayerNorm hands "
            "each rank's own rows over (parallel.mesh.on_own_rows)")


def _as_rows(t: torch.Tensor) -> Optional[Tuple[torch.Tensor, int]]:
    """``t [..., H]`` as ``[T, H]`` rows and their stride in elements, where
    it is rows of whole 16-byte vectors at one stride from a 16-byte
    aligned address (the kernels read it in place); else None."""
    h = t.shape[-1]
    try:
        rows = t.view(-1, h)
    except RuntimeError:
        return None
    vec = 16 // t.element_size()
    stride = h if rows.shape[0] == 1 else rows.stride(0)
    if (h % CHUNK or rows.stride(1) != 1 or stride < h or stride % vec
            or t.data_ptr() % 16):
        return None
    return rows, stride


def _rows(name: str, t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """:func:`_as_rows` of float32 or bfloat16 ``t``, or ValueError."""
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} must be float32 or bfloat16, not {t.dtype}")
    found = _as_rows(t)
    if found is None:
        raise ValueError(
            f"{name} {tuple(t.shape)} must be rows of a width that is a "
            f"multiple of {CHUNK} at one stride of whole 16-byte vectors, "
            "from a 16-byte aligned address: the LayerNorm kernels read it "
            "in place and copy nothing to fit")
    return found


def _params(weight: torch.Tensor, bias: torch.Tensor, h: int, device):
    for p in (weight, bias):
        if (p.shape != (h,) or p.device != device or p.dtype not in
                _DTYPE_CODES or p.stride() != (1,) or p.data_ptr() % 16):
            raise ValueError(
                f"gamma and beta must be contiguous float32 or bfloat16 [{h}] "
                f"on {device}, 16-byte aligned, not {tuple(p.shape)} "
                f"{p.dtype} on {p.device}")
    if weight.dtype != bias.dtype:
        raise ValueError(f"gamma and beta must share one dtype, not "
                         f"{weight.dtype} and {bias.dtype}")
    return weight.detach(), bias.detach()


def _launch_forward(x, weight, bias, eps, out_dtype, r=None):
    """The forward kernel on the card, in :func:`forward_plan`'s design;
    with the branch ``r``, the folded kernel, which also returns s."""
    rows, stride = _rows("x", x)
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, not "
                         f"{out_dtype}")
    t, h = rows.shape
    if r is not None:
        if r.shape != x.shape or r.dtype != x.dtype or r.device != x.device:
            raise ValueError(
                f"r must have x's shape {tuple(x.shape)}, dtype and device, "
                f"not {tuple(r.shape)} {r.dtype} on {r.device}")
        r_rows, r_stride = _rows("r", r)
    plan = forward_plan(t, h, add=r is not None)
    gamma, beta = _params(weight, bias, h, x.device)
    y = torch.empty((t, h), dtype=out_dtype, device=x.device)
    stats = torch.empty((2, t), dtype=torch.float32, device=x.device)
    lib = _kernel()
    codes = (_DTYPE_CODES[x.dtype], _DTYPE_CODES[gamma.dtype],
             _DTYPE_CODES[out_dtype], t, h, eps, plan["chunks"])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if r is None:
            err = lib.layer_norm_fwd(
                rows.data_ptr(), stride, gamma.data_ptr(), beta.data_ptr(),
                y.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                *codes, stream)
        else:
            s = torch.empty((t, h), dtype=x.dtype, device=x.device)
            err = lib.layer_norm_add_fwd(
                rows.data_ptr(), stride, r_rows.data_ptr(), r_stride,
                s.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                y.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                *codes, stream)
    name = "layer_norm_fwd" if r is None else "layer_norm_add_fwd"
    _raise_on(err, lib, name, "layer_norm_error_string")
    if r is None:
        _count(layer_norm_forward, plan["design"], stream)
        return y.view(x.shape), stats[0], stats[1]
    _count(add_layer_norm_forward, plan["design"], stream)
    return s.view(x.shape), y.view(x.shape), stats[0], stats[1]


def _launch_backward(dy, x, mean, rstd, weight, bias, ds=None, add=False):
    """The backward pair on the card, in :func:`backward_plan`'s design;
    with ``add`` the folded design, which adds ``ds`` (when given) to
    dx."""
    rows, stride = _rows("x", x)
    for name, g in (("dy", dy), ("ds", ds)):
        if g is not None and (g.shape != x.shape or g.device != x.device):
            raise ValueError(f"{name} must have x's shape {tuple(x.shape)} "
                             f"and device, not {tuple(g.shape)} on "
                             f"{g.device}")
    dy_rows, dy_stride = _rows("dy", dy)
    ds_ptr, ds_stride = None, 0
    if ds is not None:
        if ds.dtype != x.dtype:
            raise ValueError(f"ds must have x's dtype {x.dtype}, not "
                             f"{ds.dtype}")
        ds_rows, ds_stride = _rows("ds", ds)
        ds_ptr = ds_rows.data_ptr()
    t, h = rows.shape
    for name, st in (("mean", mean), ("rstd", rstd)):
        if (st.shape != (t,) or st.dtype != torch.float32
                or st.device != x.device or st.stride() != (1,)):
            raise ValueError(f"{name} must be contiguous float32 [{t}] on "
                             "x's device")
    plan = backward_plan(t, h, add)
    gamma, _ = _params(weight, bias, h, x.device)
    dx = torch.empty((t, h), dtype=x.dtype, device=x.device)
    part = torch.empty((plan["grid"], 2, h), dtype=torch.float32,
                       device=x.device)
    grads = torch.empty((2, h), dtype=gamma.dtype, device=x.device)
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.layer_norm_bwd(
            rows.data_ptr(), stride, dy_rows.data_ptr(), dy_stride, ds_ptr,
            ds_stride, mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
            dx.data_ptr(), part.data_ptr(), grads[0].data_ptr(),
            grads[1].data_ptr(), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[dy.dtype], _DTYPE_CODES[gamma.dtype], t, h,
            plan["chunks"], plan["grid"], stream)
    _raise_on(err, lib, "layer_norm_bwd", "layer_norm_error_string")
    _count(add_layer_norm_backward if add else layer_norm_backward,
           plan["design"], stream)
    return dx.view(x.shape), grads[0], grads[1]


def layer_norm_forward(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float,
                       out_dtype: torch.dtype
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, rstd)`` of x ``[..., H]``: the forward kernel on a CUDA
    tensor (or raises), :func:`layer_norm_reference` on a CPU or meta
    tensor. No autograd. y has x's shape in ``out_dtype``; mean and rstd
    are f32 ``[T]``. Its bound is bytes: x read once and y written once
    (7.53 us at GPT-2 small's ``[8192, 768]`` in bf16 on an H100). A launch
    counts under its design in ``.launches_by_design``."""
    _refuse_dtensor(x, weight, bias)
    with torch.no_grad():
        if x.is_cuda:
            return _launch_forward(x, weight, bias, eps, out_dtype)
        if x.device.type in _PLAIN_DEVICES:
            return layer_norm_reference(x, weight, bias, eps, out_dtype)
    raise ValueError(f"layer_norm runs on CUDA, CPU or meta, not {x.device}")


def layer_norm_backward(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dgamma, dbeta)``: the backward kernels on a CUDA tensor (or
    raises), :func:`layer_norm_backward_reference` on a CPU or meta
    tensor. No autograd. dx has x's shape and dtype, dgamma and dbeta the
    parameters' dtypes. Its bound is bytes: x and dy read once and dx
    written once (11.3 us at GPT-2 small's ``[8192, 768]`` in bf16 on an
    H100). The kernel's blocks each write a partial row of dgamma and dbeta
    that a second launch of the same library sums in a fixed order, one
    count."""
    _refuse_dtensor(dy, x, mean, rstd, weight, bias)
    with torch.no_grad():
        if x.is_cuda:
            return _launch_backward(dy, x, mean, rstd, weight, bias)
        if x.device.type in _PLAIN_DEVICES:
            return layer_norm_backward_reference(dy, x, mean, rstd, weight,
                                                 bias)
    raise ValueError(f"layer_norm runs on CUDA, CPU or meta, not {x.device}")


def add_layer_norm_forward(x: torch.Tensor, r: torch.Tensor,
                           weight: torch.Tensor, bias: torch.Tensor,
                           eps: float, out_dtype: torch.dtype
                           ) -> Tuple[torch.Tensor, ...]:
    """``(s, y, mean, rstd)`` of the residual rows x and the branch rows r
    ``[..., H]`` of one dtype: s = x + r in that dtype and the norm of s,
    y in ``out_dtype``. The folded kernel on a CUDA tensor (or raises),
    :func:`add_layer_norm_reference` on a CPU or meta tensor. No autograd.
    Its bound is bytes: x and r read once, s and y written once (15.1 us at
    GPT-2 small's ``[8192, 768]`` in bf16 on an H100), and at a decode
    step's ``[8, 768]`` a launch's latency, not a byte count. A launch
    counts under ``"warp_add"`` in ``.launches_by_design``."""
    _refuse_dtensor(x, r, weight, bias)
    with torch.no_grad():
        if x.is_cuda:
            return _launch_forward(x, weight, bias, eps, out_dtype, r)
        if x.device.type in _PLAIN_DEVICES:
            return add_layer_norm_reference(x, r, weight, bias, eps,
                                            out_dtype)
    raise ValueError(f"layer_norm runs on CUDA, CPU or meta, not {x.device}")


def add_layer_norm_backward(dy: torch.Tensor, ds: Optional[torch.Tensor],
                            s: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``(dx, dgamma, dbeta)`` of the folded norm, dx the gradient of both
    x and r: the norm's dx at s plus ``ds``, the residual stream's
    gradient (None when s feeds nothing else), rounded once to s's dtype.
    The backward kernels on a CUDA tensor (or raises),
    :func:`add_layer_norm_backward_reference` on a CPU or meta tensor. No
    autograd. Its bound is bytes: s, dy and ds read once and dx written
    once (15.1 us at GPT-2 small's ``[8192, 768]`` in bf16 on an H100)."""
    _refuse_dtensor(dy, ds, s, mean, rstd, weight, bias)
    with torch.no_grad():
        if s.is_cuda:
            return _launch_backward(dy, s, mean, rstd, weight, bias, ds,
                                    add=True)
        if s.device.type in _PLAIN_DEVICES:
            return add_layer_norm_backward_reference(dy, ds, s, mean, rstd,
                                                     weight, bias)
    raise ValueError(f"layer_norm runs on CUDA, CPU or meta, not {s.device}")


layer_norm_forward.launches = 0
layer_norm_forward.launches_by_design = dict.fromkeys(DESIGNS, 0)
layer_norm_backward.launches = 0
layer_norm_backward.launches_by_design = dict.fromkeys(DESIGNS, 0)
add_layer_norm_forward.launches = 0
add_layer_norm_forward.launches_by_design = dict.fromkeys(ADD_DESIGNS, 0)
add_layer_norm_backward.launches = 0
add_layer_norm_backward.launches_by_design = dict.fromkeys(ADD_DESIGNS, 0)


class _LayerNorm(torch.autograd.Function):
    """The norm; saves x in its own dtype, the f32 statistics and the
    parameters, no f32 copy of x."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, out_dtype):
        y, mean, rstd = layer_norm_forward(x, weight, bias, eps, out_dtype)
        ctx.save_for_backward(x, mean, rstd, weight, bias)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, weight, bias = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_backward(_as_kernel_rows(dy), x, mean,
                                                rstd, weight, bias)
        return dx, dgamma, dbeta, None, None


def _as_kernel_rows(g: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """An incoming gradient as the kernels read it: autograd picks its
    layout (an expanded dy after a sum, say), so one that is not rows is
    copied to rows on the card; the main paths' gradients are rows
    already."""
    if g is not None and g.is_cuda and _as_rows(g) is None:
        return torch.empty_like(g, memory_format=torch.contiguous_format
                                ).copy_(g)
    return g


class _AddLayerNorm(torch.autograd.Function):
    """The residual add folded into the norm: ``(s, y)`` of ``(x, r)``.
    Saves s (not x and r), the f32 statistics and the parameters; its
    backward hands the one folded dx to both x and r."""

    @staticmethod
    def forward(ctx, x, r, weight, bias, eps, out_dtype):
        s, y, mean, rstd = add_layer_norm_forward(x, r, weight, bias, eps,
                                                  out_dtype)
        ctx.save_for_backward(s, mean, rstd, weight, bias)
        ctx.set_materialize_grads(False)  # ln_f's s feeds nothing
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        s, mean, rstd, weight, bias = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(s)
        dx, dgamma, dbeta = add_layer_norm_backward(
            _as_kernel_rows(dy), _as_kernel_rows(ds), s, mean, rstd, weight,
            bias)
        return dx, dx, dgamma, dbeta, None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-6,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``nn.LayerNorm(epsilon=eps, dtype=out_dtype)`` of x ``[..., H]``
    with ``weight`` (gamma) and ``bias`` (beta) ``[H]`` in f32 (or bf16 for
    a serving model's parameters): normalised in f32, y in ``out_dtype``
    (x's dtype by default). Differentiable in x, weight and bias; the
    kernels on a CUDA tensor, the plain versions on a CPU one, where the
    result and the gradients are the former module's bits."""
    _refuse_dtensor(x, weight, bias)
    return _LayerNorm.apply(x, weight, bias, eps, out_dtype or x.dtype)


def add_layer_norm(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, *, eps: float = 1e-6,
                   out_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, layer_norm(s))`` with ``s = x + r``: the residual stream and
    its norm, as a pre-LN block's add and the next norm (XLA fuses that add
    into the norm in the reference). x and r share one dtype; the norm is
    :func:`layer_norm`'s. Differentiable in x, r, weight and bias; the
    folded kernels on a CUDA tensor, on a CPU one the bits of torch's add
    followed by :func:`layer_norm`, forward and backward."""
    _refuse_dtensor(x, r, weight, bias)
    return _AddLayerNorm.apply(x, r, weight, bias, eps, out_dtype or x.dtype)


__all__ = ["ADD_DESIGNS", "BWD_BLOCKS", "DESIGNS", "MAX_WIDTH", "SUM_ORDER",
           "add_layer_norm", "add_layer_norm_backward",
           "add_layer_norm_backward_reference", "add_layer_norm_forward",
           "add_layer_norm_reference", "backward_plan", "forward_plan",
           "layer_norm", "layer_norm_backward",
           "layer_norm_backward_reference", "layer_norm_forward",
           "layer_norm_reference", "layer_norm_tolerance"]
