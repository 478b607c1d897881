"""The LayerNorm kernels (``ops/csrc/layer_norm.cu``) against their plain
versions, on the card: GPT-2 small's ``[8192, 768]``, BERT-base's ``[4096,
768]``, ViT-B's ``[12608, 768]`` (b 64 x 197), the decode step's ``[8,
768]`` and the tiny widths 128 and 64, x in bf16 and f32, f32 and bf16
parameters, rows offset by +100: y, mean and rstd, then dx, dgamma and
dbeta within ``layer_norm_tolerance``; reruns bit-identical; a CUDA graph
capture of the forward and backward replayed equal to eager and counted
once a replay; widths whose lanes hold part of a chunk count (256, 512);
a strided row view (the prefill's last position) read in place; a dy
whose layout autograd picks (``LayerNorm(x).sum().backward()``); layouts
the kernels cannot read in place raise. The folded pair (the residual add
before the norm, ``add_layer_norm``) at the decode, GPT, BERT and ViT rows
and the tiny width: s the bits of torch's add, y, the statistics, dx (with
and without the residual stream's gradient), dgamma and dbeta within
``layer_norm_tolerance`` of the plain versions (dx with the bound of the
plain version's second rounding), reruns bit-identical, strided views of
the prefill's last position read in place, a captured folded forward and
backward replayed equal to eager and counted once a replay.

Needs a CUDA card and nvcc (the kernels have no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_layer_norm_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import importlib

import numpy as np
import pytest
import torch

from cron_operator_tpu_torch.models.layers import LayerNorm

ln = importlib.import_module("cron_operator_tpu_torch.ops.layer_norm")
fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

pytestmark = pytest.mark.cuda

CASE_TIMEOUT_S = 300  # as the other kernels' card tests: the build included
EPS = 1e-6
# (T, H): the main paths' rows and the tiny configs' widths
SHAPES = {"gpt": (8192, 768), "bert": (4096, 768), "vit": (12608, 768),
          "decode": (8, 768), "tiny_gpt": (2048, 128), "tiny_vit": (2048, 64)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _inputs(shape, dtype, device, param_dtype=torch.float32, seed=0,
            offset=0.0):
    """Seeded x (normal plus ``offset``), dy, gamma and beta."""
    t, h = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((t, h), np.float32) + offset)
    dy = torch.from_numpy(rng.standard_normal((t, h), np.float32))
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(h, np.float32))
    beta = torch.from_numpy(0.1 * rng.standard_normal(h, np.float32))
    return (x.to(device, dtype), dy.to(device, dtype),
            gamma.to(device, param_dtype), beta.to(device, param_dtype))


def _bits(t):
    kind = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.view(kind)


def _check_pair(x, dy, gamma, beta, out_dtype):
    """The kernels against the plain versions: within
    ``layer_norm_tolerance``, reruns the same bits."""
    y, mean, rstd = ln.layer_norm_forward(x, gamma, beta, EPS, out_dtype)
    dx, dgamma, dbeta = ln.layer_norm_backward(dy, x, mean, rstd, gamma,
                                               beta)
    torch.cuda.synchronize()
    ref_y, ref_mean, ref_rstd = ln.layer_norm_reference(x, gamma, beta, EPS,
                                                        out_dtype)
    ref = ln.layer_norm_backward_reference(dy, x, ref_mean, ref_rstd, gamma,
                                           beta)
    bounds = ln.layer_norm_tolerance(x, gamma, beta, ref_mean, ref_rstd,
                                     ref_y, dy, ref[0], ref[1])
    h = x.shape[-1]
    for name, got, want in (("y", y, ref_y), ("mean", mean, ref_mean),
                            ("rstd", rstd, ref_rstd), ("dx", dx, ref[0]),
                            ("dgamma", dgamma, ref[1]),
                            ("dbeta", dbeta, ref[2])):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert bool(torch.isfinite(got).all()), name
        err = (got.float() - want.float()).abs()
        if name in ("y", "dx"):
            err = err.reshape(-1, h)
        assert bool((err <= bounds[name]).all()), (
            name, float((err / bounds[name]).max()))
    again = ln.layer_norm_forward(x, gamma, beta, EPS, out_dtype)
    again_grads = ln.layer_norm_backward(dy, x, again[1], again[2], gamma,
                                         beta)
    for a, b in zip((y, mean, rstd, dx, dgamma, dbeta),
                    (*again, *again_grads)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_params", "bf16_params"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernels_match_the_plain_versions(cuda_device, shape, dtype,
                                          param_dtype):
    x, dy, gamma, beta = _inputs(SHAPES[shape], dtype, cuda_device,
                                 param_dtype)
    _check_pair(x, dy, gamma, beta, dtype)


@pytest.mark.parametrize("shape", ["gpt", "tiny_gpt", "tiny_vit"])
def test_offset_rows_stay_within_the_bounds(cuda_device, shape):
    """Rows near +100 (GroupNorm's mean-100 case): the variance from the
    centred squares loses nothing the bound does not admit; f32 x with a
    bf16 y too."""
    for dtype, out_dtype in ((torch.bfloat16, torch.bfloat16),
                             (torch.float32, torch.float32),
                             (torch.float32, torch.bfloat16)):
        x, dy, gamma, beta = _inputs(SHAPES[shape], dtype, cuda_device,
                                     seed=1, offset=100.0)
        _check_pair(x, dy.to(out_dtype), gamma, beta, out_dtype)


@pytest.mark.parametrize("h", [256, 512])
def test_widths_that_fill_part_of_a_plan(cuda_device, h):
    """256 fills 1 chunk a lane; 512 takes 3, each lane's last chunk past
    the row."""
    x, dy, gamma, beta = _inputs((64, h), torch.bfloat16, cuda_device,
                                 seed=2)
    _check_pair(x, dy, gamma, beta, torch.bfloat16)


def test_a_sum_after_the_norm_backpropagates(cuda_device):
    """``LayerNorm(x).sum().backward()`` hands the backward an expanded dy
    (stride 0), which it reads as rows: the gradients match the plain
    versions' on a dy of ones within the bounds."""
    x, _, gamma, beta = _inputs(SHAPES["bert"], torch.bfloat16, cuda_device,
                                seed=5)
    norm = LayerNorm(768, eps=EPS, compute_dtype=torch.bfloat16,
                     device=cuda_device)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
    xg = x.clone().requires_grad_()
    norm(xg).sum().backward()
    ones = torch.ones_like(x)
    _, mean, rstd = ln.layer_norm_reference(x, gamma, beta, EPS,
                                            torch.bfloat16)
    ref = ln.layer_norm_backward_reference(ones, x, mean, rstd, gamma, beta)
    y = ln.layer_norm_reference(x, gamma, beta, EPS, torch.bfloat16)[0]
    bounds = ln.layer_norm_tolerance(x, gamma, beta, mean, rstd, y, ones,
                                     ref[0], ref[1])
    for name, got, want in (("dx", xg.grad, ref[0]),
                            ("dgamma", norm.weight.grad, ref[1]),
                            ("dbeta", norm.bias.grad, ref[2])):
        err = (got.float() - want.float()).abs()
        assert bool((err <= bounds[name]).all()), (
            name, float((err / bounds[name]).max()))


def test_a_strided_row_view_is_read_in_place(cuda_device):
    """The prefill's ``ln_f(x[:, -1:])``: rows at a stride of s * H."""
    x, dy, gamma, beta = _inputs((8 * 16, 768), torch.bfloat16, cuda_device,
                                 seed=3)
    view = x.view(8, 16, 768)[:, -1:]
    y, mean, rstd = ln.layer_norm_forward(view, gamma, beta, EPS,
                                          torch.bfloat16)
    want = ln.layer_norm_forward(view.contiguous(), gamma, beta, EPS,
                                 torch.bfloat16)
    assert y.shape == view.shape
    for a, b in zip((y, mean, rstd), want):
        assert torch.equal(_bits(a), _bits(b))


def test_a_graph_capture_replays_equal_to_eager_and_counts(cuda_device):
    """The module's forward and backward captured as one CUDA graph: each
    replay gives eager's bits and counts one launch of each wrapper."""
    x, dy, gamma, beta = _inputs(SHAPES["bert"], torch.bfloat16, cuda_device,
                                 seed=4)
    norm = LayerNorm(768, eps=EPS, compute_dtype=torch.bfloat16,
                     device=cuda_device)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
    xg = x.clone().requires_grad_()

    def step():
        norm.weight.grad = norm.bias.grad = xg.grad = None
        out = norm(xg)
        out.backward(dy)
        return out

    want = step().detach().clone()
    want_grads = [t.grad.clone() for t in (xg, norm.weight, norm.bias)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()  # warm-up on the capture's stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with fa.capture_launches(stream.cuda_stream) as tally:
        with torch.cuda.graph(graph, stream=stream):
            out = step()
    before = (ln.layer_norm_forward.launches, ln.layer_norm_backward.launches)
    for _ in range(3):
        graph.replay()
    fa.count_replays(tally, 3)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(want))
    for t, w in zip((xg, norm.weight, norm.bias), want_grads):
        assert torch.equal(_bits(t.grad), _bits(w))
    assert (ln.layer_norm_forward.launches - before[0],
            ln.layer_norm_backward.launches - before[1]) == (3, 3)


@pytest.mark.parametrize("change", ["width", "strided", "transposed"])
def test_layouts_the_kernels_cannot_read_raise(cuda_device, change):
    gamma = torch.ones(768, device=cuda_device)
    x = torch.zeros(16, 768, dtype=torch.bfloat16, device=cuda_device)
    if change == "width":
        x, gamma = x[:, :100].contiguous(), gamma[:100].contiguous()
    elif change == "strided":
        x = torch.zeros(16, 772, dtype=torch.bfloat16,
                        device=cuda_device)[:, :768]
    else:
        x = torch.zeros(768, 16, dtype=torch.bfloat16, device=cuda_device).t()
    with pytest.raises(ValueError):
        ln.layer_norm_forward(x, gamma, torch.zeros_like(gamma), EPS,
                              torch.bfloat16)


def _check_folded(x, r, dy, ds, gamma, beta, out_dtype):
    """The folded kernels against their plain versions: s to the bit, the
    rest within ``layer_norm_tolerance`` (dx's bound grown by the plain
    version's rounding of the norm's dx before the add), reruns the same
    bits."""
    s, y, mean, rstd = ln.add_layer_norm_forward(x, r, gamma, beta, EPS,
                                                 out_dtype)
    grads = ln.add_layer_norm_backward(dy, ds, s, mean, rstd, gamma, beta)
    torch.cuda.synchronize()
    ref_s, ref_y, ref_mean, ref_rstd = ln.add_layer_norm_reference(
        x, r, gamma, beta, EPS, out_dtype)
    assert torch.equal(_bits(s), _bits(x + r))
    ref = ln.add_layer_norm_backward_reference(dy, ds, ref_s, ref_mean,
                                               ref_rstd, gamma, beta)
    dx_norm = ln.layer_norm_backward_reference(dy, ref_s, ref_mean, ref_rstd,
                                               gamma, beta)[0]
    bounds = ln.layer_norm_tolerance(ref_s, gamma, beta, ref_mean, ref_rstd,
                                     ref_y, dy, ref[0], ref[1],
                                     dx_norm=None if ds is None else dx_norm)
    h = x.shape[-1]
    for name, got, want in (("y", y, ref_y), ("mean", mean, ref_mean),
                            ("rstd", rstd, ref_rstd), ("dx", grads[0], ref[0]),
                            ("dgamma", grads[1], ref[1]),
                            ("dbeta", grads[2], ref[2])):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert bool(torch.isfinite(got).all()), name
        err = (got.float() - want.float()).abs()
        if name in ("y", "dx"):
            err = err.reshape(-1, h)
        assert bool((err <= bounds[name]).all()), (
            name, float((err / bounds[name]).max()))
    again = ln.add_layer_norm_forward(x, r, gamma, beta, EPS, out_dtype)
    again_grads = ln.add_layer_norm_backward(dy, ds, again[0], again[2],
                                             again[3], gamma, beta)
    for a, b in zip((s, y, mean, rstd, *grads), (*again, *again_grads)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("residual_grad", [True, False],
                         ids=["ds", "no_ds"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", ["decode", "gpt", "bert", "vit",
                                   "tiny_gpt"])
def test_folded_kernels_match_the_plain_versions(cuda_device, shape, dtype,
                                                 residual_grad):
    x, dy, gamma, beta = _inputs(SHAPES[shape], dtype, cuda_device, seed=6)
    r, ds, _, _ = _inputs(SHAPES[shape], dtype, cuda_device, seed=7)
    param_dtype = torch.bfloat16 if shape == "decode" else torch.float32
    _check_folded(x, r, dy, ds if residual_grad else None,
                  gamma.to(param_dtype), beta.to(param_dtype), dtype)


def test_folded_kernels_at_offset_rows(cuda_device):
    """A residual stream near +100 with a unit branch, f32 x with a bf16
    y too."""
    for dtype, out_dtype in ((torch.bfloat16, torch.bfloat16),
                             (torch.float32, torch.bfloat16)):
        x, dy, gamma, beta = _inputs(SHAPES["gpt"], dtype, cuda_device,
                                     seed=8, offset=100.0)
        r, ds, _, _ = _inputs(SHAPES["gpt"], dtype, cuda_device, seed=9)
        _check_folded(x, r, dy.to(out_dtype), ds, gamma, beta, out_dtype)


def test_folded_strided_views_are_read_in_place(cuda_device):
    """The prefill's ``ln_f(x[:, -1:] + r[:, -1:])``: both at a row stride
    of s * H."""
    x, r, gamma, beta = _inputs((8 * 16, 768), torch.bfloat16, cuda_device,
                                seed=10)
    xv, rv = (t.view(8, 16, 768)[:, -1:] for t in (x, r))
    got = ln.add_layer_norm_forward(xv, rv, gamma, beta, EPS, torch.bfloat16)
    want = ln.add_layer_norm_forward(xv.contiguous(), rv.contiguous(), gamma,
                                     beta, EPS, torch.bfloat16)
    assert got[0].shape == got[1].shape == xv.shape
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


def test_a_folded_capture_replays_equal_to_eager_and_counts(cuda_device):
    """``LayerNorm.add_norm`` forward and backward captured as one CUDA
    graph, s feeding a later op: each replay gives eager's bits and counts
    one launch of each folded wrapper and none of the unfolded ones."""
    x, r, gamma, beta = _inputs(SHAPES["bert"], torch.bfloat16, cuda_device,
                                seed=11)
    dy, dz, _, _ = _inputs(SHAPES["bert"], torch.bfloat16, cuda_device,
                           seed=12)
    norm = LayerNorm(768, eps=EPS, compute_dtype=torch.bfloat16,
                     device=cuda_device)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
    xg, rg = x.clone().requires_grad_(), r.clone().requires_grad_()

    def step():
        norm.weight.grad = norm.bias.grad = xg.grad = rg.grad = None
        s, y = norm.add_norm(xg, rg)
        torch.autograd.backward((s, y), (dz, dy))
        return s, y

    want = [t.detach().clone() for t in step()]
    want_grads = [t.grad.clone() for t in (xg, rg, norm.weight, norm.bias)]
    assert torch.equal(_bits(want_grads[0]), _bits(want_grads[1]))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()  # warm-up on the capture's stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with fa.capture_launches(stream.cuda_stream) as tally:
        with torch.cuda.graph(graph, stream=stream):
            out = step()
    wrappers = (ln.add_layer_norm_forward, ln.add_layer_norm_backward,
                ln.layer_norm_forward, ln.layer_norm_backward)
    before = [f.launches for f in wrappers]
    for _ in range(3):
        graph.replay()
    fa.count_replays(tally, 3)
    torch.cuda.synchronize()
    for a, b in zip(out, want):
        assert torch.equal(_bits(a), _bits(b))
    for t, w in zip((xg, rg, norm.weight, norm.bias), want_grads):
        assert torch.equal(_bits(t.grad), _bits(w))
    assert [f.launches - b for f, b in zip(wrappers, before)] == [3, 3, 0, 0]
