"""LayerNorm (``ops.layer_norm``) on the CPU.

The plain forward ``layer_norm_reference`` and backward
``layer_norm_backward_reference`` are what ``models/layers.py``
``LayerNorm.forward`` ran before the kernels (kept below as
``_former_forward``, verbatim) and what autograd ran through it: the two
agree to the bit, in bf16 and f32, at mean 0 and at rows offset by +100,
and so does the module, which now runs through the ``autograd.Function``;
a tiny GPT's loss, gradients and greedy tokens are the former module's
bits. The module matches flax's ``nn.LayerNorm(dtype=...)`` and
``jax.vjp`` of it on the same seeded numpy inputs within ``FLAX_ATOL``;
at rows offset by +100 flax's fast variance (E[x^2] - E[x]^2 in f32)
cancels, and both sides stay within the cancellation bound of the exact
f64 norm (the recorded divergence). ``layer_norm_tolerance`` admits an f64
evaluation of both passes and refuses a y three bf16 units in the last
place away. The dispatch: a CPU tensor never touches the kernel library, a
tensor on the card launches the kernel or raises (never the plain
version), a meta tensor gives the plain version's shapes (a FLOP count), a
DTensor at the wrapper raises and the module on a DTensor hands each
rank's own rows to the wrapper (the former bits on the CPU), and a layout
or width the kernels do not take is refused before anything is built. The
plans: one warp a row, to 768 values. The
kernels themselves run in
``tests/test_torch_layer_norm_cuda.py`` on the card.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from cron_operator_tpu_torch.models import GPT, GPTConfig
from cron_operator_tpu_torch.models.layers import LayerNorm

ln = importlib.import_module("cron_operator_tpu_torch.ops.layer_norm")
fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
serving = importlib.import_module("cron_operator_tpu_torch.workloads.generate")

EPS = 1e-6  # flax nn.LayerNorm's epsilon, as the port's models use
H = 128  # the tiny GPT's and BERT's width
# f32 sums over 128 terms (x, the centred squares, gamma dy x̂) in two
# orders, rsqrt against 1 / sqrt, and flax's E[x^2] - E[x]^2 against
# E[(x - E[x])^2] at unit spread: a few units of 2^-24 times the terms, far
# inside 2e-5 of a unit-scale result. dgamma and dbeta sum 2 x 6 rows more.
FLAX_ATOL = 2e-5


def _case(dtype=torch.float32, rows=(2, 6), h=H, seed=0, offset=0.0):
    """Seeded x, dy, gamma and beta, as numpy (f32) and torch (x and dy in
    ``dtype``, the parameters f32)."""
    rng = np.random.default_rng(seed)
    x = (offset + rng.standard_normal((*rows, h))).astype(np.float32)
    dy = rng.standard_normal((*rows, h)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(h)).astype(np.float32)
    # the numpy side sees the values the torch side holds
    tx, tdy = (torch.from_numpy(a).to(dtype) for a in (x, dy))
    x, dy = (t.float().numpy() for t in (tx, tdy))
    return (x, dy, gamma, beta), (tx, tdy, torch.from_numpy(gamma),
                                  torch.from_numpy(beta))


def _former_forward(self, x):
    """``LayerNorm.forward`` as it read before the kernels."""
    y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                     self.bias.float(), self.eps)
    return y.to(self.compute_dtype)


def _former_add_norm(self, x, r):
    """``LayerNorm.add_norm`` in the former blocks' terms: torch's add
    (the block's residual), then the former forward."""
    if r is not None:
        x = x + r
    return x, _former_forward(self, x)


def _module(gamma, beta, compute_dtype, param_dtype=torch.float32):
    norm = LayerNorm(gamma.shape[0], eps=EPS, compute_dtype=compute_dtype,
                     param_dtype=param_dtype)
    norm.load_state_dict({"weight": gamma, "bias": beta})
    return norm


@pytest.mark.parametrize("offset", [0.0, 100.0])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_forward_is_the_former_module_to_the_bit(dtype, out_dtype,
                                                       offset):
    _, (x, _, gamma, beta) = _case(dtype, offset=offset)
    norm = _module(gamma, beta, out_dtype)
    with torch.no_grad():
        want = _former_forward(norm, x)
        y, mean, rstd = ln.layer_norm_reference(x, gamma, beta, EPS,
                                                out_dtype)
        assert y.dtype == out_dtype and torch.equal(y, want)
        assert mean.shape == rstd.shape == (12,)
        assert mean.dtype == rstd.dtype == torch.float32
        assert torch.equal(norm(x), want)


@pytest.mark.parametrize("offset", [0.0, 100.0])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_is_the_former_autograd_to_the_bit(dtype, param_dtype,
                                                          offset):
    """The former module's autograd graph (the cast of y, the f32 norm, the
    casts of x and the parameters) against the plain backward and against
    the module through the Function, for x, weight and bias."""
    _, (x, dy, gamma, beta) = _case(dtype, seed=1, offset=offset)
    grads = []
    for forward in (_former_forward, LayerNorm.forward):
        norm = _module(gamma, beta, dtype, param_dtype)
        xg = x.clone().requires_grad_()
        forward(norm, xg).backward(dy)
        grads.append((xg.grad, norm.weight.grad, norm.bias.grad))
    norm = _module(gamma, beta, dtype, param_dtype)
    with torch.no_grad():
        _, mean, rstd = ln.layer_norm_reference(x, norm.weight, norm.bias,
                                                EPS, dtype)
    grads.append(ln.layer_norm_backward_reference(dy, x, mean, rstd,
                                                  norm.weight, norm.bias))
    for got in grads[1:]:
        for g, w, dt in zip(got, grads[0], (dtype, param_dtype, param_dtype)):
            assert g.dtype == w.dtype == dt and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_module_matches_flax_and_its_vjp(dtype):
    """flax ``nn.LayerNorm(epsilon, dtype)`` on the same x, scale and bias,
    y and ``jax.vjp``'s gradients (in f32), against the module: f32
    arithmetic in other orders, and in bf16 one rounding flip of y at
    most."""
    (x, dy, gamma, beta), (tx, tdy, tgamma, tbeta) = _case(dtype, seed=2)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    norm = fnn.LayerNorm(epsilon=EPS, dtype=jdt)
    params = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    jx = jnp.asarray(x).astype(jdt)
    out, vjp = jax.vjp(lambda p, xx: norm.apply({"params": p}, xx), params,
                       jx)
    module = _module(tgamma, tbeta, dtype)
    txg = tx.clone().requires_grad_()
    y = module(txg)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    want = np.asarray(out.astype(jnp.float32))
    np.testing.assert_array_less(
        np.abs(y.detach().float().numpy() - want),
        FLAX_ATOL + ulp * np.abs(want))
    if dtype == torch.float32:
        dparams, dx = vjp(jnp.asarray(dy))
        y.backward(tdy)
        np.testing.assert_allclose(txg.grad.numpy(), np.asarray(dx), rtol=0,
                                   atol=FLAX_ATOL)
        for got, key in ((module.weight.grad, "scale"),
                         (module.bias.grad, "bias")):
            np.testing.assert_allclose(got.numpy(), np.asarray(dparams[key]),
                                       rtol=0, atol=FLAX_ATOL * 12)


def test_offset_rows_keep_within_the_variance_gap_bound():
    """The recorded divergence: flax computes a row's variance as E[x^2] -
    E[x]^2 in f32 (``use_fast_variance``), which cancels when the mean is
    large beside the spread; the port (the plain version here, the kernel
    on the card) takes the centred squares. At mean 100 and std 1 over
    rows of n = 128 values each side stays within the cancellation bound
    of the exact f64 norm: a sum of n f32 terms of size E[x^2] is off by up
    to n 2^-24 E[x^2], which moves the variance by that much relative to
    itself, and the output by half that times its largest |x - mean| / std
    and |gamma|. flax lands off the exact norm; the port far closer."""
    (x, _, gamma, beta), (tx, _, tgamma, tbeta) = _case(seed=3, offset=100.0)
    flax_y = np.asarray(fnn.LayerNorm(epsilon=EPS, dtype=jnp.float32).apply(
        {"params": {"scale": gamma, "bias": beta}}, jnp.asarray(x)))
    with torch.no_grad():
        port_y = _module(tgamma, tbeta, torch.float32)(tx).numpy()
    x64 = x.astype(np.float64)
    mean = x64.mean(-1, keepdims=True)
    var = x64.var(-1, keepdims=True)
    z = (x64 - mean) / np.sqrt(var + EPS)
    exact = z * gamma + beta
    rel_var = H * 2.0 ** -24 * float(((x64 ** 2).mean(-1) / var[..., 0]).max())
    bound = rel_var / 2 * float(np.abs(z).max()) * float(np.abs(gamma).max())
    flax_gap = float(np.abs(flax_y - exact).max())
    port_gap = float(np.abs(port_y - exact).max())
    assert 0 < flax_gap <= bound
    assert port_gap <= bound and port_gap < flax_gap


@pytest.mark.parametrize("offset", [0.0, 100.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerance_admits_an_f64_evaluation_and_refuses_three_ulps(dtype,
                                                                    offset):
    """The bounds hold the plain version against an f64 evaluation of the
    same function (rounded to the same dtypes): a kernel as accurate as f64
    arithmetic passes. Three bf16 units in the last place of y do not."""
    _, (x, dy, gamma, beta) = _case(dtype, seed=4, offset=offset)
    y, mean, rstd = ln.layer_norm_reference(x, gamma, beta, EPS, dtype)
    dx, dgamma, dbeta = ln.layer_norm_backward_reference(dy, x, mean, rstd,
                                                         gamma, beta)
    bounds = ln.layer_norm_tolerance(x, gamma, beta, mean, rstd, y, dy, dx,
                                     dgamma)
    x64, g64, b64 = x.double(), gamma.double(), beta.double()
    y64, mean64, rstd64 = torch.native_layer_norm(x64, [H], g64, b64, EPS)
    dx64, dgamma64, dbeta64 = torch.ops.aten.native_layer_norm_backward(
        dy.double(), x64, [H], mean64, rstd64, g64, b64, [True] * 3)
    got = {"y": y64.to(dtype), "mean": mean64.reshape(-1),
           "rstd": rstd64.reshape(-1), "dx": dx64.to(dtype),
           "dgamma": dgamma64, "dbeta": dbeta64}
    want = {"y": y, "mean": mean, "rstd": rstd, "dx": dx, "dgamma": dgamma,
            "dbeta": dbeta}
    for key, ref in want.items():
        err = (got[key].double() - ref.double()).abs().reshape(
            bounds[key].shape)
        assert bool((err <= bounds[key]).all()), key
    three_ulps = 3 * 2.0 ** -7 * y.float().abs().reshape(-1, H)
    assert not bool((three_ulps <= bounds["y"]).all())


def test_function_saves_x_in_its_own_dtype():
    _, (x, dy, gamma, beta) = _case(torch.bfloat16, seed=5)
    norm = _module(gamma, beta, torch.bfloat16)
    x = x.requires_grad_()
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = norm(x)
    assert y.dtype == torch.bfloat16
    assert (torch.float32, tuple(x.shape)) not in saved  # no f32 copy of x
    assert (torch.bfloat16, tuple(x.shape)) in saved
    assert (torch.float32, (12,)) in saved  # mean and rstd
    y.backward(dy)
    assert x.grad.dtype == torch.bfloat16
    assert norm.weight.grad.dtype == norm.bias.grad.dtype == torch.float32


def _tiny_gpt(seed=0):
    model = GPT(GPTConfig.tiny(max_len=64, dtype=torch.float32))
    return model.init_weights(torch.Generator().manual_seed(seed))


def test_tiny_gpt_is_the_former_modules_bits(monkeypatch):
    """A tiny GPT's logits, the gradients of its loss and its greedy tokens
    with the module as it is (the residual adds folded into the norms) and
    with the former forward and torch's adds swapped in."""
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, 1024, (2, 16)))
    prompt = ids[:, :8]
    runs = []
    for former in (False, True):
        if former:
            monkeypatch.setattr(LayerNorm, "forward", _former_forward)
            monkeypatch.setattr(LayerNorm, "add_norm", _former_add_norm)
        model = _tiny_gpt()
        logits = model(ids)
        F.cross_entropy(logits[:, :-1].reshape(-1, 1024),
                        ids[:, 1:].reshape(-1)).backward()
        with torch.no_grad():
            tokens = serving.generate(model.config, model, prompt, 8,
                                      captured=False)
        runs.append((logits.detach(), [p.grad for p in model.parameters()],
                     tokens))
    (logits, grads, tokens), (f_logits, f_grads, f_tokens) = runs
    assert torch.equal(logits, f_logits) and torch.equal(tokens, f_tokens)
    assert all(torch.equal(a, b) for a, b in zip(grads, f_grads))


def test_cpu_tensor_never_touches_the_kernel_library(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(ln, "_lib", None)
    monkeypatch.setattr(ln._build, "load", no_build)
    for fn in (ln.layer_norm_forward, ln.layer_norm_backward):
        monkeypatch.setattr(fn, "launches", 0)
    _, (x, dy, gamma, beta) = _case(torch.bfloat16, seed=7)
    norm = _module(gamma, beta, torch.bfloat16)
    x = x.requires_grad_()
    norm(x).backward(dy)
    assert x.grad is not None and norm.weight.grad is not None
    assert ln.layer_norm_forward.launches == 0
    assert ln.layer_norm_backward.launches == 0


class _OnTheCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: what the wrapper
    sees on a machine whose card cannot be reached."""

    @property
    def is_cuda(self):
        return True


def test_a_cuda_tensor_raises_rather_than_falling_back(monkeypatch):
    def no_card(name):
        raise RuntimeError(f"cannot build {name}: no CUDA toolkit or card")

    monkeypatch.setattr(ln, "_lib", None)
    monkeypatch.setattr(ln._build, "load", no_card)
    for name in ("layer_norm_reference", "layer_norm_backward_reference"):
        monkeypatch.setattr(ln, name, lambda *a: pytest.fail(
            "fell back to the plain version"))
    monkeypatch.setattr(ln.layer_norm_forward, "launches", 0)
    _, (x, dy, gamma, beta) = _case(torch.bfloat16)
    mean = torch.zeros(12)
    with pytest.raises(RuntimeError, match="no CUDA toolkit or card"):
        ln.layer_norm_forward(x.as_subclass(_OnTheCard), gamma, beta, EPS,
                              torch.bfloat16)
    with pytest.raises(RuntimeError, match="no CUDA toolkit or card"):
        ln.layer_norm_backward(dy, x.as_subclass(_OnTheCard), mean, mean,
                               gamma, beta)
    assert ln.layer_norm_forward.launches == 0


def test_meta_tensors_take_the_plain_shapes_for_a_flop_count():
    """``Trainer.flops_per_step`` runs the model on the meta device."""
    x = torch.empty(2, 6, H, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    p = torch.empty(H, device="meta", requires_grad=True)
    q = torch.empty(H, device="meta", requires_grad=True)
    y = ln.layer_norm(x, p, q, out_dtype=torch.bfloat16)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    y.backward(torch.empty_like(y))
    assert x.grad.shape == x.shape and x.grad.dtype == torch.bfloat16
    assert p.grad.shape == q.grad.shape == (H,)


@pytest.fixture
def one_rank_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("tensor",))
    finally:
        dist.destroy_process_group()


def test_a_dtensor_raises(one_rank_mesh):
    _, (x, dy, gamma, beta) = _case()
    placed = distribute_tensor(x, one_rank_mesh, [Replicate()])
    with pytest.raises(TypeError, match="not DTensors"):
        ln.layer_norm(placed, gamma, beta)
    with pytest.raises(TypeError, match="not DTensors"):
        ln.layer_norm_forward(placed, gamma, beta, EPS, torch.float32)
    with pytest.raises(TypeError, match="not DTensors"):
        ln.layer_norm_backward(dy, placed, gamma, gamma, gamma, beta)


@pytest.mark.parametrize("placement", [Replicate(), Shard(0), Shard(1),
                                       Shard(2)],
                         ids=["replicate", "rows", "seq", "features"])
def test_the_module_on_a_dtensor_keeps_the_former_arithmetic(
        one_rank_mesh, monkeypatch, placement):
    """A mesh that places DTensors (``tensor``, ``expert``, ``seq``) hands
    each rank's own rows to the wrapper as plain tensors (``on_own_rows``),
    so the result keeps x's layout of rows (a split of the features, which
    no mesh makes, becomes a replica), and on the CPU the plain version
    gives the former module's bits, forward and backward."""
    _, (x, dy, gamma, beta) = _case(torch.bfloat16, seed=8)
    layers = importlib.import_module("cron_operator_tpu_torch.models.layers")
    former = _module(gamma, beta, torch.bfloat16)
    xf = x.clone().requires_grad_()
    want = _former_forward(former, xf)
    want.backward(dy)
    seen = []

    def spy(*args, **kw):
        seen.append([type(a) for a in args[:3]])
        return ln.layer_norm(*args, **kw)

    monkeypatch.setattr(layers, "layer_norm", spy)
    norm = _module(gamma, beta, torch.bfloat16)
    for name in ("weight", "bias"):
        placed = distribute_tensor(getattr(norm, name).detach(),
                                   one_rank_mesh, [Replicate()])
        setattr(norm, name, torch.nn.Parameter(placed))
    xd = distribute_tensor(x, one_rank_mesh, [placement]).requires_grad_()
    got = norm(xd)
    got.backward(distribute_tensor(dy, one_rank_mesh, got.placements))
    assert seen == [[torch.Tensor] * 3]
    rows = Replicate() if placement == Shard(2) else placement
    assert got.placements == (rows,) and got.shape == x.shape
    assert torch.equal(got.full_tensor(), want)
    assert torch.equal(xd.grad.full_tensor(), xf.grad)
    assert torch.equal(norm.weight.grad.full_tensor(), former.weight.grad)
    assert torch.equal(norm.bias.grad.full_tensor(), former.bias.grad)


@pytest.mark.parametrize("change, match", [
    (dict(h=100), "multiple of 8"),
    (dict(h=776), "at most 768"),
    (dict(h=1024), "at most 768"),
    (dict(h=2048), "at most 768"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(strided=True), "16-byte vectors"),
    (dict(unaligned=True), "16-byte"),
    (dict(transposed=True), "multiple of 8 at one stride"),
    (dict(gamma=64), r"gamma and beta must be contiguous"),
    (dict(beta_dtype=torch.bfloat16), "share one dtype"),
    (dict(out_dtype=torch.float16), "out_dtype"),
])
def test_refused_inputs_raise_before_any_build(monkeypatch, change, match):
    """What the kernels cannot read in place raises ValueError on the card
    path's checks, before the library is built: a width that is not a
    multiple of 8 or is past the widest a warp holds, a dtype they do not
    take, rows at a stride of a partial 16-byte vector or at an unaligned
    address, a transposed layout, parameters of another width or of mixed
    dtypes."""
    def no_build(name):
        raise AssertionError(f"built {name} for refused inputs")

    monkeypatch.setattr(ln, "_lib", None)
    monkeypatch.setattr(ln._build, "load", no_build)
    h, dtype = change.get("h", H), change.get("dtype", torch.bfloat16)
    x = torch.zeros(4, h, dtype=dtype)
    if change.get("strided"):
        x = torch.zeros(4, h + 4, dtype=dtype)[:, :h]  # a stride of 132
    if change.get("unaligned"):
        x = torch.zeros(4 * h + 1, dtype=dtype)[1:].view(4, h)
    if change.get("transposed"):
        x = torch.zeros(h, 4, dtype=dtype).t()
    gamma = torch.ones(change.get("gamma", h))
    beta = torch.zeros(h, dtype=change.get("beta_dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        ln._launch_forward(x, gamma, beta, EPS,
                           change.get("out_dtype", torch.bfloat16))


def test_a_width_not_a_multiple_of_8_raises_on_the_backward_too(monkeypatch):
    monkeypatch.setattr(ln, "_lib", None)
    monkeypatch.setattr(ln._build, "load", lambda name: pytest.fail("built"))
    x = torch.zeros(4, 60, dtype=torch.bfloat16)
    stats = torch.zeros(4)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln._launch_backward(x, x, stats, stats, torch.ones(60),
                            torch.zeros(60))


@pytest.mark.parametrize("h, chunks", [
    (64, 1), (128, 1), (256, 1), (264, 3), (512, 3), (768, 3),
])
def test_plans_by_width(h, chunks):
    """One warp a row: 1 chunk of 8 a lane to 256 values (the tiny configs'
    128 and 64), 3 to 768 (GPT-2 small's, BERT-base's and ViT-B's);
    the backward's grid walks the rows in at most ``BWD_BLOCKS`` blocks."""
    fwd = ln.forward_plan(8192, h)
    assert fwd == {"design": "warp", "chunks": chunks, "grid": 1024}
    assert ln.backward_plan(8192, h) == {**fwd, "grid": ln.BWD_BLOCKS}
    assert chunks * 8 * 32 >= h
    assert ln.backward_plan(8, h)["grid"] == 1


def test_launches_count_once_per_replay():
    """A launch recorded by a graph capture counts once per replay, under
    its design, as the other kernels' wrappers."""
    fwd, bwd = ln.layer_norm_forward, ln.layer_norm_backward
    assert fwd.launches_by_design.keys() == bwd.launches_by_design.keys() \
        == set(ln.DESIGNS)
    before = (fwd.launches, fwd.launches_by_design["warp"], bwd.launches)
    with fa.capture_launches(12345) as tally:
        fa._count(fwd, "warp", 12345)
        fa._count(bwd, "warp", 12345)
    assert (fwd.launches, bwd.launches) == (before[0], before[2])
    fa.count_replays(tally, 3)
    assert fwd.launches == before[0] + 3 and bwd.launches == before[2] + 3
    assert fwd.launches_by_design["warp"] == before[1] + 3
