"""The port's ResNet and MLP against the JAX package's, from the same weights.

Flax modules are initialised, their parameters go through
``models/convert.py`` into the port's, and both run the same seeded numpy
NHWC images in f32 on the CPU: a single conv under flax's ``"SAME"``
padding at odd and even sizes and strides 1 and 2, GroupNorm, ResNet-18
(logits and grads), a narrow ResNet-50 at image 80 (its stage-4 conv
strides a 5x5 map), SGD steps through both Trainers, and the MLP. The
numpy image streams give the JAX package's arrays. The blocks' relus and
residual adds run in the GroupNorms' epilogues: a narrow ResNet-18 keeps
its parameter names and gives the former block sequence's logits and
gradients to the bit, and its norms and ResNet-50's run the epilogues
counted a step (33 relu, 16 residual, 4 plain norms forward in ResNet-50;
33 masked backward).
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cron_operator_tpu.models.mlp import MLP as JaxMLP
from cron_operator_tpu.models.resnet import ResNet18 as JaxResNet18
from cron_operator_tpu.models.resnet import ResNet50 as JaxResNet50
from cron_operator_tpu.parallel.mesh import mesh_for_devices
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu.workloads.train import cross_entropy_loss as jax_xent
from cron_operator_tpu_torch.models import MLP, ResNet18, ResNet50
from cron_operator_tpu_torch.models.convert import (
    flax_rank,
    mlp_params_from_flax,
    resnet_params_from_flax,
)
from cron_operator_tpu_torch.models.layers import Conv2d, GroupNorm, same_padding
from cron_operator_tpu_torch.ops import group_norm as gn_ops
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

# f32 logits through up to 50 conv/GroupNorm layers: summation order only
# (at most 1.2e-5 apart in these runs, against logits of magnitude 2-3).
LOGIT_ATOL = 1e-4
GRAD_RTOL = 1e-4  # of each parameter's largest gradient
LOSS_ATOL = 5e-5  # per step, as tests/test_torch_train.py


def _images(b, size, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, size, size, channels), dtype=np.float32)


def _init(module, x, jit=True):
    """The flax init's params as numpy (jitted: a whole network's init
    compiles faster than it runs op by op)."""
    init = jax.jit(module.init) if jit else module.init
    params = init(jax.random.PRNGKey(0), x)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ------------------------------------------------------------- one conv


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3])
def test_conv_same_padding_matches_flax(size, stride, kernel):
    x = _images(2, size, channels=5)
    conv = fnn.Conv(6, (kernel, kernel), (stride, stride), use_bias=False,
                    dtype=jnp.float32)
    params = _init(conv, x, jit=False)
    ref = conv.apply({"params": params}, x)
    ours = Conv2d(5, 6, kernel, stride, compute_dtype=torch.float32)
    ours.weight.data.copy_(
        torch.tensor(params["kernel"].transpose(3, 2, 0, 1)))
    out = ours(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    assert _err(out.detach(), ref) < 1e-5


def test_same_padding_is_flax_rule():
    """(0, 1) on an even map under a stride-2 3x3, (1, 1) on an odd one,
    nothing for a stride-2 1x1, as lax computes "SAME"."""
    assert same_padding(8, 3, 2) == (0, 1)
    assert same_padding(5, 3, 2) == (1, 1)
    assert same_padding(8, 1, 2) == same_padding(5, 1, 2) == (0, 0)
    for size in range(1, 12):
        for kernel in (1, 3, 7, 16):
            for stride in (1, 2, 16):
                want = lax.padtype_to_pads((size,), (kernel,), (stride,),
                                           "SAME")[0]
                assert same_padding(size, kernel, stride) == tuple(want)


def test_explicit_stem_padding_matches_flax():
    x = _images(2, 9)
    conv = fnn.Conv(4, (7, 7), (2, 2), padding=[(3, 3), (3, 3)],
                    use_bias=False, dtype=jnp.float32)
    params = _init(conv, x, jit=False)
    ours = Conv2d(3, 4, 7, 2, padding=((3, 3), (3, 3)),
                  compute_dtype=torch.float32)
    ours.weight.data.copy_(
        torch.tensor(params["kernel"].transpose(3, 2, 0, 1)))
    out = ours(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _err(out.detach(), conv.apply({"params": params}, x)) < 1e-5


def test_conv_weight_is_channels_last_and_keeps_it_through_loading():
    conv = Conv2d(8, 16, 3, compute_dtype=torch.float32)
    conv.load_state_dict({"weight": torch.randn(16, 8, 3, 3)})
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)


# ------------------------------------------------------------ GroupNorm


def _group_norm_pair(x):
    gn = fnn.GroupNorm(dtype=jnp.float32)
    params = _init(gn, x, jit=False)
    rng = np.random.default_rng(4)
    params = {k: v + 0.1 * rng.standard_normal(v.shape, np.float32)
              for k, v in params.items()}
    ours = GroupNorm(x.shape[-1], compute_dtype=torch.float32)
    ours.load_state_dict({"weight": torch.tensor(params["scale"]),
                          "bias": torch.tensor(params["bias"])})
    out = ours(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return (out.detach().numpy(), np.asarray(gn.apply({"params": params}, x)),
            params)


def test_group_norm_matches_flax():
    x = _images(2, 6, channels=64)
    out, ref, _ = _group_norm_pair(x)
    assert _err(out, ref) < 1e-5


def test_group_norm_variance_gap_is_bounded():
    """flax computes a group's variance as E[x^2] - E[x]^2 in f32
    (``use_fast_variance``), which cancels when the mean is large beside
    the spread; ``F.group_norm`` computes E[(x - E[x])^2] on the card
    (Welford). At mean 100 and std 1 over groups of n = 72 values, each
    side stays within the cancellation bound of the exact f64 result: a
    sum of n f32 terms of size E[x^2] is off by up to n * 2^-24 * E[x^2],
    which moves the variance by that much relative to itself, and the
    output by half that relative error times its largest |x - mean|/std."""
    x = 100.0 + _images(2, 6, channels=64, seed=5)
    out, flax_out, params = _group_norm_pair(x)
    g = x.astype(np.float64).reshape(2, 36, 32, 2)
    mean = g.mean((1, 3), keepdims=True)
    var = g.var((1, 3), keepdims=True)
    z = ((g - mean) / np.sqrt(var + 1e-6)).reshape(x.shape)
    exact = z * params["scale"] + params["bias"]
    n = 36 * 2
    rel_var = n * 2.0 ** -24 * float(((g ** 2).mean((1, 3)) / var[:, 0, :, 0]).max())
    bound = rel_var / 2 * float(np.abs(z).max()) * float(
        np.abs(params["scale"]).max())
    assert 0 < _err(flax_out, exact) <= bound
    assert _err(out, exact) <= bound


def test_group_norm_rounds_to_the_compute_dtype():
    gn = GroupNorm(64, compute_dtype=torch.bfloat16)
    x = torch.randn(2, 64, 4, 4, dtype=torch.bfloat16)
    y = gn(x)
    assert y.dtype == torch.bfloat16 and gn.weight.dtype == torch.float32
    want = torch.nn.functional.group_norm(x.float(), 32, eps=1e-6)
    assert (y.float() - want).abs().max().item() <= 2 ** -8 * 4


# ----------------------------------------------------------------- ResNet


def _resnet_pair(jax_cls, port_cls, size, **kw):
    x = _images(2, size)
    jmodel = jax_cls(num_classes=10, dtype=jnp.float32, **kw)
    params = _init(jmodel, x)
    model = port_cls(num_classes=10, dtype=torch.float32, **kw)
    model.load_state_dict(resnet_params_from_flax(params, model))
    return x, jmodel, params, model


@pytest.fixture(scope="module")
def resnet18_pair():
    """ResNet-18 at image 32 (maps 16, 8, 4, 2, 1): the flax init, which
    takes most of this file's time, runs once."""
    return _resnet_pair(JaxResNet18, ResNet18, 32)


def test_resnet18_logits_and_grads_match_jax(resnet18_pair):
    x, jmodel, params, model = resnet18_pair
    model.zero_grad()
    labels = np.array([3, 7], np.int32)

    def loss(p):
        return jax_xent(jmodel.apply({"params": p}, x), labels)

    ref_logits = jax.jit(jmodel.apply)({"params": params}, x)
    ref_grads = resnet_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)),
        model)
    logits = model(torch.tensor(x))
    assert logits.dtype == torch.float32 and logits.shape == (2, 10)
    assert _err(logits.detach(), ref_logits) < LOGIT_ATOL
    torch.nn.functional.cross_entropy(logits, torch.tensor(labels).long()
                                      ).backward()
    for name, p in model.named_parameters():
        ref = ref_grads[name]
        scale = ref.abs().max().item() or 1.0
        assert (p.grad - ref).abs().max().item() <= GRAD_RTOL * scale, name


def test_resnet50_narrow_at_image_80_matches_jax():
    """Width 32 (GroupNorm needs 32 groups) at image 80: maps of 40, 20,
    10, 5 and 3, so a stride-2 3x3 runs on the odd 5x5 map (pads (1, 1))
    as well as on even ones (pads (0, 1))."""
    x, jmodel, params, model = _resnet_pair(JaxResNet50, ResNet50, 80,
                                            width=32)
    with torch.no_grad():
        out = model(torch.tensor(x))
    ref = jax.jit(jmodel.apply)({"params": params}, x)
    assert _err(out, ref) < LOGIT_ATOL


def test_resnet50_parameter_count():
    """25,557,032, as the JAX ResNet50 (read by shape, not built)."""
    shapes = jax.eval_shape(
        JaxResNet50().init, jax.random.PRNGKey(0),
        jnp.zeros((1, 224, 224, 3)))["params"]
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes))
    model = ResNet50(device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_jax == 25_557_032
    assert all(flax_rank(n, p) == p.ndim for n, p in model.named_parameters())


def _jax_losses(apply_fn, params, batches, steps, **train_kw):
    trainer = JaxTrainer(
        apply_fn, params, mesh_for_devices(jax.devices("cpu")[:1]),
        JaxTrainConfig(steps_per_call=1, stage_async=False, **train_kw),
    )
    return [s.loss for s in trainer.run(batches, steps)]


def test_resnet18_sgd_steps_match_the_jax_trainer(resnet18_pair):
    _, jmodel, params, _ = resnet18_pair
    model = ResNet18(num_classes=10, dtype=torch.float32)
    model.load_state_dict(resnet_params_from_flax(params, model))
    kw = dict(optimizer="sgd", learning_rate=0.1)
    want = _jax_losses(lambda p, x: jmodel.apply({"params": p}, x), params,
                       jax_data.imagenet_batches(2, 32, 10), 3, **kw)
    stats = Trainer(model, TrainConfig(**kw)).run(
        data.imagenet_batches(2, 32, 10), 3)
    got = [s.loss for s in stats]
    assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_ATOL, (got, want)


# ------------------------------------------ the norms' fused epilogues


def _former_forward(model, images):
    """``ResNet.forward`` as it ran before the epilogues were fused: each
    norm, then ``F.relu``, and ``F.relu(residual + y)`` at a block's end."""
    F = torch.nn.functional
    x = images.permute(0, 3, 1, 2).to(model.dtype)
    x = F.relu(model.stem_norm(model.stem(x)))
    x = F.max_pool2d(x, 3, 2, 1)
    for block in model.blocks:
        y = x
        for i in range(block.n_main):
            y = block.norms[i](block.convs[i](y))
            if i < block.n_main - 1:
                y = F.relu(y)
        residual = x
        if len(block.convs) > block.n_main:
            residual = block.norms[-1](block.convs[-1](x))
        x = F.relu(residual + y)
    return model.head(x.mean((2, 3))).float()


def _narrow_resnet18(dtype):
    """ResNet-18 at width 32 (the narrowest that 32 groups take) from seed
    0, with non-trivial norm parameters."""
    model = ResNet18(num_classes=10, width=32, dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def test_resnet18_parameter_names_are_unchanged():
    names = list(_narrow_resnet18(torch.float32).state_dict())
    blocks = []
    for j in range(8):
        n = 3 if j in (2, 4, 6) else 2  # stages 2-4 open with a shortcut
        blocks += [f"blocks.{j}.convs.{i}.weight" for i in range(n)]
        blocks += [f"blocks.{j}.norms.{i}.{k}" for i in range(n)
                   for k in ("weight", "bias")]
    assert sorted(names) == sorted(
        ["stem.weight", "stem_norm.weight", "stem_norm.bias", *blocks,
         "head.weight", "head.bias"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_resnet18_fused_epilogues_equal_the_former_blocks(dtype):
    """Logits and the gradients of every parameter and of the images, the
    same bits through the fused epilogues as through the former sequence.
    In bf16 the convolutions' weight gradients are left out: oneDNN's bf16
    weight gradient on the CPU differs from run to run of one sequence
    (seen at stage 4's first conv), so it cannot be held to bits; f32 holds
    them all."""
    model = _narrow_resnet18(dtype)
    images = torch.tensor(_images(2, 16))
    runs = []
    for forward in (_former_forward, lambda m, x: m(x)):
        model.zero_grad(set_to_none=True)
        x = images.clone().requires_grad_()
        logits = forward(model, x)
        torch.nn.functional.cross_entropy(
            logits, torch.tensor([3, 7])).backward()
        runs.append((logits.detach(), x.grad, {
            n: p.grad for n, p in model.named_parameters()
            if dtype == torch.float32 or "convs" not in n and n != "stem.weight"}))
    (want_logits, want_dx, want), (logits, dx, got) = runs
    assert torch.equal(logits, want_logits) and torch.equal(dx, want_dx)
    assert got.keys() == want.keys() and len(got) >= 41
    for name in want:
        assert torch.equal(got[name], want[name]), name


def _count_epilogues(monkeypatch, model, images):
    """The forward's epilogues and the backward's masks that one forward and
    backward of ``model`` asks of the GroupNorm wrappers."""
    forward, backward = {}, {}
    fwd, bwd = gn_ops.group_norm_forward, gn_ops.group_norm_backward

    def spy_fwd(x, weight, bias, groups, eps, out_dtype, relu=False,
                residual=None):
        key = ("residual_relu" if residual is not None
               else "relu" if relu else "none")
        forward[key] = forward.get(key, 0) + 1
        return fwd(x, weight, bias, groups, eps, out_dtype, relu, residual)

    def spy_bwd(*args):
        key = "relu" if args[6] else "none"
        backward[key] = backward.get(key, 0) + 1
        return bwd(*args)

    monkeypatch.setattr(gn_ops, "group_norm_forward", spy_fwd)
    monkeypatch.setattr(gn_ops, "group_norm_backward", spy_bwd)
    model(images).sum().backward()
    return forward, backward


def test_resnet_epilogue_counts_a_step(monkeypatch):
    """ResNet-50 (on the meta device, as a FLOP count runs it): the stem's
    and each block's two inner norms with a relu (33), each block's last
    with its residual (16), the 4 shortcuts plain; backward the 33 relus
    masked in the norm. ResNet-18: 9, 8 and 3, then 9 masked."""
    counts = _count_epilogues(monkeypatch, ResNet50(device="meta"),
                              torch.empty(1, 32, 32, 3, device="meta"))
    assert counts == ({"relu": 33, "residual_relu": 16, "none": 4},
                      {"relu": 33, "none": 20})
    counts = _count_epilogues(monkeypatch, _narrow_resnet18(torch.float32),
                              torch.tensor(_images(1, 16)))
    assert counts == ({"relu": 9, "residual_relu": 8, "none": 3},
                      {"relu": 9, "none": 11})


# ------------------------------------------------------------------- MLP


def _mlp_pair():
    x = _images(4, 28, channels=1)
    jmodel = JaxMLP(dtype=jnp.float32)
    params = _init(jmodel, x)
    model = MLP(dtype=torch.float32)
    model.load_state_dict(mlp_params_from_flax(params))
    return x, jmodel, params, model


def test_mlp_logits_match_jax():
    x, jmodel, params, model = _mlp_pair()
    with torch.no_grad():
        out = model(torch.tensor(x))
    assert out.shape == (4, 10)
    assert _err(out, jmodel.apply({"params": params}, x)) < 1e-5
    assert sum(p.numel() for p in MLP().parameters()) == 535_818


def test_mlp_twenty_sgd_steps_match_the_jax_trainer():
    _, jmodel, params, model = _mlp_pair()
    kw = dict(optimizer="sgd", learning_rate=0.01)
    want = _jax_losses(lambda p, x: jmodel.apply({"params": p}, x), params,
                       jax_data.mnist_batches(16), 20, **kw)
    stats = Trainer(model, TrainConfig(**kw)).run(data.mnist_batches(16), 20)
    got = [s.loss for s in stats]
    assert got[-1] < got[0]
    assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_ATOL, (got, want)


@pytest.mark.parametrize("stream, args", [
    ("mnist_batches", (3,)), ("imagenet_batches", (2, 16, 10)),
])
def test_image_streams_match_jax(stream, args):
    """``data=host``: the same seed gives the JAX package's arrays."""
    ours = getattr(data, stream)(*args, seed=7)
    ref = getattr(jax_data, stream)(*args, seed=7)
    for _ in range(2):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
