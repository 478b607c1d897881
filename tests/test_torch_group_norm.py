"""GroupNorm over channels-last tensors (``ops.group_norm``) on the CPU.

The plain forward ``group_norm_reference`` is the arithmetic that
``models/layers.py`` ``GroupNorm._norm`` ran inline before the kernels
(kept below as ``_inline_norm``, verbatim): the two agree to the bit, and so
does the module, which now runs through the ``autograd.Function``. The plain
backward ``group_norm_backward_reference`` (the kernel's arithmetic) agrees
with torch autograd through the plain forward in f32 and f64, and with
``jax.vjp`` of flax's ``nn.GroupNorm`` on the same seeded numpy x, dy, scale
and bias in f32; ``gradcheck`` holds through the Function in f64. The
Function saves x in its own dtype, not an f32 copy. ``group_norm_tolerance``
admits an f64 evaluation of both passes and refuses a y three bf16 units
in the last place away. The dispatch: a CPU tensor never touches the kernel
library, a tensor on the card launches the kernel or raises (never the plain
version), a meta tensor gives the plain version's shapes (a FLOP count), a
DTensor raises, and a layout or shape the kernels do not take is refused
before anything is built. The epilogues (``relu``, ``residual`` then
relu): the fused plain op is the former unfused sequence (the norm, ``+
residual``, ``F.relu``) to the bit, forward and backward for x, gamma,
beta and the residual, in bf16 and f32; the masked plain backward is
autograd through that sequence; a residual without a relu, or not of y's
shape and dtype, raises; launches count by epilogue, once per replay. The
kernels themselves run in ``tests/test_torch_group_norm_cuda.py`` on the
card.
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
from torch.distributed.tensor import Replicate, distribute_tensor

from cron_operator_tpu_torch.models.layers import GroupNorm

gn = importlib.import_module("cron_operator_tpu_torch.ops.group_norm")
fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

GROUPS, EPS = 32, 1e-6
# f32 sums over a group of 2 x 36 terms (x̂, dy x̂) in two orders, and
# flax's E[x^2] - E[x]^2 against E[(x - E[x])^2] at unit spread: both a few
# units of 2^-24 times the terms, far inside 2e-5 of a unit-scale result.
FLAX_GRAD_ATOL = 2e-5
AUTOGRAD_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _draw(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _case(dtype=torch.float32, b=2, c=64, h=6, w=5, seed=0, mean=0.0):
    """Seeded x (channels-last), dy, gamma and beta, as numpy and torch."""
    rng = np.random.default_rng(seed)
    x = mean + _draw(rng, b, h, w, c)  # NHWC, as flax takes it
    dy = _draw(rng, b, h, w, c)
    gamma = 1 + 0.1 * _draw(rng, c)
    beta = 0.1 * _draw(rng, c)

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2).to(dtype)

    return (x, dy, gamma, beta), (nchw(x), nchw(dy), torch.from_numpy(gamma),
                                  torch.from_numpy(beta))


def _inline_norm(x, weight, bias, num_groups, eps, compute_dtype):
    """``GroupNorm._norm`` as it read before the kernels."""
    y = F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)
    return y.to(compute_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mean", [0.0, 100.0])
def test_plain_forward_is_the_previous_module_to_the_bit(dtype, out_dtype,
                                                         mean):
    _, (x, _, gamma, beta) = _case(dtype, mean=mean)
    want = _inline_norm(x, gamma, beta, GROUPS, EPS, out_dtype)
    y, m, r = gn.group_norm_reference(x, gamma, beta, GROUPS, EPS, out_dtype)
    assert y.dtype == out_dtype and torch.equal(y, want)
    assert m.shape == r.shape == (2, GROUPS) and m.dtype == torch.float32
    norm = GroupNorm(64, compute_dtype=out_dtype)
    norm.load_state_dict({"weight": gamma, "bias": beta})
    with torch.no_grad():
        assert torch.equal(norm(x), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backward_reference_matches_autograd(dtype):
    _, (x, dy, gamma, beta) = _case(dtype, seed=1)
    x, gamma, beta = (t.to(dtype).requires_grad_() for t in (x, gamma, beta))
    y, mean, rstd = gn.group_norm_reference(x, gamma, beta, GROUPS, EPS, dtype)
    want = torch.autograd.grad(y, (x, gamma, beta), dy.to(dtype))
    got = gn.group_norm_backward_reference(dy.to(dtype), x.detach(), mean,
                                           rstd, gamma.detach(), GROUPS)
    assert mean.dtype == rstd.dtype == dtype
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= AUTOGRAD_RTOL[dtype] * scale


def test_backward_reference_matches_flax_vjp():
    (x, dy, gamma, beta), (tx, tdy, tgamma, _) = _case(seed=2)
    norm = fnn.GroupNorm(num_groups=GROUPS, epsilon=EPS, dtype=jnp.float32)
    params = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    _, vjp = jax.vjp(lambda p, xx: norm.apply({"params": p}, xx), params,
                     jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(dy))
    mean, rstd = gn.group_stats(tx, GROUPS, EPS)
    got_dx, got_dgamma, got_dbeta = gn.group_norm_backward_reference(
        tdy, tx, mean, rstd, tgamma, GROUPS)
    assert got_dx.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got_dx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(dx), rtol=0, atol=FLAX_GRAD_ATOL)
    np.testing.assert_allclose(got_dgamma.numpy(), np.asarray(
        dparams["scale"]), rtol=0, atol=FLAX_GRAD_ATOL * 60)
    np.testing.assert_allclose(got_dbeta.numpy(), np.asarray(
        dparams["bias"]), rtol=0, atol=FLAX_GRAD_ATOL * 60)


def test_gradcheck_through_the_function():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_draw(rng, 2, 16, 3, 3)).double()
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    gamma = torch.from_numpy(1 + 0.1 * _draw(rng, 16)).double().requires_grad_()
    beta = torch.from_numpy(0.1 * _draw(rng, 16)).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, g, b: gn.group_norm(a, g, b, groups=4, eps=1e-5),
        (x, gamma, beta))


def test_function_saves_x_in_its_own_dtype_and_grads_flow():
    _, (x, dy, gamma, beta) = _case(torch.bfloat16, seed=4)
    norm = GroupNorm(64, compute_dtype=torch.bfloat16)
    norm.load_state_dict({"weight": gamma, "bias": beta})
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
    y.backward(dy)
    mean, rstd = gn.group_stats(x.detach(), GROUPS, EPS)
    want = gn.group_norm_backward_reference(dy, x.detach(), mean, rstd,
                                            gamma, GROUPS)
    assert x.grad.dtype == torch.bfloat16 and torch.equal(x.grad, want[0])
    assert norm.weight.grad.dtype == norm.bias.grad.dtype == torch.float32
    assert torch.equal(norm.weight.grad, want[1])
    assert torch.equal(norm.bias.grad, want[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerance_admits_an_f64_evaluation_and_refuses_three_ulps(dtype):
    _, (x, dy, gamma, beta) = _case(dtype, seed=5)
    y, mean, rstd = gn.group_norm_reference(x, gamma, beta, GROUPS, EPS, dtype)
    dx, dgamma, dbeta = gn.group_norm_backward_reference(dy, x, mean, rstd,
                                                         gamma, GROUPS)
    bounds = gn.group_norm_tolerance(x, gamma, beta, GROUPS, mean, rstd, y,
                                     dy, dx)
    y64, mean64, rstd64 = gn.group_norm_reference(
        x.double(), gamma, beta, GROUPS, EPS, torch.float64)
    got = {"y": y64.to(dtype), "mean": mean64, "rstd": rstd64}
    got.update(zip(("dx", "dgamma", "dbeta"), gn.group_norm_backward_reference(
        dy.double(), x.double(), mean64, rstd64, gamma, GROUPS)))
    got["dx"] = got["dx"].to(dtype)
    want = {"y": y, "mean": mean, "rstd": rstd, "dx": dx, "dgamma": dgamma,
            "dbeta": dbeta}
    for key, ref in want.items():
        err = (got[key].double() - ref.double()).abs()
        assert bool((err <= bounds[key]).all()), key
    three_ulps = 3 * 2.0 ** -7 * y.float().abs()  # three bf16 ulps at |y|
    assert not bool((three_ulps <= bounds["y"]).all())


def test_cpu_tensor_never_touches_the_kernel_library(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(gn, "_lib", None)
    monkeypatch.setattr(gn._build, "load", no_build)
    for fn in (gn.group_norm_forward, gn.group_norm_backward):
        monkeypatch.setattr(fn, "launches", 0)
    _, (x, dy, gamma, beta) = _case(torch.bfloat16, seed=6)
    norm = GroupNorm(64, compute_dtype=torch.bfloat16)
    x = x.requires_grad_()
    norm(x).backward(dy)
    assert x.grad is not None and norm.weight.grad is not None
    assert gn.group_norm_forward.launches == gn.group_norm_backward.launches == 0


class _OnTheCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: what the wrapper
    sees on a machine whose card cannot be reached."""

    @property
    def is_cuda(self):
        return True


def test_a_cuda_tensor_raises_rather_than_falling_back(monkeypatch):
    def no_card(name):
        raise RuntimeError(f"cannot build {name}: no CUDA toolkit or card")

    monkeypatch.setattr(gn, "_lib", None)
    monkeypatch.setattr(gn._build, "load", no_card)
    monkeypatch.setattr(gn, "group_norm_reference",
                        lambda *a: pytest.fail("fell back to the plain version"))
    monkeypatch.setattr(gn.group_norm_forward, "launches", 0)
    _, (x, _, gamma, beta) = _case(torch.bfloat16)
    x = x.as_subclass(_OnTheCard)
    with pytest.raises(RuntimeError, match="no CUDA toolkit or card"):
        gn.group_norm_forward(x, gamma, beta, GROUPS, EPS, torch.bfloat16)
    assert gn.group_norm_forward.launches == 0


def test_meta_tensors_take_the_plain_shapes_for_a_flop_count():
    """``Trainer.flops_per_step`` runs the model on the meta device."""
    x = torch.empty(2, 64, 4, 4, device="meta", requires_grad=True)
    p = torch.empty(64, device="meta", requires_grad=True)
    y = gn.group_norm(x, p, p, out_dtype=torch.bfloat16)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    y.backward(torch.empty_like(y))
    assert x.grad.shape == x.shape and p.grad.shape == p.shape


@pytest.fixture
def one_rank_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_a_dtensor_raises(one_rank_mesh):
    _, (x, _, gamma, beta) = _case()
    x = distribute_tensor(x, one_rank_mesh, [Replicate()])
    with pytest.raises(TypeError, match="not DTensors"):
        gn.group_norm(x, gamma, beta)
    with pytest.raises(TypeError, match="not DTensors"):
        gn.group_norm_forward(x, gamma, beta, GROUPS, EPS, torch.float32)


def test_the_module_hands_a_dtensor_over_as_local_rows(one_rank_mesh):
    _, (x, dy, gamma, beta) = _case(seed=7)
    norm = GroupNorm(64, compute_dtype=torch.float32)
    norm.load_state_dict({"weight": gamma, "bias": beta})
    with torch.no_grad():
        want = norm(x)
        for name in ("weight", "bias"):
            placed = distribute_tensor(getattr(norm, name), one_rank_mesh,
                                       [Replicate()])
            setattr(norm, name, torch.nn.Parameter(placed))
        got = norm(distribute_tensor(x, one_rank_mesh, [Replicate()]))
    # the rows may arrive in another layout, whose CPU kernel sums in
    # another order
    assert (got.to_local() - want).abs().max().item() < 1e-5


@pytest.mark.parametrize("change, match", [
    (dict(layout="nchw"), "channels-last"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(c=96), "power of two"),
    (dict(groups=3), "power of two"),
    (dict(c=2 ** 14), "256 channels a group"),
    (dict(gamma=32), r"gamma and beta must be \[64\]"),
    (dict(unaligned=True), "16-byte"),
])
def test_refused_inputs_raise_before_any_build(monkeypatch, change, match):
    def no_build(name):
        raise AssertionError(f"built {name} for refused inputs")

    monkeypatch.setattr(gn, "_lib", None)
    monkeypatch.setattr(gn._build, "load", no_build)
    c, dtype = change.get("c", 64), change.get("dtype", torch.bfloat16)
    x = torch.zeros(2, 4, 4, c, dtype=dtype).permute(0, 3, 1, 2)
    if change.get("layout") == "nchw":
        x = x.contiguous()
    if change.get("unaligned"):
        # a channels-last view one element past a 16-byte boundary
        x = torch.zeros(2 * 16 * c + 1, dtype=dtype)[1:].view(
            2, 4, 4, c).permute(0, 3, 1, 2)
    gamma = torch.ones(change.get("gamma", c))
    with pytest.raises(ValueError, match=match):
        gn._launch_forward(x, gamma, gamma, change.get("groups", GROUPS), EPS,
                           torch.bfloat16)


def test_kernel_bookkeeping():
    """The wrappers count their launches as the other kernels do, by
    design: each direction's cluster and two-pass ones."""
    assert gn.group_norm_forward.launches_by_design.keys() == {"cluster",
                                                               "two_pass"}
    assert gn.group_norm_backward.launches_by_design.keys() == {"cluster",
                                                                "two_pass"}
    for fn in (gn.group_norm_forward, gn.group_norm_backward):
        assert isinstance(fn.launches, int)


# ResNet-50's GroupNorms at b 128 x 224^2, (channels, map side), as
# chip_smoke.py's RESNET50_NORMS lists them
RESNET50_NORMS = [(64, 112), (64, 56), (128, 56), (256, 56), (128, 28),
                  (256, 28), (512, 28), (256, 14), (512, 14), (1024, 14),
                  (512, 7), (2048, 7)]


def _assert_fits(plan, c, hw, groups, held):
    """A cluster plan holds whole groups and whole 16-byte vectors of each
    held tensor (dtypes ``held``: x, and dy in the backward), covers the
    map, and fits a block's shared memory."""
    assert plan["design"] == "cluster"
    slab, cluster = plan["slab"], plan["cluster"]
    assert c % slab == 0 and slab >= c // groups and slab <= 256
    assert slab & (slab - 1) == 0
    assert all(slab * t.itemsize % 16 == 0 for t in held)
    assert plan["pix"] * cluster >= hw > plan["pix"] * (cluster - 1) - cluster
    assert plan["box_pix"] <= 256
    assert plan["nbox"] * plan["box_pix"] >= plan["pix"]
    tiles = plan["nbox"] * plan["box_pix"] * slab * sum(
        t.itemsize for t in held)
    assert tiles < plan["smem"] <= gn.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("c, side", RESNET50_NORMS,
                         ids=lambda v: str(v))
def test_backward_plan_takes_the_cluster_design(c, side, dtype):
    """Each shape's plan: two blocks an SM, the smallest cluster that gets
    there with pixel rows of 64 bytes or more, and the widest slab at that
    cluster (twice it would not fit half an SM)."""
    hw = side * side
    plan = gn.backward_plan(128, c, hw, GROUPS, dtype, dtype)
    _assert_smallest_cluster(plan, c, hw, (dtype, dtype), gn._HALF_SM)


def _assert_smallest_cluster(plan, c, hw, held, budget):
    """The plan's block, holding the ``held`` tensors, fits ``budget``
    bytes at the smallest cluster that gets there with pixel rows of 64
    bytes or more, at the widest slab."""
    dtype = held[0]
    _assert_fits(plan, c, hw, GROUPS, held)
    assert plan["smem"] <= budget
    assert plan["slab"] * dtype.itemsize >= 64
    wider = gn._fit(c, hw, GROUPS, held, plan["cluster"],
                    min(2 * plan["slab"], 256), budget)
    assert wider is None or wider["slab"] == plan["slab"]
    for smaller in gn.CLUSTERS[:gn.CLUSTERS.index(plan["cluster"])]:
        other = gn._fit(c, hw, GROUPS, held, smaller, 256, budget)
        assert other is None or other["slab"] * dtype.itemsize < 64


def test_backward_plan_at_resnet50_in_bf16():
    """(cluster, slab) of each bf16 shape: 16 blocks of 32 channels at
    112^2, 4 of 32 at 56^2, one block of 32 at 28^2, of 128 at 14^2 and of
    256 at 7^2; at most 1.53 MiB (1,605,632 bytes) of x and dy a
    cluster."""
    plans = {(c, side): gn.backward_plan(128, c, side * side, GROUPS,
                                         torch.bfloat16, torch.bfloat16)
             for c, side in RESNET50_NORMS}
    want = {112: (16, 32), 56: (4, 32), 28: (1, 32), 14: (1, 128),
            7: (1, 256)}
    for (c, side), plan in plans.items():
        assert (plan["cluster"], plan["slab"]) == want[side], (c, side)
    assert max(side * side * plan["slab"] * 4
               for (c, side), plan in plans.items()) <= 1_605_632


def test_backward_plan_with_mixed_dtypes_and_a_given_cluster():
    plan = gn.backward_plan(128, 64, 112 * 112, GROUPS, torch.float32,
                            torch.bfloat16)
    _assert_fits(plan, 64, 112 * 112, GROUPS, (torch.float32, torch.bfloat16))
    eight = gn.backward_plan(128, 64, 112 * 112, GROUPS, torch.bfloat16,
                             torch.bfloat16, cluster=8)
    _assert_fits(eight, 64, 112 * 112, GROUPS, (torch.bfloat16,) * 2)
    assert (eight["cluster"], eight["slab"]) == (8, 32)
    assert eight["smem"] > gn._HALF_SM  # one block an SM
    half = gn.backward_plan(128, 64, 112 * 112, GROUPS, torch.bfloat16,
                            torch.bfloat16, cluster=16, max_slab=32)
    assert (half["cluster"], half["slab"]) == (16, 32)
    assert half["smem"] <= gn._HALF_SM


@pytest.mark.parametrize("c, hw, groups, dtype", [
    (64, 512 * 512, 32, torch.bfloat16),   # 8 channels of 262,144 pixels
    (4, 56 * 56, 2, torch.float32),        # f32 x with bf16 dy: 8 bytes
])
def test_backward_plan_keeps_two_pass_beyond_the_cluster(c, hw, groups,
                                                         dtype):
    plan = gn.backward_plan(2, c, hw, groups, dtype, torch.bfloat16)
    assert plan == {"design": "two_pass"}



# backward_plan's (cluster, slab, pix, box_pix, nbox, smem) at each of
# ResNet-50's shapes, bf16 then f32, as the backward's cluster design was
# measured with it: holding x alone in the forward's plan changed none
BACKWARD_PLANS = {
    (64, 112): [(16, 32, 784, 196, 4, 102944), (16, 16, 784, 196, 4, 101664)],
    (64, 56): [(4, 32, 784, 196, 4, 102944), (4, 16, 784, 196, 4, 101664)],
    (128, 56): [(4, 32, 784, 196, 4, 102944), (4, 16, 784, 196, 4, 101664)],
    (256, 56): [(4, 32, 784, 196, 4, 102944), (4, 16, 784, 196, 4, 101664)],
    (128, 28): [(1, 32, 784, 196, 4, 102944), (1, 16, 784, 196, 4, 101664)],
    (256, 28): [(1, 32, 784, 196, 4, 102944), (1, 16, 784, 196, 4, 101664)],
    (512, 28): [(1, 32, 784, 196, 4, 102944), (1, 16, 784, 196, 4, 101664)],
    (256, 14): [(1, 128, 196, 196, 1, 110600), (1, 64, 196, 196, 1, 105480)],
    (512, 14): [(1, 128, 196, 196, 1, 110600), (1, 64, 196, 196, 1, 105480)],
    (1024, 14): [(1, 128, 196, 196, 1, 110600),
                 (1, 64, 196, 196, 1, 105480)],
    (512, 7): [(1, 256, 49, 49, 1, 70664), (1, 128, 49, 49, 1, 60424)],
    (2048, 7): [(1, 256, 49, 49, 1, 70664), (1, 128, 49, 49, 1, 60424)],
}


def test_backward_plan_is_unchanged_at_resnet50():
    for (c, side), want in BACKWARD_PLANS.items():
        for dtype, plan_want in zip((torch.bfloat16, torch.float32), want):
            plan = gn.backward_plan(128, c, side * side, GROUPS, dtype, dtype)
            assert plan["design"] == "cluster"
            assert tuple(plan[k] for k in (
                "cluster", "slab", "pix", "box_pix", "nbox", "smem")) == (
                    plan_want), (c, side, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("c, side", RESNET50_NORMS,
                         ids=lambda v: str(v))
def test_forward_plan_takes_the_cluster_design(c, side, dtype):
    """The backward's rule for a block that holds x alone: two blocks an
    SM, the smallest cluster with 64-byte pixel rows, the widest slab."""
    hw = side * side
    plan = gn.forward_plan(128, c, hw, GROUPS, dtype)
    _assert_smallest_cluster(plan, c, hw, (dtype,), gn._HALF_SM)


def test_forward_plan_at_resnet50_in_bf16():
    """(cluster, slab) of each bf16 shape: 8 blocks of 32 channels at
    112^2, 2 of 32 at 56^2, one block of 64 at 28^2 and of 256 at 14^2 and
    7^2; about 100 KB of x a block (25 KB at 7^2)."""
    want = {112: (8, 32), 56: (2, 32), 28: (1, 64), 14: (1, 256),
            7: (1, 256)}
    for c, side in RESNET50_NORMS:
        plan = gn.forward_plan(128, c, side * side, GROUPS, torch.bfloat16)
        assert (plan["cluster"], plan["slab"]) == want[side], (c, side)
        x_bytes = -(-side * side // plan["cluster"]) * plan["slab"] * 2
        assert x_bytes == (25_088 if side == 7 else 100_352), (c, side)


def test_forward_plan_with_f32_x_and_a_given_cluster():
    plan = gn.forward_plan(128, 64, 112 * 112, GROUPS, torch.float32)
    _assert_fits(plan, 64, 112 * 112, GROUPS, (torch.float32,))
    assert (plan["cluster"], plan["slab"]) == (8, 16)
    sixteen = gn.forward_plan(128, 64, 112 * 112, GROUPS, torch.bfloat16,
                              cluster=16)
    _assert_fits(sixteen, 64, 112 * 112, GROUPS, (torch.bfloat16,))
    assert (sixteen["cluster"], sixteen["slab"]) == (16, 64)
    one = gn.forward_plan(128, 512, 7 * 7, GROUPS, torch.bfloat16, cluster=1,
                          max_slab=64)
    assert (one["cluster"], one["slab"], one["nbox"]) == (1, 64, 1)


@pytest.mark.parametrize("c, hw, groups, dtype", [
    (64, 512 * 512, 32, torch.bfloat16),   # 8 channels of 262,144 pixels
    (16, 2048 * 2048, 4, torch.float32),   # 4 channels of 4 M pixels
])
def test_forward_plan_keeps_two_pass_beyond_the_cluster(c, hw, groups,
                                                        dtype):
    assert gn.forward_plan(2, c, hw, groups, dtype) == {"design": "two_pass"}
    assert gn.forward_plan(2, c, hw, groups, dtype, cluster=16) == {
        "design": "two_pass"}


# ------------------------------------------------------------- epilogues


def _unfused(norm, x, residual, relu):
    """The model's former sequence after a norm: ``F.relu(residual + y)``
    or ``F.relu(y)``."""
    y = norm(x)
    if residual is not None:
        y = residual + y
    return F.relu(y) if relu else y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("with_residual", [False, True],
                         ids=["relu", "residual_relu"])
def test_fused_epilogue_is_the_former_sequence_to_the_bit(dtype,
                                                          with_residual):
    """z and the gradients of x, gamma, beta and the residual through the
    fused op equal those through the norm, the add and ``F.relu`` as the
    model ran them, bit for bit; the plain forward gives the same z."""
    _, (x, dy, gamma, beta) = _case(dtype, seed=8)
    rng = np.random.default_rng(9)
    res = torch.from_numpy(_draw(rng, 2, 6, 5, 64)).permute(0, 3, 1, 2).to(
        dtype) if with_residual else None
    norm = GroupNorm(64, compute_dtype=dtype)
    norm.load_state_dict({"weight": gamma, "bias": beta})
    runs = []
    for fused in (False, True):
        xin = x.clone().requires_grad_()
        rin = None if res is None else res.clone().requires_grad_()
        norm.zero_grad(set_to_none=True)
        z = (norm(xin, residual=rin, relu=True) if fused
             else _unfused(norm, xin, rin, True))
        z.backward(dy)
        runs.append([z, xin.grad, norm.weight.grad, norm.bias.grad]
                    + ([] if rin is None else [rin.grad]))
    assert bool((runs[1][0] == 0).any()) and bool((runs[1][0] > 0).any())
    for got, want in zip(*reversed(runs)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    plain, _, _ = gn.group_norm_reference(x, gamma, beta, GROUPS, EPS, dtype,
                                          relu=True, residual=res)
    assert torch.equal(plain, runs[0][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_backward_reference_is_autograd_through_the_relu(dtype):
    """The plain backward with ``relu`` masks dy as autograd masks it
    behind ``F.relu`` of the plain forward: the same bits as the plain
    backward of that masked dy, and autograd through ``F.group_norm`` and
    ``F.relu`` within AUTOGRAD_RTOL."""
    _, (x, dy, gamma, beta) = _case(dtype, seed=10)
    x, dy = x.to(dtype), dy.to(dtype)
    xg, gg, bg = (t.to(dtype).requires_grad_() for t in (x, gamma, beta))
    y, mean, rstd = gn.group_norm_reference(xg, gg, bg, GROUPS, EPS, dtype)
    z = F.relu(y)
    masked = torch.autograd.grad(z, y, dy, retain_graph=True)[0]
    want = torch.autograd.grad(z, (xg, gg, bg), dy)
    got = gn.group_norm_backward_reference(dy, x, mean, rstd, gamma.to(dtype),
                                           GROUPS, relu=True,
                                           bias=beta.to(dtype), eps=EPS)
    again = gn.group_norm_backward_reference(masked, x, mean, rstd,
                                             gamma.to(dtype), GROUPS)
    assert bool((masked == 0).any())
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= AUTOGRAD_RTOL[dtype] * scale


@pytest.mark.parametrize("change, match", [
    (dict(relu=False), "only with relu=True"),
    (dict(dtype=torch.float32), "y's dtype"),
    (dict(shape=(2, 64, 6, 4)), "x's shape"),
])
def test_a_residual_the_epilogue_does_not_take_raises(change, match):
    _, (x, _, gamma, beta) = _case(torch.bfloat16)
    res = torch.zeros(change.get("shape", x.shape),
                      dtype=change.get("dtype", torch.bfloat16))
    with pytest.raises(ValueError, match=match):
        gn.group_norm(x, gamma, beta, relu=change.get("relu", True),
                      residual=res)


def test_refused_epilogue_inputs_raise_before_any_build(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for refused inputs")

    monkeypatch.setattr(gn, "_lib", None)
    monkeypatch.setattr(gn._build, "load", no_build)
    x = torch.zeros(2, 4, 4, 64, dtype=torch.bfloat16).permute(0, 3, 1, 2)
    gamma = torch.ones(64)
    with pytest.raises(ValueError, match="residual must be channels-last"):
        gn._launch_forward(x, gamma, gamma, GROUPS, EPS, torch.bfloat16,
                           relu=True, residual=x.contiguous())
    with pytest.raises(ValueError, match="needs bias"):
        gn._launch_backward(x, x, torch.zeros(2, GROUPS),
                            torch.ones(2, GROUPS), gamma, GROUPS, relu=True)
    with pytest.raises(ValueError, match="needs bias and eps"):
        gn.group_norm_backward(x, x, torch.zeros(2, GROUPS),
                               torch.ones(2, GROUPS), gamma, GROUPS,
                               relu=True)


def test_meta_tensors_take_the_epilogues():
    x = torch.empty(2, 64, 4, 4, device="meta", requires_grad=True)
    res = torch.empty(2, 64, 4, 4, device="meta", requires_grad=True)
    p = torch.empty(64, device="meta", requires_grad=True)
    z = gn.group_norm(x, p, p, relu=True, residual=res)
    z.backward(torch.empty_like(z))
    assert res.grad.shape == x.grad.shape == x.shape
    gn.group_norm(x, p, p, relu=True).backward(torch.empty_like(z))


STREAM = 0x3000  # a stream handle for a capture's tally


def test_epilogue_bookkeeping_counts_once_per_replay(monkeypatch):
    """Each wrapper counts its launches by epilogue beside its designs: the
    forward's none, relu and residual_relu, the backward's none and relu; a
    capture's launches count once a replay."""
    fwd, bwd = gn.group_norm_forward, gn.group_norm_backward
    assert tuple(fwd.launches_by_epilogue) == gn.EPILOGUES == (
        "none", "relu", "residual_relu")
    assert tuple(bwd.launches_by_epilogue) == gn.BACKWARD_EPILOGUES == (
        "none", "relu")
    for fn in (fwd, bwd):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_design",
                            dict.fromkeys(fn.launches_by_design, 0))
        monkeypatch.setattr(fn, "launches_by_epilogue",
                            dict.fromkeys(fn.launches_by_epilogue, 0))
    fa._count(fwd, "cluster", STREAM, "residual_relu")
    with fa.capture_launches(STREAM) as tally:
        fa._count(fwd, "cluster", STREAM, "relu")
        fa._count(bwd, "cluster", STREAM, "relu")
        fa._count(bwd, "two_pass", STREAM, "none")
    assert tally == {(fwd, "cluster", "relu"): 1, (bwd, "cluster", "relu"): 1,
                     (bwd, "two_pass", "none"): 1}
    fa.count_replays(tally, 3)
    assert fwd.launches == 4 and bwd.launches == 6
    assert fwd.launches_by_epilogue == {"none": 0, "relu": 3,
                                        "residual_relu": 1}
    assert bwd.launches_by_epilogue == {"none": 3, "relu": 3}
    assert bwd.launches_by_design == {"cluster": 3, "two_pass": 3}
