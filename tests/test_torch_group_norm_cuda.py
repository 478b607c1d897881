"""The GroupNorm kernels (``ops/csrc/group_norm.cu``) against their plain
versions, on the card: three ResNet-50 shapes and a ragged one, bf16 and
f32, forward (y, mean, rstd) and backward (dx, dgamma, dbeta) within
``group_norm_tolerance``; the forward's cluster design at those shapes and
at its edges (one block, 16 blocks, a map one pixel past a TMA box, a map
no cluster divides, f32 x with bf16 y) beside its two-pass design on the
same inputs; the backward's cluster design at its edges (7^2
and 14^2 maps whose pixels do not divide among the cluster's blocks, a
slab narrower than C, f32, a rank with no pixel) beside the two-pass
design on the same inputs; bit-identical reruns; a CUDA graph capture of
the forward and backward replayed equal to eager, with the launches counted
once per replay; the model's ``GroupNorm`` launching both kernels; and
inputs that are not channels-last-contiguous raising. The epilogues, in
both designs of each direction at the edge shapes above: the fused forward
(relu, and a residual then relu) equals the unfused kernel's y followed by
torch's add and relu, and the fused backward (the relu's mask recomputed
from x) the unfused kernel fed ``dy * (z > 0)``, to the bit, reruns
identical; a captured fused norm replays equal to eager, counted by
epilogue.

Needs a CUDA card and nvcc (the kernels have no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_group_norm_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import importlib

import numpy as np
import pytest
import torch

from cron_operator_tpu_torch.models.layers import GroupNorm

gn = importlib.import_module("cron_operator_tpu_torch.ops.group_norm")
fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

CASE_TIMEOUT_S = 300  # as the other kernels' card tests: the build included
GROUPS, EPS = 32, 1e-6
# (b, C, H, W): ResNet-50's widest map, a middle one and its 7x7 stage at a
# small batch, and a map of 35 pixels that ends inside a tile
SHAPES = [(4, 64, 56, 56), (4, 512, 14, 14), (8, 2048, 7, 7), (3, 128, 5, 7)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _inputs(shape, dtype, device, seed=0):
    """Seeded channels-last x and dy, f32 gamma and beta."""
    b, c, h, w = shape
    rng = np.random.default_rng(seed)

    def nchw(*s):
        a = torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
        return a.to(device, dtype).permute(0, 3, 1, 2)

    x, dy = nchw(b, h, w, c), nchw(b, h, w, c)
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(c, np.float32))
    beta = torch.from_numpy(0.1 * rng.standard_normal(c, np.float32))
    return x, dy, gamma.to(device), beta.to(device)


def _assert_within(got: dict, ref: dict, bounds: dict):
    for key, want in ref.items():
        have = got[key]
        assert have.dtype == want.dtype and have.shape == want.shape, key
        assert bool(torch.isfinite(have.float()).all()), key
        err = (have.float() - want.float()).abs()
        assert bool((err <= bounds[key]).all()), (
            key, float((err / bounds[key]).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_the_plain_versions(cuda_device, shape, dtype):
    x, dy, gamma, beta = _inputs(shape, dtype, cuda_device)
    y, mean, rstd = gn.group_norm_forward(x, gamma, beta, GROUPS, EPS, dtype)
    dx, dgamma, dbeta = gn.group_norm_backward(dy, x, mean, rstd, gamma,
                                               GROUPS)
    torch.cuda.synchronize()
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    ry, rmean, rrstd = gn.group_norm_reference(x, gamma, beta, GROUPS, EPS,
                                               dtype)
    # the backward's plain version from the kernel's own statistics: both
    # sides then take the same inputs
    rdx, rdgamma, rdbeta = gn.group_norm_backward_reference(
        dy, x, mean, rstd, gamma, GROUPS)
    bounds = gn.group_norm_tolerance(x, gamma, beta, GROUPS, rmean, rrstd, ry,
                                     dy, rdx)
    _assert_within({"y": y, "mean": mean, "rstd": rstd},
                   {"y": ry, "mean": rmean, "rstd": rrstd}, bounds)
    _assert_within({"dx": dx, "dgamma": dgamma, "dbeta": dbeta},
                   {"dx": rdx, "dgamma": rdgamma, "dbeta": rdbeta}, bounds)


# (b, C, H, W) for the cluster backward's edges: 7^2 and 14^2 maps, whose
# 49 and 196 pixels do not divide among clusters of 8 (7 and 25 a block,
# the last rank short or empty), slabs narrower than C, and the widest map
EDGE_SHAPES = [(3, 2048, 7, 7), (2, 512, 14, 14), (2, 64, 112, 112),
               (2, 256, 56, 56), (2, 256, 28, 28)]


def _edge_plans(shape, dtype):
    """backward_plan's plan, then clusters of 8 and of 16 at the widest
    slab that fits them."""
    b, c, h, w = shape
    yield gn.backward_plan(b, c, h * w, GROUPS, dtype, dtype)
    for cluster in (8, 16):
        yield gn.backward_plan(b, c, h * w, GROUPS, dtype, dtype,
                               cluster=cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cluster_backward_at_its_edges(cuda_device, shape, dtype):
    x, dy, gamma, beta = _inputs(shape, dtype, cuda_device, 4)
    _, mean, rstd = gn.group_norm_forward(x, gamma, beta, GROUPS, EPS, dtype)
    ry, rmean, rrstd = gn.group_norm_reference(x, gamma, beta, GROUPS, EPS,
                                               dtype)
    ref = gn.group_norm_backward_reference(dy, x, mean, rstd, gamma, GROUPS)
    bounds = gn.group_norm_tolerance(x, gamma, beta, GROUPS, rmean, rrstd, ry,
                                     dy, ref[0])
    keys = ("dx", "dgamma", "dbeta")
    before = dict(gn.group_norm_backward.launches_by_design)
    got = gn.group_norm_backward(dy, x, mean, rstd, gamma, GROUPS)
    assert gn.group_norm_backward.launches_by_design["cluster"] == (
        before["cluster"] + 1)
    for plan in [*_edge_plans(shape, dtype), {"design": "two_pass"}]:
        assert plan["design"] in ("cluster", "two_pass")
        if plan["design"] == "cluster":
            assert gn.backward_occupancy(x, GROUPS, plan) >= 1
        outs = gn._launch_backward(dy, x, mean, rstd, gamma, GROUPS, plan)
        again = gn._launch_backward(dy, x, mean, rstd, gamma, GROUPS, plan)
        torch.cuda.synchronize()
        _assert_within(dict(zip(keys, outs)), dict(zip(keys, ref)), bounds)
        for a, b_ in zip(outs, again):
            assert torch.equal(a, b_), plan
    for a, b_ in zip(got, gn._launch_backward(
            dy, x, mean, rstd, gamma, GROUPS,
            gn.backward_plan(*shape[:2], shape[2] * shape[3], GROUPS, dtype,
                             dtype))):
        assert torch.equal(a, b_)


# (b, C, H, W) for the cluster forward's edges beside SHAPES: a map of 257
# pixels (one past a 256-pixel box), one of 259 (7 x 37) that no cluster of
# 2-16 blocks divides, the widest map, and a slab narrower than C
FORWARD_SHAPES = SHAPES + [(2, 64, 1, 257), (2, 128, 7, 37),
                           (2, 64, 112, 112), (2, 256, 28, 28)]


def _forward_plans(shape, dtype):
    """forward_plan's plan, then one block and 16 blocks a (b, slab) at the
    widest slab that fits them, then the two-pass design."""
    b, c, h, w = shape
    yield gn.forward_plan(b, c, h * w, GROUPS, dtype)
    for cluster in (1, 16):
        yield gn.forward_plan(b, c, h * w, GROUPS, dtype, cluster=cluster)
    yield {"design": "two_pass"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)], ids=["bf16", "f32", "f32-bf16"])
@pytest.mark.parametrize("shape", FORWARD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cluster_forward_at_its_edges(cuda_device, shape, dtype, out_dtype):
    x, _, gamma, beta = _inputs(shape, dtype, cuda_device, 5)
    ry, rmean, rrstd = gn.group_norm_reference(x, gamma, beta, GROUPS, EPS,
                                               out_dtype)
    ref = {"y": ry, "mean": rmean, "rstd": rrstd}
    bounds = gn.group_norm_tolerance(x, gamma, beta, GROUPS, rmean, rrstd, ry)
    before = dict(gn.group_norm_forward.launches_by_design)
    got = gn.group_norm_forward(x, gamma, beta, GROUPS, EPS, out_dtype)
    assert gn.group_norm_forward.launches_by_design["cluster"] == (
        before["cluster"] + 1)
    for plan in _forward_plans(shape, dtype):
        assert plan["design"] in ("cluster", "two_pass")
        if plan["design"] == "cluster":
            assert gn.forward_occupancy(x, GROUPS, plan) >= 1
        outs = gn._launch_forward(x, gamma, beta, GROUPS, EPS, out_dtype,
                                  plan)
        again = gn._launch_forward(x, gamma, beta, GROUPS, EPS, out_dtype,
                                   plan)
        torch.cuda.synchronize()
        assert outs[0].is_contiguous(memory_format=torch.channels_last)
        _assert_within(dict(zip(ref, outs)), ref, bounds)
        for a, b_ in zip(outs, again):
            assert torch.equal(a, b_), plan
    b, c, h, w = shape
    for a, b_ in zip(got, gn._launch_forward(
            x, gamma, beta, GROUPS, EPS, out_dtype,
            gn.forward_plan(b, c, h * w, GROUPS, dtype))):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_reruns_are_bit_identical(cuda_device):
    x, dy, gamma, beta = _inputs(SHAPES[0], torch.bfloat16, cuda_device, 1)
    runs = []
    for _ in range(2):
        y, mean, rstd = gn.group_norm_forward(x, gamma, beta, GROUPS, EPS,
                                              torch.bfloat16)
        runs.append((y, mean, rstd, *gn.group_norm_backward(
            dy, x, mean, rstd, gamma, GROUPS)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_capture_equals_eager_and_counts_replays(cuda_device):
    norm = GroupNorm(256, compute_dtype=torch.bfloat16, device=cuda_device)
    x, dy, gamma, beta = _inputs((4, 256, 28, 28), torch.bfloat16,
                                 cuda_device, 2)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
    xin = x.clone().requires_grad_()

    def clear():
        xin.grad = None
        norm.zero_grad(set_to_none=True)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        clear()
        y = norm(xin)  # the eager step, which also warms up
        y.backward(dy)
        eager = [t.detach().clone() for t in (y, xin.grad, norm.weight.grad,
                                              norm.bias.grad)]
        clear()
        graph = torch.cuda.CUDAGraph()
        with fa.capture_launches(side.cuda_stream) as tally, \
                torch.cuda.graph(graph, stream=side):
            y = norm(xin)
            y.backward(dy)
    torch.cuda.current_stream().wait_stream(side)
    for fn in (gn.group_norm_forward, gn.group_norm_backward):
        fn.launches = 0
        fn.launches_by_design = dict.fromkeys(fn.launches_by_design, 0)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    fa.count_replays(tally, 2)
    assert gn.group_norm_forward.launches == 2
    assert gn.group_norm_backward.launches == 2
    assert gn.group_norm_forward.launches_by_design == {"cluster": 2,
                                                        "two_pass": 0}
    assert gn.group_norm_backward.launches_by_design == {"cluster": 2,
                                                         "two_pass": 0}
    for got, want in zip((y, xin.grad, norm.weight.grad, norm.bias.grad),
                         eager):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_the_model_norm_launches_both_kernels(cuda_device):
    norm = GroupNorm(128, compute_dtype=torch.bfloat16, device=cuda_device)
    x, dy, _, _ = _inputs((2, 128, 14, 14), torch.bfloat16, cuda_device, 3)
    x.requires_grad_()
    before = (gn.group_norm_forward.launches, gn.group_norm_backward.launches)
    norm(x).backward(dy)
    torch.cuda.synchronize()
    assert (gn.group_norm_forward.launches - before[0],
            gn.group_norm_backward.launches - before[1]) == (1, 1)
    assert x.grad.dtype == torch.bfloat16
    assert norm.weight.grad.dtype == torch.float32


@pytest.mark.cuda
def test_an_input_that_is_not_channels_last_raises(cuda_device):
    x, dy, gamma, beta = _inputs((2, 64, 8, 8), torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="channels-last"):
        gn.group_norm_forward(x.contiguous(), gamma, beta, GROUPS, EPS,
                              torch.bfloat16)
    y, mean, rstd = gn.group_norm_forward(x, gamma, beta, GROUPS, EPS,
                                          torch.bfloat16)
    with pytest.raises(ValueError, match="channels-last"):
        gn.group_norm_backward(dy.contiguous(), x, mean, rstd, gamma, GROUPS)


# ------------------------------------------------------------- epilogues


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)], ids=["bf16", "f32", "f32-bf16"])
@pytest.mark.parametrize("shape", FORWARD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_forward_is_the_unfused_kernel_and_torch(cuda_device, shape,
                                                       dtype, out_dtype):
    """relu(y) and relu(y + residual) in the forward's epilogue: the same
    bits as the unfused kernel's y, then torch's add and ``F.relu``, in
    each plan of ``_forward_plans``; the statistics unchanged; reruns
    identical."""
    x, _, gamma, beta = _inputs(shape, dtype, cuda_device, 6)
    res = _inputs(shape, out_dtype, cuda_device, 7)[0]
    before = dict(gn.group_norm_forward.launches_by_epilogue)
    for plan in _forward_plans(shape, dtype):
        y, mean, rstd = gn._launch_forward(x, gamma, beta, GROUPS, EPS,
                                           out_dtype, plan)
        for residual in (None, res):
            want = torch.relu(y if residual is None else residual + y)
            runs = [gn._launch_forward(x, gamma, beta, GROUPS, EPS, out_dtype,
                                       plan, relu=True, residual=residual)
                    for _ in range(2)]
            torch.cuda.synchronize()
            for z, m, r in runs:
                assert z.is_contiguous(memory_format=torch.channels_last)
                assert torch.equal(z, want), (plan, residual is None)
                assert torch.equal(m, mean) and torch.equal(r, rstd)
            assert bool((want == 0).any()) and bool((want > 0).any())
    plans = len(list(_forward_plans(shape, dtype)))
    after = gn.group_norm_forward.launches_by_epilogue
    assert (after["relu"] - before["relu"], after["residual_relu"]
            - before["residual_relu"]) == (2 * plans, 2 * plans)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EDGE_SHAPES + SHAPES[3:],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_backward_is_the_unfused_kernel_of_the_masked_dy(
        cuda_device, shape, dtype):
    """The backward with the relu's mask recomputed from x equals the
    unfused kernel fed ``threshold_backward(dy, z, 0)`` (autograd's mask
    behind the forward's relu) to the bit, dx, dgamma and dbeta, in each of
    ``_edge_plans`` and the two-pass design; reruns identical."""
    x, dy, gamma, beta = _inputs(shape, dtype, cuda_device, 8)
    z, mean, rstd = gn.group_norm_forward(x, gamma, beta, GROUPS, EPS, dtype,
                                          relu=True)
    masked = torch.ops.aten.threshold_backward(dy, z, 0)
    assert bool((masked == 0).any()) and bool((masked != 0).any())
    for plan in [*_edge_plans(shape, dtype), {"design": "two_pass"}]:
        want = gn._launch_backward(masked, x, mean, rstd, gamma, GROUPS, plan)
        runs = [gn._launch_backward(dy, x, mean, rstd, gamma, GROUPS, plan,
                                    relu=True, bias=beta) for _ in range(2)]
        torch.cuda.synchronize()
        for got in runs:
            for key, a, b_ in zip(("dx", "dgamma", "dbeta"), got, want):
                assert torch.equal(a, b_), (plan, key)


@pytest.mark.cuda
def test_fused_graph_equals_eager_and_counts_epilogues(cuda_device):
    """A block's last norm, ``relu(norm(x) + residual)``, and an inner
    norm's ``relu(norm(x))``, forward and backward captured and replayed:
    the same bits as eager, launches counted by epilogue once a replay."""
    norms = [GroupNorm(256, compute_dtype=torch.bfloat16, device=cuda_device)
             for _ in range(2)]
    x, dy, gamma, beta = _inputs((4, 256, 28, 28), torch.bfloat16,
                                 cuda_device, 9)
    res = _inputs((4, 256, 28, 28), torch.bfloat16, cuda_device, 10)[0]
    with torch.no_grad():
        for norm in norms:
            norm.weight.copy_(gamma)
            norm.bias.copy_(beta)
    xin, rin = x.clone().requires_grad_(), res.clone().requires_grad_()
    leaves = (xin, rin, *norms[0].parameters(), *norms[1].parameters())

    def step():
        for t in leaves:
            t.grad = None
        z = norms[1](norms[0](xin, relu=True), residual=rin, relu=True)
        z.backward(dy)
        return z

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = [step().detach().clone()] + [t.grad.clone() for t in leaves]
        graph = torch.cuda.CUDAGraph()
        for t in leaves:
            t.grad = None
        with fa.capture_launches(side.cuda_stream) as tally, \
                torch.cuda.graph(graph, stream=side):
            z = norms[1](norms[0](xin, relu=True), residual=rin, relu=True)
            z.backward(dy)
    torch.cuda.current_stream().wait_stream(side)
    for fn in (gn.group_norm_forward, gn.group_norm_backward):
        fn.launches = 0
        fn.launches_by_design = dict.fromkeys(fn.launches_by_design, 0)
        fn.launches_by_epilogue = dict.fromkeys(fn.launches_by_epilogue, 0)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    fa.count_replays(tally, 2)
    assert gn.group_norm_forward.launches_by_epilogue == {
        "none": 0, "relu": 2, "residual_relu": 2}
    assert gn.group_norm_backward.launches_by_epilogue == {"none": 2,
                                                           "relu": 2}
    for got, want in zip([z] + [t.grad for t in leaves], eager):
        assert torch.equal(got, want)
