"""The port's Switch-MoE FFN (``parallel/moe.py``) against the JAX package's,
case by case after ``tests/test_moe.py``'s single-device cases, on the same
numpy inputs in f32 on the CPU.

Routing is discontinuous: a near-tie between two experts could go either
way between two f32 implementations. So each case first checks that every
token's route (its expert, and its slot in that expert's buffer) is JAX's,
and that the inputs sit clear of ties (the smallest top-1 margin of the
router probabilities is stated per case), and only then compares values.
The expert-sharded cases of ``tests/test_moe.py`` wait for the mesh.

The port's plain-tensor path dispatches and combines by token index
(gathers); its dense one-hot formulation stays as ``moe_ffn_reference``,
and the last cases hold the one to the other.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.parallel.moe import init_moe_params as jax_init
from cron_operator_tpu.parallel.moe import moe_ffn as jax_moe_ffn
from cron_operator_tpu.parallel.moe import router_top1 as jax_router_top1
from cron_operator_tpu_torch.parallel import moe as port_moe
from cron_operator_tpu_torch.parallel.moe import (
    _slot_positions,
    _capacity,
    init_moe_params,
    moe_ffn,
    moe_ffn_reference,
    router_top1,
    router_top1_indices,
    slot_indices,
)

D, F, E = 8, 16, 4
# f32 values: the same products and reductions in another order
VALUE_ATOL = 1e-5
# The router draws normal(0.02) weights, so its probabilities sit near 1/E
# and the top two differ little; the cases' smallest gaps are 8.6e-6 and
# up, over 250 f32 ulps of a probability near 1/4.
MIN_MARGIN = 1e-6


def _inputs(x_key, p_key, tokens, dtype=jnp.float32):
    """The JAX case's input and parameters as numpy arrays."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(x_key), (tokens, D),
                                     dtype))
    params = jax_init(jax.random.PRNGKey(p_key), d_model=D, d_ff=F,
                      n_experts=E)
    return x, {k: np.asarray(v) for k, v in params.items()}


def _torch(params):
    return {k: torch.tensor(v) for k, v in params.items()}


def _routes(dispatch):
    """(kept, expert, slot) of every token from a [T, E, C] dispatch; -1
    for a dropped token's expert and slot."""
    d = np.asarray(dispatch, dtype=np.float32)
    kept = d.sum(axis=(1, 2)) > 0
    expert = np.where(kept, d.sum(axis=2).argmax(axis=1), -1)
    slot = np.where(kept, d.sum(axis=1).argmax(axis=1), -1)
    return kept, expert, slot


def _min_margin(logits):
    """The smallest gap between a token's top two router probabilities."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32)))
    top2 = np.sort(probs, axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def _assert_same_routes(x, params, capacity):
    """Each package routes the input its own way (logits in f32 from x and
    the router); the routes must be identical, clear of ties. Returns the
    two dispatches."""
    logits = np.asarray(x, np.float32) @ params["router"]
    # above f32 rounding of a probability near 1/E (an ulp is 3e-8)
    assert _min_margin(logits) > MIN_MARGIN
    _, jax_dispatch, _ = jax_router_top1(
        jnp.asarray(x, jnp.float32) @ jnp.asarray(params["router"]), capacity)
    _, dispatch, _ = router_top1(
        torch.tensor(np.asarray(x, np.float32)) @ _torch(params)["router"],
        capacity)
    for ours, ref in zip(_routes(dispatch.numpy()), _routes(jax_dispatch)):
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jax_dispatch))
    return dispatch, jax_dispatch


def _per_token_reference(params, x, capacity):
    """Per-token numpy Switch top-1 with capacity drop (tanh gelu)."""
    probs = np.asarray(jax.nn.softmax(x @ params["router"], axis=-1))
    counts = [0] * E
    out = np.zeros_like(x)
    for t in range(x.shape[0]):
        e = int(np.argmax(probs[t]))
        if counts[e] >= capacity:
            continue  # dropped
        counts[e] += 1
        h = x[t] @ params["wi"][e]
        h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi) * (h + 0.044715 * h ** 3)))
        out[t] = (h @ params["wo"][e]) * probs[t, e]
    return out


class TestRouting:
    def test_dispatch_combine_shapes_and_slots(self):
        x, params = _inputs(0, 1, 12)
        _assert_same_routes(x, params, 3)
        logits = x @ params["router"]
        combine, dispatch, aux = router_top1(torch.tensor(logits), 3)
        jc, jd, jaux = jax_router_top1(jnp.asarray(logits), 3)
        assert combine.shape == dispatch.shape == (12, E, 3)
        # Each kept token occupies exactly one (expert, slot); each
        # (expert, slot) holds at most one token.
        per_token = dispatch.sum(dim=(1, 2))
        assert set(per_token.tolist()) <= {0.0, 1.0}
        assert dispatch.sum(dim=0).max().item() <= 1.0
        assert aux.item() > 0.0
        np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
        np.testing.assert_allclose(combine.numpy(), np.asarray(jc),
                                   rtol=0, atol=1e-6)
        assert abs(aux.item() - float(jaux)) <= 1e-6

    def test_matches_per_token_reference(self):
        x, params = _inputs(2, 3, 32)
        capacity = _capacity(32, E, 1.25)
        assert capacity == max(1, int(np.ceil(32 / E * 1.25)))
        _assert_same_routes(x, params, capacity)
        y, aux = moe_ffn(_torch(params), torch.tensor(x),
                         capacity_factor=1.25)
        jy, jaux = jax_moe_ffn({k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(x), capacity_factor=1.25)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=VALUE_ATOL)
        assert abs(aux.item() - float(jaux)) <= 1e-6
        ref = _per_token_reference(params, x, capacity)
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-4)

    def test_overflow_tokens_are_dropped_to_zero(self):
        """Tiny capacity forces drops; dropped rows must be exactly 0."""
        x, params = _inputs(4, 5, 16)
        dispatch, _ = _assert_same_routes(x, params, 1)
        kept = dispatch.sum(dim=(1, 2)).numpy() > 0
        assert kept.sum() <= E  # at most capacity * E tokens survive
        assert kept.sum() < 16
        y, _ = moe_ffn(_torch(params), torch.tensor(x),
                       capacity_factor=1.0 / (16 / E))
        jy, _ = jax_moe_ffn({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), capacity_factor=1.0 / (16 / E))
        dropped_rows = y.numpy()[~kept]
        np.testing.assert_array_equal(dropped_rows,
                                      np.zeros_like(dropped_rows))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=VALUE_ATOL)


class TestTraining:
    def test_grads_flow_and_aux_loss_balances(self):
        """The gradients of mean(y^2) + 0.01 aux: every one finite, the
        router's nonzero (through the gates and the aux loss, since the
        dispatch carries none), and each within f32 rounding of jax.grad's."""
        x, params = _inputs(9, 10, 32)
        _assert_same_routes(x, params, _capacity(32, E, 1.25))

        def jax_loss(p):
            y, aux = jax_moe_ffn(p, jnp.asarray(x))
            return jnp.mean(y ** 2) + 0.01 * aux

        want = jax.grad(jax_loss)({k: jnp.asarray(v)
                                   for k, v in params.items()})
        leaves = {k: v.clone().requires_grad_() for k, v in
                  _torch(params).items()}
        y, aux = moe_ffn(leaves, torch.tensor(x))
        (torch.mean(y ** 2) + 0.01 * aux).backward()
        for name, leaf in leaves.items():
            grad = leaf.grad.numpy()
            assert np.isfinite(grad).all(), name
            ref = np.asarray(want[name])
            np.testing.assert_allclose(
                grad, ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                err_msg=name)
        # Router must receive gradient (through gates and aux loss).
        assert leaves["router"].grad.abs().sum().item() > 0.0

    def test_aux_loss_alone_reaches_the_router(self):
        """The aux loss's gradient reaches the router through the mean
        router probability, as jax.grad of the JAX aux gives it."""
        x, params = _inputs(9, 10, 32)
        want = jax.grad(lambda r: jax_router_top1(
            jnp.asarray(x) @ r, 10)[2])(jnp.asarray(params["router"]))
        router = torch.tensor(params["router"]).requires_grad_()
        router_top1(torch.tensor(x) @ router, 10)[2].backward()
        assert router.grad.abs().sum().item() > 0.0
        np.testing.assert_allclose(router.grad.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-7)


class TestTrainerIntegration:
    def test_moe_compute_dtype_follows_model(self):
        """bf16 models run the expert products in bf16, keeping only
        routing in f32: the output is bf16, the aux f32, and the output
        within twice the JAX bf16 output's own distance from f32."""
        x, params = _inputs(1, 0, 16, dtype=jnp.bfloat16)
        jparams = {k: jnp.asarray(v) for k, v in params.items()}
        xb = jnp.asarray(x)  # bfloat16
        _assert_same_routes(np.asarray(xb, np.float32), params,
                            _capacity(16, E, 1.25))
        y, aux = moe_ffn(_torch(params),
                         torch.tensor(np.asarray(xb, np.float32)).to(
                             torch.bfloat16),
                         compute_dtype=torch.bfloat16)
        assert y.dtype == torch.bfloat16
        assert aux.dtype == torch.float32
        jy, jaux = jax_moe_ffn(jparams, xb, compute_dtype=jnp.bfloat16)
        jy32, _ = jax_moe_ffn(jparams, xb.astype(jnp.float32))
        gap = np.abs(np.asarray(jy, np.float32) - np.asarray(jy32)).max()
        assert np.abs(y.float().numpy() - np.asarray(jy, np.float32)).max() \
            <= 2 * gap
        assert abs(aux.item() - float(jaux)) <= 1e-6


def test_init_moe_params_scales():
    """The JAX function's scales, untruncated, on the generator's device."""
    params = init_moe_params(torch.Generator().manual_seed(0), d_model=256,
                             d_ff=512, n_experts=8)
    assert params["router"].shape == (256, 8)
    assert params["wi"].shape == (8, 256, 512)
    assert params["wo"].shape == (8, 512, 256)
    assert abs(params["router"].std().item() - 0.02) < 1e-3
    assert abs(params["wi"].std().item() - 256 ** -0.5) < 1e-3
    assert abs(params["wo"].std().item() - 512 ** -0.5) < 1e-3
    # untruncated: a normal draw of ~1M values reaches past 4 std
    assert params["wi"].abs().max().item() > 4 * 256 ** -0.5
    assert {p.dtype for p in params.values()} == {torch.float32}


@pytest.mark.parametrize("tokens, experts, factor", [
    (8192, 8, 1.25), (8, 8, 8.0), (4096, 8, 1.25), (12, 4, 0.1)])
def test_capacity_is_the_jax_capacity(tokens, experts, factor):
    from cron_operator_tpu.parallel.moe import _capacity as jax_capacity

    assert _capacity(tokens, experts, factor) == jax_capacity(
        tokens, experts, factor)


@pytest.mark.parametrize("tokens", [1, 7, 1000, 8192])
def test_slot_positions_scan_the_inner_axis_to_the_same_ranks(tokens):
    """The router's cumsum runs along the inner axis of an ``[E, T]`` copy;
    on random one-hot masks its ranks equal the token-axis cumsum's, the
    port's former form and JAX's, from 1 to 8192 tokens."""
    rng = np.random.default_rng(tokens)
    mask = np.eye(E, dtype=np.float32)[rng.integers(0, E, tokens)]
    got = _slot_positions(torch.tensor(mask))
    assert got.dtype == torch.int64 and got.shape == (tokens,)
    t = torch.tensor(mask)
    dim0 = ((torch.cumsum(t, dim=0) - 1.0) * t).sum(dim=-1).long()
    assert torch.equal(got, dim0)
    ref = ((jnp.cumsum(jnp.asarray(mask), axis=0) - 1.0)
           * jnp.asarray(mask)).sum(-1).astype(jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_routes_at_the_training_token_count_equal_jax():
    """8192 tokens, as one MoE layer of the GPT-2-small step routes, at a
    small capacity so that most tokens past it are dropped."""
    rng = np.random.default_rng(11)
    logits = 3 * rng.standard_normal((8192, E), dtype=np.float32)
    _, dispatch, _ = router_top1(torch.tensor(logits), 64)
    _, jax_dispatch, _ = jax_router_top1(jnp.asarray(logits), 64)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jax_dispatch))


# The index path against the dense formulation. name: (experts, capacity
# factor); None sets the capacity to the busiest expert's count, so that
# expert's buffer is exactly full and no token drops.
INDEX_CASES = {
    "dropped": (4, 0.5),
    "empty_slots": (4, 2.0),
    "exactly_full": (4, None),
    "one_expert": (1, 1.0),
}
INDEX_TOKENS = 64
# The router's and x's gradients: the index path sums each gate's gradient
# <dy, expert_out> in f32 in its own order (f32: 1e-5 of the largest entry,
# as the JAX parity cases), where the dense path takes it from a product
# that rounds it to the compute dtype (bf16: unit roundoff 2^-8 on each
# token's term, so 2^-7 of the largest entry).
ROUTER_GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _index_run(fn, params, x, factor, dtype):
    """y, aux, dx and the parameters' gradients of mean(y^2) + 0.01 aux."""
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    xl = x.clone().requires_grad_()
    y, aux = fn(leaves, xl, capacity_factor=factor, compute_dtype=dtype)
    ((y.float() ** 2).mean() + 0.01 * aux).backward()
    return (y.detach(), aux.detach(), xl.grad,
            {k: v.grad for k, v in leaves.items()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_index_path_equals_the_dense_formulation(case, dtype, monkeypatch):
    """Each kept token fills one slot and each slot holds one token, so
    every row of the dense products has one non-zero term: the gathers give
    the forward, dX through the dispatch and the experts' gradients to the
    bit, in f32 and bf16. The router's and x's gradients (x's through the
    router's logits) are within ``ROUTER_GRAD_REL``; a rerun is
    bit-identical."""
    experts, factor = INDEX_CASES[case]
    T = INDEX_TOKENS
    gen = torch.Generator().manual_seed(7)
    params = init_moe_params(gen, d_model=D, d_ff=F, n_experts=experts)
    x = torch.randn(T, D, generator=gen).to(dtype)
    logits = x.float() @ params["router"]
    expert_index, _, _, _ = router_top1_indices(logits, T)
    counts = torch.bincount(expert_index, minlength=experts)
    if factor is None:
        factor = (counts.max().item() - 0.5) * experts / T
    cap = _capacity(T, experts, factor)
    _, slot, gate, _ = router_top1_indices(logits, cap)
    kept = slot < cap
    assert {"dropped": not kept.all(),
            "empty_slots": kept.all() and bool((counts < cap).any()),
            "exactly_full": kept.all() and counts.max().item() == cap,
            "one_expert": kept.all() and cap == T}[case]
    assert torch.equal(gate == 0, ~kept)
    dest, src = slot_indices(expert_index, slot, cap, experts)
    assert torch.equal(dest[~kept], torch.full_like(dest[~kept],
                                                    experts * cap))
    assert torch.equal(src[dest[kept]], torch.arange(T)[kept])
    assert (src == T).sum().item() == experts * cap - kept.sum().item()

    index = _index_run(moe_ffn, params, x, factor, dtype)
    dense = _index_run(moe_ffn_reference, params, x, factor, dtype)
    assert index[0].dtype == dtype
    assert torch.equal(_bits(index[0]), _bits(dense[0]))
    assert torch.equal(index[1], dense[1])
    for name in ("wi", "wo"):
        assert torch.equal(_bits(index[3][name]), _bits(dense[3][name])), name
    rel = ROUTER_GRAD_REL[dtype]
    for got, want in ((index[3]["router"], dense[3]["router"]),
                      (index[2], dense[2])):
        assert ((got.float() - want.float()).abs()
                <= rel * want.float().abs().max()).all()
    again = _index_run(moe_ffn, params, x, factor, dtype)
    assert torch.equal(_bits(again[0]), _bits(index[0]))
    assert torch.equal(_bits(again[2]), _bits(index[2]))
    for name in params:
        assert torch.equal(again[3][name], index[3][name]), name

    # dX through the dispatch alone: both paths route detached logits
    real = port_moe.router_top1_indices
    monkeypatch.setattr(port_moe, "router_top1_indices",
                        lambda lg, c: real(lg.detach(), c))
    index = _index_run(moe_ffn, params, x, factor, dtype)
    dense = _index_run(moe_ffn_reference, params, x, factor, dtype)
    assert torch.equal(_bits(index[2]), _bits(dense[2]))


def test_index_path_runs_no_token_by_slot_product():
    """Under ``FlopCounterMode`` a training pass of the index path counts
    the router's and the experts' products alone, forward and backward;
    the dense formulation adds its five ``[T, E*C]`` products (dispatch,
    combine, dX through the dispatch, d expert_out, d combine)."""
    from torch.utils.flop_counter import FlopCounterMode

    T = INDEX_TOKENS
    gen = torch.Generator().manual_seed(8)
    params = init_moe_params(gen, d_model=D, d_ff=F, n_experts=E)
    x = torch.randn(T, D, generator=gen)
    C = _capacity(T, E, 1.25)
    counted = {}
    for fn in (moe_ffn, moe_ffn_reference):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        with FlopCounterMode(display=False) as mode:
            y, aux = fn(leaves, x.clone().requires_grad_())
            (y.sum() + aux).backward()
        counted[fn] = mode.get_total_flops()
    work = 3 * 2 * T * D * E + 3 * 2 * 2 * E * C * D * F
    assert counted[moe_ffn] == work
    assert counted[moe_ffn_reference] == work + 5 * 2 * T * E * C * D
