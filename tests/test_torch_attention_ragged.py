"""Flash attention at sequence lengths that no kernel tile divides, on the
CPU: the port's plain versions of K1-K3 against the JAX package's plain
attention and its ``jax.vjp`` on the same numpy inputs, the dispatch that
sends a CUDA tensor at such a length to the kernels (their launchers
recorded here, not run: no card), and the checks the launchers still make
before anything is built.

The kernels take any ``seq`` >= 1 (a partial last tile on each side; the
card tests in ``test_torch_flash_ragged_cuda.py`` hold them to these plain
versions). The public ``flash_attention`` and ``impl="flash"`` keep the JAX
package's block rule; ``multi_head_attention``'s ``auto`` on the card does
not. Tolerance: f32, summation order only, ``RTOL`` of the largest entry of
the reference plus ``ATOL`` for a gradient that is zero in exact arithmetic
(at s 1 the one key takes all the mass, so dQ = dK = 0 and either side
leaves rounding residue of up to about 1e-6).
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.parallel.ring import (
    _single_device_attention as jax_plain_attention,
)

fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
attention = importlib.import_module("cron_operator_tpu_torch.ops.attention")

RAGGED = (1, 63, 65, 197, 200, 255)
RTOL = 1e-4  # of max|ref|: f32 summation order only
ATOL = 1e-5
H, D, B = 4, 32, 2


def _inputs(seed, s, kv_h):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, s, H, D), (B, s, kv_h, D), (B, s, kv_h, D),
                          (B, s, H, D))]


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_attention(q, k, v, causal):
    """The JAX package's plain attention, K/V repeated to the query heads
    as its dispatch repeats them (``jnp.repeat`` over the head axis)."""
    group = q.shape[2] // k.shape[2]
    k, v = (jnp.repeat(x, group, axis=2) for x in (k, v))
    return jax_plain_attention(q, k, v, causal=causal)


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_grads(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda q, k, v: _jax_attention(q, k, v, causal),
                     q, k, v)
    return vjp(do)


def _assert_close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= RTOL * np.max(np.abs(ref)) + ATOL


@pytest.mark.parametrize("kv_h", [4, 2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", RAGGED)
def test_plain_forward_matches_jax(s, causal, kv_h):
    q, k, v, _ = _inputs(s, s, kv_h)
    o, lse = fa.flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    _assert_close(o, _jax_attention(q, k, v, causal))
    assert lse.shape == (B * H, s, 1) and lse.is_contiguous()
    assert bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("kv_h", [4, 2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", RAGGED)
def test_plain_backward_matches_jax_vjp(s, causal, kv_h):
    q, k, v, do = _inputs(100 + s, s, kv_h)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal=causal)
    grads = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo,
                                             causal=causal)
    for got, ref in zip(grads, _jax_grads(q, k, v, do, causal)):
        _assert_close(got, ref)


@pytest.mark.parametrize("causal", [False, True])
def test_any_length_entry_on_the_cpu_is_the_plain_pair(causal):
    """The entry ``auto`` takes on the card runs the plain versions for a
    CPU tensor at any length, forward and backward through its Function."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(7, 197, 2))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa._flash_attention_any_length(*leaves, causal=causal)
    o, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    assert torch.equal(out, o)
    out.backward(do)
    refs = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal)
    for leaf, ref in zip(leaves, refs):
        assert torch.equal(leaf.grad, ref)


class _OnTheCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: what the dispatch
    and the wrappers see of a tensor on the card."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


def _plain(x):
    return x.as_subclass(torch.Tensor)


@pytest.fixture
def recorded_launches(monkeypatch):
    """The three launchers replaced by their plain versions, each call
    recorded as (kernel, seq); the plain attention body fails the test."""
    calls = []

    def k1(q, k, v, causal):
        calls.append(("K1", q.shape[1]))
        return fa.flash_attention_reference(*map(_plain, (q, k, v)),
                                            causal=causal)

    def k2(q, k, v, do, lse, delta, causal):
        calls.append(("K2", q.shape[1]))
        return fa.flash_attention_dq_reference(
            *map(_plain, (q, k, v, do)), lse, delta, causal=causal)

    def k3(q, k, v, do, lse, delta, causal):
        calls.append(("K3", q.shape[1]))
        return fa.flash_attention_dkv_reference(
            *map(_plain, (q, k, v, do)), lse, delta, causal=causal)

    monkeypatch.setattr(fa, "_launch", k1)
    monkeypatch.setattr(fa, "_launch_dq", k2)
    monkeypatch.setattr(fa, "_launch_dkv", k3)
    return calls


@pytest.mark.parametrize("causal", [False, True])
def test_auto_sends_a_cuda_tensor_at_197_to_the_kernels(
        monkeypatch, recorded_launches, causal):
    """ViT-B/16's 197 tokens: ``auto`` launches K1, then K2 and K3 in the
    backward, never the plain body, and the result is the kernels'."""
    monkeypatch.setattr(
        attention, "_single_device_attention",
        lambda *a, **kw: pytest.fail("auto ran the plain body on the card"))
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(11, 197, 2))
    leaves = [x.clone().as_subclass(_OnTheCard).requires_grad_()
              for x in (q, k, v)]
    out = attention.multi_head_attention(*leaves, causal=causal)
    assert recorded_launches == [("K1", 197)]
    o, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    assert torch.equal(_plain(out), o)
    out.backward(do)
    assert recorded_launches == [("K1", 197), ("K2", 197), ("K3", 197)]
    refs = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal)
    for leaf, ref in zip(leaves, refs):
        assert torch.equal(_plain(leaf.grad), ref)


def test_auto_on_the_cpu_at_197_is_the_plain_body(recorded_launches):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(12, 197, 4))
    out = attention.multi_head_attention(q, k, v)
    assert recorded_launches == []
    assert torch.equal(out, attention._single_device_attention(q, k, v,
                                                               causal=False))


@pytest.mark.parametrize("s", [197, 200])
def test_flash_keeps_the_block_rule(recorded_launches, s):
    """``impl="flash"`` and the public ``flash_attention`` keep the JAX
    package's refusal of a sequence its blocks do not divide."""
    q = torch.zeros(1, s, 2, 64).as_subclass(_OnTheCard)
    with pytest.raises(ValueError, match="multiple of block sizes"):
        attention.multi_head_attention(q, q, q, impl="flash")
    with pytest.raises(ValueError, match="multiple of block sizes"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="multiple of block sizes"):
        fa.flash_attention_fwd(q, q, q)
    assert recorded_launches == []


@pytest.mark.parametrize("dtype, d, design", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.float32, 64, "fma"), (torch.bfloat16, 256, "fma"),
])
@pytest.mark.parametrize("s", [96, 197])
def test_ragged_seq_passes_the_checks_before_any_build(monkeypatch, s, dtype,
                                                       d, design):
    """s 96 and 197 pass every check of the forward and backward launchers;
    nothing is built for it here (no nvcc)."""
    def no_build(name):
        raise AssertionError(f"built {name} during the checks")

    monkeypatch.setattr(fa._build, "load", no_build)
    q = torch.zeros(1, s, 2, d, dtype=dtype)
    k = torch.zeros(1, s, 1, d, dtype=dtype)
    lse = torch.zeros(2, s, 1)
    fa._check_kernel_inputs(q, k, k)
    assert fa._design(dtype, d) == design
    inputs, head, _ = fa._bwd_args(q, k, k, q, lse, lse, (q,), design)
    assert head[-5:] == [1, s, 2, 1, d]
    assert inputs[4].shape == (2, s, 1)


@pytest.mark.parametrize("s, d, match", [
    (0, 64, "seq length >= 1"),
    (197, 48, "head_dim"),
    (197, 96, "head_dim"),
])
def test_launchers_still_refuse(s, d, match):
    q = torch.zeros(1, s, 2, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        fa._check_kernel_inputs(q, q, q)


def test_auto_leaves_an_unbuilt_head_dim_to_the_plain_body(
        monkeypatch, recorded_launches):
    """A head dim no kernel is built for (48) takes the plain body under
    ``auto`` on the card, at any length, as before."""
    q = torch.randn(1, 197, 2, 48).as_subclass(_OnTheCard)
    out = attention.multi_head_attention(q, q, q)
    assert recorded_launches == []
    assert torch.equal(_plain(out), attention._single_device_attention(
        _plain(q), _plain(q), _plain(q), causal=False))


def test_meta_counts_attention_at_the_true_length():
    """FLOPs on the meta device count the 197 x 197 pairs, not padded
    tiles: ViT's MFU and ``xla_flops_per_step`` stay where they were."""
    q = torch.empty(64, 197, 12, 64, device="meta")
    with attention.count_attention_flops() as tally:
        attention.multi_head_attention(q, q, q)
    assert tally.flops == 4 * 64 * 64 * 12 * 197 * 197


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_h", [4, 2])
def test_vanishing_grad_floor_holds_the_residue_at_one_key(dtype, kv_h):
    """At s 1 the plain dQ and dK are rounding residue within
    ``vanishing_grad_floor`` of zero, and the floor stays far below dV,
    which does not vanish."""
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _inputs(3, 1, kv_h))
    o, lse = fa.flash_attention_reference(q, k, v)
    dq, dk, dv = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    floor_dq, floor_dk = fa.vanishing_grad_floor(q, k, v, do, lse)
    assert dq.float().abs().max().item() <= floor_dq
    assert dk.float().abs().max().item() <= floor_dk
    assert max(floor_dq, floor_dk) < 1e-2 * dv.float().abs().max().item()
