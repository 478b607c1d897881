"""The port's flash-attention backward against the JAX package's K2/K3.

On the CPU the port's backward runs its plain versions of K2 and K3
(``flash_attention_bwd_reference`` and the autograd Function around it).
They are held against the JAX package's ``_flash_bwd`` on the same
residuals and against ``jax.grad`` through its ``flash_attention`` in
interpret mode, at ``1e-4 * max|ref|`` per gradient (f32 summation order,
as ``tests/test_ops.py`` bounds the JAX kernels against dense attention).
The JAX package's kernels run with bf16 inputs, which round P and dS to
bf16 as the port's sm90 K3 does, give dK and dV within ``dkv_tolerance`` of
the port's f32 plain version on the same residuals: that pins the bound the
card tests hold K3 to. The CUDA kernels themselves are held against the
plain versions in ``test_torch_flash_bwd_kernel_cuda.py``, which needs the
card.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from cron_operator_tpu.ops.flash_attention import _flash_bwd as jax_flash_bwd
from cron_operator_tpu.ops.flash_attention import _forward as jax_forward
from cron_operator_tpu.ops.flash_attention import flash_attention as jax_flash

fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

RTOL = 1e-4  # of max|ref|: f32 summation order only
_jax_fwd = jax.jit(jax_forward, static_argnums=(3, 4, 5, 6))
_jax_bwd = jax.jit(jax_flash_bwd, static_argnums=(0, 1, 2, 3))


def _inputs(seed, s, kv_h, h=4, d=32, b=2):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape, dtype=np.float32)
        for shape in ((b, s, h, d), (b, s, kv_h, d), (b, s, kv_h, d),
                      (b, s, h, d))
    ]


def _torch(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _assert_close(got, ref):
    ref = np.asarray(ref)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= RTOL * np.max(np.abs(ref))


CASES = [
    pytest.param(256, 64, causal, kv_h, id=f"s256-b64-c{int(causal)}-kv{kv_h}")
    for causal in (False, True) for kv_h in (4, 2, 1)
] + [
    pytest.param(256, None, causal, kv_h, id=f"s256-bdef-c{int(causal)}-kv{kv_h}")
    for causal in (False, True) for kv_h in (4, 2, 1)
] + [
    pytest.param(128, None, causal, 4, id=f"s128-bdef-c{int(causal)}-kv4")
    for causal in (False, True)
]


@pytest.mark.parametrize("s, block, causal, kv_h", CASES)
def test_plain_backward_matches_jax_flash_bwd(s, block, causal, kv_h):
    """The same residuals ``(q, k, v, o, lse)`` and dO through the JAX
    package's ``_flash_bwd`` and the port's plain backward."""
    q, k, v, do = _inputs(s + kv_h, s, kv_h)
    blk = block or fa._default_block(s)
    o, lse = _jax_fwd(q, k, v, causal, blk, blk, True)
    ref = _jax_bwd(causal, blk, blk, True, (q, k, v, o, lse), do)
    got = fa.flash_attention_bwd_reference(*_torch(q, k, v, o, lse, do),
                                           causal=causal)
    for g, r in zip(got, ref):
        _assert_close(g, r)


@pytest.mark.parametrize(
    "s, block, causal, kv_h",
    [pytest.param(128, None, causal, kv_h, id=f"s128-c{int(causal)}-kv{kv_h}")
     for causal in (False, True) for kv_h in (4, 2, 1)]
    + [pytest.param(256, 64, True, 2, id="s256-b64-c1-kv2")],
)
def test_autograd_matches_jax_grad(s, block, causal, kv_h):
    """``torch.autograd.grad`` through the port's ``flash_attention``
    against ``jax.grad`` through the JAX one in interpret mode."""
    q, k, v, do = _inputs(7 * s + kv_h, s, kv_h)

    def jax_loss(q, k, v):
        out = jax_flash(q, k, v, causal=causal, block_q=block, block_k=block,
                        interpret=True)
        return jnp.sum(out * do)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (t.requires_grad_() for t in _torch(q, k, v))
    out = fa.flash_attention(qt, kt, vt, causal=causal, block_q=block,
                             block_k=block)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    for g, r in zip(got, ref):
        _assert_close(g, r)


@functools.lru_cache(maxsize=None)
def _bf16_jax(d, kv_h, causal):
    """The JAX kernels' forward and backward in bf16 (interpret mode): the
    residuals as f32 torch tensors (the bf16 Q, K, V, dO, O and the f32
    LSE), ``Delta`` from them, and the JAX ``(dq, dk, dv)`` as f32."""
    arrays = _inputs(d * 10 + kv_h, 256, kv_h, d=d, b=1)
    q, k, v, do = (jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays)
    o, lse = _jax_fwd(q, k, v, causal, 128, 128, True)
    grads = _jax_bwd(causal, 128, 128, True, (q, k, v, o, lse), do)
    qt, kt, vt, dot, ot, lse_t = _torch(
        *(x.astype(jnp.float32) for x in (q, k, v, do, o)), lse)
    delta = fa._delta(ot, dot)
    got = _torch(*(x.astype(jnp.float32) for x in grads))
    return (qt, kt, vt, dot, lse_t, delta), got


def _bf16_case(d, kv_h, causal):
    """dK and dV of the JAX kernels in bf16 and of the port's f32 plain
    version on the same residuals (the bf16 Q, K, V, dO, O and the f32 LSE
    of the JAX forward), with the bounds of ``dkv_tolerance``."""
    (qt, kt, vt, dot, lse_t, delta), (_, dk_j, dv_j) = _bf16_jax(d, kv_h,
                                                                 causal)
    refs = fa.flash_attention_dkv_reference(qt, kt, vt, dot, lse_t, delta,
                                            causal=causal)
    bounds = fa.dkv_tolerance(qt.bfloat16(), kt.bfloat16(), vt.bfloat16(),
                              dot.bfloat16(), lse_t, delta, *refs,
                              causal=causal)
    return (dk_j, dv_j), refs, bounds


def _bf16_dq_case(d, kv_h, causal):
    """dQ of the JAX kernel K2 in bf16 and of the port's f32 plain version
    on the same residuals, with the bound of ``dq_tolerance``."""
    (qt, kt, vt, dot, lse_t, delta), (dq_j, _, _) = _bf16_jax(d, kv_h, causal)
    ref = fa.flash_attention_dq_reference(qt, kt, vt, dot, lse_t, delta,
                                          causal=causal)
    bound = fa.dq_tolerance(qt.bfloat16(), kt.bfloat16(), vt.bfloat16(),
                            dot.bfloat16(), lse_t, delta, ref, causal=causal)
    return dq_j, ref, bound


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_h", [4, 2, 1])  # groups 1, 2, 4
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_kernels_within_dkv_bound(d, kv_h, causal):
    got, refs, bounds = _bf16_case(d, kv_h, causal)
    for g, r, bound in zip(got, refs, bounds):
        assert bool(((g - r).abs() <= bound).all())


def test_dkv_one_ulp_is_not_enough():
    """Rounding P and dS to bf16 moves dK by more than one bf16 ulp of
    itself somewhere, which is why the bound has its 2^-8 terms."""
    (dk, _), (dk_ref, _), _ = _bf16_case(64, 4, False)
    one_ulp = 2.0 ** -7 * dk_ref.abs() + 1e-4 * dk_ref.abs().max()
    assert not bool(((dk - dk_ref).abs() <= one_ulp).all())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_h", [4, 2, 1])  # groups 1, 2, 4
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_kernels_within_dq_bound(d, kv_h, causal):
    """The Pallas K2 in bf16, which rounds dS to bf16 before dS K as the
    port's sm90 K2 does, lies within the sm90 ``dq_tolerance`` of the f32
    plain version: that pins the bound the card tests hold K2 to."""
    dq, ref, bound = _bf16_dq_case(d, kv_h, causal)
    assert fa._design(torch.bfloat16, d) == "sm90"
    assert bool(((dq - ref).abs() <= bound).all())


def test_dq_one_ulp_is_not_enough():
    """Rounding dS to bf16 moves dQ by more than one bf16 ulp of itself
    somewhere, which is why the bound has its 2^-8 term."""
    dq, ref, _ = _bf16_dq_case(64, 4, False)
    one_ulp = 2.0 ** -7 * ref.abs() + 1e-4 * ref.abs().max()
    assert not bool(((dq - ref).abs() <= one_ulp).all())


def test_f32_dq_bound_is_summation_order():
    q, k, v, do = _torch(*_inputs(4, 128, 2))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa._delta(o, do)
    ref = fa.flash_attention_dq_reference(q, k, v, do, lse, delta, causal=True)
    bound = fa.dq_tolerance(q, k, v, do, lse, delta, ref, causal=True)
    assert torch.equal(bound, torch.full_like(ref,
                                              1e-4 * ref.abs().max().item()))


@pytest.mark.parametrize("d", [32, 256])
def test_fma_bf16_dq_bound_is_one_ulp(d):
    """The fma design keeps dS in f32 and rounds dQ once: its bf16 bound
    stays one bf16 ulp, with none of the sm90 design's terms."""
    q, k, v, do = (t.bfloat16() for t in _torch(*_inputs(5, 128, 2, d=d)))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa._delta(o, do)
    ref = fa.flash_attention_dq_reference(q, k, v, do, lse, delta,
                                          causal=True)
    bound = fa.dq_tolerance(q, k, v, do, lse, delta, ref, causal=True)
    ref = ref.float().abs()
    assert fa._design(q.dtype, d) == "fma"
    assert torch.equal(bound, 2.0 ** -7 * ref + 1e-4 * ref.max().item())


def test_f32_dkv_bound_is_summation_order():
    q, k, v, do = _torch(*_inputs(4, 128, 2))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa._delta(o, do)
    refs = fa.flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                            causal=True)
    for ref, bound in zip(refs, fa.dkv_tolerance(q, k, v, do, lse, delta,
                                                 *refs, causal=True)):
        assert torch.equal(bound, torch.full_like(
            ref, 1e-4 * ref.abs().max().item()))


@pytest.mark.parametrize("d", [32, 256])
def test_fma_bf16_dkv_bound_is_one_ulp(d):
    """The fma design keeps P and dS in f32 and rounds dK and dV once: its
    bf16 bound stays one bf16 ulp, with none of the sm90 design's terms."""
    q, k, v, do = (t.bfloat16() for t in _torch(*_inputs(5, 128, 2, d=d)))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa._delta(o, do)
    refs = fa.flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                            causal=True)
    for ref, bound in zip(refs, fa.dkv_tolerance(q, k, v, do, lse, delta,
                                                 *refs, causal=True)):
        ref = ref.float().abs()
        assert torch.equal(bound, 2.0 ** -7 * ref + 1e-4 * ref.max().item())


def test_gradients_under_checkpoint():
    """``torch.utils.checkpoint(use_reentrant=False)`` reruns the Function's
    forward in the backward (``remat=1``) and gives the same grads."""
    q, k, v, do = _torch(*_inputs(3, 128, 2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    direct = torch.autograd.grad(
        fa.flash_attention(*leaves, causal=True), leaves, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = checkpoint(lambda *x: fa.flash_attention(*x, causal=True), *leaves,
                     use_reentrant=False)
    remat = torch.autograd.grad(out, leaves, do)
    for a, b in zip(direct, remat):
        assert torch.equal(a, b)


def test_wrappers_take_the_plain_version_on_the_cpu(monkeypatch):
    """K2's and K3's wrappers launch nothing for CPU tensors and give the
    plain versions' values."""
    monkeypatch.setattr(fa.flash_attention_dq, "launches", 0)
    monkeypatch.setattr(fa.flash_attention_dkv, "launches", 0)
    q, k, v, do = _torch(*_inputs(5, 128, 2))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert fa.flash_attention_dq.launches == fa.flash_attention_dkv.launches == 0


@pytest.mark.parametrize(
    "dtype, d, match",
    [(torch.float16, 64, "float32 or bfloat16"), (torch.float32, 48, "head_dim")],
)
def test_backward_launcher_checks_before_building(dtype, d, match):
    """What the backward kernels do not take is refused before anything is
    built (so this runs without nvcc)."""
    q = torch.zeros(1, 128, 2, d, dtype=dtype)
    lse = torch.zeros(2, 128, 1)
    with pytest.raises(ValueError, match=match):
        fa._bwd_args(q, q, q, q, lse, lse, (q,))


def test_backward_launcher_checks_lse_layout():
    q = torch.zeros(1, 128, 2, 32)
    with pytest.raises(ValueError, match="lse must be contiguous"):
        fa._bwd_args(q, q, q, q, torch.zeros(2, 128), torch.zeros(2, 128, 1),
                     (q,))


@pytest.mark.parametrize("kernel, fn", [("dq", "flash_attention_dq"),
                                        ("dkv", "flash_attention_dkv")])
@pytest.mark.parametrize("dtype, d, design", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 32, "fma"), (torch.float32, 64, "fma"),
])
def test_backward_launch_routes_by_design(monkeypatch, kernel, fn, dtype, d,
                                          design):
    """K2 and K3 take the library of :func:`_design` and count the launch
    under it: bf16 at d 64/128 goes to the sm90 kernels. The launch itself
    is recorded here, not made (no card)."""
    calls = []
    monkeypatch.setattr(fa, "_bwd_call", lambda name, *a: calls.append(
        (name, a[-1])))
    wrapper = getattr(fa, fn)
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "launches_by_design",
                        dict.fromkeys(fa.DESIGNS, 0))
    q = torch.zeros(1, 128, 2, d, dtype=dtype)
    lse = torch.zeros(2, 128, 1)
    launch = fa._launch_dq if kernel == "dq" else fa._launch_dkv
    launch(q, q, q, q, lse, lse, True)
    assert calls == [(kernel, design)]
    assert wrapper.launches == 1
    assert wrapper.launches_by_design == {**dict.fromkeys(fa.DESIGNS, 0),
                                          design: 1}


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("s, kv_h, lse_shape, match", [
    (0, 2, (2, 0, 1), "seq length >= 1"),
    (128, 3, (2, 128, 1), "positive divisor"),
    (128, 2, (2, 128), "lse must be contiguous"),
])
def test_sm90_backward_launcher_checks_before_building(monkeypatch, kernel, s,
                                                       kv_h, lse_shape, match):
    """What the sm90 K2 and K3 do not take is refused before their library
    is built (so this runs without nvcc)."""
    def no_build(name):
        raise AssertionError(f"built {name} for refused inputs")

    monkeypatch.setattr(fa._build, "load", no_build)
    q = torch.zeros(1, s, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, s, kv_h, 64, dtype=torch.bfloat16)
    lse = torch.zeros(lse_shape)
    outs = (q,) if kernel == "dq" else (k, k)
    with pytest.raises(ValueError, match=match):
        fa._bwd_call(kernel, q, k, k, q, lse, torch.zeros(2, s, 1), outs,
                     True, "sm90")
