"""The port's flash-attention backward against the JAX package's K2/K3.

On the CPU the port's backward runs its plain versions of K2 and K3
(``flash_attention_bwd_reference`` and the autograd Function around it).
They are held against the JAX package's ``_flash_bwd`` on the same
residuals and against ``jax.grad`` through its ``flash_attention`` in
interpret mode, at ``1e-4 * max|ref|`` per gradient (f32 summation order,
as ``tests/test_ops.py`` bounds the JAX kernels against dense attention).
The CUDA kernels themselves are held against the plain versions in
``test_torch_flash_bwd_kernel_cuda.py``, which needs the card.
"""

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
