"""The port's flash-attention forward against the JAX package's kernel K1.

On the CPU the port's wrapper runs its plain version; it is held against
the Pallas kernel in interpret mode (O and LSE) and against the dense JAX
reference, at the tolerance of f32 summation order. The Pallas kernel run
with bf16 inputs, which rounds P to bf16 as the port's sm90 kernel does,
lies within ``forward_tolerance`` of the port's f32 plain version: that
pins the bound the card tests hold the kernel to. The shape rules,
refusals and the choice of kernel design are checked without a card. The
CUDA kernels themselves are held against the plain version in
``test_torch_flash_kernel_cuda.py``, which needs the card.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.ops.attention import reference_attention as jax_reference
from cron_operator_tpu.ops.flash_attention import _forward as jax_forward
from cron_operator_tpu.ops.flash_attention import flash_attention as jax_flash

# the module, not the function of the same name that ops/__init__ exports
fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

ATOL = 2e-5  # f32, summation order only
_jax_fwd = jax.jit(jax_forward, static_argnums=(3, 4, 5, 6))


def _inputs(seed, b, s, h, kv_h, d):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape, dtype=np.float32)
        for shape in ((b, s, h, d), (b, s, kv_h, d), (b, s, kv_h, d))
    ]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


class TestPlainMatchesJaxKernel:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("block", [None, 64])
    def test_o_and_lse(self, causal, block):
        q, k, v = _inputs(7, 2, 256, 2, 2, 64)
        bq = block or 256  # the JAX default block for seq 256
        o_j, lse_j = _jax_fwd(q, k, v, causal, bq, bq, True)
        o_t, lse_t = fa.flash_attention_fwd(
            *_torch(q, k, v), causal=causal, block_q=block, block_k=block
        )
        assert o_t.shape == (2, 256, 2, 64)
        assert lse_t.shape == tuple(lse_j.shape) == (4, 256, 1)
        assert _max_err(o_t, o_j) < ATOL
        assert _max_err(lse_t, lse_j) < ATOL

    def test_public_wrappers_agree(self):
        q, k, v = _inputs(3, 1, 128, 2, 2, 32)
        ref = jax_flash(q, k, v, causal=True, interpret=True)
        out = fa.flash_attention(*_torch(q, k, v), causal=True)
        assert _max_err(out, ref) < ATOL

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("kv_h", [2, 1])  # groups 2 and 4
    def test_gqa_matches_repeated_reference(self, causal, kv_h):
        q, k, v = _inputs(11, 2, 256, 4, kv_h, 32)
        group = 4 // kv_h
        ref = jax_reference(
            q, jnp.repeat(k, group, axis=2), jnp.repeat(v, group, axis=2),
            causal=causal,
        )
        o, lse = fa.flash_attention_fwd(*_torch(q, k, v), causal=causal)
        assert o.shape == (2, 256, 4, 32)
        assert _max_err(o, ref) < ATOL
        _, lse_j = _jax_fwd(q, k, v, causal, 256, 256, True)
        assert _max_err(lse, lse_j) < ATOL


class TestBf16Tolerance:
    """The Pallas kernel in bf16 against the port's f32 plain version on the
    same (bf16-valued) inputs: O within ``forward_tolerance``."""

    @staticmethod
    def _case(d, kv_h, causal):
        q, k, v = _inputs(d + kv_h, 1, 256, 4, kv_h, d)
        q, k, v = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
        o_j, _ = _jax_fwd(q, k, v, causal, 128, 128, True)
        qt, kt, vt = (torch.tensor(np.asarray(x.astype(jnp.float32)))
                      for x in (q, k, v))
        o_ref, lse_ref = fa.flash_attention_reference(qt, kt, vt,
                                                      causal=causal)
        o_j = torch.tensor(np.asarray(o_j.astype(jnp.float32)))
        return (o_j - o_ref).abs(), o_ref, fa.forward_tolerance(
            qt.bfloat16(), kt.bfloat16(), vt.bfloat16(), o_ref, lse_ref,
            causal=causal)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("kv_h", [4, 2, 1])  # groups 1, 2, 4
    @pytest.mark.parametrize("d", [64, 128])
    def test_bf16_kernel_within_bound(self, d, kv_h, causal):
        diff, _, bound = self._case(d, kv_h, causal)
        assert bool((diff <= bound).all())

    def test_one_ulp_is_not_enough(self):
        """Rounding P to bf16 moves O by more than one bf16 ulp of itself
        somewhere, which is why the bound has its 2^-8 (P |V|) / l term."""
        diff, o_ref, _ = self._case(64, 4, False)
        one_ulp = 2.0 ** -7 * o_ref.abs() + 1e-4 * o_ref.abs().max()
        assert not bool((diff <= one_ulp).all())

    def test_f32_bound_is_summation_order(self):
        q, k, v = _torch(*_inputs(2, 1, 128, 2, 2, 64))
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=True)
        bound = fa.forward_tolerance(q, k, v, o_ref, lse_ref, causal=True)
        assert torch.equal(bound, torch.full_like(o_ref, 1e-4))

    @pytest.mark.parametrize("d", [32, 256])
    def test_fma_bf16_bound_is_one_ulp(self, d):
        """The fma design keeps P in f32 and rounds O once: its bf16 bound
        stays one bf16 ulp, with none of the sm90 design's P term."""
        q, k, v = (x.bfloat16() for x in _torch(*_inputs(4, 1, 128, 2, 2, d)))
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=True)
        bound = fa.forward_tolerance(q, k, v, o_ref, lse_ref, causal=True)
        assert torch.equal(bound, 2.0 ** -7 * o_ref.float().abs() + 1e-4)


class TestDesign:
    """Which kernel design K1 and K3 take, decided from dtype and head dim
    before anything is built or launched."""

    @pytest.mark.parametrize("dtype, d, design", [
        (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
        (torch.bfloat16, 32, "fma"), (torch.bfloat16, 256, "fma"),
        (torch.float32, 32, "fma"), (torch.float32, 64, "fma"),
        (torch.float32, 128, "fma"), (torch.float32, 256, "fma"),
    ])
    def test_route_by_dtype_and_head_dim(self, dtype, d, design):
        assert fa._design(dtype, d) == design

    def test_every_wrapper_counts_by_design(self):
        for fn in (fa.flash_attention, fa.flash_attention_dq,
                   fa.flash_attention_dkv):
            assert set(fn.launches_by_design) == set(fa.DESIGNS)

    @pytest.mark.parametrize("dtype, d, s, match", [
        (torch.bfloat16, 48, 128, "head_dim"),
        (torch.bfloat16, 64, 0, "seq length >= 1"),
        (torch.float16, 64, 128, "float32 or bfloat16"),
    ])
    def test_refused_shape_raises_before_any_build(self, monkeypatch, dtype,
                                                   d, s, match):
        def no_build(name):
            raise AssertionError(f"built {name} for a refused shape")

        monkeypatch.setattr(fa._build, "load", no_build)
        q = torch.zeros(1, s, 2, d, dtype=dtype)
        lse = torch.zeros(2, s, 1)
        with pytest.raises(ValueError, match=match):
            fa._launch(q, q, q, causal=True)
        with pytest.raises(ValueError, match=match):
            fa._bwd_args(q, q, q, q, lse, lse, (q,), fa._design(dtype, d))

    def test_tma_readiness(self):
        """A contiguous bf16 tensor and the fused ``qkv[:, :, i]`` views
        are read in place; a base 2 bytes off 16, or a head stride that is
        not a multiple of 16 bytes, is copied first."""
        qkv = torch.zeros(2, 64, 3, 4, 64, dtype=torch.bfloat16)
        assert all(fa._tma_ready(x) for x in qkv.unbind(2))
        flat = torch.zeros(2 * 64 * 4 * 64 + 1, dtype=torch.bfloat16)
        shifted = flat[1:].view(2, 64, 4, 64)
        assert not fa._tma_ready(shifted)
        copy = fa._for_tma(shifted)
        assert fa._tma_ready(copy) and torch.equal(copy, shifted)
        narrow = torch.zeros(2, 64, 4, 68, dtype=torch.bfloat16)[..., :64]
        assert not fa._tma_ready(narrow)


class TestRefusals:
    def test_rejects_unaligned_seq(self):
        q = torch.ones(1, 100, 1, 8)
        with pytest.raises(ValueError, match="multiple of block sizes"):
            fa.flash_attention(q, q, q)

    def test_rejects_bad_head_ratio(self):
        q = torch.ones(1, 128, 4, 8)
        k = torch.ones(1, 128, 3, 8)
        with pytest.raises(ValueError, match="positive divisor"):
            fa.flash_attention(q, k, k)

    def test_only_flash_attention_records_a_graph(self):
        """``flash_attention`` is differentiable (its backward is held
        against the JAX kernels in ``test_torch_flash_backward.py``);
        ``flash_attention_fwd`` returns bare tensors."""
        q = torch.ones(1, 128, 1, 32, requires_grad=True)
        assert fa.flash_attention(q, q, q).grad_fn is not None
        o, lse = fa.flash_attention_fwd(q, q, q)
        assert o.grad_fn is None and lse.grad_fn is None

    def test_other_devices_raise(self):
        q = torch.empty(1, 128, 1, 32, device="meta")
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fa.flash_attention(q, q, q)

    @pytest.mark.parametrize(
        "dtype, d, match",
        [(torch.float16, 64, "float32 or bfloat16"), (torch.float32, 48, "head_dim")],
    )
    def test_kernel_launcher_checks_before_building(self, dtype, d, match):
        """The launcher refuses what the kernel does not take before it
        builds or launches anything (so this runs without nvcc)."""
        q = torch.zeros(1, 128, 2, d, dtype=dtype)
        with pytest.raises(ValueError, match=match):
            fa._launch(q, q, q, causal=True)

    def test_cpu_tensor_launches_nothing(self, monkeypatch):
        monkeypatch.setattr(fa.flash_attention, "launches", 0)
        q, k, v = _torch(*_inputs(1, 1, 128, 2, 2, 32))
        fa.flash_attention(q, k, v, causal=True)
        assert fa.flash_attention.launches == 0

    def test_default_block_matches_jax(self):
        from cron_operator_tpu.ops.flash_attention import (
            _default_block as jax_default_block,
        )

        for s in (128, 256, 384, 512, 640, 1024, 1536, 2048, 100):
            assert fa._default_block(s) == jax_default_block(s)
