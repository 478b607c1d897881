"""The port's attention dispatch, RoPE and Q/K/V projection against the JAX
package, on the same numpy inputs, in f32 on the CPU."""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.models.gpt import GPTConfig as JaxGPTConfig
from cron_operator_tpu.models.layers import grouped_qkv_projection
from cron_operator_tpu.ops.attention import multi_head_attention as jax_mha
from cron_operator_tpu.ops.rope import apply_rope as jax_apply_rope
from cron_operator_tpu.parallel.mesh import mesh_for_devices as jax_mesh
from cron_operator_tpu_torch.models.convert import _linear
from cron_operator_tpu_torch.models.gpt import GPTConfig
from cron_operator_tpu_torch.models.layers import GroupedQKVProjection
from cron_operator_tpu_torch.ops.attention import multi_head_attention
from cron_operator_tpu_torch.ops.rope import apply_rope

ATOL = 2e-5  # f32, summation order only


def _qkv(seed, b, s, h, kv_h, d):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape, dtype=np.float32)
        for shape in ((b, s, h, d), (b, s, kv_h, d), (b, s, kv_h, d))
    ]


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


class TestDispatch:
    @pytest.mark.parametrize("impl", ["xla", "flash", "auto"])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("kv_h", [4, 2])
    def test_matches_jax(self, impl, causal, kv_h):
        q, k, v = _qkv(2, 2, 128, 4, kv_h, 32)
        ref = jax_mha(q, k, v, causal=causal, impl=impl, interpret=True)
        out = multi_head_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=causal, impl=impl
        )
        assert out.shape == (2, 128, 4, 32)
        assert _err(out, ref) < ATOL

    def test_auto_on_cpu_is_the_plain_path(self):
        q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 128, 2, 2, 32))
        auto = multi_head_attention(q, k, v, causal=True)
        xla = multi_head_attention(q, k, v, causal=True, impl="xla")
        assert torch.equal(auto, xla)

    @pytest.mark.parametrize("impl", ["ring", "ulysses"])
    def test_sequence_parallel_not_ported(self, impl):
        """A plain tensor carries no mesh: ``ring`` and ``ulysses`` give plain
        attention, as the JAX dispatch does under a mesh without a ``seq``
        axis (the JAX jobs' one-device mesh), GQA K/V repeated as there.
        The sequence-parallel paths themselves run in gloo worlds
        (``test_torch_ring.py``)."""
        q, k, v = _qkv(4, 2, 128, 4, 2, 32)
        ref = jax_mha(q, k, v, causal=True, impl=impl,
                      mesh=jax_mesh(jax.devices("cpu")[:1]))
        out = multi_head_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=True, impl=impl)
        xla = multi_head_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=True, impl="xla")
        assert torch.equal(out, xla)
        assert _err(out, ref) < ATOL

    def test_unknown_impl_and_bad_ratio(self):
        q = torch.zeros(1, 128, 4, 32)
        with pytest.raises(ValueError, match="unknown attention impl"):
            multi_head_attention(q, q, q, impl="nope")
        with pytest.raises(ValueError, match="positive divisor"):
            multi_head_attention(q, q[:, :, :3], q[:, :, :3], impl="xla")
        with pytest.raises(ValueError, match="multiple of block sizes"):
            multi_head_attention(q[:, :100], q[:, :100], q[:, :100],
                                 impl="flash")


class TestRope:
    @pytest.mark.parametrize("positions", [np.arange(16), np.array([9])])
    def test_matches_jax(self, positions):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, len(positions), 3, 32), dtype=np.float32)
        ref = jax_apply_rope(jnp.asarray(x), jnp.asarray(positions))
        out = apply_rope(torch.from_numpy(x), torch.from_numpy(positions))
        assert _err(out, ref) < 1e-5

    def test_odd_head_dim_rejected(self):
        with pytest.raises(ValueError, match="even"):
            apply_rope(torch.zeros(1, 2, 1, 5), torch.arange(2))


class _JaxProjection(fnn.Module):
    cfg: Any

    @fnn.compact
    def __call__(self, y, positions=None):
        return grouped_qkv_projection(self.cfg, y, positions)


class TestGroupedQKVProjection:
    @pytest.mark.parametrize("kv_heads, rope", [(0, False), (2, True), (1, False)])
    def test_matches_jax(self, kv_heads, rope):
        jcfg = JaxGPTConfig.tiny(dtype=jnp.float32, num_kv_heads=kv_heads,
                                 rope=rope)
        y = np.random.default_rng(8).standard_normal((2, 16, 128),
                                                     dtype=np.float32)
        mod = _JaxProjection(jcfg)
        params = jax.tree_util.tree_map(
            np.asarray, mod.init(jax.random.PRNGKey(1), y)["params"]
        )
        ref = mod.apply({"params": params}, y)

        proj = GroupedQKVProjection(
            GPTConfig.tiny(dtype=torch.float32, num_kv_heads=kv_heads,
                           rope=rope)
        )
        sd = {}
        for name in params:  # "qkv" for MHA, "q" + "kv" for GQA
            sd.update(_linear(params[name], 1, name))
        proj.load_state_dict(sd)
        with torch.no_grad():
            out = proj(torch.from_numpy(y))
        kv_h = kv_heads or 4
        for o, r, h in zip(out, ref, (4, kv_h, kv_h)):
            assert o.shape == (2, 16, h, 32)
            assert _err(o, r) < 1e-5

    def test_invalid_kv_heads_rejected(self):
        with pytest.raises(ValueError, match="positive divisor"):
            GroupedQKVProjection(GPTConfig.tiny(num_kv_heads=3))
