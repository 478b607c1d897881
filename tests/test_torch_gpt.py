"""The port's GPT against the JAX package's, from the same weights.

A JAX ``GPT`` is initialised, its parameters go through
``params_from_flax`` into the port's model, and both run the same numpy
token ids in f32 on the CPU: the full forward, the prefill (logits and the
cache it writes) and one decode step, for MHA and for GQA with RoPE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.models.gpt import GPT as JaxGPT
from cron_operator_tpu.models.gpt import GPTConfig as JaxGPTConfig
from cron_operator_tpu_torch.models import GPT, GPTConfig
from cron_operator_tpu_torch.models.convert import params_from_flax

ATOL = 1e-4  # f32 logits over a 1024 vocab, summation order only

VARIANTS = {
    "mha": dict(),
    "gqa_rope": dict(num_kv_heads=2, rope=True),
}


def _pair(impl="xla", **over):
    jcfg = JaxGPTConfig.tiny(dtype=jnp.float32, attention_impl=impl,
                             attention_interpret=True, **over)
    tcfg = GPTConfig.tiny(dtype=torch.float32, attention_impl=impl, **over)
    # the flash kernel takes only 128-aligned sequences, init included
    init_len = 128 if impl == "flash" else 4
    params = JaxGPT(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, init_len), jnp.int32)
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = GPT(tcfg)
    model.load_state_dict(params_from_flax(params, tcfg))
    return jcfg, params, model.eval()


def _ids(b, s, vocab=1024, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
class TestAgainstJax:
    def test_full_forward_logits(self, variant):
        jcfg, params, model = _pair(**VARIANTS[variant])
        ids = _ids(2, 16)
        ref, _ = JaxGPT(jcfg).apply({"params": params}, ids)
        with torch.no_grad():
            out = model(torch.from_numpy(ids).long())
        assert out.dtype == torch.float32 and out.shape == (2, 16, 1024)
        assert _err(out, ref) < ATOL

    def test_prefill_then_decode(self, variant):
        jcfg, params, model = _pair(**VARIANTS[variant])
        ids = _ids(2, 8)
        (ref, _), mut = JaxGPT(jcfg, prefill=True).apply(
            {"params": params}, ids, mutable=["cache"]
        )
        cache = model.new_cache(2)
        with torch.no_grad():
            out = model.prefill(torch.from_numpy(ids).long(), cache)
        assert _err(out, ref[:, -1]) < ATOL
        assert cache.pos == int(mut["cache"]["step"]) == 8
        for i in range(jcfg.num_layers):
            for name, buf in (("k", cache.k[i]), ("v", cache.v[i])):
                ref_buf = mut["cache"][f"layer_{i}"][name]
                assert buf.shape == ref_buf.shape
                assert _err(buf, ref_buf) < 1e-5

        token = _ids(2, 1, seed=9)
        (ref_step, _), mut2 = JaxGPT(jcfg, decode=True).apply(
            {"params": params, "cache": mut["cache"]}, token,
            mutable=["cache"],
        )
        with torch.no_grad():
            step = model.decode(torch.from_numpy(token).long(), cache)
        assert _err(step, ref_step[:, -1]) < ATOL
        assert cache.pos == int(mut2["cache"]["step"]) == 9
        assert _err(cache.k[0], mut2["cache"]["layer_0"]["k"]) < 1e-5


def test_flash_prefill_matches_jax_kernel():
    """The prefill through impl="flash": the port's plain flash version on
    the CPU against the JAX kernel in interpret mode."""
    jcfg, params, model = _pair(impl="flash")
    ids = _ids(1, 128)
    (ref, _), _ = JaxGPT(jcfg, prefill=True).apply(
        {"params": params}, ids, mutable=["cache"]
    )
    with torch.no_grad():
        out = model.prefill(torch.from_numpy(ids).long(), model.new_cache(1))
    assert _err(out, ref[:, -1]) < ATOL


def test_parameter_count_matches_jax():
    jcfg, params, model = _pair()
    n_jax = sum(int(a.size) for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_random_init_uses_flax_scales():
    cfg = GPTConfig.tiny(dtype=torch.float32)
    model = GPT(cfg).init_weights(torch.Generator().manual_seed(0))
    assert abs(model.tok_emb.weight.std().item() - 128 ** -0.5) < 5e-3
    assert abs(model.pos_emb.std().item() - 0.02) < 2e-3
    w = model.layers[0].fc_out.weight  # fan-in 512
    assert abs(w.std().item() - 512 ** -0.5) < 3e-3
    assert w.abs().max().item() <= 2 * 512 ** -0.5 / 0.87962566103423978
    assert model.layers[0].fc_out.bias.abs().max().item() == 0.0
    again = GPT(cfg).init_weights(torch.Generator().manual_seed(0))
    assert torch.equal(model.tok_emb.weight, again.tok_emb.weight)


def test_moe_not_ported_and_gqa_cache_is_kv_heads_sized():
    with pytest.raises(NotImplementedError, match="MoE"):
        GPT(GPTConfig.tiny(moe_every=1))
    model = GPT(GPTConfig.tiny(num_kv_heads=2))
    assert model.new_cache(3).k[0].shape == (3, 512, 2, 32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_compute_over_f32_parameters_matches_jax(variant):
    """Flax keeps parameters in f32 and casts them to ``dtype`` at use; so
    does the port. A bf16 forward from the same f32 weights stays within
    bf16 tolerance of the JAX bf16 forward: twice the JAX bf16 forward's
    own distance from the f32 one."""
    over = VARIANTS[variant]
    jcfg, params, _ = _pair(**over)
    jcfg_bf16 = JaxGPTConfig.tiny(dtype=jnp.bfloat16, **over)
    cfg = GPTConfig.tiny(dtype=torch.bfloat16, **over)
    model = GPT(cfg)
    model.load_state_dict(params_from_flax(params, cfg))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    ids = _ids(2, 16)
    ref_bf16, _ = JaxGPT(jcfg_bf16).apply({"params": params}, ids)
    ref_f32, _ = JaxGPT(jcfg).apply({"params": params}, ids)
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    assert out.dtype == torch.float32
    assert _err(out, ref_bf16) <= 2 * _err(ref_bf16, ref_f32)


def test_bf16_model_trains_f32_masters():
    """An AdamW step of lr 1e-3 moves a LayerNorm scale of 1.0 by 1e-3,
    which a bf16 parameter (spacing 2^-8 below 1) would round away."""
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import Trainer

    model = GPT(GPTConfig.tiny(max_len=32))
    model.init_weights(torch.Generator().manual_seed(0))
    Trainer(model).step(next(data.causal_token_batches(2, 32, 1024)))
    scale = model.layers[0].ln_attn.weight.detach()
    assert scale.dtype == torch.float32
    assert ((scale - 1).abs() - 1e-3).abs().max().item() < 1e-5
