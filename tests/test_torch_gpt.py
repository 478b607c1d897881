"""The port's GPT against the JAX package's, from the same weights.

A JAX ``GPT`` is initialised, its parameters go through
``params_from_flax`` into the port's model, and both run the same numpy
token ids in f32 on the CPU: the full forward, the prefill (logits and the
cache it writes) and one decode step, for MHA, for GQA with RoPE, and with
Switch-MoE blocks (``moe_every=2``, 4 experts), whose routes (every token's
expert and buffer slot, in each MoE call) are checked equal to JAX's before
any value is compared, and whose aux loss is compared with JAX's.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.models.gpt import GPT as JaxGPT
from cron_operator_tpu.models.gpt import GPTConfig as JaxGPTConfig
from cron_operator_tpu.models.gpt import MoEBlock as JaxMoEBlock
from cron_operator_tpu.parallel.moe import router_top1 as jax_router_top1
from cron_operator_tpu_torch.models import GPT, GPTConfig, MoEBlock
from cron_operator_tpu_torch.models.convert import params_from_flax
from cron_operator_tpu_torch.parallel.moe import _capacity, router_top1

ATOL = 1e-4  # f32 logits over a 1024 vocab, summation order only
AUX_ATOL = 1e-6  # the f32 aux loss, a sum of a few O(1) terms x 0.01

VARIANTS = {
    "mha": dict(),
    "gqa_rope": dict(num_kv_heads=2, rope=True),
}
MOE = dict(moe_every=2, num_experts=4)
F32_VARIANTS = {**VARIANTS, "moe": MOE}
# The smallest gap between a token's top two router probabilities in these
# cases is 4.5e-5 (prefill), far above f32 rounding (about 6e-8 near 1/2).
MIN_MARGIN = 1e-6


class _MoECalls:
    """Records the input of every MoE block call on both sides: the JAX
    ``MoEBlock`` through ``nn.intercept_methods``, the port's through a
    forward hook; each with its decode flag."""

    def __init__(self, model):
        self.jax, self.port = [], []
        self._hooks = [m.register_forward_hook(self._port_hook, with_kwargs=True)
                       for m in model.modules() if isinstance(m, MoEBlock)]

    def _port_hook(self, module, args, kwargs, out):
        self.port.append((args[0].detach().numpy().copy(),
                          bool(kwargs.get("decode", False)), module))

    def intercept(self):
        def interceptor(next_fun, args, kwargs, context):
            if (isinstance(context.module, JaxMoEBlock)
                    and context.method_name == "__call__"):
                self.jax.append((np.asarray(args[0]), context.module.decode))
            return next_fun(*args, **kwargs)
        return nn.intercept_methods(interceptor)

    def assert_same_routes(self):
        """Every MoE call routed every token to JAX's expert and slot, from
        inputs clear of ties."""
        assert self.jax and len(self.jax) == len(self.port)
        for (jx, jdec), (px, pdec, module) in zip(self.jax, self.port):
            assert jdec == pdec and jx.shape == px.shape
            cfg = module.config
            cf = (max(cfg.moe_capacity_factor, float(cfg.num_experts))
                  if pdec else cfg.moe_capacity_factor)
            b, s, d = px.shape
            cap = _capacity(b * s, cfg.num_experts, cf)
            router = module.router.detach()
            jlogits = (jnp.asarray(jx.reshape(b * s, d), jnp.float32)
                       @ jnp.asarray(router.numpy()))
            plogits = torch.tensor(px.reshape(b * s, d)).float() @ router
            probs = np.sort(np.asarray(jax.nn.softmax(jlogits)), axis=-1)
            assert (probs[:, -1] - probs[:, -2]).min() > MIN_MARGIN
            _, jdispatch, _ = jax_router_top1(jlogits, cap)
            _, pdispatch, _ = router_top1(plogits, cap)
            np.testing.assert_array_equal(pdispatch.numpy(),
                                          np.asarray(jdispatch))

    def close(self):
        for h in self._hooks:
            h.remove()


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


@pytest.mark.parametrize("variant", sorted(F32_VARIANTS))
class TestAgainstJax:
    def test_full_forward_logits(self, variant):
        jcfg, params, model = _pair(**F32_VARIANTS[variant])
        ids = _ids(2, 16)
        calls = _MoECalls(model)
        with calls.intercept():
            ref, ref_aux = JaxGPT(jcfg).apply({"params": params}, ids)
        with torch.no_grad():
            out = model(torch.from_numpy(ids).long())
        calls.close()
        if model.has_moe:
            calls.assert_same_routes()
            out, aux = out
            assert aux.dtype == torch.float32 and aux.ndim == 0
            assert float(ref_aux) > 0
            assert abs(aux.item() - float(ref_aux)) < AUX_ATOL
        assert out.dtype == torch.float32 and out.shape == (2, 16, 1024)
        assert _err(out, ref) < ATOL

    def test_prefill_then_decode(self, variant):
        """Prefill routes with the training capacity factor, decode with
        num_experts (no drops), as the JAX model does."""
        jcfg, params, model = _pair(**F32_VARIANTS[variant])
        ids = _ids(2, 8)
        calls = _MoECalls(model)
        with calls.intercept():
            (ref, _), mut = JaxGPT(jcfg, prefill=True).apply(
                {"params": params}, ids, mutable=["cache"]
            )
        cache = model.new_cache(2)
        with torch.no_grad():
            out = model.prefill(torch.from_numpy(ids).long(), cache)
        if model.has_moe:
            calls.assert_same_routes()
        assert _err(out, ref[:, -1]) < ATOL
        assert cache.pos == int(mut["cache"]["step"]) == 8
        for i in range(jcfg.num_layers):
            for name, buf in (("k", cache.k[i]), ("v", cache.v[i])):
                ref_buf = mut["cache"][f"layer_{i}"][name]
                assert buf.shape == ref_buf.shape
                assert _err(buf, ref_buf) < 1e-5

        token = _ids(2, 1, seed=9)
        with calls.intercept():
            (ref_step, _), mut2 = JaxGPT(jcfg, decode=True).apply(
                {"params": params, "cache": mut["cache"]}, token,
                mutable=["cache"],
            )
        with torch.no_grad():
            step = model.decode(torch.from_numpy(token).long(), cache)
        calls.close()
        if model.has_moe:
            assert [dec for _, dec in calls.jax] == [False, True]
            calls.assert_same_routes()
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


def test_moe_parameter_count_matches_jax():
    """Every expert counts, as in the JAX tree's leaves."""
    jcfg, params, model = _pair(**MOE)
    n_jax = sum(int(a.size) for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert "moe" in params["layer_1"] and "moe" not in params["layer_0"]


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


def test_moe_blocks_replace_the_ffn_and_gqa_cache_is_kv_heads_sized():
    """Every moe_every-th block (1-based, as JAX's ``(i + 1) % k``) holds a
    MoE block in place of the dense FFN, with JAX's parameter layout."""
    model = GPT(GPTConfig.tiny(moe_every=2, num_experts=4, num_layers=4))
    assert model.has_moe
    assert [layer.moe is not None for layer in model.layers] == [
        False, True, False, True]
    names = {n for n, _ in model.named_parameters()}
    assert {"layers.1.moe.router", "layers.1.moe.wi", "layers.1.moe.wo",
            "layers.0.fc_in.weight"} <= names
    assert not any(n.startswith("layers.1.fc_") for n in names)
    moe = model.layers[1].moe
    assert (moe.router.shape, moe.wi.shape, moe.wo.shape) == (
        (128, 4), (4, 128, 512), (4, 512, 128))
    assert not GPT(GPTConfig.tiny(moe_every=3)).has_moe  # 2 layers
    model = GPT(GPTConfig.tiny(num_kv_heads=2))
    assert model.new_cache(3).k[0].shape == (3, 512, 2, 32)


def test_moe_random_init_uses_flax_scales():
    """flax's lecun_normal on an ``(E, in, out)`` kernel counts the expert
    axis in the fan-in: std 1/sqrt(E * in), truncated at 2 std; the router
    is normal(0.02), as the JAX ``MoEBlock`` draws them."""
    cfg = GPTConfig.tiny(dtype=torch.float32, moe_every=1, num_experts=8)
    model = GPT(cfg).init_weights(torch.Generator().manual_seed(0))
    jax_moe = JaxMoEBlock(JaxGPTConfig.tiny(num_experts=8)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 128)))["params"]
    moe = model.layers[0].moe
    for name, fan_in in (("wi", 8 * 128), ("wo", 8 * 512)):
        w = getattr(moe, name).detach()
        std = fan_in ** -0.5
        assert abs(w.std().item() - std) < 0.02 * std, name
        assert abs(float(np.std(np.asarray(jax_moe[name]))) - std) \
            < 0.02 * std, name
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978, name
    assert abs(moe.router.std().item() - 0.02) < 2e-3
    again = GPT(cfg).init_weights(torch.Generator().manual_seed(0))
    assert torch.equal(moe.wi, again.layers[0].moe.wi)


def test_moe_flops_per_step_are_counted():
    """``Trainer.flops_per_step`` counts an MoE GPT's step on the meta
    device (the routing's argmax and cumsum included): not None, and above
    the dense model's by the experts' and the router's products alone:
    dispatch and combine are gathers by token index, which count no
    FLOPs."""
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    flops = {}
    for name, over in (("dense", {}), ("moe", MOE)):
        model = GPT(GPTConfig.tiny(max_len=32, **over))
        model.init_weights(torch.Generator().manual_seed(0))
        trainer = Trainer(model, TrainConfig(
            aux_loss_in_output=model.has_moe))
        trainer.step(next(data.causal_token_batches(2, 32, 1024)))
        flops[name] = trainer.flops_per_step()
    assert flops["moe"] is not None and flops["dense"] is not None
    # layer 1's FFN (2 x 64 tokens x 128 x 512 x 2 products, x 3 for the
    # backward) becomes E=4 experts over C=20 slots each
    t, d, f, e, c = 64, 128, 512, 4, 20
    dense_ffn = 3 * 2 * 2 * t * d * f
    moe_ffn = 3 * 2 * 2 * e * c * d * f
    router = 3 * 2 * t * d * e
    assert flops["moe"] - flops["dense"] == pytest.approx(
        moe_ffn + router - dense_ffn, rel=0.02)


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
