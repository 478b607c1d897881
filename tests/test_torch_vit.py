"""The port's ViT against the JAX package's, from the same weights.

A JAX ``ViT`` tiny is initialised, its parameters go through
``vit_params_from_flax`` into the port's model, and both run the same
seeded numpy NHWC images in f32 on the CPU: logits and grads with the
learned positions and with RoPE, for MHA and GQA; an image that does not
divide by the patch raises as the JAX model does.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.models.vit import ViT as JaxViT
from cron_operator_tpu.models.vit import ViTConfig as JaxViTConfig
from cron_operator_tpu.workloads.train import cross_entropy_loss as jax_xent
from cron_operator_tpu_torch.models import ViT, ViTConfig
from cron_operator_tpu_torch.models.convert import flax_rank, vit_params_from_flax
from cron_operator_tpu_torch.workloads.train import cross_entropy_loss

RTOL = 1e-4  # of the largest |logit| or |grad| of a parameter: f32 order

VARIANTS = {
    "mha": {}, "mha_rope": dict(rope=True), "gqa": dict(num_kv_heads=2),
    "gqa_rope": dict(num_kv_heads=2, rope=True),
}


def _images(b, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, size, size, 3), dtype=np.float32)


def _pair(**over):
    jcfg = JaxViTConfig.tiny(dtype=jnp.float32, **over)
    tcfg = ViTConfig.tiny(dtype=torch.float32, **over)
    params = jax.jit(JaxViT(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(1)
    # nonzero cls_token and biases, so that their mapping shows
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape,
                                                             np.float32),
        params)
    model = ViT(tcfg)
    model.load_state_dict(vit_params_from_flax(params, tcfg))
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_and_grads_match_jax(variant):
    jcfg, tcfg, params, model = _pair(**VARIANTS[variant])
    x = _images(2)
    labels = np.array([3, 7], np.int32)
    jmodel = JaxViT(jcfg)

    def loss(p):
        return jax_xent(jmodel.apply({"params": p}, x), labels)

    ref_logits = np.array(jax.jit(jmodel.apply)({"params": params}, x))
    ref_grads = vit_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)),
        tcfg)
    logits = model(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (2, 10)
    err = (logits.detach() - torch.from_numpy(ref_logits)).abs().max().item()
    assert err <= RTOL * np.abs(ref_logits).max()
    cross_entropy_loss(logits, torch.from_numpy(labels)).backward()
    assert set(ref_grads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        ref = ref_grads[name]
        scale = ref.abs().max().item() or 1.0
        assert (p.grad - ref).abs().max().item() <= RTOL * scale, name


def test_unaligned_image_raises_as_jax():
    jcfg, _, params, model = _pair()
    x = _images(1, size=36)
    with pytest.raises(ValueError, match="not divisible by patch size 8"):
        JaxViT(jcfg).apply({"params": params}, x)
    with pytest.raises(ValueError, match="not divisible by patch size 8"):
        model(torch.from_numpy(x))


def test_parameter_count_and_ranks_match_jax():
    """ViT-B/16: 86,567,656 parameters on both sides (the JAX count read by
    shape); ``cls_token`` keeps flax's rank 3, which the decay mask reads."""
    shapes = jax.eval_shape(
        JaxViT(JaxViTConfig.base()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 224, 224, 3)))["params"]
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes))
    model = ViT(ViTConfig.base(), device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_jax == 86_567_656
    assert model.cls_token.shape == (1, 1, 768)
    assert flax_rank("cls_token", model.cls_token) == 3
    assert flax_rank("patch_embed.weight", model.patch_embed.weight) == 4
    assert model.pos_emb.shape == (197, 768)
    assert ViT(ViTConfig.tiny(rope=True), device="meta").pos_emb is None


def test_random_init_uses_flax_scales():
    model = ViT(ViTConfig.tiny(dtype=torch.float32))
    model.init_weights(torch.Generator().manual_seed(0))
    assert model.cls_token.abs().max().item() == 0.0
    assert abs(model.pos_emb.std().item() - 0.02) < 5e-3
    w = model.patch_embed.weight  # fan-in 8 * 8 * 3
    assert abs(w.std().item() - 192 ** -0.5) < 5e-3
    assert model.patch_embed.bias.abs().max().item() == 0.0
