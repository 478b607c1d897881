"""The port's BERT against the JAX package's, from the same weights.

A JAX ``Bert`` tiny is initialised, its parameters go through
``params_from_flax`` into the port's model, and both run the same seeded
numpy token ids in f32 on the CPU: logits and grads on the plain (``xla``)
path for MHA and for GQA with RoPE; the port's ``flash`` path (on the CPU,
the plain versions of K1-K3 through the autograd Function) against the JAX
kernels in interpret mode; and ten AdamW steps through both Trainers.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.models.bert import Bert as JaxBert
from cron_operator_tpu.models.bert import BertConfig as JaxBertConfig
from cron_operator_tpu.parallel.mesh import mesh_for_devices
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu.workloads.train import cross_entropy_loss as jax_xent
from cron_operator_tpu_torch.models import Bert, BertConfig
from cron_operator_tpu_torch.models.bert import EncoderLayer
from cron_operator_tpu_torch.models.convert import params_from_flax
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.train import (
    TrainConfig,
    Trainer,
    cross_entropy_loss,
)

RTOL = 1e-4  # of the largest |logit| or |grad| of a parameter: f32 order
FLASH_RTOL = 5e-4  # tests/test_ops.py's bound for flash against dense
LOSS_ATOL = 5e-5  # per step, as tests/test_torch_train.py

VARIANTS = {"mha": {}, "gqa_rope": dict(num_kv_heads=2, rope=True)}


def _pair(seq, impl="xla", **over):
    jcfg = JaxBertConfig.tiny(dtype=jnp.float32, attention_impl=impl,
                              attention_interpret=impl == "flash",
                              max_len=seq, **over)
    tcfg = BertConfig.tiny(dtype=torch.float32, attention_impl=impl,
                           max_len=seq, **over)
    params = jax.jit(JaxBert(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, seq), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = Bert(tcfg)
    model.load_state_dict(params_from_flax(params, tcfg))
    return jcfg, tcfg, params, model


def _ids(b, s, seed=3):
    return np.random.default_rng(seed).integers(0, 1024, (b, s)).astype(np.int32)


def _grads_match(jcfg, tcfg, params, model, ids, rtol):
    """Logits and the grads of the MLM loss (targets = inputs) on both
    sides, each within ``rtol`` of its largest magnitude."""
    jmodel = JaxBert(jcfg)

    def loss(p):
        return jax_xent(jmodel.apply({"params": p}, ids), ids)

    ref_logits = jax.jit(jmodel.apply)({"params": params}, ids)
    ref_grads = params_from_flax(
        jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)),
        tcfg)
    x = torch.from_numpy(ids).long()
    logits = model(x)
    assert logits.dtype == torch.float32
    assert logits.shape == (*ids.shape, tcfg.vocab_size)
    ref_logits = torch.from_numpy(np.array(ref_logits))
    scale = ref_logits.abs().max().item()
    assert (logits.detach() - ref_logits).abs().max().item() <= rtol * scale
    cross_entropy_loss(logits, x).backward()
    assert set(ref_grads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        ref = ref_grads[name]
        scale = ref.abs().max().item() or 1.0
        assert (p.grad - ref).abs().max().item() <= rtol * scale, name


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_and_grads_match_jax(variant):
    jcfg, tcfg, params, model = _pair(16, **VARIANTS[variant])
    _grads_match(jcfg, tcfg, params, model, _ids(2, 16), RTOL)


def test_flash_path_matches_the_jax_kernels_in_interpret_mode():
    """The port's plain K1-K3 through the autograd Function (non-causal)
    against the Pallas kernels run by the interpreter, as
    tests/test_ops.py's BERT flash-vs-dense check."""
    jcfg, tcfg, params, model = _pair(128, impl="flash")
    _grads_match(jcfg, tcfg, params, model, _ids(2, 128), FLASH_RTOL)


def test_ten_adamw_steps_match_the_jax_trainer():
    jcfg, tcfg, params, model = _pair(32)
    jmodel = JaxBert(jcfg)
    jtrainer = JaxTrainer(
        lambda p, x: jmodel.apply({"params": p}, x), params,
        mesh_for_devices(jax.devices("cpu")[:1]),
        JaxTrainConfig(steps_per_call=1, stage_async=False),
    )
    want = [s.loss for s in jtrainer.run(
        jax_data.token_batches(2, 32, 1024), 10)]
    got = [s.loss for s in Trainer(model, TrainConfig()).run(
        data.token_batches(2, 32, 1024), 10)]
    assert got[-1] < got[0]
    assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_ATOL, (got, want)


def test_attention_is_bidirectional():
    """A token's logits change when a later token changes: the encoder is
    GPT's block with ``causal = False``."""
    assert EncoderLayer.causal is False
    model = Bert(BertConfig.tiny(dtype=torch.float32, max_len=8))
    model.init_weights(torch.Generator().manual_seed(0))
    ids = torch.arange(8)[None]
    other = ids.clone()
    other[0, -1] = 100
    with torch.no_grad():
        assert not torch.allclose(model(ids)[0, 0], model(other)[0, 0])


def test_parameter_count_matches_jax():
    """BERT-base: 108,890,112 parameters on both sides (the JAX count read
    by shape)."""
    shapes = jax.eval_shape(
        JaxBert(JaxBertConfig.base()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 512), jnp.int32))["params"]
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes))
    model = Bert(BertConfig.base(), device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_jax == 108_890_112


def test_random_init_uses_flax_scales():
    model = Bert(BertConfig.tiny(dtype=torch.float32))
    model.init_weights(torch.Generator().manual_seed(0))
    assert abs(model.tok_emb.weight.std().item() - 128 ** -0.5) < 5e-3
    assert abs(model.pos_emb.std().item() - 0.02) < 2e-3
    w = model.layers[1].fc_in.weight  # fan-in 128
    assert abs(w.std().item() - 128 ** -0.5) < 3e-3
    assert model.layers[1].ln_mlp.weight.eq(1).all()


def test_bf16_compute_over_f32_parameters():
    cfg = BertConfig.tiny(max_len=16)
    model = Bert(cfg).init_weights(torch.Generator().manual_seed(0))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with torch.no_grad():
        out = model(torch.from_numpy(_ids(2, 16)).long())
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
