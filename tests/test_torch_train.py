"""The port's training harness against the JAX package's.

- ``TrainConfig.lr_at`` gives optax's schedule values at every step.
- One optimizer step (AdamW with ``decay_mask`` and ``grad_clip``) on a GPT
  tiny from converted weights moves every parameter as the optax step
  does; that pins the decay mask's rank rule for the flattened qkv bias.
  The clip formula is pinned on its own against ``optax.clip_by_global_norm``.
- 20 steps of GPT tiny through the port's ``Trainer`` give the JAX
  ``Trainer``'s losses (``steps_per_call=1``, the same numpy
  ``causal_token_batches``), for MHA, GQA with RoPE and Switch-MoE blocks
  (the router's aux loss added to the loss, as ``aux_loss_in_output``)
  under AdamW and for MHA and MoE under SGD (parameters compared too), on
  the ``xla`` path, and once on the ``flash`` path (the port's plain K1-K3 through the autograd Function
  against the JAX kernels in interpret mode).
- Multi-step calls: 10 steps at ``steps_per_call`` 1, 2 and 5 (host data,
  staged ahead or inline) leave bit-identical parameters; at
  ``steps_per_call=4`` the losses are the JAX ``Trainer``'s at 4; fused
  data trains on the batches the device stream draws from the same seed;
  ``per_step_stats`` splits a call into its steps.

Everything runs in f32 on the CPU; each tolerance is stated where it is
used. Parameters are compared under SGD only: under AdamW an element whose
gradient is about 0 takes a step of about +-lr whose sign is rounding noise.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cron_operator_tpu.models.gpt import GPT as JaxGPT
from cron_operator_tpu.models.gpt import GPTConfig as JaxGPTConfig
from cron_operator_tpu.parallel.mesh import mesh_for_devices
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu.workloads.train import cross_entropy_loss as jax_xent_loss
from cron_operator_tpu_torch.models import GPT, GPTConfig
from cron_operator_tpu_torch.models.convert import flax_rank, params_from_flax
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.train import (
    StepStats,
    TrainConfig,
    Trainer,
    clip_by_global_norm_,
    cross_entropy_loss,
)


def _pair(seq, impl="xla", noise=0.0, **over):
    """A JAX GPT tiny's f32 params (optionally perturbed, so that biases are
    not 0) and the port's model loaded from them."""
    jcfg = JaxGPTConfig.tiny(dtype=jnp.float32, attention_impl=impl,
                             attention_interpret=True, max_len=seq, **over)
    tcfg = GPTConfig.tiny(dtype=torch.float32, attention_impl=impl,
                          max_len=seq, **over)
    params = JaxGPT(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, seq), jnp.int32)
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    if noise:
        rng = np.random.default_rng(1)
        params = jax.tree_util.tree_map(
            lambda a: a + noise * rng.standard_normal(a.shape, np.float32),
            params,
        )
    model = GPT(tcfg)
    model.load_state_dict(params_from_flax(params, tcfg))
    return jcfg, tcfg, params, model


def _tiny(seq=32):
    """The port's GPT tiny in f32 with seeded random weights."""
    model = GPT(GPTConfig.tiny(dtype=torch.float32, max_len=seq))
    return model.init_weights(torch.Generator().manual_seed(0))


# ----------------------------------------------------------------- lr_at


@pytest.mark.parametrize(
    "schedule, warmup, total",
    [("constant", 0, 0), ("cosine", 0, 10), ("warmup_cosine", 3, 10),
     ("warmup_cosine", 0, 7), ("warmup_cosine", 12, 10)],
)
def test_lr_at_matches_optax(schedule, warmup, total):
    kw = dict(learning_rate=3e-3, lr_schedule=schedule, warmup_steps=warmup,
              schedule_steps=total)
    ours = TrainConfig(**kw).lr_at()
    ref = JaxTrainConfig(**kw).lr_at()
    for step in range(0, 16):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6,
                                           abs=1e-12), step


def test_lr_at_refuses_what_optax_refuses():
    with pytest.raises(ValueError, match="schedule_steps"):
        TrainConfig(lr_schedule="cosine").lr_at()
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        TrainConfig(lr_schedule="step").lr_at()


# --------------------------------------------------- one optimizer step


def test_one_adamw_step_with_decay_mask_and_clip_matches_optax():
    """A strong weight decay (0.5, lr 1e-2: a decay step of 5e-3 * p)
    makes a wrong mask visible on every decayed element; the perturbed
    biases are not 0, so the flattened qkv bias shows whether it decays."""
    seq = 16
    jcfg, tcfg, params, model = _pair(seq, noise=0.05)
    batch = next(jax_data.causal_token_batches(2, seq, 1024, seed=4))
    kw = dict(learning_rate=1e-2, weight_decay=0.5, decay_mask=True,
              grad_clip_norm=0.5)

    def loss_of(p):
        logits, _ = JaxGPT(jcfg).apply({"params": p}, batch["x"])
        return jax_xent_loss(logits, batch["y"])

    grads = jax.jit(jax.grad(loss_of))(params)
    tx = JaxTrainConfig(**kw).make_optimizer()
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    want = params_from_flax(optax.apply_updates(params, updates), tcfg)
    g_norm = float(optax.global_norm(grads))
    assert g_norm > 0.5  # the clip is active
    clipped = params_from_flax(
        jax.tree_util.tree_map(lambda g: g * 0.5 / g_norm, grads), tcfg
    )

    trainer = Trainer(model, TrainConfig(**kw))
    trainer.step(batch)
    got = dict(model.named_parameters())
    for name, ref in want.items():
        diff = (got[name].detach() - ref).abs()
        # Elements with a clear gradient take the same Adam step, sign
        # included: the difference is f32 rounding. Elements whose clipped
        # gradient is below 1e-6 may step +-lr on either side.
        clear = clipped[name].abs() > 1e-6
        if clear.any():
            assert diff[clear].max().item() < 1e-5, name
        assert diff.max().item() <= 2 * kw["learning_rate"] + 1e-5, name


def test_decay_mask_follows_the_flax_ranks():
    """optax decays flax's rank-3 qkv bias (and the rank-2/3 q/kv biases of
    GQA), which the port stores flattened to rank 1."""
    for over, decayed_bias in (({}, "layers.0.attn.qkv.bias"),
                               ({"num_kv_heads": 2}, "layers.0.attn.kv.bias")):
        model = GPT(GPTConfig.tiny(dtype=torch.float32, **over))
        opt = TrainConfig(decay_mask=True).make_optimizer(model)
        decayed = {id(p) for g in opt.param_groups if g["weight_decay"] > 0
                   for p in g["params"]}
        names = {n for n, p in model.named_parameters() if id(p) in decayed}
        assert decayed_bias in names
        assert "layers.0.out.bias" not in names
        assert "layers.0.ln_attn.weight" not in names
        assert "tok_emb.weight" in names and "layers.0.fc_in.weight" in names
    assert flax_rank("layers.3.attn.q.bias", torch.zeros(8)) == 2


def test_decay_mask_needs_adamw():
    with pytest.raises(ValueError, match="adamw"):
        TrainConfig(decay_mask=True, optimizer="sgd").make_optimizer(
            GPT(GPTConfig.tiny()))


@pytest.mark.parametrize("scale", [1e-7, 1.0, 30.0])
def test_clip_matches_optax_clip_by_global_norm(scale):
    """No epsilon in the norm: at a global norm of 1e-7 against a bound of
    5e-8 optax halves the gradients, where ``clip_grad_norm_``'s 1e-6 would
    scale them by 1/22."""
    rng = np.random.default_rng(2)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    arrays = [a * scale / np.sqrt(sum((x ** 2).sum() for x in arrays))
              for a in arrays]  # global norm == scale
    max_norm = 0.5 * scale if scale < 1 else 5.0
    tx = optax.clip_by_global_norm(max_norm)
    want, _ = tx.update(arrays, tx.init(arrays))
    got = [torch.tensor(a) for a in arrays]
    clip_by_global_norm_(got, max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11), dtype=np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    want = float(jax_xent_loss(logits, labels))
    got = cross_entropy_loss(torch.tensor(logits), torch.tensor(labels))
    assert abs(got.item() - want) <= 1e-6 * abs(want)


# ------------------------------------------------------ 20 training steps


def _jax_losses(jcfg, params, seq, steps, **train_kw):
    model = JaxGPT(jcfg)
    trainer = JaxTrainer(
        lambda p, x: model.apply({"params": p}, x), params,
        mesh_for_devices(jax.devices("cpu")[:1]),
        JaxTrainConfig(steps_per_call=1, stage_async=False,
                       aux_loss_in_output=True, **train_kw),
    )
    stats = trainer.run(jax_data.causal_token_batches(2, seq, 1024), steps)
    return [s.loss for s in stats], trainer.state.params


# Per-step losses agree to f32 rounding carried through 20 updates: at most
# 3.4e-6 apart in these runs, held to 5e-5.
LOSS_ATOL = 5e-5
RUNS = {
    # name: (seq, impl, model overrides, train kwargs)
    "mha-adamw": (32, "xla", {}, {}),
    "gqa_rope-adamw": (32, "xla", {"num_kv_heads": 2, "rope": True}, {}),
    "mha-sgd": (32, "xla", {}, {"optimizer": "sgd", "learning_rate": 0.05}),
    "flash-adamw": (128, "flash", {}, {}),
    # Switch-MoE blocks (layer 1 of 2, 4 experts, the aux loss added)
    "moe-adamw": (32, "xla", {"moe_every": 2, "num_experts": 4}, {}),
    "moe-sgd": (32, "xla", {"moe_every": 2, "num_experts": 4},
                {"optimizer": "sgd", "learning_rate": 0.05}),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_twenty_steps_match_the_jax_trainer(run):
    seq, impl, over, train_kw = RUNS[run]
    jcfg, tcfg, params, model = _pair(seq, impl=impl, **over)
    want, jax_params = _jax_losses(jcfg, params, seq, 20, **train_kw)
    trainer = Trainer(model, TrainConfig(aux_loss_in_output=model.has_moe,
                                         **train_kw))
    stats = trainer.run(data.causal_token_batches(2, seq, 1024), 20)
    got = [s.loss for s in stats]
    assert len(got) == 20 and trainer.steps_done == 20
    assert got[-1] < got[0]
    assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_ATOL, (got, want)
    if train_kw.get("optimizer") == "sgd":
        ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jax_params),
                               tcfg)
        for name, p in model.named_parameters():
            assert (p.detach() - ref[name]).abs().max().item() < 1e-5, name


def test_remat_gives_the_same_steps():
    """``remat`` recomputes the forward in the backward
    (``torch.utils.checkpoint``): the same losses and parameters."""
    runs = []
    for remat in (False, True):
        model = _tiny()
        trainer = Trainer(model, TrainConfig(remat=remat))
        stats = trainer.run(data.causal_token_batches(2, 32, 1024), 3)
        runs.append(([s.loss for s in stats], model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for name, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][name]), name


def test_moe_aux_loss_is_added_eager_and_under_remat():
    """Under ``aux_loss_in_output`` the step's loss is the task loss plus
    the model's aux (the router balance loss times ``moe_aux_weight``),
    and ``remat`` recomputes both: the same losses and parameters."""
    cfg = GPTConfig.tiny(dtype=torch.float32, max_len=32, moe_every=2,
                         num_experts=4)
    batches = list(itertools.islice(data.causal_token_batches(2, 32, 1024),
                                    3))
    runs = []
    for remat in (False, True):
        model = GPT(cfg).init_weights(torch.Generator().manual_seed(0))
        x, y = (torch.as_tensor(batches[0][k]) for k in ("x", "y"))
        with torch.no_grad():
            logits, aux = model(x)
            want = (cross_entropy_loss(logits, y) + aux).item()
        assert aux.item() > 0
        trainer = Trainer(model, TrainConfig(remat=remat,
                                             aux_loss_in_output=True))
        stats = trainer.run(iter(batches), 3)
        assert stats[0].loss == pytest.approx(want, rel=1e-6)
        runs.append(([s.loss for s in stats], model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for name, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][name]), name


@pytest.mark.parametrize("stream", ["token_batches", "causal_token_batches"])
def test_token_streams_match_jax(stream):
    """``data=host``: the same seed gives the JAX package's batches."""
    ours = getattr(data, stream)(3, 16, 1000, seed=7)
    ref = getattr(jax_data, stream)(3, 16, 1000, seed=7)
    for _ in range(2):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_sync_every_fetches_the_loss_on_its_steps():
    """The first step, every ``sync_every``-th step counting from it, and
    the last fetch the loss (the JAX ``Trainer.run``'s rule); the others
    leave it on the device."""
    model = _tiny()
    trainer = Trainer(model, TrainConfig(sync_every=3))
    stats = trainer.run(data.causal_token_batches(2, 32, 1024), 8)
    assert [s.loss is not None for s in stats] == [
        True, False, True, False, False, True, False, True]
    assert trainer.first_dispatch_time_s == stats[0].step_time_s


def test_run_is_a_total_step_target_and_stops_on_request():
    model = _tiny()
    trainer = Trainer(model)
    batches = data.causal_token_batches(2, 32, 1024)
    assert len(trainer.run(batches, 2)) == 2
    assert len(trainer.run(batches, 3)) == 1  # only the remainder
    assert trainer.run(batches, 10, should_stop=lambda: True) == []
    assert trainer.steps_done == 3


# ------------------------------------------------------- multi-step calls


def _params_after(steps_per_call, stage_async=True, steps=10):
    model = _tiny()
    trainer = Trainer(model, TrainConfig(steps_per_call=steps_per_call,
                                         stage_async=stage_async))
    stats = trainer.run(data.causal_token_batches(2, 32, 1024), steps)
    assert trainer.steps_done == steps
    assert sum(s.chunk for s in stats) == steps
    return stats, {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def one_step_calls():
    return _params_after(1, stage_async=False)


@pytest.mark.parametrize("steps_per_call, stage_async", [
    (1, True),  # the Prefetcher
    (2, False),  # inline groups
    (5, True),  # the ChunkStager
], ids=["1-prefetched", "2-inline", "5-staged"])
def test_steps_per_call_leaves_bit_identical_params(
        one_step_calls, steps_per_call, stage_async):
    """Step i of a call takes the batch (and the learning rate) it would
    have taken as a call of its own: the parameters after 10 steps are the
    same bits as with calls of one step staged inline, whatever the
    chunking and the staging."""
    stats, params = _params_after(steps_per_call, stage_async)
    assert [s.chunk for s in stats] == [steps_per_call] * (10 // steps_per_call)
    ref_stats, ref = one_step_calls
    for name, p in ref.items():
        assert torch.equal(params[name], p), name
    # each call fetches its last step's loss, the one-step run's loss there
    want = {s.step: s.loss for s in ref_stats}
    assert [s.loss for s in stats] == [want[s.step] for s in stats]


def test_losses_at_steps_per_call_4_match_the_jax_trainer():
    """Calls of 4 steps on both sides, the same numpy batches: each call's
    last loss within the tolerance of the one-step runs above."""
    seq = 32
    jcfg, tcfg, params, model = _pair(seq)
    jax_model = JaxGPT(jcfg)
    jax_trainer = JaxTrainer(
        lambda p, x: jax_model.apply({"params": p}, x), params,
        mesh_for_devices(jax.devices("cpu")[:1]),
        JaxTrainConfig(steps_per_call=4, stage_async=False,
                       aux_loss_in_output=True),
    )
    want = jax_trainer.run(jax_data.causal_token_batches(2, seq, 1024), 12)
    trainer = Trainer(model, TrainConfig(steps_per_call=4))
    got = trainer.run(data.causal_token_batches(2, seq, 1024), 12)
    assert [s.chunk for s in got] == [s.chunk for s in want] == [4, 4, 4]
    assert [s.step for s in got] == [s.step for s in want]
    diffs = [abs(a.loss - b.loss) for a, b in zip(got, want)]
    assert max(diffs) <= LOSS_ATOL, (got, want)


def test_fused_data_trains_on_the_device_stream():
    """``sample_fn`` draws each step's batch inside the step from a
    generator seeded with ``data_seed``: the same batches as the device
    stream from that seed, so the same parameters, in calls of 3."""
    sample = data.causal_token_sample(2, 32, 1024)
    runs = []
    for fused in (False, True):
        model = _tiny()
        trainer = Trainer(model, TrainConfig(steps_per_call=3, data_seed=4),
                          sample_fn=sample if fused else None)
        batches = (itertools.repeat({}) if fused else
                   data.device_batches(sample, device="cpu", seed=4))
        trainer.run(batches, 6)
        runs.append(dict(model.named_parameters()))
    for name, p in runs[0].items():
        assert torch.equal(p, runs[1][name]), name


def test_one_external_batch_cannot_feed_a_call_of_several_steps():
    trainer = Trainer(_tiny())
    batch = next(data.causal_token_batches(2, 32, 1024))
    with pytest.raises(ValueError, match="chunk > 1 requires fused data"):
        trainer.step(batch, chunk=2)
    stats = trainer.step(trainer.put_chunk([batch, batch]))
    assert stats.chunk == 2 and trainer.steps_done == 2


def test_per_step_stats_split_a_call():
    """One record per step, the phase walls split evenly, the loss (and
    the checkpoint stall) on the last step, as the JAX ``per_step_stats``."""
    call = StepStats(step=7, loss=1.5, step_time_s=0.25, chunk=4, data_s=0.4,
                     dispatch_s=0.8, sync_s=1.2, ckpt_s=0.1, compiled=True)
    steps = Trainer.per_step_stats(call)
    assert [s.step for s in steps] == [4, 5, 6, 7]
    assert [s.loss for s in steps] == [None, None, None, 1.5]
    assert [s.ckpt_s for s in steps] == [0.0, 0.0, 0.0, 0.1]
    for s in steps:
        assert (s.chunk, s.step_time_s, s.compiled) == (1, 0.25, True)
        assert (s.data_s, s.dispatch_s, s.sync_s) == (0.1, 0.2, 0.3)
    single = StepStats(step=1, loss=2.0, step_time_s=0.5)
    assert Trainer.per_step_stats(single) == [single]


def test_auto_steps_per_call_resolves_to_8():
    assert Trainer(_tiny(), TrainConfig(steps_per_call="auto")
                   ).resolved_steps_per_call == 8
    with pytest.raises(ValueError, match="steps_per_call"):
        Trainer(_tiny(), TrainConfig(steps_per_call="8"))
