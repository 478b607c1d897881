"""``seq`` meshes on the plain path of the port's meshed training, in gloo
worlds on the CPU.

A mesh whose axes above 1 are among ``data``, ``fsdp`` and ``seq`` trains
plain modules (``parallel.mesh.data_parallel``): each rank holds its rows
of the batch and its block of positions as plain tensors, the modules that
see a block of positions get the mesh (learned and rotary positions at the
block's offset, ring or Ulysses attention on the local blocks) and the MoE
blocks route every rank's tokens in the one-device order. Worlds of 2 and
4 rank processes (``tests/torch_mesh_ranks.py``) are spawned together,
once for the module, and the test process runs the one-process port and
the JAX package beside them, from the same seeded numpy batches in f32
(tiny GPT or BERT, 2 layers, 4 heads, seq 32, batch 4, AdamW, converted JAX
weights):

- ring GPT under ``seq 2``, ``data 2 x seq 2`` and ``fsdp 2 x seq 2`` (the
  shipped Crons' layout), the last also with ``remat``; GPT with Switch-MoE
  blocks (every second block, 4 experts, capacity factor 1, so tokens are
  dropped) under ``data 2 x seq 2``, 2 rows a rank; GPT with GQA and RoPE
  under ring ``seq 2``; BERT with Ulysses under ``seq 2``.
- Each run: the path taken (``ddp`` or ``fsdp``); the losses of 5 steps and
  the first step's gradients against the one-process port (rtol 1e-5, atol
  1e-5 of each tensor's largest magnitude, as ``test_torch_parallel.py``)
  and against the JAX sharded ``Trainer`` on a mesh of the same axes
  (losses within 5e-5, gradients ``jax.grad``'s within rtol 1e-4); the same
  5 steps in calls of 4 leave the losses and the parameters of calls of one
  step, to the bit; each rank counts a step's model FLOPs over the global
  batch, as one process does; the parameters lie as ``sharding_for_tree``
  places them.
- The MoE run routed in rank order (batch shard, seq block, row, position)
  instead of the one-device order gives other losses, more than ten times
  the bound the one-device order meets: the order matters at 2 rows a
  rank.

The card's side (the ring and Ulysses steps captured over NCCL) is in
``hack/torch_mesh_cards.py``'s graph legs.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.models import GPT as JaxGPT
from cron_operator_tpu.models import Bert as JaxBert
from cron_operator_tpu.models import BertConfig as JaxBertConfig
from cron_operator_tpu.models import GPTConfig as JaxGPTConfig
from cron_operator_tpu.parallel.mesh import mesh_for_devices as jax_mesh
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu.workloads.train import cross_entropy_loss as jax_xent
from cron_operator_tpu_torch.models.bert import Bert, BertConfig
from cron_operator_tpu_torch.models.convert import params_from_flax
from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
from cron_operator_tpu_torch.parallel.mesh import (
    plan_for_devices,
    sharding_for_tree,
)
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer
from test_torch_parallel import LOSS_ATOL, _close
from torch_mesh_ranks import start_world, wait_world

SEQ, BATCH, STEPS, CHUNK = 32, 4, 5, 4
SP_TRAIN = {"seq_dim_in_batch": 1, "labels_follow_seq": True}
RING = {"attention_impl": "ring"}
MOE = {**RING, "moe_every": 2, "num_experts": 4, "moe_capacity_factor": 1.0}
# name: (world, axes, model, model overrides, train overrides, path)
RUNS = {
    "gpt_ring_seq2": (2, {"seq": 2}, "gpt", RING, {}, "ddp"),
    "gpt_ring_data2_seq2": (4, {"seq": 2}, "gpt", RING, {}, "ddp"),
    "gpt_ring_fsdp2_seq2": (4, {"fsdp": 2, "seq": 2}, "gpt", RING, {},
                            "fsdp"),
    "gpt_ring_fsdp2_seq2_remat": (4, {"fsdp": 2, "seq": 2}, "gpt", RING,
                                  {"remat": True}, "fsdp"),
    "gpt_moe_data2_seq2": (4, {"seq": 2}, "gpt", MOE, {}, "ddp"),
    "gpt_gqa_rope_ring_seq2": (2, {"seq": 2}, "gpt",
                               {**RING, "num_kv_heads": 2, "rope": True}, {},
                               "ddp"),
    "bert_ulysses_seq2": (2, {"seq": 2}, "bert",
                          {"attention_impl": "ulysses"}, {}, "ddp"),
}
STREAMS = {"gpt": "causal_token_batches", "bert": "token_batches"}


def _jax_config(model, over):
    maker = JaxBertConfig.tiny if model == "bert" else JaxGPTConfig.tiny
    return maker(dtype=jnp.float32, max_len=SEQ, **over)


def _port_config(model, over):
    maker = BertConfig.tiny if model == "bert" else GPTConfig.tiny
    return maker(dtype=torch.float32, max_len=SEQ, **over)


def _port_model(model, over):
    return (Bert if model == "bert" else GPT)(_port_config(model, over))


def _flax_params(model, over):
    """Seed-0 parameters of the JAX model, as numpy (they do not depend on
    the attention: the plain model is initialised)."""
    cls = JaxBert if model == "bert" else JaxGPT
    plain = cls(replace(_jax_config(model, over), attention_impl="xla"))
    params = plain.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, SEQ), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _one_process(model, over, train_kw, weights):
    """The one-process port: losses, first step's gradients and the model
    FLOPs a step."""
    net = _port_model(model, over)
    net.load_state_dict(weights)
    trainer = Trainer(net, TrainConfig(
        steps_per_call=1, stage_async=False,
        aux_loss_in_output=getattr(net, "has_moe", False), **train_kw))
    batches = getattr(data, STREAMS[model])(BATCH, SEQ, 1024)
    stats = trainer.run(batches, 1)
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    stats += trainer.run(batches, STEPS)
    return {"losses": [s.loss for s in stats], "grads": grads,
            "flops": trainer.flops_per_step()}


def _jax_losses(model, over, train_kw, world, axes, params):
    """The JAX sharded Trainer's losses on a mesh of the same axes."""
    mesh = jax_mesh(jax.devices("cpu")[:world], **axes)
    cls = JaxBert if model == "bert" else JaxGPT
    net = cls(_jax_config(model, over), mesh=mesh)
    trainer = JaxTrainer(
        lambda p, x: net.apply({"params": p}, x), params, mesh,
        JaxTrainConfig(steps_per_call=1, stage_async=False,
                       aux_loss_in_output=model == "gpt", **SP_TRAIN,
                       **train_kw))
    stats = trainer.run(getattr(jax_data, STREAMS[model])(BATCH, SEQ, 1024),
                        STEPS)
    return [s.loss for s in stats]


def _jax_grads(model, over, params):
    """``jax.grad`` of the first step's loss on one device, as numpy (the
    same for every mesh and every attention)."""
    cls = JaxBert if model == "bert" else JaxGPT
    plain = cls(replace(_jax_config(model, over), attention_impl="xla"))
    batch = next(getattr(jax_data, STREAMS[model])(BATCH, SEQ, 1024))

    def loss_of(p):
        out = plain.apply({"params": p}, batch["x"])
        if model == "gpt":
            logits, aux = out
            return jax_xent(logits, batch["y"]) + aux
        return jax_xent(out, batch["y"])

    grads = jax.jit(jax.grad(loss_of))(params)
    return jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The ranks' results, and the one-process port's and the JAX
    package's beside them (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("seq_plain_worlds")
    jobs = {2: [], 4: []}
    result = {"flax": {}, "weights": {}, "one": {}, "jax": {}}
    for name, (world, axes, model, over, train_kw, _) in RUNS.items():
        params = _flax_params(model, over)
        weights = params_from_flax(params, _port_config(model, over))
        path = out / f"{name}.weights.pt"
        torch.save(weights, path)
        result["flax"][name] = params
        result["weights"][name] = weights
        jobs[world].append({
            "kind": "data_parallel", "name": name, "axes": axes,
            "model": model, "cfg": {"max_len": SEQ, **over},
            "stream": STREAMS[model], "weights": str(path), "batch": BATCH,
            "steps": STEPS, "chunk": CHUNK,
            "train": {**SP_TRAIN, **train_kw},
            "rank_order": "moe_every" in over})
    running = [start_world(w, js, out) for w, js in jobs.items()]
    grads = {}  # by model: runs of one model share the first step's
    try:
        for name, (world, axes, model, over, train_kw, _) in RUNS.items():
            params = result["flax"][name]
            result["one"][name] = _one_process(model, over, train_kw,
                                               result["weights"][name])
            key = (model, tuple(sorted(over.items())))
            if key not in grads:
                grads[key] = _jax_grads(model, over, params)
            result["jax"][name] = (
                _jax_losses(model, over, train_kw, world, axes, params),
                grads[key])
    finally:
        for procs in running:
            wait_world(procs)
    for world, js in jobs.items():
        for job in js:
            result[job["name"]] = [
                torch.load(out / f"{job['name']}.rank{r}.pt",
                           weights_only=False) for r in range(world)]
    return result


@pytest.mark.parametrize("run", sorted(RUNS))
def test_seq_meshes_train_plain_modules_as_one_process(worlds, run):
    ranks = worlds[run]
    assert [r["path"] for r in ranks] == [RUNS[run][5]] * len(ranks)
    ref = worlds["one"][run]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]  # the global loss
    got = ranks[0]
    assert len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    for name, g in ref["grads"].items():
        _close(got["grads"][name], g)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_seq_meshes_train_as_the_jax_sharded_trainer(worlds, run):
    model, over = RUNS[run][2:4]
    want, jax_grads = worlds["jax"][run]
    got = worlds[run][0]
    assert max(abs(a - b) for a, b in zip(got["losses"], want)) <= LOSS_ATOL
    want_grads = params_from_flax(jax_grads, _port_config(model, over))
    for name, g in want_grads.items():
        _close(got["grads"][name], g, rtol=1e-4)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_seq_calls_of_several_steps_equal_calls_of_one(worlds, run):
    for got in worlds[run]:
        chunked = got["chunked"]
        # one record a call: steps 4 and 5
        assert chunked["losses"] == [got["losses"][CHUNK - 1],
                                     got["losses"][-1]]
        for name, value in got["final"].items():
            assert torch.equal(chunked["final"][name], value), name


@pytest.mark.parametrize("run", sorted(RUNS))
def test_seq_model_flops_count_the_global_batch(worlds, run):
    """Each rank counts a step's FLOPs over the whole batch and sequence,
    as one process does: the count drops the ``seq`` attachment too."""
    want = worlds["one"][run]["flops"]
    assert want
    for got in worlds[run]:
        assert got["chunked"]["flops"] == want


@pytest.mark.parametrize("run", sorted(RUNS))
def test_seq_plain_parameters_lie_as_the_rule_places_them(worlds, run):
    world, axes, model, over = RUNS[run][:4]
    plan = plan_for_devices(world, **axes)
    want = sharding_for_tree(_port_model(model, over), plan)
    for got in worlds[run]:
        assert got["mesh"] == plan.axis_sizes
        assert got["placements"] == {n: [str(p) for p in pl]
                                     for n, pl in want.items()}


def test_moe_routes_in_the_one_device_token_order(worlds):
    """At 2 rows a rank under ``data 2 x seq 2``, rank order (batch shard,
    seq block, row, position) is not the one-device order (row, position),
    and top-1 capacity fills slots in token order: routed in rank order,
    the run drops other tokens and its losses leave the one-process ones,
    where the one-device order keeps them (the tests above)."""
    ref = np.array(worlds["one"]["gpt_moe_data2_seq2"]["losses"])
    bound = 1e-5 * np.abs(ref).max()  # what the one-device order meets
    for got in worlds["gpt_moe_data2_seq2"]:
        wrong = np.array(got["rank_order_losses"])
        assert wrong.shape == ref.shape
        assert np.abs(wrong - ref).max() > 10 * bound
