"""The port's training over a device mesh, in gloo worlds on the CPU.

Worlds of 4 and 2 rank processes (``tests/torch_mesh_ranks.py``, one
thread each) are spawned together, once for the module; the test process runs the
one-process port and the JAX package beside them.

- Tiny GPT (f32, 2 layers, 4 heads, seq 32, batch 4 of the numpy
  ``causal_token_batches``, AdamW, converted JAX weights) under data 2 x
  fsdp 2 (with a global-norm clip that bites), tensor 2 and, with
  Switch-MoE blocks (every second block, 4 experts), expert 2: the losses of 5 steps and the first step's gradients
  equal the one-process port's within rtol 1e-5 (atol 1e-5 of each
  tensor's largest magnitude: sums over ranks run in another order), and
  every rank reports the same global loss. (Parameters are not compared
  after AdamW steps: the k bias, whose gradient is 0 up to rounding, takes
  steps of about +-lr whose sign is that rounding.) The losses equal
  the JAX ``Trainer``'s on a mesh of the same axes over its virtual CPU
  devices within 5e-5 (the bound of the one-device comparison in
  ``test_torch_train.py``), and the gradients ``jax.grad``'s within rtol
  1e-4.
- Placements: under data 2 x fsdp 2 every parameter lies as
  ``parallel.mesh.sharding_for_tree`` says; under ``tensor 2`` and
  ``expert 2`` the model trains plain modules (DDP), under ``tensor`` each
  rank holding its heads' rows of ``qkv`` and its slice of ``fc_in`` and
  the matching input columns of ``out`` and ``fc_out``, under ``expert``
  its 2 of the 4 experts' ``wi`` and ``wo``, every other parameter whole
  (``tests/test_torch_tensor_plain.py`` and
  ``tests/test_torch_expert_plain.py`` take those paths further).
The elastic chain (checkpoints across world sizes) is in
``test_torch_mesh.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cron_operator_tpu.models.gpt import GPT as JaxGPT
from cron_operator_tpu.models.gpt import GPTConfig as JaxGPTConfig
from cron_operator_tpu.parallel.mesh import mesh_for_devices as jax_mesh
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu.workloads.train import cross_entropy_loss as jax_xent
from cron_operator_tpu_torch.models.convert import params_from_flax
from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
from cron_operator_tpu_torch.parallel.mesh import (
    plan_for_devices,
    sharding_for_tree,
)
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer
from torch_mesh_ranks import start_world, wait_world

SEQ, BATCH, STEPS = 32, 4, 5
MOE = {"moe_every": 2, "num_experts": 4}
# name: (world, axes, model overrides, TrainConfig overrides); the global
# norm clip (a seventh of the first step's norm, about 3.5) bites under fsdp,
# where each rank holds shards of the gradients
RUNS = {
    "data_fsdp": (4, {"fsdp": 2}, {}, {"grad_clip_norm": 0.5}),
    "tensor": (2, {"tensor": 2}, {}, {}),
    "expert": (2, {"expert": 2}, MOE, {}),
}
LOSS_ATOL = 5e-5


def _flax_params(over):
    cfg = JaxGPTConfig.tiny(dtype=jnp.float32, attention_impl="xla",
                            max_len=SEQ, **over)
    params = JaxGPT(cfg).init(jax.random.PRNGKey(0),
                              jnp.zeros((1, SEQ), jnp.int32))["params"]
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _port_config(over):
    return GPTConfig.tiny(dtype=torch.float32, attention_impl="xla",
                          max_len=SEQ, **over)


def _one_process(weights, over, train_kw):
    """The one-process port run of a RUNS entry: the losses and the first
    step's gradients."""
    model = GPT(_port_config(over))
    model.load_state_dict(weights)
    trainer = Trainer(model, TrainConfig(steps_per_call=1, stage_async=False,
                                         aux_loss_in_output=model.has_moe,
                                         **train_kw))
    batches = data.causal_token_batches(BATCH, SEQ, 1024)
    stats = trainer.run(batches, 1)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats += trainer.run(batches, STEPS)
    return {"losses": [s.loss for s in stats], "grads": grads}


def _jax_run(jcfg, params, world, axes, train_kw):
    """The JAX Trainer's losses on a mesh of the same axes, and jax.grad
    of the first step's loss (clipped as the step clips it)."""
    model = JaxGPT(jcfg)
    trainer = JaxTrainer(
        lambda p, x: model.apply({"params": p}, x), params,
        jax_mesh(jax.devices("cpu")[:world], **axes),
        JaxTrainConfig(steps_per_call=1, stage_async=False,
                       aux_loss_in_output=True, **train_kw),
    )
    stats = trainer.run(jax_data.causal_token_batches(BATCH, SEQ, 1024),
                        STEPS)
    batch = next(jax_data.causal_token_batches(BATCH, SEQ, 1024))

    def loss_of(p):
        logits, aux = model.apply({"params": p}, batch["x"])
        return jax_xent(logits, batch["y"]) + aux

    grads = jax.jit(jax.grad(loss_of))(params)
    if train_kw.get("grad_clip_norm"):  # the port's p.grad is clipped
        clip = optax.clip_by_global_norm(train_kw["grad_clip_norm"])
        grads, _ = clip.update(grads, clip.init(grads))
    return [s.loss for s in stats], jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("worlds")
    jobs = {4: [], 2: []}
    result = {"flax": {}, "weights": {}}
    for name, (world, axes, over, train_kw) in RUNS.items():
        jcfg, params = _flax_params(over)
        weights = params_from_flax(params, _port_config(over))
        path = out / f"{name}.weights.pt"
        torch.save(weights, path)
        result["flax"][name] = (jcfg, params)
        result["weights"][name] = weights
        jobs[world].append({"kind": "train", "name": name, "axes": axes,
                            "cfg": {"max_len": SEQ, **over},
                            "weights": str(path), "batch": BATCH,
                            "steps": STEPS, "train": train_kw})
    running = [start_world(w, js, out) for w, js in jobs.items()]
    for procs in running:
        wait_world(procs)
    for world, js in jobs.items():
        for job in js:
            result[job["name"]] = [
                torch.load(out / f"{job['name']}.rank{r}.pt",
                           weights_only=False) for r in range(world)]
    return result


def _close(got, want, rtol=1e-5):
    atol = rtol * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_sharded_training_matches_one_process(worlds, run):
    ranks = worlds[run]
    ref = _one_process(worlds["weights"][run], *RUNS[run][2:])
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]  # the global loss, everywhere
    got = ranks[0]
    assert len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    for name, g in ref["grads"].items():
        _close(got["grads"][name], g)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_sharded_training_matches_the_jax_trainer(worlds, run):
    world, axes, over, train_kw = RUNS[run]
    jcfg, params = worlds["flax"][run]
    want, jax_grads = _jax_run(jcfg, params, world, axes, train_kw)
    got = worlds[run][0]
    assert max(abs(a - b) for a, b in zip(got["losses"], want)) <= LOSS_ATOL
    want_grads = params_from_flax(jax_grads, _port_config(over))
    for name, g in want_grads.items():
        _close(got["grads"][name], g, rtol=1e-4)


# Under tensor 2 the transformer's blocks keep their pieces, under expert 2
# the MoE blocks their experts: the dim of each split parameter (its name's
# last two components) that holds half
SPLIT_DIMS = {
    "tensor": {"qkv.weight": 0, "qkv.bias": 0, "out.weight": 1,
               "fc_in.weight": 0, "fc_in.bias": 0, "fc_out.weight": 1,
               # the tied table's vocab rows (1024: 512 a rank)
               "tok_emb.weight": 0},
    "expert": {"moe.wi": 0, "moe.wo": 0},
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_parameters_lie_as_the_rule_places_them(worlds, run):
    world, axes, over, _ = RUNS[run]
    got = worlds[run][0]
    assert got["mesh"] == plan_for_devices(world, **axes).axis_sizes
    model = GPT(_port_config(over))
    if run in SPLIT_DIMS:  # the plain path: plain pieces under DDP
        assert [r["path"] for r in worlds[run]] == ["ddp"] * world
        for rank in worlds[run]:
            assert all(p == ["R", "R"] for p in rank["placements"].values())
            for name, p in model.named_parameters():
                shape = list(p.shape)
                dim = SPLIT_DIMS[run].get(".".join(name.split(".")[-2:]))
                if dim is not None:
                    shape[dim] //= 2
                assert rank["shapes"][name] == tuple(shape), name
        return
    want = sharding_for_tree(model, plan_for_devices(world, **axes))
    assert got["placements"] == {n: [str(p) for p in pl]
                                 for n, pl in want.items()}
