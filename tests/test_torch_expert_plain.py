"""``expert`` meshes on the plain path of the port's meshed training, in
gloo worlds on the CPU.

A mesh whose axes above 1 are among ``data``, ``fsdp``, ``seq``,
``expert`` and (for GPT, BERT and ViT) ``tensor`` trains plain modules.
The batch layout is JAX's: the batch is split over ``data`` and ``fsdp``
(and its positions over ``seq``), never over ``expert``, so the ranks of
an ``expert`` group hold the same rows. ``parallel.mesh.data_parallel``
first has each MoE block keep its E/n experts' ``wi`` and ``wo`` (JAX's
``P('expert')``, only when n divides E), the router and everything else
whole, then wraps the model in DDP or FSDP2 over the batch axes; the
experts' outputs are gathered over the ``expert`` group
(``parallel.moe.gather_experts``). Worlds of 2 and 4 rank processes
(``tests/torch_mesh_ranks.py``) are spawned together, once for the
module, and the test process runs the one-process port and the JAX
package beside them, from the same seeded numpy batches in f32 (tiny GPT:
2 layers, 4 heads, Switch-MoE every second block, 4 experts, capacity
factor 1, so tokens drop; seq 32, batch 4, AdamW, converted JAX weights):

- ``expert 2``; ``data 2 x expert 2`` with a global-norm clip that bites;
  ``fsdp 2 x expert 2``; ring ``seq 2 x expert 2``; ``tensor 2 x expert
  2`` (the experts over ``expert`` alone, at full width; attention and
  the dense FFN over ``tensor``); ``expert 2`` with 3 experts (left
  whole).
- Each run: the path taken (``ddp`` or ``fsdp``, never ``dtensor``); the
  losses of 5 steps and the first step's gradients (gathered whole)
  against the one-process port (rtol 1e-5, atol 1e-5 of each tensor's
  largest magnitude) and against the JAX sharded ``Trainer`` on a mesh of
  the same axes (losses within 5e-5, gradients ``jax.grad``'s within rtol
  1e-4), the bounds of ``tests/test_torch_tensor_plain.py``; after the
  steps the router and every whole parameter the same bits on each rank of
  an ``expert`` group; each rank holds the pieces the rule gives it; the
  same 5 steps in calls of 4 leave the losses and the parameters of calls
  of one step, to the bit; each rank counts a step's model FLOPs as one
  device does.
- ``moe_ffn`` and ``moe_ffn_reference`` with ``expert_group`` (under
  ``expert 2`` and ``data 2 x expert 2``) against one-process ``moe_ffn``:
  the output, and the gradients of x, the router and ``wi``/``wo``
  gathered whole; the router's gradient summed over ``expert`` as well
  (the trap of a replicated gradient) lies outside the bound that the
  right one meets.
- A checkpoint written under ``data 2 x expert 2``, restored and written
  again by one process, then restored under ``expert 2`` and written from
  its gathered state, holds the same bits at every stage (parameters and
  AdamW moments).

The card's side (the ``expert`` step captured over NCCL) is in
``hack/torch_mesh_cards.py``'s graph legs and
``tests/test_torch_expert_plain_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cron_operator_tpu.models import GPT as JaxGPT
from cron_operator_tpu.models import GPTConfig as JaxGPTConfig
from cron_operator_tpu.parallel.mesh import mesh_for_devices as jax_mesh
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu.workloads.train import cross_entropy_loss as jax_xent
from cron_operator_tpu_torch.models.convert import params_from_flax
from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
from cron_operator_tpu_torch.parallel.mesh import MeshPlan, plain_axes
from cron_operator_tpu_torch.parallel.moe import init_moe_params, moe_ffn
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer
from test_torch_parallel import LOSS_ATOL, _close
from torch_mesh_ranks import start_world, wait_world

SEQ, BATCH, STEPS, CHUNK = 32, 4, 5, 4
MOE = {"moe_every": 2, "num_experts": 4, "moe_capacity_factor": 1.0}
RING = {"attention_impl": "ring"}
SP_TRAIN = {"seq_dim_in_batch": 1, "labels_follow_seq": True}
# name: (world, axes, model overrides, train overrides, path)
RUNS = {
    "expert2": (2, {"expert": 2}, MOE, {}, "ddp"),
    # the clip (about a seventh of the first step's norm) bites
    "data2_expert2_clip": (4, {"expert": 2}, MOE, {"grad_clip_norm": 0.5},
                           "ddp"),
    "fsdp2_expert2": (4, {"fsdp": 2, "expert": 2}, MOE, {}, "fsdp"),
    "ring_seq2_expert2": (4, {"seq": 2, "expert": 2}, {**MOE, **RING},
                          SP_TRAIN, "ddp"),
    "tensor2_expert2": (4, {"expert": 2, "tensor": 2}, MOE, {}, "ddp"),
    "expert2_three_experts": (2, {"expert": 2}, {**MOE, "num_experts": 3},
                              {}, "ddp"),
}
# The dim of each split parameter (by its name's last components) that a
# rank of a group of 2 holds half of, and the axis it splits over
EXPERT_DIMS = {"moe.wi": 0, "moe.wo": 0}
TENSOR_DIMS = {"attn.qkv.weight": 0, "attn.qkv.bias": 0, "out.weight": 1,
               "fc_in.weight": 0, "fc_in.bias": 0, "fc_out.weight": 1,
               # the tied table's vocab rows (1024: 512 a rank)
               "tok_emb.weight": 0}
# moe_ffn alone: 64 tokens, 4 experts at capacity factor 1
MOE_FFN = {"seed": 5, "d": 16, "f": 32, "experts": 4, "tokens": 64,
           "capacity_factor": 1.0}
CHAIN = {"cfg": {"max_len": SEQ, **MOE}, "batch": BATCH}


def _port_config(over):
    return GPTConfig.tiny(dtype=torch.float32, max_len=SEQ,
                          **{"attention_impl": "xla", **over})


def _jax_config(over):
    return JaxGPTConfig.tiny(dtype=jnp.float32, max_len=SEQ, **over)


def _flax_params(over):
    """Seed-0 parameters of the JAX model, as numpy (they do not depend on
    the attention: the plain model is initialised)."""
    plain = JaxGPT(replace(_jax_config(over), attention_impl="xla"))
    params = jax.jit(plain.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, SEQ), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _one_process(over, train_kw, weights):
    """The one-process port: losses, first step's gradients and the model
    FLOPs a step."""
    net = GPT(_port_config(over))
    net.load_state_dict(weights)
    trainer = Trainer(net, TrainConfig(
        steps_per_call=1, stage_async=False, aux_loss_in_output=True,
        **train_kw))
    batches = data.causal_token_batches(BATCH, SEQ, 1024)
    stats = trainer.run(batches, 1)
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    stats += trainer.run(batches, STEPS)
    return {"losses": [s.loss for s in stats], "grads": grads,
            "flops": trainer.flops_per_step()}


def _jax_reference(name):
    """The JAX package's side of run ``name``: the sharded Trainer's
    losses on a mesh of the same axes and the first step's (clipped)
    ``jax.grad`` on one device. The fixture runs it in processes of their
    own, beside the ranks."""
    world, axes, over, train_kw = RUNS[name][:4]
    params = _flax_params(over)
    mesh = jax_mesh(jax.devices("cpu")[:world], **axes)
    ring = over.get("attention_impl") == "ring"
    net = JaxGPT(_jax_config(over), **({"mesh": mesh} if ring else {}))
    trainer = JaxTrainer(
        lambda p, x: net.apply({"params": p}, x), params, mesh,
        JaxTrainConfig(steps_per_call=1, stage_async=False,
                       aux_loss_in_output=True, **train_kw))
    losses = [s.loss for s in trainer.run(
        jax_data.causal_token_batches(BATCH, SEQ, 1024), STEPS)]
    plain = JaxGPT(replace(_jax_config(over), attention_impl="xla"))
    batch = next(jax_data.causal_token_batches(BATCH, SEQ, 1024))

    def loss_of(p):
        logits, aux = plain.apply({"params": p}, batch["x"])
        return jax_xent(logits, batch["y"]) + aux

    grads = jax.jit(jax.grad(loss_of))(params)
    if train_kw.get("grad_clip_norm"):  # the port's p.grad is clipped
        clip = optax.clip_by_global_norm(train_kw["grad_clip_norm"])
        grads, _ = clip.update(grads, clip.init(grads))
    return losses, jax.tree_util.tree_map(np.asarray, grads)


def _wait_for_step(root, timeout=300.0) -> None:
    store = CheckpointStore("ns", "chain", root=root, max_to_keep=100)
    deadline = time.monotonic() + timeout
    try:
        while store.latest_step() is None:
            if time.monotonic() > deadline:
                raise TimeoutError(f"no checkpoint under {root}")
            time.sleep(0.2)
    finally:
        store.close()


def _one_rank_round_trip(src, dst) -> int:
    """One process restores the newest step at ``src`` and writes its
    ``host_state`` at that step to ``dst``; returns the step."""
    cfg = _port_config(MOE)
    model = GPT(cfg).init_weights(torch.Generator().manual_seed(0))
    store = CheckpointStore("ns", "chain", root=src, max_to_keep=100)
    out = CheckpointStore("ns", "chain", root=dst)
    try:
        trainer = Trainer(
            model, TrainConfig(steps_per_call=1, aux_loss_in_output=True),
            sample_fn=data.causal_token_sample(BATCH, SEQ, cfg.vocab_size),
            checkpoint=store)
        out.save(trainer.steps_done, trainer.host_state())
    finally:
        out.close()
        store.close()
    return trainer.steps_done


def _moe_one_process():
    """One-process ``moe_ffn`` on the whole seeded batch of the
    ``moe_expert`` job, with its objective: the output, the aux loss, and
    the gradients of x and of every parameter."""
    gen = torch.Generator().manual_seed(MOE_FFN["seed"])
    init = init_moe_params(gen, d_model=MOE_FFN["d"], d_ff=MOE_FFN["f"],
                           n_experts=MOE_FFN["experts"])
    x = torch.randn(MOE_FFN["tokens"], MOE_FFN["d"],
                    generator=gen).requires_grad_()
    params = {k: v.clone().requires_grad_() for k, v in init.items()}
    y, aux = moe_ffn(params, x, capacity_factor=MOE_FFN["capacity_factor"])
    ((y ** 2).sum() / MOE_FFN["tokens"] + 0.01 * aux).backward()
    return {"y": y.detach(), "aux": aux.detach(), "x_grad": x.grad,
            "grads": {k: p.grad for k, p in params.items()}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The ranks' results, and the one-process port's and the JAX
    package's beside them (computed while the ranks run, the JAX package's
    in three processes of its own)."""
    pool = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
        "spawn"))
    references = {name: pool.submit(_jax_reference, name) for name in RUNS}
    out = tmp_path_factory.mktemp("expert_plain_worlds")
    saved, resaved, gathered = (str(out / d) for d in
                                ("saved", "resaved", "gathered"))
    # the data 2 x expert 2 save first: the one-process leg waits for it
    jobs = {4: [{**CHAIN, "kind": "chain", "name": "save", "dir": saved,
                 "axes": {"expert": 2}, "steps": 2, "save_every": 2},
                {**MOE_FFN, "kind": "moe_expert", "name": "moe_data2",
                 "axes": {"expert": 2}}],
            2: [{**MOE_FFN, "kind": "moe_expert", "name": "moe_expert2",
                 "axes": {"expert": 2}}]}
    result = {"weights": {}, "one": {}}
    for name, (world, axes, over, train_kw, _) in RUNS.items():
        jobs[world].append({
            "kind": "data_parallel", "name": name, "axes": axes,
            "cfg": {"max_len": SEQ, **over},
            "weights": str(out / f"{name}.weights.pt"), "batch": BATCH,
            "steps": STEPS, "chunk": CHUNK, "train": train_kw})
    jobs[2].append({**CHAIN, "kind": "tensor_restore", "name": "restore",
                    "dir": resaved, "out_dir": gathered,
                    "axes": {"expert": 2}})
    # the ranks start importing while the weights are made; each waits for
    # its run's file
    running = [start_world(w, js, out) for w, js in jobs.items()]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny models, beside 6 ranks and the pool
    try:
        made = {}
        for name, (_, _, over, _, _) in RUNS.items():
            key = over.get("num_experts")
            if key not in made:
                made[key] = params_from_flax(_flax_params(over),
                                             _port_config(over))
            result["weights"][name] = made[key]
            path = out / f"{name}.weights.pt"
            torch.save(made[key], f"{path}.tmp")
            os.replace(f"{path}.tmp", path)  # whole when a rank sees it
        _wait_for_step(saved)
        result["round_trip_step"] = _one_rank_round_trip(saved, resaved)
        for name, (_, _, over, train_kw, _) in RUNS.items():
            result["one"][name] = _one_process(over, train_kw,
                                               result["weights"][name])
        result["moe_one"] = _moe_one_process()
        result["jax"] = {name: f.result() for name, f in references.items()}
    finally:
        torch.set_num_threads(threads)
        pool.shutdown(cancel_futures=True)
        for procs in running:
            wait_world(procs)
    for world, js in jobs.items():
        for job in js:
            result[job["name"]] = [
                torch.load(out / f"{job['name']}.rank{r}.pt",
                           weights_only=False) for r in range(world)]
    result["payloads"] = [
        torch.load(f"{root}/ns/chain/2/state.pt", weights_only=True)
        for root in (saved, resaved, gathered)]
    return result


@pytest.mark.parametrize("run", sorted(RUNS))
def test_expert_meshes_train_plain_modules_as_one_process(worlds, run):
    ranks = worlds[run]
    assert [r["path"] for r in ranks] == [RUNS[run][4]] * len(ranks)
    ref = worlds["one"][run]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]  # the global loss
    for got in ranks:  # every rank gathers the same whole gradients
        assert len(got["losses"]) == STEPS
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        for name, g in ref["grads"].items():
            _close(got["grads"][name], g)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_expert_meshes_train_as_the_jax_sharded_trainer(worlds, run):
    over = RUNS[run][2]
    want, jax_grads = worlds["jax"][run]
    got = worlds[run][0]
    assert max(abs(a - b) for a, b in zip(got["losses"], want)) <= LOSS_ATOL
    for name, g in params_from_flax(jax_grads, _port_config(over)).items():
        _close(got["grads"][name], g, rtol=1e-4)


def _groups(run):
    """The ranks of each ``expert`` group of run ``run``'s mesh, laid out
    row-major in the order (data, fsdp, expert, seq, tensor)."""
    world, axes = RUNS[run][:2]
    stride, size = axes.get("seq", 1) * axes.get("tensor", 1), axes["expert"]
    return [[base + i * stride for i in range(size)]
            for base in range(world) if base % (stride * size) < stride]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_whole_parameters_are_the_same_bits_across_an_expert_group(worlds,
                                                                   run):
    """After the steps, the router and every parameter that stays whole
    (and every piece, gathered whole) hold the same bits on each rank of an
    ``expert`` group: the ranks see the same tokens and the same whole
    gradients, and nothing sums them over the group."""
    ranks = worlds[run]
    for group in _groups(run):
        first = ranks[group[0]]["final"]
        assert any(name.endswith("moe.router") for name in first)
        for r in group[1:]:
            for name, value in ranks[r]["final"].items():
                assert torch.equal(value, first[name]), (run, r, name)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_expert_ranks_hold_the_pieces_of_the_split_rule(worlds, run):
    """Every rank holds half of ``wi`` and ``wo`` on the experts when 2
    divides E (whole at 3 experts), under ``tensor`` half of the
    attention's and the dense FFN's split parameters (the MoE blocks at
    full width) and of the tied table's vocab rows, every other parameter
    whole, as plain tensors or FSDP2's shards over ``fsdp`` alone."""
    _, axes, over = RUNS[run][:3]
    net = GPT(_port_config(over))
    split = dict(EXPERT_DIMS) if over["num_experts"] % 2 == 0 else {}
    if "tensor" in axes:
        split.update(TENSOR_DIMS)
    for got in worlds[run]:
        for name, p in net.named_parameters():
            shape = list(p.shape)
            key = next((k for k in split
                        if name == k or name.endswith("." + k)), None)
            if key:
                shape[split[key]] //= 2
            assert got["shapes"][name] == tuple(shape), name
            on = dict(zip(got["mesh"], got["placements"][name]))
            assert on["expert"] == on["data"] == "R", name
            if "fsdp" not in axes or key in EXPERT_DIMS:
                assert set(on.values()) == {"R"}, name


@pytest.mark.parametrize("run", sorted(RUNS))
def test_expert_calls_of_several_steps_equal_calls_of_one(worlds, run):
    for got in worlds[run]:
        chunked = got["chunked"]
        # one record a call: steps 4 and 5
        assert chunked["losses"] == [got["losses"][CHUNK - 1],
                                     got["losses"][-1]]
        for name, value in got["final"].items():
            assert torch.equal(chunked["final"][name], value), name


@pytest.mark.parametrize("run", sorted(RUNS))
def test_expert_model_flops_count_the_one_device_model(worlds, run):
    """Each rank counts a step's FLOPs with every expert whole and no mesh
    attachment, as one process does."""
    want = worlds["one"][run]["flops"]
    assert want
    for got in worlds[run]:
        assert got["chunked"]["flops"] == want


@pytest.mark.parametrize("job", ["moe_expert2", "moe_data2"])
@pytest.mark.parametrize("path", ["index", "dense"])
def test_moe_ffn_over_an_expert_group_equals_one_process(worlds, job, path):
    """``moe_ffn`` (and ``moe_ffn_reference``) with ``expert_group``: each
    rank's output rows, its input gradient, the router's gradient and the
    experts' gathered whole equal one process's ``moe_ffn`` on the whole
    batch."""
    want = worlds["moe_one"]
    for rank in worlds[job]:
        got, rows = rank[path], slice(*rank["rows"])
        _close(got["y"], want["y"][rows])
        _close(got["x_grad"], want["x_grad"][rows])
        _close(got["aux"], want["aux"])
        for name, g in want["grads"].items():
            _close(got["grads"][name], g)


@pytest.mark.parametrize("job", ["moe_expert2", "moe_data2"])
def test_a_router_gradient_summed_over_expert_counts_it_twice(worlds, job):
    """The router's gradient is whole and alike on every rank of an
    ``expert`` group; summed over the group (the trap of a replicated
    gradient) it is twice the one-process gradient, far outside the bound
    that the right one meets."""
    want = worlds["moe_one"]["grads"]["router"]
    for rank in worlds[job]:
        got = rank["index"]
        _close(got["grads"]["router"], want)
        wrong = got["router_summed"]
        bound = 1e-5 * max(1.0, want.abs().max().item())
        assert (wrong - want).abs().max().item() > 100 * bound
        torch.testing.assert_close(wrong, 2 * want, rtol=1e-5, atol=1e-7)


def test_a_checkpoint_crosses_expert_meshes_bit_exact(worlds):
    """data 2 x expert 2 writes step 2 (each expert piece gathered whole),
    one process restores it and writes it again, expert 2 restores that
    (each rank cutting its experts) and writes its gathered state: the
    three files hold the same bits, parameters and AdamW state alike."""
    assert worlds["round_trip_step"] == 2
    assert [r["restored_step"] for r in worlds["restore"]] == [2, 2]
    assert worlds["restore"][0]["shapes"]["layers.1.moe.wi"] == (
        2, 128, 512)  # a piece: 2 of the 4 experts

    def same(a, b, path=""):
        if torch.is_tensor(a):
            assert torch.is_tensor(b) and a.dtype == b.dtype, path
            assert torch.equal(a, b), path
        elif isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}/{i}")
        else:
            assert a == b, path

    saved, resaved, gathered = worlds["payloads"]
    assert saved["step"] == 2 and saved["optimizer"]["state"]
    assert saved["params"]["layers.1.moe.wi"].shape == (4, 128, 512)
    same(saved, resaved)
    same(saved, gathered)


@pytest.mark.parametrize("axes", [
    {"data": 1, "expert": 2}, {"data": 2, "expert": 2},
    {"data": 1, "fsdp": 2, "expert": 2}, {"data": 1, "expert": 2, "seq": 2},
    {"data": 1, "expert": 2, "tensor": 2}],
    ids=["expert", "data_expert", "fsdp_expert", "seq_expert",
         "tensor_expert"])
def test_expert_is_a_plain_axis_for_every_model(axes):
    """``expert`` trains plain modules for every model (a model without
    MoE blocks keeps each parameter whole on every ``expert`` rank), and
    beside ``tensor`` for the models that split their blocks."""
    from cron_operator_tpu_torch.models.mlp import MLP

    assert plain_axes(MeshPlan(axes), GPT)
    assert plain_axes(MeshPlan(axes), MLP) is ("tensor" not in axes)
