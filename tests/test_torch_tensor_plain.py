"""``tensor`` meshes on the plain path of the port's meshed training, in
gloo worlds on the CPU.

A mesh whose axes above 1 are among ``data``, ``fsdp``, ``seq`` and
``tensor`` trains plain modules when the model splits its blocks (GPT,
BERT, ViT: ``splits_over_tensor``): ``parallel.mesh.data_parallel`` first
has each block keep its heads (the QKV projection's rows, ``out``'s input
columns) and its slice of the FFN (``fc_in``'s rows, ``fc_out``'s input
columns, an MoE block's ``wi``/``wo`` on the FFN's width), the Megatron
layout, then wraps the model in DDP or FSDP2 over the batch axes. Worlds
of 2 and 4 rank processes (``tests/torch_mesh_ranks.py``) are spawned
together, once for the module, and the test process runs the one-process
port and the JAX package beside them, from the same seeded numpy batches
in f32 (tiny GPT, BERT and ViT: 2 layers, 4 heads; seq 32, batch 4,
AdamW, converted JAX weights):

- GPT (MHA) under ``tensor 2`` and under ``fsdp 2 x tensor 2`` with
  ``remat``; GPT with GQA 2 under ``data 2 x tensor 2`` with a global-norm
  clip that bites; GPT with GQA 1 (its heads stay whole: only the FFN
  splits) under ``tensor 2``; GPT with Switch-MoE blocks (every second
  block, 2 experts, capacity factor 1) under ``data 2 x tensor 2``; BERT
  under ``fsdp 2 x tensor 2``; ViT under ``tensor 2``.
- Each run: the path taken (``ddp`` or ``fsdp``, never ``dtensor``); the
  losses of 5 steps and the first step's gradients (gathered whole)
  against the one-process port (rtol 1e-5, atol 1e-5 of each tensor's
  largest magnitude, as ``test_torch_parallel.py``) and against the JAX
  sharded ``Trainer`` on a mesh of the same axes over its virtual CPU
  devices (losses within 5e-5, gradients ``jax.grad``'s within rtol
  1e-4), the bounds of ``tests/test_torch_seq_plain.py``; the same 5
  steps in calls of 4 leave the losses and the parameters of calls of one
  step, to the bit; each rank counts a step's model FLOPs as one device
  does; each rank holds the pieces the split rule gives it (GPT's and
  BERT's tied table its block of the vocab rows: ``tests/
  test_torch_vocab_parallel.py`` trains on the vocab-parallel loss).
- A checkpoint written under ``fsdp 2 x tensor 2``, restored and written
  again by one process, then restored under ``tensor 2`` and written from
  its gathered state, holds the same bits at every stage (parameters and
  AdamW moments).
- ``qkv`` split as one contiguous block of rows a rank (not by head
  within q, k and v) gives losses far outside the bound the right split
  meets.
- The pair of collectives (``copy_to_tensor``: identity forward, sum
  backward; ``reduce_from_tensor``: sum forward, identity backward) and a
  row-parallel ``Linear``, whose bias is added once.
- The grids of the batch group and of FSDP2's mesh (``parallel.mesh.
  regrid``) of ``data 2 x fsdp 2 x tensor 2`` and ``fsdp 2 x seq 2 x
  tensor 2`` hold the batch axes' ranks at each ``tensor`` coordinate.

The card's side (the ``tensor`` steps captured over NCCL) is in
``hack/torch_mesh_cards.py``'s graph legs and
``tests/test_torch_tensor_plain_cuda.py``.
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
from cron_operator_tpu.models import Bert as JaxBert
from cron_operator_tpu.models import BertConfig as JaxBertConfig
from cron_operator_tpu.models import GPTConfig as JaxGPTConfig
from cron_operator_tpu.models.vit import ViT as JaxViT
from cron_operator_tpu.models.vit import ViTConfig as JaxViTConfig
from cron_operator_tpu.parallel.mesh import mesh_for_devices as jax_mesh
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu.workloads.train import cross_entropy_loss as jax_xent
from cron_operator_tpu_torch.models.bert import Bert, BertConfig
from cron_operator_tpu_torch.models.convert import (
    params_from_flax,
    vit_params_from_flax,
)
from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
from cron_operator_tpu_torch.models.mlp import MLP
from cron_operator_tpu_torch.models.resnet import ResNet
from cron_operator_tpu_torch.models.vit import ViT, ViTConfig
from cron_operator_tpu_torch.parallel.mesh import (
    MeshPlan,
    TensorSplit,
    plain_axes,
    plan_for_devices,
    rank_grid,
    regrid,
)
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer
from test_torch_parallel import LOSS_ATOL, _close
from torch_mesh_ranks import start_world, wait_world

SEQ, BATCH, STEPS, CHUNK = 32, 4, 5, 4
MOE = {"moe_every": 2, "num_experts": 2, "moe_capacity_factor": 1.0}
# name: (world, axes, model, model overrides, train overrides, path)
RUNS = {
    "gpt_tensor2": (2, {"tensor": 2}, "gpt", {}, {}, "ddp"),
    "gpt_fsdp2_tensor2_remat": (4, {"fsdp": 2, "tensor": 2}, "gpt", {},
                                {"remat": True}, "fsdp"),
    # the clip (about a seventh of the first step's norm) bites
    "gpt_gqa2_data2_tensor2_clip": (4, {"tensor": 2}, "gpt",
                                    {"num_kv_heads": 2},
                                    {"grad_clip_norm": 0.5}, "ddp"),
    "gpt_gqa1_tensor2": (2, {"tensor": 2}, "gpt", {"num_kv_heads": 1}, {},
                         "ddp"),
    "gpt_moe_data2_tensor2": (4, {"tensor": 2}, "gpt", MOE, {}, "ddp"),
    "bert_fsdp2_tensor2": (4, {"fsdp": 2, "tensor": 2}, "bert", {}, {},
                           "fsdp"),
    "vit_tensor2": (2, {"tensor": 2}, "vit", {}, {}, "ddp"),
}
STREAMS = {"gpt": "causal_token_batches", "bert": "token_batches",
           "vit": "imagenet_batches"}
# The dim of each split parameter (by its name's last components) that a
# rank of tensor 2 holds half of; the attention's only when both head
# counts divide 2
SPLIT_DIMS = {"attn.qkv.weight": 0, "attn.qkv.bias": 0, "attn.q.weight": 0,
              "attn.q.bias": 0, "attn.kv.weight": 0, "attn.kv.bias": 0,
              "out.weight": 1, "fc_in.weight": 0, "fc_in.bias": 0,
              "fc_out.weight": 1, "moe.wi": 2, "moe.wo": 1,
              # the vocab rows (1024 at tiny: 512 a rank, no padding)
              "tok_emb.weight": 0}
CHAIN = {"cfg": {"max_len": SEQ}, "batch": BATCH}
# meshes of 8 ranks whose FSDP2 mesh replicates over a batch axis beside a
# tensor axis: name: (axes, FSDP2's grid at tensor coordinate t)
GROUPS = {"data2_fsdp2_tensor2": ({"fsdp": 2, "tensor": 2},  # data outer
                                  lambda t: [[t, 2 + t], [4 + t, 6 + t]]),
          # fsdp outer, seq inner: fsdp moved last
          "fsdp2_seq2_tensor2": ({"fsdp": 2, "seq": 2, "tensor": 2},
                                 lambda t: [[t, 4 + t], [2 + t, 6 + t]])}


def _jax_config(model, over):
    if model == "vit":
        return JaxViTConfig.tiny(dtype=jnp.float32, **over)
    maker = JaxBertConfig.tiny if model == "bert" else JaxGPTConfig.tiny
    return maker(dtype=jnp.float32, max_len=SEQ, **over)


def _port_config(model, over):
    if model == "vit":
        return ViTConfig.tiny(dtype=torch.float32, attention_impl="xla",
                              **over)
    maker = BertConfig.tiny if model == "bert" else GPTConfig.tiny
    return maker(dtype=torch.float32, attention_impl="xla", max_len=SEQ,
                 **over)


def _port_model(model, over):
    return {"gpt": GPT, "bert": Bert, "vit": ViT}[model](
        _port_config(model, over))


def _jax_model(model, over):
    cls = {"gpt": JaxGPT, "bert": JaxBert, "vit": JaxViT}[model]
    return cls(replace(_jax_config(model, over), attention_impl="xla"))


def _stream(pkg, model):
    """The numpy batches of ``model`` from ``pkg`` (the port's or the JAX
    package's ``workloads.data``)."""
    if model == "vit":
        cfg = ViTConfig.tiny()
        return pkg.imagenet_batches(BATCH, cfg.image_size, cfg.num_classes)
    return getattr(pkg, STREAMS[model])(BATCH, SEQ, 1024)


def _flax_params(model, over):
    """Seed-0 parameters of the JAX model, as numpy."""
    shape = ((1, 32, 32, 3) if model == "vit" else (1, SEQ))
    dtype = jnp.float32 if model == "vit" else jnp.int32
    params = jax.jit(_jax_model(model, over).init)(
        jax.random.PRNGKey(0), jnp.zeros(shape, dtype))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _converted(model, over, params):
    convert = vit_params_from_flax if model == "vit" else params_from_flax
    return convert(params, _port_config(model, over))


def _one_process(model, over, train_kw, weights):
    """The one-process port: losses, first step's gradients and the model
    FLOPs a step."""
    net = _port_model(model, over)
    net.load_state_dict(weights)
    trainer = Trainer(net, TrainConfig(
        steps_per_call=1, stage_async=False,
        aux_loss_in_output=getattr(net, "has_moe", False), **train_kw))
    batches = _stream(data, model)
    stats = trainer.run(batches, 1)
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    stats += trainer.run(batches, STEPS)
    return {"losses": [s.loss for s in stats], "grads": grads,
            "flops": trainer.flops_per_step()}


def _jax_losses(model, over, train_kw, world, axes, params):
    """The JAX sharded Trainer's losses on a mesh of the same axes."""
    net = _jax_model(model, over)
    trainer = JaxTrainer(
        lambda p, x: net.apply({"params": p}, x), params,
        jax_mesh(jax.devices("cpu")[:world], **axes),
        JaxTrainConfig(steps_per_call=1, stage_async=False,
                       aux_loss_in_output=model == "gpt", **train_kw))
    return [s.loss for s in trainer.run(_stream(jax_data, model), STEPS)]


def _jax_grads(model, over, params, clip):
    """``jax.grad`` of the first step's loss on one device (clipped as
    the step clips it, at ``clip`` above 0), as numpy."""
    net = _jax_model(model, over)
    batch = next(_stream(jax_data, model))

    def loss_of(p):
        out = net.apply({"params": p}, batch["x"])
        if model == "gpt":
            logits, aux = out
            return jax_xent(logits, batch["y"]) + aux
        return jax_xent(out, batch["y"])

    grads = jax.jit(jax.grad(loss_of))(params)
    if clip:  # the port's p.grad is clipped
        clip = optax.clip_by_global_norm(clip)
        grads, _ = clip.update(grads, clip.init(grads))
    return jax.tree_util.tree_map(np.asarray, grads)


def _jax_reference(name):
    """The JAX package's side of run ``name``: the sharded Trainer's
    losses and the first step's (clipped) ``jax.grad``. The fixture runs
    it in processes of their own, beside the ranks: the JAX programs
    compile there in parallel."""
    world, axes, model, over, train_kw = RUNS[name][:5]
    params = _flax_params(model, over)
    return (_jax_losses(model, over, train_kw, world, axes, params),
            _jax_grads(model, over, params,
                       train_kw.get("grad_clip_norm", 0)))


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
    cfg = _port_config("gpt", {})
    model = GPT(cfg).init_weights(torch.Generator().manual_seed(0))
    store = CheckpointStore("ns", "chain", root=src, max_to_keep=100)
    out = CheckpointStore("ns", "chain", root=dst)
    try:
        trainer = Trainer(
            model, TrainConfig(steps_per_call=1),
            sample_fn=data.causal_token_sample(BATCH, SEQ, cfg.vocab_size),
            checkpoint=store)
        out.save(trainer.steps_done, trainer.host_state())
    finally:
        out.close()
        store.close()
    return trainer.steps_done


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The ranks' results, and the one-process port's and the JAX
    package's beside them (computed while the ranks run, the JAX package's
    in three processes of its own)."""
    pool = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
        "spawn"))
    references = {name: pool.submit(_jax_reference, name) for name in RUNS}
    out = tmp_path_factory.mktemp("tensor_plain_worlds")
    saved, resaved, gathered = (str(out / d) for d in
                                ("saved", "resaved", "gathered"))
    # the fsdp 2 x tensor 2 save first: the one-process leg waits for it
    jobs = {4: [{**CHAIN, "kind": "chain", "name": "save", "dir": saved,
                 "axes": {"fsdp": 2, "tensor": 2}, "steps": 2,
                 "save_every": 2}],
            2: []}
    result = {"weights": {}, "one": {}}
    for name, (world, axes, model, over, train_kw, _) in RUNS.items():
        job = {"kind": "data_parallel", "name": name, "axes": axes,
               "model": model, "stream": STREAMS[model],
               "cfg": over if model == "vit" else {"max_len": SEQ, **over},
               "weights": str(out / f"{name}.weights.pt"), "batch": BATCH,
               "steps": STEPS,
               "chunk": CHUNK, "train": train_kw}
        jobs[world].append(job)
        if name == "gpt_tensor2":
            jobs[2].append({**job, "kind": "train", "name": "contiguous",
                            "contiguous_qkv": True})
    jobs[2] += [
        {"kind": "tensor_collectives", "name": "collectives", "seed": 7,
         "axes": {"tensor": 2}},
        {**CHAIN, "kind": "tensor_restore", "name": "restore",
         "dir": resaved, "out_dir": gathered, "axes": {"tensor": 2}}]
    # the ranks start importing while the weights are made; each waits for
    # its run's file
    running = [start_world(w, js, out) for w, js in jobs.items()]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny models, beside 6 ranks and the pool
    try:
        made = {}
        for name, (_, _, model, over, _, _) in RUNS.items():
            key = (model, tuple(sorted(over.items())))
            if key not in made:
                made[key] = _converted(model, over, _flax_params(model, over))
            result["weights"][name] = made[key]
            path = out / f"{name}.weights.pt"
            torch.save(made[key], f"{path}.tmp")
            os.replace(f"{path}.tmp", path)  # whole when a rank sees it
        _wait_for_step(saved)
        result["round_trip_step"] = _one_rank_round_trip(saved, resaved)
        for name, (world, axes, model, over, train_kw, _) in RUNS.items():
            result["one"][name] = _one_process(model, over, train_kw,
                                               result["weights"][name])
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
def test_tensor_meshes_train_plain_modules_as_one_process(worlds, run):
    ranks = worlds[run]
    assert [r["path"] for r in ranks] == [RUNS[run][5]] * len(ranks)
    ref = worlds["one"][run]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]  # the global loss
    for got in ranks:  # every rank gathers the same whole gradients
        assert len(got["losses"]) == STEPS
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        for name, g in ref["grads"].items():
            _close(got["grads"][name], g)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tensor_meshes_train_as_the_jax_sharded_trainer(worlds, run):
    model, over = RUNS[run][2:4]
    want, jax_grads = worlds["jax"][run]
    got = worlds[run][0]
    assert max(abs(a - b) for a, b in zip(got["losses"], want)) <= LOSS_ATOL
    for name, g in _converted(model, over, jax_grads).items():
        _close(got["grads"][name], g, rtol=1e-4)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tensor_calls_of_several_steps_equal_calls_of_one(worlds, run):
    for got in worlds[run]:
        chunked = got["chunked"]
        # one record a call: steps 4 and 5
        assert chunked["losses"] == [got["losses"][CHUNK - 1],
                                     got["losses"][-1]]
        for name, value in got["final"].items():
            assert torch.equal(chunked["final"][name], value), name


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tensor_model_flops_count_the_one_device_model(worlds, run):
    """Each rank counts a step's FLOPs with every parameter whole and no
    mesh attachment, as one process does."""
    want = worlds["one"][run]["flops"]
    assert want
    for got in worlds[run]:
        assert got["chunked"]["flops"] == want


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tensor_ranks_hold_the_pieces_of_the_split_rule(worlds, run):
    """Every rank holds half of each split parameter on its split dim (the
    attention's only when both head counts divide 2; GPT's and BERT's tied
    table, half of its vocab rows), every other parameter whole, as plain
    tensors or FSDP2's shards over ``fsdp`` alone."""
    _, axes, model, over = RUNS[run][:4]
    net = _port_model(model, over)
    heads_whole = over.get("num_kv_heads") == 1
    for got in worlds[run]:
        for name, p in net.named_parameters():
            shape = list(p.shape)
            key = next((k for k in SPLIT_DIMS
                        if name == k or name.endswith("." + k)), None)
            if key and not (heads_whole and (key.startswith("attn.")
                                             or key == "out.weight")):
                shape[SPLIT_DIMS[key]] //= 2
            assert got["shapes"][name] == tuple(shape), name
            on = dict(zip(got["mesh"], got["placements"][name]))
            assert on["tensor"] == on["data"] == "R", name
            if "fsdp" not in axes:
                assert set(on.values()) == {"R"}, name


def test_a_checkpoint_crosses_tensor_meshes_bit_exact(worlds):
    """fsdp 2 x tensor 2 writes step 2 (each piece gathered whole), one
    process restores it and writes it again, tensor 2 restores that (each
    rank cutting its pieces) and writes its gathered state: the three
    files hold the same bits, parameters and AdamW state alike."""
    assert worlds["round_trip_step"] == 2
    assert [r["restored_step"] for r in worlds["restore"]] == [2, 2]
    assert worlds["restore"][0]["shapes"]["layers.0.attn.qkv.weight"] == (
        192, 128)  # a piece: 2 of the 4 heads of q, k and v
    assert worlds["restore"][0]["shapes"]["tok_emb.weight"] == (
        512, 128)  # half of the vocab rows

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
    same(saved, resaved)
    same(saved, gathered)


def test_a_contiguous_qkv_split_gives_other_losses(worlds):
    """``qkv`` rows split as one contiguous block a rank hand a rank the
    rows of q and part of k as if they were its heads of q, k and v: its
    losses leave the one-process ones by far more than the bound the
    split by head meets (the tests above)."""
    ref = np.array(worlds["one"]["gpt_tensor2"]["losses"])
    bound = 1e-5 * np.abs(ref).max()
    for got in worlds["contiguous"]:
        wrong = np.array(got["losses"])
        assert wrong.shape == ref.shape
        assert np.abs(wrong - ref).max() > 100 * bound


def test_the_megatron_pair_and_a_row_parallel_bias(worlds):
    """``copy_to_tensor``: each rank's output is its input and its input's
    gradient the sum of every rank's cotangent; ``reduce_from_tensor``:
    each rank's output the sum of every rank's input and its gradient its
    own cotangent (a sum there would count a replicated gradient twice);
    a row-parallel ``Linear`` gives the whole layer's output, its bias
    added once."""
    ranks = worlds["collectives"]
    copy = [r["copy"] for r in ranks]
    red = [r["reduce"] for r in ranks]
    for mine in copy:
        assert torch.equal(mine["y"], mine["x"])
        torch.testing.assert_close(mine["grad"], copy[0]["w"] + copy[1]["w"],
                                   rtol=0, atol=0)
    for mine in red:
        torch.testing.assert_close(mine["y"], red[0]["x"] + red[1]["x"],
                                   rtol=0, atol=0)
        assert torch.equal(mine["grad"], mine["w"])
    for r in ranks:
        torch.testing.assert_close(r["row_parallel"]["y"],
                                   r["row_parallel"]["whole"],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_batch_groups_hold_the_batch_axes_at_a_tensor_coordinate(name):
    """8 ranks laid out row-major (data or fsdp, then fsdp or seq, then
    ``tensor`` innermost), regrouped as ``batch_group`` and ``_fsdp_mesh``
    regroup them: at ``tensor`` coordinate t the batch group is the 4
    ranks of that coordinate, and FSDP2's mesh those 4 ranks with
    ``fsdp`` last, replicated over the other batch axis."""
    axes, fsdp_grid = GROUPS[name]
    plan = plan_for_devices(8, **axes)
    grid = rank_grid(plan, range(8))
    batch = [a for a in plan.axis_sizes if a != "tensor"]
    replicate = [a for a in ("data", "seq") if a in plan.axis_sizes]
    groups, names = regrid(grid, plan.axis_sizes, {"batch": batch})
    assert names == ("rest", "batch")
    assert groups.tolist() == [[0, 2, 4, 6], [1, 3, 5, 7]]
    fsdp, names = regrid(grid, plan.axis_sizes,
                         {"replicate": replicate, "fsdp": ["fsdp"]})
    assert names == ("rest", "replicate", "fsdp")
    for t in range(2):
        assert fsdp[t].tolist() == fsdp_grid(t)
    # without a tensor axis above 1 the grid keeps no rest dim
    plan = plan_for_devices(4, fsdp=2)
    flat, names = regrid(rank_grid(plan, range(4)), plan.axis_sizes,
                         {"replicate": ["data"], "fsdp": ["fsdp"]})
    assert names == ("replicate", "fsdp") and flat.tolist() == [[0, 1],
                                                               [2, 3]]


@pytest.mark.parametrize("model, axes, plain", [
    (GPT, {"data": 1, "tensor": 2}, True),
    (Bert, {"data": 2, "tensor": 2}, True),
    (ViT, {"data": 1, "fsdp": 2, "tensor": 2}, True),
    (GPT, {"data": 1, "seq": 2, "tensor": 2}, True),
    (MLP, {"data": 1, "tensor": 2}, False),
    (ResNet, {"data": 2, "tensor": 2}, False),
    (GPT, {"data": 1, "expert": 2, "tensor": 2}, True),
    (GPT, {"pipe": 2, "data": 1, "tensor": 2}, False),
    (None, {"data": 1, "tensor": 2}, False),
    (MLP, {"data": 2, "fsdp": 2}, True),
], ids=["gpt", "bert_data", "vit_fsdp", "gpt_seq", "mlp", "resnet",
        "gpt_expert", "gpt_pipe", "no_model", "mlp_batch_axes"])
def test_the_rule_takes_tensor_for_models_that_split(model, axes, plain):
    """The model decides, by rule at construction: GPT, BERT and ViT take
    ``tensor`` on the plain path (beside ``expert`` too), MLP and ResNet
    keep DTensor parameters under it, and ``pipe`` above 1 keeps them for
    every model."""
    assert plain_axes(MeshPlan(axes), model) is plain


@pytest.mark.parametrize("outer, heads", [(3, 4), (2, 2), (1, 4)],
                         ids=["qkv", "kv", "q"])
def test_a_split_keeps_each_ranks_heads_in_every_block(outer, heads):
    """A rank's piece of a ``(outer, heads, head_dim)`` row layout is
    ``view(outer, heads, d, ...)[:, its heads]``: its heads of each of q,
    k and v, not a contiguous block of rows; the pieces in rank order give
    the whole back."""
    d, hidden, t = 8, 16, 2
    whole = torch.randn(outer * heads * d, hidden,
                        generator=torch.Generator().manual_seed(outer))
    split = TensorSplit(0, outer)
    pieces = [split.local(whole, r, t) for r in range(t)]
    per = heads // t
    for r, piece in enumerate(pieces):
        want = whole.view(outer, heads, d, hidden)[:, r * per:(r + 1) * per]
        assert torch.equal(piece, want.reshape(-1, hidden))
    assert torch.equal(split.whole(pieces), whole)
