"""``tensor`` meshes of the MLP and ResNet on the plain path of the port's
meshed training, in gloo worlds on the CPU.

The MLP and ResNet split over ``tensor`` (``splits_over_tensor``), so a
mesh whose axes above 1 are among ``data``, ``fsdp`` and ``tensor`` trains
them as plain modules: ``parallel.mesh.data_parallel`` first has the MLP
keep its slice of the first pair of hidden layers (``dense.0``'s rows and
bias, ``dense.1``'s input columns) and each ResNet block its slice of the
first two convs (the first by output channels in whole GroupNorm groups,
with its norm's scale and bias and half its groups; the second by input
channels), then wraps the model in DDP or FSDP2 over the batch axes.
Worlds of 2 and 4 rank processes (``tests/torch_mesh_ranks.py``) are
spawned together, once for the module, and the test process runs the
one-process port and the JAX package beside them, from the same seeded
numpy batches in f32 (an MLP of widths 64 and 32 on MNIST's 28x28
images; ResNets of two stages of one block at width 64, bottleneck and
basic, on 32x32 images, 10 classes: each rank of ``tensor 2`` holds 16
groups of 2 channels in a block's first norm; batch 4, weights converted
from the flax initialisation):

- the MLP under ``tensor 2``, ``data 2 x tensor 2`` with SGD, and ``fsdp 2
  x tensor 2``; the bottleneck ResNet under ``tensor 2``, ``data 2 x
  tensor 2`` with a global-norm clip that bites, and ``fsdp 2 x tensor
  2``; the basic ResNet under ``tensor 2``.
- Each run: the path taken (``ddp`` or ``fsdp``, never ``dtensor``); the
  losses of 5 steps and the first step's gradients (gathered whole)
  against the one-process port (rtol 1e-5, atol 1e-5 of each tensor's
  largest magnitude) and against the JAX sharded ``Trainer`` on a mesh of
  the same axes over its virtual CPU devices (losses within
  ``LOSS_ATOL``, gradients ``jax.grad``'s within rtol 1e-4), the bounds of
  ``tests/test_torch_tensor_plain.py``; the same 5 steps in calls of 4
  leave the losses and the parameters of calls of one step, to the bit;
  each rank counts a step's model FLOPs as one device does; each rank
  holds the pieces the split rule gives it, its conv weights
  channels-last, and its split norms at half their groups and channels;
  a ResNet rank's steps (not an MLP's) run cuDNN's deterministic
  algorithms, and the process's flag is its own again after them.
- A checkpoint written under ``tensor 2``, restored and written again by
  one process, then restored under ``fsdp 2 x tensor 2`` and written from
  its gathered state, holds the same bits at every stage (parameters and
  AdamW moments).
- The rule: a block keeps every parameter whole when the ranks do not
  divide its groups, and the sum of a row-parallel conv's partial maps is
  made in place, channels-last, with no copy.

The card's side (the steps captured over NCCL) is in
``hack/torch_mesh_cards.py``'s ``resnet50`` and ``mnist`` legs and
``chip_smoke.py``'s phase 15.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cron_operator_tpu.models.mlp import MLP as JaxMLP
from cron_operator_tpu.models.resnet import BasicBlock as JaxBasicBlock
from cron_operator_tpu.models.resnet import (
    BottleneckBlock as JaxBottleneckBlock,
)
from cron_operator_tpu.models.resnet import ResNet as JaxResNet
from cron_operator_tpu.parallel.mesh import mesh_for_devices as jax_mesh
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu.workloads.train import cross_entropy_loss as jax_xent
from cron_operator_tpu_torch.models.convert import (
    mlp_params_from_flax,
    resnet_params_from_flax,
)
from cron_operator_tpu_torch.models.layers import Conv2d
from cron_operator_tpu_torch.models.resnet import BottleneckBlock
from cron_operator_tpu_torch.parallel.mesh import reduce_from_tensor
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer
from test_torch_parallel import LOSS_ATOL, _close
from torch_mesh_ranks import image_model, start_world, wait_world

BATCH, STEPS, CHUNK, SIZE = 4, 5, 4, 32
MLP_CFG = {"features": [64, 32]}
RESNET_CFG = {"stages": [1, 1], "width": 64, "image_size": SIZE}
CFGS = {"mlp": MLP_CFG, "resnet": RESNET_CFG, "resnet_basic": RESNET_CFG}
SGD = {"optimizer": "sgd", "learning_rate": 0.1}
# name: (world, axes, model, train overrides, path)
RUNS = {
    "mlp_tensor2": (2, {"tensor": 2}, "mlp", {}, "ddp"),
    "mlp_data2_tensor2_sgd": (4, {"tensor": 2}, "mlp", SGD, "ddp"),
    "mlp_fsdp2_tensor2": (4, {"fsdp": 2, "tensor": 2}, "mlp", {}, "fsdp"),
    "resnet_tensor2": (2, {"tensor": 2}, "resnet", {}, "ddp"),
    # the clip (about a third of the first step's norm) bites
    "resnet_data2_tensor2_clip": (4, {"tensor": 2}, "resnet",
                                  {"grad_clip_norm": 1.0}, "ddp"),
    "resnet_fsdp2_tensor2": (4, {"fsdp": 2, "tensor": 2}, "resnet", {},
                             "fsdp"),
    "resnet_basic_tensor2": (2, {"tensor": 2}, "resnet_basic", {}, "ddp"),
}
STREAMS = {"mlp": "mnist_batches", "resnet": "imagenet_batches",
           "resnet_basic": "imagenet_batches"}
# The dim of each split parameter (by its name's last components) that a
# rank of tensor 2 holds half of: the MLP's first pair, each block's first
# conv with its norm and its second conv's input channels
SPLIT_DIMS = {"mlp": {"dense.0.weight": 0, "dense.0.bias": 0,
                      "dense.1.weight": 1},
              "resnet": {"convs.0.weight": 0, "norms.0.weight": 0,
                         "norms.0.bias": 0, "convs.1.weight": 1}}
CHAIN = {"model": "resnet", "cfg": RESNET_CFG, "batch": BATCH}


def _jax_model(model):
    if model == "mlp":
        return JaxMLP(features=tuple(MLP_CFG["features"]), num_classes=10,
                      dtype=jnp.float32)
    block = JaxBasicBlock if model == "resnet_basic" else JaxBottleneckBlock
    return JaxResNet(stage_sizes=tuple(RESNET_CFG["stages"]), block=block,
                     num_classes=10, width=RESNET_CFG["width"],
                     dtype=jnp.float32)


def _stream(pkg, model):
    """The numpy batches of ``model`` from ``pkg`` (the port's or the JAX
    package's ``workloads.data``)."""
    if model == "mlp":
        return pkg.mnist_batches(BATCH)
    return pkg.imagenet_batches(BATCH, SIZE, 10)


def _flax_params(model):
    """Seed-0 parameters of the JAX model, as numpy."""
    shape = (1, 28, 28, 1) if model == "mlp" else (1, SIZE, SIZE, 3)
    params = jax.jit(_jax_model(model).init)(
        jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _converted(model, params):
    if model == "mlp":
        return mlp_params_from_flax(params)
    return resnet_params_from_flax(params, image_model(model, CFGS[model]))


def _one_process(model, train_kw, weights):
    """The one-process port: losses, first step's gradients and the model
    FLOPs a step."""
    net = image_model(model, CFGS[model])
    net.load_state_dict(weights)
    trainer = Trainer(net, TrainConfig(steps_per_call=1, stage_async=False,
                                       **train_kw))
    batches = _stream(data, model)
    stats = trainer.run(batches, 1)
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    stats += trainer.run(batches, STEPS)
    return {"losses": [s.loss for s in stats], "grads": grads,
            "flops": trainer.flops_per_step()}


def _jax_reference(name):
    """The JAX package's side of run ``name``: the sharded Trainer's
    losses on a mesh of the run's axes, and the first step's (clipped)
    ``jax.grad`` on one device, as numpy. The fixture runs it in processes
    of their own, beside the ranks."""
    world, axes, model, train_kw = RUNS[name][:4]
    params = _flax_params(model)
    net = _jax_model(model)
    trainer = JaxTrainer(
        lambda p, x: net.apply({"params": p}, x), params,
        jax_mesh(jax.devices("cpu")[:world], **axes),
        JaxTrainConfig(steps_per_call=1, stage_async=False, **train_kw))
    losses = [s.loss for s in trainer.run(_stream(jax_data, model), STEPS)]
    batch = next(_stream(jax_data, model))

    def loss_of(p):
        return jax_xent(net.apply({"params": p}, batch["x"]), batch["y"])

    grads = jax.jit(jax.grad(loss_of))(params)
    clip = train_kw.get("grad_clip_norm", 0)
    if clip:  # the port's p.grad is clipped
        clip = optax.clip_by_global_norm(clip)
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
    model = image_model("resnet", RESNET_CFG).init_weights(
        torch.Generator().manual_seed(0))
    store = CheckpointStore("ns", "chain", root=src, max_to_keep=100)
    out = CheckpointStore("ns", "chain", root=dst)
    try:
        trainer = Trainer(
            model, TrainConfig(steps_per_call=1),
            sample_fn=data.imagenet_sample(BATCH, SIZE, 10),
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
    out = tmp_path_factory.mktemp("tensor_conv_worlds")
    saved, resaved, gathered = (str(out / d) for d in
                                ("saved", "resaved", "gathered"))
    # the tensor 2 save first: the one-process leg waits for it
    jobs = {2: [{**CHAIN, "kind": "chain", "name": "save", "dir": saved,
                 "axes": {"tensor": 2}, "steps": 2, "save_every": 2}],
            4: []}
    result = {"weights": {}, "one": {}}
    for name, (world, axes, model, train_kw, _) in RUNS.items():
        jobs[world].append({
            "kind": "data_parallel", "name": name, "axes": axes,
            "model": model, "stream": STREAMS[model], "cfg": CFGS[model],
            "weights": str(out / f"{name}.weights.pt"), "batch": BATCH,
            "steps": STEPS, "chunk": CHUNK, "train": train_kw})
    jobs[4].append({**CHAIN, "kind": "tensor_restore", "name": "restore",
                    "dir": resaved, "out_dir": gathered,
                    "axes": {"fsdp": 2, "tensor": 2}})
    # the ranks start importing while the weights are made; each waits for
    # its run's file
    running = [start_world(w, js, out) for w, js in jobs.items()]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny models, beside 6 ranks and the pool
    try:
        made = {}
        for name, (_, _, model, _, _) in RUNS.items():
            if model not in made:
                made[model] = _converted(model, _flax_params(model))
            result["weights"][name] = made[model]
            path = out / f"{name}.weights.pt"
            torch.save(made[model], f"{path}.tmp")
            os.replace(f"{path}.tmp", path)  # whole when a rank sees it
        _wait_for_step(saved)
        result["round_trip_step"] = _one_rank_round_trip(saved, resaved)
        for name, (_, _, model, train_kw, _) in RUNS.items():
            result["one"][name] = _one_process(model, train_kw,
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
def test_tensor_meshes_train_mlp_and_resnet_as_one_process(worlds, run):
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
def test_tensor_meshes_train_mlp_and_resnet_as_the_jax_sharded_trainer(
        worlds, run):
    model = RUNS[run][2]
    want, jax_grads = worlds["jax"][run]
    got = worlds[run][0]
    assert max(abs(a - b) for a, b in zip(got["losses"], want)) <= LOSS_ATOL
    for name, g in _converted(model, jax_grads).items():
        _close(got["grads"][name], g, rtol=1e-4)


def test_the_clip_bites(worlds):
    """The clipped run's first gradients are a third or less of the
    unclipped ones' norm: the clip's split-aware norm is exercised."""
    clipped = worlds["resnet_data2_tensor2_clip"][0]["grads"]
    whole = worlds["one"]["resnet_tensor2"]["grads"]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in whole.values()]))
    got = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in clipped.values()]))
    assert norm > 3 * RUNS["resnet_data2_tensor2_clip"][3]["grad_clip_norm"]
    torch.testing.assert_close(got, torch.tensor(1.0), rtol=1e-5, atol=0)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tensor_conv_calls_of_several_steps_equal_calls_of_one(worlds, run):
    for got in worlds[run]:
        chunked = got["chunked"]
        # one record a call: steps 4 and 5
        assert chunked["losses"] == [got["losses"][CHUNK - 1],
                                     got["losses"][-1]]
        for name, value in got["final"].items():
            assert torch.equal(chunked["final"][name], value), name


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tensor_conv_model_flops_count_the_one_device_model(worlds, run):
    """Each rank counts a step's FLOPs with every parameter whole and no
    mesh attachment (every norm at all its groups), as one process does."""
    want = worlds["one"][run]["flops"]
    assert want
    for got in worlds[run]:
        assert got["chunked"]["flops"] == want


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tensor_conv_ranks_hold_the_pieces_of_the_split_rule(worlds, run):
    """Every rank holds half of each split parameter on its split dim,
    every other parameter whole, as plain tensors or FSDP2's shards over
    ``fsdp`` alone; under DDP every conv weight channels-last; each
    block's first norm at 16 of its 32 groups and half its channels, the
    other norms whole; a ResNet rank's steps held to cuDNN's
    deterministic algorithms, and the flag restored after them."""
    _, axes, model = RUNS[run][:3]
    net = image_model(model, CFGS[model])
    dims = SPLIT_DIMS["mlp" if model == "mlp" else "resnet"]
    for got in worlds[run]:
        for name, p in net.named_parameters():
            shape = list(p.shape)
            key = next((k for k in dims if name.endswith("." + k)
                        or (model == "mlp" and name == k)), None)
            if key and name.startswith(("blocks.", "dense.")):
                shape[dims[key]] //= 2
            assert got["shapes"][name] == tuple(shape), name
            on = dict(zip(got["mesh"], got["placements"][name]))
            assert on["tensor"] == on["data"] == "R", name
            if "fsdp" not in axes:
                assert set(on.values()) == {"R"}, name
        if "fsdp" not in axes and model != "mlp":
            assert got["channels_last"] and all(
                got["channels_last"].values()), got["channels_last"]
        # a conv model's steps (and no one else's) hold cuDNN to its
        # deterministic kernels, so the whole parameters' gradients come
        # out alike on every rank of the tensor group; the flag is the
        # process's own again after them
        assert got["cudnn_deterministic"] == {
            "steps": [model != "mlp"], "after": False}
        for name, m in net.named_modules():
            if isinstance(m, torch.nn.GroupNorm):
                split = name.startswith("blocks.") and name.endswith(
                    "norms.0")
                want = ((16, m.num_channels // 2) if split
                        else (32, m.num_channels))
                assert got["groups"][name] == want, name


def test_a_resnet_checkpoint_crosses_tensor_meshes_bit_exact(worlds):
    """tensor 2 writes step 2 (each piece gathered whole), one process
    restores it and writes it again, fsdp 2 x tensor 2 restores that
    (each rank cutting its pieces) and writes its gathered state: the
    three files hold the same bits, parameters and AdamW state alike."""
    assert worlds["round_trip_step"] == 2
    assert [r["restored_step"] for r in worlds["restore"]] == [2] * 4
    shapes = worlds["restore"][0]["shapes"]
    assert shapes["blocks.1.convs.0.weight"] == (64, 256, 1, 1)  # 64 of 128
    assert shapes["blocks.1.convs.1.weight"] == (128, 64, 3, 3)
    assert shapes["blocks.1.norms.0.weight"] == (64,)

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


@pytest.mark.parametrize("t, split", [(1, True), (2, True), (4, True),
                                      (3, False), (64, False)])
def test_a_block_splits_at_group_boundaries_or_stays_whole(t, split):
    """A block splits its first two convs when ``t`` divides its 32
    groups; else it names nothing and stays whole on every rank."""
    block = BottleneckBlock(64, 64, dtype=torch.float32)
    rule = block.tensor_splits(t)
    assert bool(rule) is split
    if split:
        assert set(rule) == {"convs.0.weight", "norms.0.weight",
                             "norms.0.bias", "convs.1.weight"}


def test_a_row_parallel_conv_sums_its_partial_map_in_place(tmp_path):
    """The partial map a row-parallel conv hands the all-reduce is the
    tensor the sum comes back in (no copy), channels-last, and a copy is
    made only for a tensor whose layout is not dense."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", rank=0, world_size=1,
        init_method=f"file://{tmp_path / 'store'}")
    try:
        group = dist.group.WORLD
        conv = Conv2d(4, 8, 3, compute_dtype=torch.float32)
        x = torch.randn(2, 4, 6, 6).contiguous(
            memory_format=torch.channels_last)
        seen = []
        real = dist.all_reduce

        def spy(t, *args, **kw):
            seen.append(t)
            return real(t, *args, **kw)

        dist.all_reduce = spy
        try:
            y = conv(x, tensor_group=group)
            strided = torch.randn(2, 8, 6, 12)[..., ::2]
            z = reduce_from_tensor(strided, group)
        finally:
            dist.all_reduce = real
        assert seen[0] is y
        assert y.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(y, conv(x), rtol=0, atol=0)
        assert seen[1] is z and z is not strided
        torch.testing.assert_close(z, strided, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()
