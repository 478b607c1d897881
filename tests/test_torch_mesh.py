"""The port's device mesh (``parallel/mesh.py``) against the JAX package's,
and its elastic restore in gloo worlds on the CPU.

- Plans: every case of a shared table of ``plan_for_devices``, ``replan``
  and ``regrow`` (``tests/test_parallel.py`` and ``tests/test_elastic.py``)
  gives the JAX package's axis sizes, or its ``ValueError``: the
  controller replans with the JAX copy and resubmits a port job.
- Placements: the JAX rule's cases, mapped to the torch layout (a 2-D
  kernel ``[in, out]`` is a ``Linear`` weight ``[out, in]``), give the JAX
  spec transposed, ties of a square matrix included; a GPT tiny's
  parameters get, transposed, the JAX ``sharding_for_tree`` of its flax
  tree, except the flattened ``qkv``/``out`` kernels, whose divergence is
  pinned; batches and MoE parameters as in JAX.
- Hybrid meshes: the ranks' layout is the JAX ``hybrid_mesh_for_slices``
  device layout (data slice-major, model axes inside a slice), grouped by
  ``LOCAL_WORLD_SIZE``.
- One rank per device: ``param.devices`` is the world size, a rank of a
  world drives ``cuda:$LOCAL_RANK``, and two runner processes started
  from a rendered two-rank env get their own device and the same mesh,
  and train ``gpt`` under ``fsdp=2`` to the one-process loss.
- Worlds (spawned once for the module, ``tests/torch_mesh_ranks.py``):
  ``moe_ffn`` with its experts sharded gives the unsharded values; the
  elastic chain of ``tests/test_elastic.py`` as 4 -> 2 -> 1 ranks: each leg
  saves every 4 steps and runs past its save (to 6, then 9), the next
  resumes from the save on the mesh ``replan`` gives, with parameters
  bit-exact to what was saved, and the loss curve continues the
  uninterrupted one-process run's within 5e-5 (fused data: the generator's
  state is in the checkpoint); a one-process checkpoint restores bit-exact
  onto 2 and 4 ranks.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import itertools
import json
import os
import subprocess
import sys
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.models import GPT as JaxGPT
from cron_operator_tpu.models import GPTConfig as JaxGPTConfig
from cron_operator_tpu.parallel import mesh as jmesh
from cron_operator_tpu_torch.backends.registry import JobContext
from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
from cron_operator_tpu_torch.parallel import mesh as tmesh
from cron_operator_tpu_torch.parallel.moe import (
    init_moe_params,
    moe_ffn,
    moe_param_sharding,
)
from cron_operator_tpu_torch.utils import device as device_mod
from cron_operator_tpu_torch.workloads import data, entrypoints, runner
from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer
from torch_mesh_ranks import ROOT, _free_port, spawn_world

# ------------------------------------------------------------------ plans

PLANS = {
    # name: (devices, axes) for plan_for_devices
    "all_data": (8, {}),
    "factored": (16, {"tensor": 2, "fsdp": 2}),
    "every_axis": (32, {"tensor": 2, "seq": 2, "fsdp": 2, "pipe": 2,
                        "expert": 2}),
    "indivisible": (8, {"tensor": 3}),
    "given_data": (8, {"fsdp": 2, "data": 4}),
    "wrong_data": (8, {"fsdp": 2, "data": 2}),
}
REPLANS = {
    # name: (launch plan (devices, axes), [(target, allow_grow, original)])
    "data_absorbs_shrink": ((8, {"fsdp": 2}), [(4, False, None)]),
    "model_axes_reduced": ((8, {"fsdp": 4}), [(2, False, None)]),
    "tensor_survives": ((8, {"tensor": 2, "fsdp": 2}), [(4, False, None)]),
    "same_count": ((8, {"fsdp": 2}), [(8, False, None)]),
    "grow_refused": ((4, {}), [(8, False, None)]),
    "empty_refused": ((4, {}), [(0, False, None)]),
    "grow_widens_data": ((4, {"fsdp": 2}), [(8, True, None)]),
    "grow_restores": ((8, {"fsdp": 4}), [(2, False, None), (8, True, "orig")]),
    "grow_partial": ((8, {"fsdp": 4}), [(2, False, None), (4, True, "orig")]),
    "grow_no_original": ((2, {"fsdp": 2}), [(8, True, None)]),
    "grow_indivisible": ((4, {"fsdp": 4}), [(6, True, None)]),
    "mixed_shrink": ((16, {"tensor": 2, "fsdp": 2, "expert": 2}),
                     [(4, False, None), (2, False, None), (16, True, "orig")]),
    "regrow": ((8, {"fsdp": 4}), [(2, False, None), ("regrow", True, "orig")]),
}


def _outcome(fn):
    try:
        return fn().axis_sizes
    except ValueError as err:
        return ("ValueError", str(err))


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_for_devices_matches_jax(case):
    n, axes = PLANS[case]
    got = _outcome(lambda: tmesh.plan_for_devices(n, **axes))
    assert got == _outcome(lambda: jmesh.plan_for_devices(n, **axes))
    if case == "factored":
        assert got == {"data": 4, "fsdp": 2, "tensor": 2}


@pytest.mark.parametrize("case", sorted(REPLANS))
def test_replan_and_regrow_match_jax(case):
    (n, axes), chain = REPLANS[case]
    outcomes = []
    for pkg in (tmesh, jmesh):
        orig = pkg.plan_for_devices(n, **axes)
        plan, trail = orig, []
        for target, grow, original in chain:
            original = orig if original == "orig" else None
            if target == "regrow":
                step = lambda: pkg.regrow(plan, n, original_plan=original)
            else:
                step = lambda: pkg.replan(plan, target, allow_grow=grow,
                                          original_plan=original)
            trail.append(_outcome(step))
            if isinstance(trail[-1], tuple):
                break
            plan = pkg.MeshPlan(trail[-1])
        outcomes.append(trail)
    assert outcomes[0] == outcomes[1]


def test_replan_takes_a_device_sequence():
    plan = tmesh.plan_for_devices(8)
    assert tmesh.replan(plan, ["r0", "r1"]).n_devices == 2
    assert tmesh.replan(plan, 8) is plan


# ------------------------------------------------------------- placements


def _jax_mesh(**axes):
    return jmesh.mesh_for_devices(jax.devices("cpu"), **axes)


SHAPES = {
    # name: (flax shape, mesh axes over 8 devices)
    "bias": ((128,), {"fsdp": 2, "tensor": 2}),
    "scalar": ((), {"fsdp": 2, "tensor": 2}),
    "matrix_tensor_then_fsdp": ((512, 256), {"fsdp": 2, "tensor": 2}),
    "indivisible": ((7, 3), {"fsdp": 2, "tensor": 2}),
    "data_only": ((512, 256), {}),
    "square_fsdp": ((256, 256), {"fsdp": 2}),
    "square_fsdp_tensor": ((256, 256), {"fsdp": 2, "tensor": 2}),
    "tall_fsdp": ((16, 4), {"fsdp": 2}),
    "wide_tensor": ((3, 8), {"tensor": 4}),
}


def _plan(mesh):
    return tmesh.MeshPlan(dict(mesh.shape))


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_placement_is_the_jax_rule_transposed(case):
    """A flax kernel ``[in, out]`` is the port's ``[out, in]`` with
    ``features_dim=0``; rank < 2 keeps its shape."""
    shape, axes = SHAPES[case]
    mesh = _jax_mesh(**axes)
    want = list(jmesh.pspec_for_shape(shape, mesh))
    want += [None] * (len(shape) - len(want))
    if len(shape) == 2:
        got = tmesh.spec_for_shape(shape[::-1], _plan(mesh), features_dim=0)
        assert got[::-1] == want
    else:
        assert tmesh.spec_for_shape(shape, _plan(mesh)) == want
    # the same rule on the flax layout itself (features last)
    assert tmesh.spec_for_shape(shape, _plan(mesh)) == want


def test_placements_are_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    plan = tmesh.plan_for_devices(8, fsdp=2, tensor=2)
    assert tmesh.placements_for_shape((256, 512), plan, features_dim=0) == (
        Replicate(), Shard(1), Shard(0))
    assert tmesh.placements_for_shape((128,), plan) == (Replicate(),) * 3


@pytest.mark.parametrize("axes, seq_dim", [({"fsdp": 2}, None),
                                           ({"fsdp": 2}, 1), ({"seq": 4}, 1)])
def test_batch_placements_match_batch_pspec(axes, seq_dim):
    from torch.distributed.tensor import Replicate, Shard

    mesh = _jax_mesh(**axes)
    spec = jmesh.batch_pspec(mesh, seq_dim=seq_dim)
    got = tmesh.batch_placements(_plan(mesh), seq_dim=seq_dim)
    want = tmesh.placements_from_spec(list(spec), _plan(mesh))
    assert got == want
    assert got[0] == Shard(0)  # data
    assert all(p in (Shard(0), Shard(seq_dim or 0), Replicate()) for p in got)


# Flattened DenseGeneral kernels: JAX splits their head_dim over tensor,
# the port the flattened output features (parallel/mesh.py docstring).
FLATTENED = ("attn.qkv.weight", "out.weight")


@pytest.mark.parametrize("axes", [{"fsdp": 2, "tensor": 2}, {"fsdp": 4},
                                  {"tensor": 2, "expert": 2}],
                         ids=["fsdp2-tensor2", "fsdp4", "tensor2-expert2"])
def test_gpt_tiny_placements_match_jax_sharding_for_tree(axes):
    """Every 2-D kernel, embedding, norm and bias of a GPT tiny with MoE
    blocks lies, transposed, as the JAX rule places its flax leaf; the
    flattened attention kernels take the pinned divergence."""
    jcfg = JaxGPTConfig.tiny(moe_every=2, num_experts=4)
    jparams = jax.eval_shape(
        lambda: JaxGPT(jcfg).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32)))["params"]
    mesh = _jax_mesh(**axes)
    jspecs = jmesh.sharding_for_tree(jparams, mesh)
    model = GPT(GPTConfig.tiny(moe_every=2, num_experts=4), device="meta")
    got = tmesh.sharding_for_tree(model, _plan(mesh))

    def want(path, transpose=False):
        node = jspecs
        for k in path:
            node = node[k]
        spec = list(node.spec)
        return spec[::-1] if transpose else spec

    names = {
        "tok_emb.weight": (("tok_emb", "embedding"), False),
        "pos_emb": (("pos_emb",), False),
        "layers.0.fc_in.weight": (("layer_0", "Dense_0", "kernel"), True),
        "layers.0.fc_out.weight": (("layer_0", "Dense_1", "kernel"), True),
        "layers.1.moe.wi": (("layer_1", "moe", "wi"), False),
        "layers.1.moe.wo": (("layer_1", "moe", "wo"), False),
        "layers.1.moe.router": (("layer_1", "moe", "router"), False),
        "layers.0.ln_attn.weight": (("layer_0", "LayerNorm_0", "scale"), False),
        "layers.0.fc_in.bias": (("layer_0", "Dense_0", "bias"), False),
    }
    for name, (path, transpose) in names.items():
        shape = tuple(model.get_parameter(name).shape)
        spec = want(path, transpose)
        spec += [None] * (len(shape) - len(spec))
        assert got[name] == tmesh.placements_from_spec(spec, _plan(mesh)), name
    # the divergence: JAX's qkv kernel [hidden, 3, heads, head_dim] puts
    # head_dim on tensor; the port's [3 * heads * head_dim, hidden] puts its
    # flattened output features there
    if "tensor" in axes:
        jspec = want(("layer_0", "qkv", "kernel"))
        assert jspec[-1] == "tensor"
        assert tmesh.spec_for_shape(
            (384, 128), _plan(mesh), features_dim=0)[0] == "tensor"


def test_moe_param_sharding_specs():
    from torch.distributed.tensor import Replicate, Shard

    params = init_moe_params(torch.Generator().manual_seed(8), d_model=16,
                             d_ff=32, n_experts=4)
    jax_mesh = _jax_mesh(expert=4)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jspecs = __import__("cron_operator_tpu.parallel.moe", fromlist=["x"]
                        ).moe_param_sharding(jparams, jax_mesh)
    got = moe_param_sharding(params, _plan(jax_mesh))
    for name in params:
        want = tmesh.placements_from_spec(
            list(jspecs[name].spec) + [None] * 3, _plan(jax_mesh))
        assert got[name] == want, name
    assert got["wi"] == (Replicate(), Shard(0))
    assert got["router"] == (Replicate(), Replicate())


# ------------------------------------------------------------ hybrid mesh


class _Dev:
    def __init__(self, i, slice_index=None):
        self.id = i
        if slice_index is not None:
            self.slice_index = slice_index


@pytest.mark.parametrize("slices, axes", [(2, {"tensor": 2}),
                                          (2, {"fsdp": 2, "tensor": 2}),
                                          (4, {}), (2, {"pipe": 2})])
def test_hybrid_layout_matches_jax(slices, axes):
    devs = jax.devices("cpu")
    jm = jmesh.hybrid_mesh_for_slices(slices, devices=devs, **axes)
    groups, names, inner = tmesh.hybrid_grid(slices, list(range(8)), **axes)
    grid = np.concatenate([np.array(g).reshape(inner) for g in groups])
    assert names == jm.axis_names
    assert grid.tolist() == np.vectorize(lambda d: d.id)(jm.devices).tolist()


def test_hybrid_groups_by_slice_index_and_local_world(monkeypatch):
    devs = [_Dev(i, slice_index=1 - i // 4) for i in range(8)]
    groups = tmesh.group_devices_by_slice(devs, 2)
    assert [[d.id for d in g] for g in groups] == [[4, 5, 6, 7], [0, 1, 2, 3]]
    with pytest.raises(ValueError, match="uneven"):
        tmesh.group_devices_by_slice(
            [_Dev(i, slice_index=int(i > 0)) for i in range(8)], 2)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.hybrid_grid(3, list(range(8)))
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.hybrid_grid(2, list(range(8)), fsdp=8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    nodes = tmesh._node_ranks(range(8))
    assert [n.slice_index for n in nodes] == [0, 0, 1, 1, 2, 2, 3, 3]
    with pytest.raises(ValueError, match="span 4 slice"):
        tmesh.group_devices_by_slice(nodes, 2)  # 4 nodes are 4 slices


def test_mesh_for_slice_checks_the_chip_count():
    class Spec:
        chips, topology = 4, "2x2"

    with pytest.raises(ValueError, match="has 4 chips but 1 devices"):
        tmesh.mesh_for_slice(Spec())
    with pytest.raises(ValueError, match="needs 4 devices, got 2"):
        tmesh.make_mesh(tmesh.plan_for_devices(4), ranks=[0, 1])


# ------------------------------------------------------- one rank a device


def test_devices_param_is_the_world_size(monkeypatch):
    """``param.devices`` must equal the world size; a rank of a world above
    one drives ``cuda:$LOCAL_RANK`` (a divergence from the JAX package's
    single controller, which caps one process's devices)."""
    assert device_mod.resolve_device("cpu", "1") == torch.device("cpu")
    with pytest.raises(ValueError, match="param.devices=2 but the world has 1"):
        device_mod.resolve_device("cpu", "2")
    monkeypatch.setattr(device_mod, "world_size", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    chosen = []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert device_mod.resolve_device(None, "2") == torch.device("cuda", 1)
    assert chosen == [torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="param.devices=4 but the world has 2"):
        device_mod.resolve_device(None, "4")


def test_world_of_one_refuses_axes_it_cannot_hold():
    """At one rank the model axes, ``seq`` among them, raise ``ValueError``
    as the JAX package's one-device mesh does."""
    ctx = JobContext("t", "ns", {}, {"platform": "cpu", "fsdp": "2"})
    with pytest.raises(ValueError, match="not divisible"):
        entrypoints._train_device(ctx)
    ctx = JobContext("t", "ns", {}, {"platform": "cpu", "slices": "2"})
    with pytest.raises(ValueError, match="slices"):
        entrypoints._train_device(ctx)
    ctx = JobContext("t", "ns", {}, {"platform": "cpu", "seq": "2"})
    with pytest.raises(ValueError, match="not divisible"):
        entrypoints._train_device(ctx)
    device, mesh = entrypoints._train_device(
        JobContext("t", "ns", {}, {"platform": "cpu"}))
    assert device == torch.device("cpu") and mesh is None


# ---------------------------------------------------------------- worlds

SEQ, BATCH = 32, 4
MOE = {"seed": 6, "d": 16, "f": 32, "experts": 8, "tokens": 32}


def _chain_trainer(root):
    cfg = GPTConfig.tiny(dtype=torch.float32, attention_impl="xla",
                         max_len=SEQ)
    model = GPT(cfg).init_weights(torch.Generator().manual_seed(0))
    store = CheckpointStore("ns", "chain", root=root, max_to_keep=100)
    return store, Trainer(
        model, TrainConfig(steps_per_call=1, save_every=4),
        sample_fn=data.causal_token_sample(BATCH, SEQ, 1024),
        checkpoint=store)


def _runner_env(rank, port):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "JAX_", "MASTER_", "WORLD_SIZE",
                                "RANK", "LOCAL_"))}
    env.update(PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]),
               OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")
    return env


GPT_JOB = ["gpt", "platform=cpu", "size=tiny", "seq_len=32", "batch_size=4",
           "steps=2", "steps_per_call=1", "data=host", "fsdp=2"]


def _start_runner_world(args):
    """Two port runner processes of a gloo world, started."""
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "cron_operator_tpu_torch.workloads.runner",
         *args], cwd=ROOT, env=_runner_env(r, port), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]


def _runner_frames(procs):
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        out.append([json.loads(line[len(runner.PROGRESS_PREFIX):])
                    for line in stdout.splitlines()
                    if line.startswith(runner.PROGRESS_PREFIX)])
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_worlds")
    chain_dir, grow_dir = str(out / "chain"), str(out / "grow")
    result = {}
    # The runner worlds run beside the spawned ones.
    probe = _start_runner_world(["torch_mesh_ranks:mesh_probe",
                                 "platform=cpu", "fsdp=2"])
    gpt = _start_runner_world(GPT_JOB)
    # A one-process lineage at step 4, restored onto larger meshes.
    store, trainer = _chain_trainer(grow_dir)
    trainer.run(itertools.repeat({}), 4)
    store.close()
    launch = tmesh.plan_for_devices(4, fsdp=2)  # data 2 x fsdp 2
    shrunk = tmesh.replan(launch, 2)
    result["shrunk"] = shrunk
    chain = {"cfg": {"max_len": SEQ}, "batch": BATCH, "save_every": 4}
    spawn_world(4, [
        {**chain, "kind": "chain", "name": "chain4", "dir": chain_dir,
         "axes": {"fsdp": launch.axis("fsdp")}, "steps": 6},
        {**chain, "kind": "chain", "name": "grow4", "dir": grow_dir,
         "axes": {"fsdp": 2, "tensor": 2}, "steps": 4},
        {**MOE, "kind": "moe", "name": "moe4", "axes": {"expert": 2}},
        {"kind": "refuse", "name": "refuse4", "axes": {}},
    ], out)
    spawn_world(2, [
        {**chain, "kind": "split", "name": "split2", "dir": grow_dir,
         "empty": str(out / "empty"), "axes": {"fsdp": 2}},
        {**chain, "kind": "chain", "name": "chain2", "dir": chain_dir,
         "axes": {a: shrunk.axis(a) for a in ("fsdp", "tensor", "expert")},
         "steps": 9},
        {**chain, "kind": "chain", "name": "grow2", "dir": grow_dir,
         "axes": {"tensor": 2}, "steps": 4},
    ], out)
    for name, world in (("chain4", 4), ("grow4", 4), ("moe4", 4),
                        ("refuse4", 4), ("split2", 2), ("chain2", 2),
                        ("grow2", 2)):
        result[name] = [torch.load(out / f"{name}.rank{r}.pt",
                                   weights_only=False) for r in range(world)]
    # The chain's last leg on one process, and the uninterrupted run.
    store, trainer = _chain_trainer(chain_dir)
    result["resumed1"] = trainer.steps_done
    result["chain1"] = [s.loss for s in trainer.run(itertools.repeat({}), 12)]
    store.close()
    store, trainer = _chain_trainer(str(out / "ref"))
    result["ref"] = [s.loss for s in trainer.run(itertools.repeat({}), 12)]
    store.close()
    reader = CheckpointStore("ns", "chain", root=chain_dir, create=False)
    result["saved"] = {step: reader.restore_params(step) for step in (4, 8)}
    result["grow_saved"] = CheckpointStore(
        "ns", "chain", root=grow_dir, create=False).restore_params(4)
    result["probe"] = _runner_frames(probe)
    result["gpt"] = _runner_frames(gpt)
    return result


def test_sharded_moe_matches_unsharded(worlds):
    gen = torch.Generator().manual_seed(MOE["seed"])
    params = {k: v.requires_grad_() for k, v in init_moe_params(
        gen, d_model=MOE["d"], d_ff=MOE["f"], n_experts=MOE["experts"]
    ).items()}
    x = torch.randn(MOE["tokens"], MOE["d"], generator=gen)
    y, aux = moe_ffn(params, x)
    ((y ** 2).mean() + 0.01 * aux).backward()
    for rank in worlds["moe4"]:
        assert rank["placements"]["wi"] == ["R", "S(0)"]
        torch.testing.assert_close(rank["y"], y.detach(), rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(rank["aux"], aux.detach(), rtol=1e-5,
                                   atol=0)
        for name, p in params.items():
            torch.testing.assert_close(rank["grads"][name], p.grad,
                                       rtol=1e-5, atol=1e-7)


def test_kernel_wrappers_refuse_dtensors(worlds):
    """A DTensor reaching K1-K3's wrappers is an error, not a quiet
    gather: attention hands them each rank's local block."""
    for rank in worlds["refuse4"]:
        assert set(rank["refused"]) == {
            "flash_attention", "flash_attention_fwd", "flash_attention_dq",
            "flash_attention_dkv"}
        for name, err in rank["refused"].items():
            assert err is not None and "not DTensors" in err, name


@pytest.mark.parametrize("q_heads, kv_heads, batch, want", [
    (4, 4, 8, ("S(0)", "S(0)", "S(2)")),
    (4, 2, 8, ("S(0)", "S(0)", "S(2)")),
    (4, 1, 8, ("S(0)", "S(0)", "R")),  # GQA: kv heads do not divide
    (3, 3, 8, ("S(0)", "S(0)", "R")),
    (4, 4, 2, ("R", "R", "S(2)")),  # batch does not divide data x fsdp
], ids=["mha", "gqa2", "gqa1", "odd_heads", "small_batch"])
def test_attention_placements_follow_sharded_flash(q_heads, kv_heads, batch,
                                                   want):
    """As the JAX ``_sharded_flash``: the batch over (data, fsdp) when it
    divides, heads over ``tensor`` only when both head counts divide."""
    from cron_operator_tpu_torch.ops.attention import attention_placements

    plan = tmesh.plan_for_devices(8, fsdp=2, tensor=2)  # data 2
    q = torch.empty(batch, 128, q_heads, 64, device="meta")
    k = torch.empty(batch, 128, kv_heads, 64, device="meta")
    got = attention_placements(q, k, plan)
    assert tuple(str(p) for p in got) == want


def test_resumes_land_on_checkpoint_steps(worlds):
    assert worlds["shrunk"].axis_sizes == {"data": 1, "fsdp": 2}
    assert worlds["chain4"][0]["restored_step"] == 0
    assert worlds["chain2"][0]["restored_step"] == 4
    assert worlds["resumed1"] == 8


@pytest.mark.parametrize("leg", ["chain2", "grow4", "grow2"])
def test_restored_params_bit_exact(worlds, leg):
    """What each mesh restored is bit for bit what was saved, on every
    rank: resharding moves bytes, it never rounds them."""
    saved = (worlds["saved"][4] if leg == "chain2" else worlds["grow_saved"])
    for rank in worlds[leg]:
        assert set(rank["restored"]) == set(saved)
        for name, value in saved.items():
            assert torch.equal(rank["restored"][name], value), name


def test_ranks_that_restore_different_steps_refuse(worlds):
    # rank 0's store holds step 4, rank 1's (a node-local root) holds none
    for got in worlds["split2"]:
        assert got["error"] is not None
        assert "restored different checkpoint steps [4, None]" in got["error"]


def test_loss_curve_continues(worlds):
    chain = (worlds["chain4"][0]["losses"] + worlds["chain2"][0]["losses"]
             + worlds["chain1"])
    for world in ("chain4", "chain2"):
        for rank in worlds[world][1:]:
            assert rank["losses"] == worlds[world][0]["losses"]
    # leg 1 ran steps 1-6, leg 2 steps 5-9, leg 3 steps 9-12
    steps = list(range(1, 7)) + list(range(5, 10)) + list(range(9, 13))
    ref = worlds["ref"]
    assert len(ref) == 12 and len(chain) == len(steps)
    for step, loss in zip(steps, chain):
        assert abs(loss - ref[step - 1]) <= 5e-5, (step, loss, ref[step - 1])


def test_rendered_two_rank_env_gives_each_rank_its_device_and_one_mesh(
        worlds):
    """Two runner processes from the env a two-rank PyTorchJob renders
    (``MASTER_*``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``): each gets its
    own device and its own coordinate of the same mesh; every rank emits
    the frames, as the JAX runner's processes do."""
    frames = worlds["probe"]
    progress = [f[-1]["progress"] for f in frames]
    assert [p["mesh"] for p in progress] == [{"data": 1, "fsdp": 2}] * 2
    assert [p["coordinate"] for p in progress] == [[0, 0], [0, 1]]
    assert [p["device"] for p in progress] == ["cpu", "cpu"]


def test_gpt_trains_under_fsdp_through_the_runner(worlds):
    """``gpt fsdp=2`` in a two-rank gloo world reports the one-process
    loss on every rank (GPT tiny in bf16: the sums over ranks round
    differently, held to 1e-2 relative)."""
    frames = worlds["gpt"]
    done = [f[-1] for f in frames]
    assert all(d["type"] == "done" for d in done)
    losses = [d["progress"]["last_loss"] for d in done]
    assert losses[0] == losses[1]
    ctx = JobContext("gpt", "default", {},
                     dict(a.split("=", 1) for a in GPT_JOB[1:]
                          if not a.startswith("fsdp")))
    entrypoints.gpt(ctx)
    assert abs(losses[0] - ctx.progress["last_loss"]) <= (
        1e-2 * ctx.progress["last_loss"])
    assert done[0]["progress"]["n_params"] == ctx.progress["n_params"]
