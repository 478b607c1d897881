"""The plain data-parallel path of the port's meshed training, in gloo
worlds on the CPU.

A mesh whose axes above 1 are only ``data`` and ``fsdp`` trains plain
modules (``parallel.mesh.data_parallel``): ``DistributedDataParallel``
under ``data``, FSDP2 under ``fsdp`` (replicated over ``data`` when both are
above 1). Worlds of 2 and 4 rank processes (``tests/torch_mesh_ranks.py``)
are spawned together, once for the module, and the test process runs the
one-process port and the JAX package beside them.

- The rule: ``data``, ``fsdp``, ``seq``, ``expert`` and their products
  take the plain path (the ``seq`` runs are in ``test_torch_seq_plain.py``,
  the ``expert`` ones in ``test_torch_expert_plain.py``); a mesh with
  ``tensor`` (for no model that splits its blocks) or ``pipe`` above 1
  keeps DTensor parameters.
- Tiny GPT (f32, 2 layers, 4 heads, seq 32, batch 4 of the numpy
  ``causal_token_batches``, AdamW, converted JAX weights) under ``data 2``,
  ``fsdp 2`` and ``data 2 x fsdp 2``, and with Switch-MoE blocks (every
  second block, 4 experts, capacity factor 1, so tokens are dropped) under
  ``data 2``: the path taken, the losses of 5 steps and the first step's
  gradients against the one-process port (rtol 1e-5, atol 1e-5 of each
  tensor's largest magnitude, as ``test_torch_parallel.py``) and against the
  JAX sharded ``Trainer`` on a mesh of the same axes (losses within 5e-5,
  gradients rtol 1e-4); the parameters lie as ``sharding_for_tree`` places
  them (a DDP parameter, and one FSDP2 leaves whole, reads ``R``); the same
  5 steps in calls of 4 (a call of 4 and a call of 1, staged by the
  trainer's thread) leave the losses and the parameters of 5 calls of one
  step, to the bit; each rank counts a step's model FLOPs over the global
  batch, as one process does.
- ``moe_ffn`` with ``group`` under ``data 2`` routes each rank's tokens
  among every rank's, as one device does (output, aux loss and gradients
  within 1e-5), where routing each rank's tokens alone gives another
  output.

The card's side (a captured step over NCCL equal to the eager one) is in
``tests/test_torch_mesh_graph_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import numpy as np
import pytest
import torch

from cron_operator_tpu_torch.models.convert import params_from_flax
from cron_operator_tpu_torch.models.gpt import GPT
from cron_operator_tpu_torch.parallel.mesh import (
    MeshPlan,
    plain_axes,
    plan_for_devices,
    sharding_for_tree,
)
from cron_operator_tpu_torch.parallel.moe import init_moe_params, moe_ffn
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer
from test_torch_parallel import (
    BATCH,
    LOSS_ATOL,
    SEQ,
    STEPS,
    _close,
    _flax_params,
    _jax_run,
    _one_process,
    _port_config,
)
from torch_mesh_ranks import start_world, wait_world

CHUNK = 4
MOE = {"moe_every": 2, "num_experts": 4, "moe_capacity_factor": 1.0}
# name: (world, axes, model overrides, the path the trainer takes)
RUNS = {
    "data": (2, {}, {}, "ddp"),
    "fsdp": (2, {"fsdp": 2}, {}, "fsdp"),
    "data_fsdp": (4, {"fsdp": 2}, {}, "fsdp"),
    "moe_data": (2, {}, MOE, "ddp"),
}
# moe_ffn alone: 64 tokens over 2 ranks, 4 experts at capacity factor 1
MOE_FFN = {"seed": 3, "d": 16, "f": 32, "experts": 4, "tokens": 64,
           "capacity_factor": 1.0}


@pytest.mark.parametrize("axes, plain", [
    ({"data": 4}, True),
    ({"data": 1, "fsdp": 4}, True),
    ({"data": 2, "fsdp": 2}, True),
    ({"data": 1}, True),
    ({"data": 2, "tensor": 2}, False),
    ({"data": 2, "expert": 2}, True),
    ({"data": 2, "seq": 2}, True),
    ({"data": 1, "fsdp": 2, "seq": 2}, True),
    ({"data": 1, "seq": 2, "tensor": 2}, False),
    ({"pipe": 2, "data": 2}, False),
    ({"data": 1, "fsdp": 2, "tensor": 2}, False),
])
def test_the_rule_picks_the_plain_path_for_batch_axes_only(axes, plain):
    assert plain_axes(MeshPlan(axes)) is plain


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_worlds")
    jobs = {4: [], 2: [{**MOE_FFN, "kind": "moe_group", "name": "moe_ffn",
                        "axes": {}}]}
    result = {"flax": {}, "weights": {}}
    for name, (world, axes, over, _) in RUNS.items():
        jcfg, params = _flax_params(over)
        weights = params_from_flax(params, _port_config(over))
        path = out / f"{name}.weights.pt"
        torch.save(weights, path)
        result["flax"][name] = (jcfg, params)
        result["weights"][name] = weights
        jobs[world].append({"kind": "data_parallel", "name": name,
                            "axes": axes, "cfg": {"max_len": SEQ, **over},
                            "weights": str(path), "batch": BATCH,
                            "steps": STEPS, "chunk": CHUNK})
    running = [start_world(w, js, out) for w, js in jobs.items()]
    for procs in running:
        wait_world(procs)
    for world, js in jobs.items():
        for job in js:
            result[job["name"]] = [
                torch.load(out / f"{job['name']}.rank{r}.pt",
                           weights_only=False) for r in range(world)]
    return result


@pytest.mark.parametrize("run", sorted(RUNS))
def test_batch_axes_train_plain_modules_as_one_process(worlds, run):
    ranks = worlds[run]
    assert [r["path"] for r in ranks] == [RUNS[run][3]] * len(ranks)
    ref = _one_process(worlds["weights"][run], RUNS[run][2], {})
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]  # the global loss
    got = ranks[0]
    assert len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    for name, g in ref["grads"].items():
        _close(got["grads"][name], g)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_batch_axes_train_as_the_jax_sharded_trainer(worlds, run):
    world, axes, over, _ = RUNS[run]
    jcfg, params = worlds["flax"][run]
    want, jax_grads = _jax_run(jcfg, params, world, axes, {})
    got = worlds[run][0]
    assert max(abs(a - b) for a, b in zip(got["losses"], want)) <= LOSS_ATOL
    want_grads = params_from_flax(jax_grads, _port_config(over))
    for name, g in want_grads.items():
        _close(got["grads"][name], g, rtol=1e-4)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_plain_parameters_lie_as_the_rule_places_them(worlds, run):
    world, axes, over, _ = RUNS[run]
    plan = plan_for_devices(world, **axes)
    want = sharding_for_tree(GPT(_port_config(over)), plan)
    for got in worlds[run]:
        assert got["mesh"] == plan.axis_sizes
        assert got["placements"] == {n: [str(p) for p in pl]
                                     for n, pl in want.items()}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_calls_of_several_steps_equal_calls_of_one(worlds, run):
    for got in worlds[run]:
        chunked = got["chunked"]
        # one record a call: steps 4 and 5
        assert chunked["losses"] == [got["losses"][CHUNK - 1],
                                     got["losses"][-1]]
        for name, value in got["final"].items():
            assert torch.equal(chunked["final"][name], value), name


@pytest.mark.parametrize("run", sorted(RUNS))
def test_model_flops_count_the_global_batch(worlds, run):
    """Each rank counts a step's FLOPs over the whole mesh's batch, as one
    process does (the ``mfu`` param divides them by the mesh's peak)."""
    over = RUNS[run][2]
    model = GPT(_port_config(over))
    trainer = Trainer(model, TrainConfig(steps_per_call=1,
                                         aux_loss_in_output=model.has_moe))
    trainer.run(data.causal_token_batches(BATCH, SEQ, 1024), 1)
    want = trainer.flops_per_step()
    assert want
    for got in worlds[run]:
        assert got["chunked"]["flops"] == want


def test_moe_ffn_routes_every_ranks_tokens_as_one_device(worlds):
    gen = torch.Generator().manual_seed(MOE_FFN["seed"])
    params = {k: v.requires_grad_() for k, v in init_moe_params(
        gen, d_model=MOE_FFN["d"], d_ff=MOE_FFN["f"],
        n_experts=MOE_FFN["experts"]).items()}
    x = torch.randn(MOE_FFN["tokens"], MOE_FFN["d"],
                    generator=gen).requires_grad_()
    y, aux = moe_ffn(params, x, capacity_factor=MOE_FFN["capacity_factor"])
    ((y ** 2).sum() / MOE_FFN["tokens"] + 0.01 * aux).backward()
    ranks = worlds["moe_ffn"]
    rows = MOE_FFN["tokens"] // len(ranks)
    for r, got in enumerate(ranks):
        mine = slice(r * rows, (r + 1) * rows)
        torch.testing.assert_close(got["y"], y.detach()[mine], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(got["aux"], aux.detach(), rtol=1e-5,
                                   atol=0)
        torch.testing.assert_close(got["x_grad"], x.grad[mine], rtol=1e-5,
                                   atol=1e-6)
        for name, p in params.items():
            torch.testing.assert_close(got["grads"][name], p.grad,
                                       rtol=1e-5, atol=1e-6)
    # routed among its own tokens alone, a rank drops other tokens
    assert any(not torch.allclose(got["alone"], got["y"]) for got in ranks)


def test_moe_ffn_group_index_path_equals_the_dense_one(worlds):
    """Over the group too, each rank's gathers give the dense products'
    output and expert gradients to the bit: a slot of another rank's token
    reads a zero row, and the sum over the ranks adds exact zeros. The
    router's and x's gradients (the gate's <dy, expert_out> summed in
    another order) stay within f32 rounding."""
    for got in worlds["moe_ffn"]:
        dense = got["dense"]
        assert torch.equal(got["y"], dense["y"])
        assert torch.equal(got["aux"], dense["aux"])
        for name in ("wi", "wo"):
            assert torch.equal(got["grads"][name], dense["grads"][name]), name
        torch.testing.assert_close(got["grads"]["router"],
                                   dense["grads"]["router"], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(got["x_grad"], dense["x_grad"], rtol=1e-5,
                                   atol=1e-6)
