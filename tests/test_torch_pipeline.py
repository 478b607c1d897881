"""The port's GPipe primitive (``parallel/pipeline.py``) in gloo worlds on
the CPU, case by case against ``tests/test_pipeline.py``.

Worlds of 2 and 4 rank processes (``tests/torch_mesh_ranks.py``, one
thread each) are spawned together, once for the module. Each runs
``spmd_pipeline`` of ``relu(x @ w + b)`` stages (width 16, batch 8, f32,
seeded numpy) under pipe 4, pipe 2 x data 2 and pipe 2, with plain stacked
parameters and with DTensor ones placed by ``pipeline_param_sharding``;
the test process runs the stages in sequence and the JAX
``spmd_pipeline`` on a mesh of the same axes over its virtual CPU devices.
Outputs agree within 1e-5, gradients (of ``sum(y ** 2)``, for x and every
stacked tensor) within 1e-5 of each tensor's largest magnitude; every rank
holds the same whole output and gradients. The checks refuse a mesh
without ``pipe``, a stage count unequal to it, and a batch (or a data
shard's batch) that does not divide into microbatches; the standard jobs
refuse ``pipe > 1``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.parallel.mesh import mesh_for_devices as jax_mesh
from cron_operator_tpu.parallel.pipeline import spmd_pipeline as jax_pipeline
from cron_operator_tpu.parallel.pipeline import (
    stack_pipeline_stages as jax_stack,
)
from cron_operator_tpu_torch.backends.registry import JobContext
from cron_operator_tpu_torch.parallel.mesh import PIPE_AXIS, plan_for_devices
from cron_operator_tpu_torch.parallel.pipeline import (
    pipeline_param_sharding,
    stack_pipeline_stages,
)
from cron_operator_tpu_torch.workloads.entrypoints import _train_device
from torch_mesh_ranks import (
    pipeline_arrays,
    pipeline_stage,
    start_world,
    wait_world,
)

ATOL = 1e-5  # outputs, f32
GRAD_RTOL = 1e-5  # gradients, of each tensor's largest magnitude
WIDTH, BATCH = 16, 8
# name: (world, axes, stages, microbatches)
RUNS = {"pipe4": (4, {"pipe": 4}, 4, 4),
        "pipe2_data2": (4, {"pipe": 2}, 2, 2),
        "pipe2": (2, {"pipe": 2}, 2, 4)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe_worlds")
    jobs = {2: [], 4: []}
    for name, (world, axes, stages, m) in RUNS.items():
        jobs[world].append({"kind": "pipeline", "name": name, "axes": axes,
                            "arrays": [0, stages, WIDTH, BATCH],
                            "microbatches": m})
    for world in jobs:
        jobs[world].append({"kind": "pipe_guards", "name": f"guards{world}",
                            "axes": {}})
    running = [start_world(w, js, out) for w, js in jobs.items()]
    for procs in running:
        wait_world(procs)
    return {job["name"]: [torch.load(out / f"{job['name']}.rank{r}.pt",
                                     weights_only=False)
                          for r in range(world)]
            for world, js in jobs.items() for job in js}


def _sequential(stages):
    """The stages run in sequence: y and the gradients of sum(y ** 2) for x
    and each stage's w and b, stacked."""
    _, x = pipeline_arrays(0, len(stages), WIDTH, BATCH)
    x = torch.from_numpy(x).requires_grad_()
    params = [{n: torch.from_numpy(a).requires_grad_() for n, a in s.items()}
              for s in stages]
    y = x
    for p in params:
        y = pipeline_stage(p, y)
    (y ** 2).sum().backward()
    grads = stack_pipeline_stages([{n: t.grad for n, t in p.items()}
                                   for p in params])
    return y.detach(), x.grad, grads


def _jax(name):
    """JAX's spmd_pipeline on a mesh of the same axes: y and jax.grad of
    sum(y ** 2) for the stacked stages and x."""
    world, axes, n_stages, m = RUNS[name]
    stages, x = pipeline_arrays(0, n_stages, WIDTH, BATCH)
    mesh = jax_mesh(jax.devices("cpu")[:world], **axes)
    stacked = jax_stack([{n: jnp.asarray(a) for n, a in s.items()}
                         for s in stages])

    def stage(p, x):
        return jax.nn.relu(x @ p["w"] + p["b"])

    def run(p, x):
        return jax_pipeline(stage, p, x, mesh=mesh, n_microbatches=m)

    y = jax.jit(run)(stacked, jnp.asarray(x))
    grads = jax.jit(jax.grad(lambda p, x: jnp.sum(run(p, x) ** 2),
                             argnums=(0, 1)))(stacked, jnp.asarray(x))
    return y, grads


def _close(got, want, rtol=GRAD_RTOL):
    want = torch.as_tensor(np.array(want))
    atol = rtol * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _check(ranks, name):
    stages, _ = pipeline_arrays(0, RUNS[name][2], WIDTH, BATCH)
    y, x_grad, grads = _sequential(stages)
    jy, (jgrads, jx_grad) = _jax(name)
    for got in ranks:
        for key in ("y", "y_dtensor"):
            assert (got[key] - y).abs().max() <= ATOL
            _close(got[key], jy, ATOL)
        _close(got["x_grad"], x_grad)
        _close(got["x_grad"], jx_grad)
        for n in grads:
            for key in ("grads", "grads_dtensor"):
                _close(got[key][n], grads[n])
                _close(got[key][n], jgrads[n])


def test_matches_sequential_pipe_only(worlds):
    """TestForward.test_matches_sequential_pipe_only (pipe 4, 4
    microbatches), with TestBackward.test_grads_match_sequential's
    gradients."""
    _check(worlds["pipe4"], "pipe4")


def test_composes_with_data_axis(worlds):
    """TestForward.test_composes_with_data_axis: pipe 2 x data 2, each data
    shard's 4 rows in 2 microbatches."""
    assert worlds["pipe2_data2"][0]["placements"]["w"] == ["S(0)", "R"]
    _check(worlds["pipe2_data2"], "pipe2_data2")


def test_two_stages(worlds):
    _check(worlds["pipe2"], "pipe2")


@pytest.mark.parametrize("world", [2, 4])
def test_microbatch_count_must_divide(worlds, world):
    assert "not divisible" in worlds[f"guards{world}"][0]["microbatches"]


@pytest.mark.parametrize("world", [2, 4])
def test_requires_pipe_axis(worlds, world):
    assert "no 'pipe' axis" in worlds[f"guards{world}"][0]["no_pipe"]


@pytest.mark.parametrize("world", [2, 4])
def test_stage_count_must_match_pipe_axis(worlds, world):
    """TestPerShardDivisibility.test_stage_count_must_match_pipe_axis: a
    stack of the wrong length raises, not a pipeline that ignores
    stages."""
    got = worlds[f"guards{world}"][0]["stages"]
    assert f"but the mesh 'pipe' axis has {world}" in got


def test_local_batch_must_divide_microbatches(worlds):
    """TestPerShardDivisibility: batch 8 over data 2 gives 4 rows a shard,
    which 8 microbatches do not divide."""
    assert "per-shard batch 4" in worlds["guards4"][0]["per_shard"]
    assert worlds["guards2"][0]["per_shard"] is None  # data 1: 8 rows divide


def test_pipeline_param_sharding_places_stage_dim_on_pipe(worlds):
    plan = plan_for_devices(8, pipe=4)
    place = pipeline_param_sharding({"w": torch.zeros(4, 2),
                                     "b": torch.zeros(4)}, plan)
    assert [str(p) for p in place["w"]] == ["S(0)", "R"]  # pipe, data
    assert list(plan.axis_names).index(PIPE_AXIS) == 0
    for got in worlds["pipe4"]:
        assert got["placements"] == {"w": ["S(0)", "R"], "b": ["S(0)", "R"]}


def test_stack_pipeline_stages_refuses_unequal_stages():
    with pytest.raises(ValueError, match="differ"):
        stack_pipeline_stages([{"w": torch.zeros(2)}, {"v": torch.zeros(2)}])


def test_pipe_param_rejected_by_standard_entrypoints():
    ctx = JobContext("p", "default", {}, {"pipe": "2", "platform": "cpu"})
    with pytest.raises(ValueError, match="spmd_pipeline"):
        _train_device(ctx)
