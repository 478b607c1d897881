"""The port's training entrypoints in every execution mode, and the params
that pick devices, against the JAX package's: calls of several steps
(staged ahead or inline), batch prefetch and fused data run each job to
its step target with one timeline entry per step; ``param.pipe > 1`` and
``param.devices`` beyond the visible count raise ``ValueError`` in both
packages; ``param.devices`` is the world size (one rank per device)."""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import math

import pytest
import torch

from cron_operator_tpu.backends.registry import JobContext as JaxJobContext
from cron_operator_tpu.workloads import entrypoints as jax_entrypoints
from cron_operator_tpu.workloads.entrypoints import gpt as jax_gpt
from cron_operator_tpu_torch.backends.registry import JobContext
from cron_operator_tpu_torch.workloads import entrypoints
from cron_operator_tpu_torch.workloads.entrypoints import generate_job, gpt

GPT_PARAMS = {
    "platform": "cpu", "size": "tiny", "steps": "5", "batch_size": "2",
    "seq_len": "32", "attention": "xla",
}
# The other training jobs at tiny sizes on the CPU (ResNet-50 keeps its
# full width: the JAX job has no size param; image 32 keeps it quick).
JOB_PARAMS = {
    "mnist": {"batch_size": "8"},
    "bert": {"size": "tiny", "batch_size": "2", "seq_len": "32",
             "attention": "xla"},
    "resnet50": {"batch_size": "2", "image_size": "32"},
    "vit": {"size": "tiny", "batch_size": "2"},
}
SERVING_PARAMS = {
    "platform": "cpu", "size": "tiny", "rounds": "1", "batch_size": "2",
    "prompt_len": "4", "max_new": "4",
}


ALL_JOBS = ["gpt", *sorted(JOB_PARAMS)]
MODES = {
    "steps_per_call_4": {"steps_per_call": "4"},
    "prefetch_2": {"prefetch": "2"},
    "data_fused": {"data": "fused"},
    "inline_steps_per_call_4": {"steps_per_call": "4", "stage_async": "0"},
}


def _params(job, **extra):
    base = GPT_PARAMS if job == "gpt" else JOB_PARAMS[job]
    return {"platform": "cpu", "steps": "5", **base, **extra}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("job", ALL_JOBS)
def test_training_jobs_run_every_execution_mode(job, mode):
    """Calls of 4 steps (staged ahead or inline), batch prefetch and fused
    data: 5 steps run (a call of 4 and a tail of 1 where calls carry 4),
    with one timeline entry per step and a finite loss."""
    ctx = JobContext("train", "default", {}, _params(job, **MODES[mode]))
    getattr(entrypoints, job)(ctx)
    assert ctx.progress["steps_done"] == 5
    assert [e["step"] for e in ctx.progress["step_timeline"]] == [1, 2, 3, 4, 5]
    assert ctx.progress["steps_per_call"] == int(
        MODES[mode].get("steps_per_call", 8))
    assert ctx.progress["data_mode"] == MODES[mode].get("data", "device")
    assert math.isfinite(ctx.progress["last_loss"])


@pytest.mark.parametrize("job", ALL_JOBS)
def test_pipe_raises_value_error_as_in_jax(job):
    """``param.pipe > 1`` is refused for good, by both packages: the
    standard jobs train one step and never take a pipe axis."""
    params = {**_params(job), "pipe": "2"}
    with pytest.raises(ValueError, match="pipe"):
        getattr(jax_entrypoints, job)(
            JaxJobContext("train", "default", {}, dict(params)))
    with pytest.raises(ValueError, match="pipe"):
        getattr(entrypoints, job)(JobContext("train", "default", {}, params))


def test_devices_caps_as_in_jax():
    """``param.devices=1`` runs; more devices than are visible raise
    ``ValueError`` in both packages (the JAX tests see 8 CPU devices, the
    port one)."""
    ctx = JobContext("train", "default", {}, _params("gpt", devices="1"))
    gpt(ctx)
    assert ctx.progress["steps_done"] == 5
    params = _params("gpt", devices="64")
    with pytest.raises(ValueError, match="param.devices=64"):
        jax_gpt(JaxJobContext("train", "default", {}, dict(params)))
    with pytest.raises(ValueError, match="param.devices=64"):
        gpt(JobContext("train", "default", {}, params))
    with pytest.raises(ValueError, match="param.devices=2"):
        generate_job(JobContext("gen", "default", {},
                                {**SERVING_PARAMS, "devices": "2"}))


def test_devices_above_one_wait_for_the_mesh(monkeypatch):
    """The mesh is one rank per device: a lone process that sees two cards
    and asks for ``param.devices=2`` (or 3) is told to launch one rank per
    card, where the JAX package's single controller would drive both; a
    world of two ranks takes ``devices=2`` (``test_torch_mesh.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    params = {k: v for k, v in _params("gpt").items() if k != "platform"}
    for want in ("2", "3"):
        with pytest.raises(ValueError, match="launch one rank per card"):
            gpt(JobContext("train", "default", {}, {**params,
                                                     "devices": want}))
