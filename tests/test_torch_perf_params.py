"""The perf params of the port's training jobs: ``mfu``,
``flops_accounting`` and ``profile_dir``, and what they read.

- ``Trainer.flops_per_step`` counts a step's model FLOPs on the ``meta``
  device: for the MLP it equals ``FlopCounterMode`` over a real CPU
  forward and backward; for GPT and BERT it equals 6 x tokens x the
  matmul weights (the tied head included) plus the attention formula of
  ``chip_smoke.py`` (12 d per (query, key) pair kept, per head and layer),
  whatever the attention path; it leaves the live gradients and the
  optimizer state as they were.
- ``mfu=1`` publishes ``mfu`` = FLOPs / (avg step s x peak), from the
  unrounded average (``avg_step_time_s`` is published rounded), with the
  peak from ``param.peak_flops_per_chip`` (none on the CPU without it: no
  ``mfu``, as in the JAX job); ``flops_accounting=1`` publishes
  ``xla_flops_per_step``.
- ``profile_dir`` pins ``steps_per_call=auto`` to 1 and leaves a
  ``torch.profiler`` trace; a profiler failure is ``profile_error`` and
  the job succeeds.
- ``backends/gpu.py`` knows the H100 SXM's peak by the device name.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cron_operator_tpu.backends.registry import JobContext as JaxJobContext
from cron_operator_tpu.workloads.entrypoints import mnist as jax_mnist
from cron_operator_tpu_torch.backends.gpu import (
    PEAK_FLOPS_PER_CHIP,
    peak_flops_per_chip,
)
from cron_operator_tpu_torch.backends.registry import JobContext
from cron_operator_tpu_torch.models import MLP, Bert, BertConfig, GPT, GPTConfig
from cron_operator_tpu_torch.workloads import data, entrypoints
from cron_operator_tpu_torch.workloads.train import (
    TrainConfig,
    Trainer,
    cross_entropy_loss,
)


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("h100-sxm", 989e12),
    ("NVIDIA H100 PCIe", None), ("NVIDIA H100 NVL", None),
    ("NVIDIA A100-SXM4-80GB", None), ("", None)])
def test_peak_by_device_name(name, peak):
    assert peak_flops_per_chip(name) == peak
    assert PEAK_FLOPS_PER_CHIP["h100-sxm"] == 989e12


def test_mlp_count_equals_flop_counter_on_a_real_step():
    model = MLP(device="cpu").init_weights(torch.Generator().manual_seed(0))
    batch = data.mnist_sample(8)(torch.Generator().manual_seed(0))
    trainer = Trainer(model, TrainConfig(optimizer="sgd"))
    assert trainer.flops_per_step() is None  # before the first step
    trainer.step(batch)
    with FlopCounterMode(display=False) as counter:
        cross_entropy_loss(model(batch["x"]), batch["y"]).backward()
    assert trainer.flops_per_step() == counter.get_total_flops() > 0


def _lm_formula(model, cfg, b, s, causal):
    """6 x tokens x the matmul weights (the tied embedding counts once, as
    the head) + the attention's 12 d per kept pair, head and layer."""
    weights = sum(p.numel() for n, p in model.named_parameters()
                  if p.dim() == 2 and "pos_emb" not in n)
    d = cfg.hidden_size // cfg.num_heads
    pairs = s * (s + 1) // 2 if causal else s * s
    return (6 * b * s * weights
            + cfg.num_layers * 12 * d * b * cfg.num_heads * pairs)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_language_model_count_is_the_formula(family, impl):
    """On the ``xla`` path the CPU step computes full s x s products and on
    ``flash`` the plain K1-K3; the count is the formula either way."""
    b, s = 2, 128
    if family == "gpt":
        cfg = GPTConfig.tiny(max_len=s, attention_impl=impl)
        model, sample = GPT(cfg, device="cpu"), data.causal_token_sample(
            b, s, cfg.vocab_size)
    else:
        cfg = BertConfig.tiny(max_len=s, attention_impl=impl)
        model, sample = Bert(cfg, device="cpu"), data.token_sample(
            b, s, cfg.vocab_size)
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = Trainer(model, sample_fn=sample)
    trainer.step({})
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    state = {i: {k: v.clone() for k, v in st.items()}
             for i, st in trainer.optimizer.state_dict()["state"].items()}
    flops = trainer.flops_per_step()
    assert flops == _lm_formula(model, cfg, b, s, family == "gpt")
    # the count left the live gradients and the optimizer state alone
    for n, p in model.named_parameters():
        assert p.device.type == "cpu" and torch.equal(p.grad, grads[n]), n
    for i, st in trainer.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(v, state[i][k]), (i, k)
    assert trainer.flops_per_step() == flops  # counted once


MNIST = {"platform": "cpu", "steps": "6", "batch_size": "8",
         "steps_per_call": "2"}


def test_mfu_and_flops_accounting_are_published():
    ctx = JobContext("perf", "default", {}, {
        **MNIST, "mfu": "1", "flops_accounting": "1",
        "peak_flops_per_chip": "1e12"})
    entrypoints.mnist(ctx)
    p = ctx.progress
    flops = p["xla_flops_per_step"]
    assert flops > 0
    # The job computes mfu = round(flops / (avg * peak), 4) from the
    # unrounded average step time, as the JAX job does, and publishes the
    # average rounded to 4 places: the average lies within half a unit of
    # that place, and rounding is monotone, so mfu lies between the values
    # the two ends of that interval give.
    half = 0.5e-4
    slow, fast = p["avg_step_time_s"] + half, p["avg_step_time_s"] - half
    low = round(flops / (slow * 1e12), 4)
    high = round(flops / (fast * 1e12), 4) if fast > 0 else float("inf")
    assert low <= p["mfu"] <= high


def test_mfu_needs_a_peak_as_in_the_jax_job():
    """On the CPU there is no card to name a peak: neither job publishes
    ``mfu``; both run."""
    params = {**MNIST, "mfu": "1"}
    jctx = JaxJobContext("perf", "default", {}, dict(params))
    jax_mnist(jctx)
    ctx = JobContext("perf", "default", {}, dict(params))
    entrypoints.mnist(ctx)
    assert "mfu" not in ctx.progress and "mfu" not in jctx.progress
    assert ctx.progress["steps_done"] == jctx.progress["steps_done"] == 6


def test_profile_dir_leaves_a_trace_and_pins_one_step_a_call(tmp_path):
    ctx = JobContext("perf", "default", {}, {
        "platform": "cpu", "steps": "3", "batch_size": "8",
        "profile_dir": str(tmp_path / "prof")})
    entrypoints.mnist(ctx)
    assert ctx.progress["steps_per_call"] == 1
    assert ctx.progress["profile_dir"] == str(tmp_path / "prof")
    trace = json.loads(open(ctx.progress["profile_trace"]).read())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("addmm" in n or "mm" in n for n in names)
    assert "profile_error" not in ctx.progress


def test_a_profiler_failure_does_not_fail_the_job(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    ctx = JobContext("perf", "default", {}, {
        "platform": "cpu", "steps": "3", "batch_size": "8",
        "profile_dir": str(blocker / "prof")})  # under a file: no dir
    entrypoints.mnist(ctx)
    assert ctx.progress["steps_done"] == 3
    assert "profile_error" in ctx.progress
