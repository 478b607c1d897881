"""The port's ``generate_job`` against the JAX package's: same params, same
published progress keys and read-bytes model; the card unless asked."""

import pytest
import torch

from cron_operator_tpu.backends.registry import JobContext as JaxJobContext
from cron_operator_tpu.workloads.entrypoints import generate_job as jax_generate_job
from cron_operator_tpu_torch.backends.registry import JobContext
from cron_operator_tpu_torch.workloads.entrypoints import generate_job

PARAMS = {
    "platform": "cpu", "size": "tiny", "rounds": "2", "batch_size": "2",
    "prompt_len": "4", "max_new": "4",
}


@pytest.mark.parametrize(
    "extra", [{}, {"kv_heads": "2", "rope": "1"}], ids=["mha", "gqa_rope"]
)
def test_publishes_what_the_jax_job_publishes(extra):
    params = {**PARAMS, **extra}
    jctx = JaxJobContext("gen", "default", {}, dict(params))
    jax_generate_job(jctx)
    published = []
    ctx = JobContext("gen", "default", {}, dict(params))
    ctx.publish = lambda: published.append(dict(ctx.progress))
    generate_job(ctx)
    assert set(ctx.progress) == set(jctx.progress)
    for key in ("n_params", "decode_read_bytes_per_step", "steps_done",
                "tokens_generated"):
        assert ctx.progress[key] == jctx.progress[key], key
    assert ctx.progress["tokens_generated"] == 16
    assert ctx.progress["tokens_per_s"] > 0
    assert len(published) == 2


def test_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {k: v for k, v in PARAMS.items() if k != "platform"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_job(JobContext("gen", "default", {}, params))


@pytest.mark.parametrize(
    "extra, match",
    [({"checkpoint_from": "train"}, "checkpoint"), ({"moe_every": "2"}, "MoE")],
)
def test_later_slices_raise(extra, match):
    with pytest.raises(NotImplementedError, match=match):
        generate_job(JobContext("gen", "default", {}, {**PARAMS, **extra}))


def test_stop_before_the_first_round():
    ctx = JobContext("gen", "default", {}, dict(PARAMS))
    ctx.cancel.set()
    generate_job(ctx)
    assert "steps_done" not in ctx.progress


def test_context_normalizes_param_keys():
    ctx = JobContext("gen", "default", {}, {"Batch-Size": 3})
    assert ctx.params == {"batch_size": "3"}
