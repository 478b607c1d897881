"""The port's entrypoints against the JAX package's: ``generate_job`` and
the training jobs (``gpt``, ``bert``, ``mnist``, ``resnet50``, ``vit``) take
the same params and publish the same progress keys (and ``generate_job``
the same read-bytes model); they run on the card unless asked, the params
of later slices raise, the job-contract params (``checkpoint``, ``mfu``,
``flops_accounting``, ``profile_dir``) run, and ``moe_every`` builds
Switch-MoE blocks in ``gpt`` and ``generate_job`` and is ignored by the
other jobs. The execution modes, ``param.devices`` and
``param.pipe`` are in ``tests/test_torch_entrypoint_modes.py``."""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import threading

import pytest
import torch

from cron_operator_tpu.backends.registry import JobContext as JaxJobContext
from cron_operator_tpu.workloads.entrypoints import generate_job as jax_generate_job
from cron_operator_tpu.workloads import entrypoints as jax_entrypoints
from cron_operator_tpu.workloads.entrypoints import gpt as jax_gpt
from cron_operator_tpu_torch.backends.registry import JobContext
from cron_operator_tpu_torch.models import GPT, GPTConfig
from cron_operator_tpu_torch.workloads import entrypoints
from cron_operator_tpu_torch.workloads.entrypoints import generate_job, gpt

PARAMS = {
    "platform": "cpu", "size": "tiny", "rounds": "2", "batch_size": "2",
    "prompt_len": "4", "max_new": "4",
}


@pytest.mark.parametrize(
    "extra", [{}, {"kv_heads": "2", "rope": "1"},
              {"moe_every": "2", "num_experts": "4"}],
    ids=["mha", "gqa_rope", "moe"]
)
def test_publishes_what_the_jax_job_publishes(extra):
    """The same keys and counts; with MoE blocks ``n_params`` and the
    read-bytes model count every expert, as the JAX job's leaf count."""
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


def test_generate_job_serves_moe_blocks():
    """``moe_every`` builds the MoE model the ``gpt`` job trains: its
    parameter count is the dense model's with every second FFN replaced by
    4 experts and a router (tiny: hidden 128, mlp 512, no biases)."""
    dense = JobContext("gen", "default", {}, dict(PARAMS))
    generate_job(dense)
    ctx = JobContext("gen", "default", {}, {
        **PARAMS, "moe_every": "2", "num_experts": "4"})
    generate_job(ctx)
    ffn = 128 * 512 + 512 + 512 * 128 + 128
    moe = 128 * 4 + 2 * 4 * 128 * 512
    assert ctx.progress["n_params"] == dense.progress["n_params"] - ffn + moe
    assert ctx.progress["tokens_generated"] == 16


def test_stop_before_the_first_round():
    ctx = JobContext("gen", "default", {}, dict(PARAMS))
    ctx.cancel.set()
    generate_job(ctx)
    assert "steps_done" not in ctx.progress


def test_context_normalizes_param_keys():
    ctx = JobContext("gen", "default", {}, {"Batch-Size": 3})
    assert ctx.params == {"batch_size": "3"}


GPT_PARAMS = {
    "platform": "cpu", "size": "tiny", "steps": "3", "batch_size": "2",
    "seq_len": "32", "attention": "xla",
}


@pytest.mark.parametrize("extra", [{}, {"sync_every": "2", "steps": "5"}],
                         ids=["sync_every_1", "sync_every_2"])
def test_gpt_publishes_what_the_jax_job_publishes(extra):
    """Same params (host data, one step per call, inline staging): the
    same progress keys, plus the port's ``n_params``; under
    ``sync_every=2`` both add ``async_dispatch_ms_p50``."""
    params = {**GPT_PARAMS, "data": "host", "steps_per_call": "1",
              "stage_async": "0", **extra}
    # one JAX device: the tiny batch does not divide over the 8 CPU devices
    jctx = JaxJobContext("train", "default", {}, {**params, "devices": "1"})
    jax_gpt(jctx)
    published = []
    ctx = JobContext("train", "default", {}, dict(params))
    ctx.publish = lambda: published.append(dict(ctx.progress))
    gpt(ctx)
    assert set(ctx.progress) == set(jctx.progress) | {"n_params"}
    for key in ("steps_done", "steps_per_call", "data_mode"):
        assert ctx.progress[key] == jctx.progress[key], key
    steps = int(params["steps"])
    assert ctx.progress["steps_done"] == steps
    assert len(ctx.progress["step_timeline"]) == steps
    assert ("async_dispatch_ms_p50" in ctx.progress) == ("sync_every" in extra)
    assert ctx.progress["step_timeline"][0]["compile"] is True
    assert ctx.progress["tokens_per_s"] > 0
    assert published and "first_step_at" in published[0]


def test_gpt_defaults_resolve_and_draw_on_the_device():
    """``steps_per_call=auto`` is published as 8 (no checkpoint store to
    snap to); ``data=device`` (the default) draws from a torch.Generator on
    the job's device. The watchdog is beaten once per step."""
    beats = []
    ctx = JobContext("train", "default", {}, dict(GPT_PARAMS))
    ctx.watchdog = type("Beat", (), {"beat": lambda self: beats.append(1)})()
    gpt(ctx)
    assert ctx.progress["steps_per_call"] == 8
    assert ctx.progress["data_mode"] == "device"
    assert ctx.progress["steps_done"] == 3 and len(beats) == 3
    import math
    assert math.isfinite(ctx.progress["last_loss"])


def test_gpt_injected_hang_waits_for_cancel():
    """An injected hang wedges the loop after the step in flight until the
    job is cancelled: here the watchdog's first beat, which comes after
    that step, cancels the job 0.2 s later. In the default mode the call in
    flight carries all 3 steps: the loop records (and beats for) each of
    them, the first record waits for the cancel, and no call follows."""
    ctx = JobContext("train", "default", {}, dict(GPT_PARAMS))
    ctx.hang = threading.Event()
    ctx.hang.set()
    timers = []

    class Watchdog:
        def beat(self):
            timers.append(threading.Timer(0.2, ctx.cancel.set))
            timers[-1].start()

    ctx.watchdog = Watchdog()
    gpt(ctx)
    for t in timers:
        t.join(timeout=5)
        assert not t.is_alive()
    assert len(timers) == 3
    assert ctx.progress["steps_done"] == 3
    assert ctx.progress["hang_injected_at"] > 0
    assert [e["step"] for e in ctx.progress["step_timeline"]] == [1, 2, 3]


def test_gpt_fused_xent_matches_the_logits_loss():
    """``fused_xent=1`` changes memory, not math: the first-step loss of the
    chunked cross-entropy equals the logits path's (same seeds), within the
    5e-3 the JAX package's own test allows."""
    losses = []
    for fused in ("0", "1"):
        ctx = JobContext("train", "default", {}, {
            **GPT_PARAMS, "steps": "1", "fused_xent": fused, "data": "host"})
        gpt(ctx)
        losses.append(ctx.progress["last_loss"])
    assert abs(losses[0] - losses[1]) < 5e-3, losses


def test_gpt_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {k: v for k, v in GPT_PARAMS.items() if k != "platform"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt(JobContext("train", "default", {}, params))


@pytest.mark.parametrize(
    "extra, match",
    [({axis: "2"}, f"param.{axis}") for axis in
     ("tensor", "seq", "fsdp", "expert", "slices")]
    + [({"attention": "ring"}, "ring"),
       ({"attention": "ulysses"}, "ulysses")],
    ids=lambda v: "-".join(v) if isinstance(v, dict) else None,
)
def test_gpt_later_slices_raise(extra, match):
    """The mesh axes, ``seq`` among them, are the mesh's, and a world of one
    process cannot hold them: ``ValueError``, as the JAX package's
    one-device mesh raises (``slices``: one device does not divide into
    two). ``attention=ring|ulysses`` at one rank trains with plain
    attention, as the JAX job does over its one-device mesh: the losses of
    ``attention=xla``. The sequence-parallel runs are in
    ``test_torch_ring.py``."""
    if "attention" not in extra:
        with pytest.raises(ValueError, match="not divisible"):
            gpt(JobContext("train", "default", {}, {**GPT_PARAMS, **extra}))
        return
    runs = []
    for params in ({**GPT_PARAMS, **extra}, GPT_PARAMS):
        ctx = JobContext("train", "default", {}, {**params, "data": "host"})
        gpt(ctx)
        runs.append(ctx.progress["last_loss"])
    assert runs[0] == runs[1], (match, runs)


@pytest.mark.parametrize("extra", [{}, {"remat": "1"}, {"fused_xent": "1"}],
                         ids=["default", "remat", "fused_xent"])
def test_gpt_trains_moe_blocks(extra):
    """``moe_every=1`` (every block MoE, 4 experts) trains, also under
    remat and with the chunked cross-entropy: the parameters count every
    expert, and the first step's loss is the task loss plus the model's
    aux loss (one step a call, so that the first step publishes it)."""
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import cross_entropy_loss

    params = {**GPT_PARAMS, "moe_every": "1", "num_experts": "4",
              "steps": "4", "data": "fused", "steps_per_call": "1", **extra}
    ctx = JobContext("train", "default", {}, params)
    losses = []
    ctx.publish = lambda: losses.append(ctx.progress.get("last_loss"))
    gpt(ctx)
    assert ctx.progress["steps_done"] == 4
    import math
    assert math.isfinite(ctx.progress["last_loss"])
    dense = JobContext("train", "default", {}, {**GPT_PARAMS, "steps": "1"})
    gpt(dense)
    per_ffn = 4 * 128 + 2 * 4 * 128 * 512 - (128 * 512 + 512 + 512 * 128 + 128)
    assert ctx.progress["n_params"] == dense.progress["n_params"] + 2 * per_ffn
    # The first step of the job, replayed here from the seed-0 weights and
    # the fused generator's first batch: task loss + aux.
    model = GPT(GPTConfig.tiny(max_len=32, moe_every=1, num_experts=4))
    model.init_weights(torch.Generator().manual_seed(0))
    batch = data.causal_token_sample(2, 32, 1024)(
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits, aux = model(batch["x"])
    first = cross_entropy_loss(logits, batch["y"]).item() + aux.item()
    timeline = ctx.progress["step_timeline"]
    assert len(timeline) == 4 and losses[0] == pytest.approx(first, rel=1e-5)


@pytest.mark.parametrize("extra, key", [
    ({"checkpoint": "1"}, "steps_done"),
    ({"mfu": "1", "peak_flops_per_chip": "1e12"}, "mfu"),
    ({"flops_accounting": "1"}, "xla_flops_per_step"),
    ({"profile_dir": "prof"}, "profile_trace")],
    ids=["checkpoint", "mfu", "flops_accounting", "profile_dir"])
def test_gpt_job_contract_params_run(extra, key, tmp_path):
    """The params that waited for the one-card job contract run and
    publish what the JAX job does (``profile_trace`` is the port's)."""
    extra = {k: (str(tmp_path / v) if k == "profile_dir" else v)
             for k, v in extra.items()}
    ctx = JobContext("train", "default", {}, {
        **GPT_PARAMS, "checkpoint_dir": str(tmp_path), **extra})
    gpt(ctx)
    assert ctx.progress["steps_done"] == int(GPT_PARAMS["steps"])
    assert key in ctx.progress and "profile_error" not in ctx.progress


def test_gpt_default_mode_matches_the_jax_job():
    """The default execution mode (``steps_per_call=auto``) with host data:
    the JAX and the port job publish the same ``steps_per_call`` and one
    timeline entry per step, over calls of 8 steps and a tail of 2."""
    params = {**GPT_PARAMS, "data": "host", "steps": "10"}
    jctx = JaxJobContext("train", "default", {}, {**params, "devices": "1"})
    jax_gpt(jctx)
    ctx = JobContext("train", "default", {}, dict(params))
    gpt(ctx)
    assert ctx.progress["steps_per_call"] == jctx.progress["steps_per_call"]
    assert ctx.progress["steps_per_call"] == 8
    assert (len(ctx.progress["step_timeline"])
            == len(jctx.progress["step_timeline"]) == 10)
    assert ctx.progress["steps_done"] == jctx.progress["steps_done"] == 10


# The other training jobs at tiny sizes on the CPU (ResNet-50 keeps its
# full width: the JAX job has no size param; image 32 keeps it quick).
JOB_PARAMS = {
    "mnist": {"batch_size": "8"},
    "bert": {"size": "tiny", "batch_size": "2", "seq_len": "32",
             "attention": "xla"},
    "resnet50": {"batch_size": "2", "image_size": "32"},
    "vit": {"size": "tiny", "batch_size": "2"},
}
N_PARAMS = {"mnist": 535_818, "resnet50": 25_557_032}


def _job_params(job, **extra):
    return {"platform": "cpu", "steps": "3", **JOB_PARAMS[job], **extra}


@pytest.mark.parametrize("job", ["mnist", "bert", "vit"])
def test_training_jobs_publish_what_the_jax_jobs_publish(job):
    """Host data, one step per call, inline staging: the JAX job's progress
    keys plus the port's ``n_params``; ``tokens_per_s`` only for BERT."""
    params = _job_params(job, data="host", steps_per_call="1",
                         stage_async="0")
    jctx = JaxJobContext("train", "default", {}, {**params, "devices": "1"})
    getattr(jax_entrypoints, job)(jctx)
    ctx = JobContext("train", "default", {}, dict(params))
    getattr(entrypoints, job)(ctx)
    assert set(ctx.progress) == set(jctx.progress) | {"n_params"}
    for key in ("steps_done", "steps_per_call", "data_mode"):
        assert ctx.progress[key] == jctx.progress[key], key
    assert ("tokens_per_s" in ctx.progress) == (job == "bert")
    assert ctx.progress["n_params"] == N_PARAMS.get(
        job, ctx.progress["n_params"])


def test_resnet50_publishes_the_jax_run_keys():
    """The JAX ``_run`` publishes one key set for every job without a token
    count (read from a JAX ``mnist`` run, which compiles in seconds where
    ResNet-50 takes minutes); the port's ``resnet50`` adds ``n_params``,
    ResNet-50's 25,557,032."""
    jctx = JaxJobContext("train", "default", {}, {
        **_job_params("mnist", data="host", steps_per_call="1",
                      stage_async="0"), "devices": "1"})
    jax_entrypoints.mnist(jctx)
    ctx = JobContext("train", "default", {}, _job_params(
        "resnet50", steps="2", data="host"))
    entrypoints.resnet50(ctx)
    assert set(ctx.progress) == set(jctx.progress) | {"n_params"}
    assert ctx.progress["n_params"] == 25_557_032
    assert ctx.progress["steps_done"] == 2


@pytest.mark.parametrize("job", ["mnist", "bert", "vit"])
def test_training_jobs_draw_on_the_device_by_default(job):
    ctx = JobContext("train", "default", {}, _job_params(job))
    getattr(entrypoints, job)(ctx)
    assert ctx.progress["data_mode"] == "device"
    assert ctx.progress["steps_done"] == 3
    import math
    assert math.isfinite(ctx.progress["last_loss"])


@pytest.mark.parametrize("job", sorted(JOB_PARAMS))
def test_training_jobs_refuse_the_cpu_unless_asked(job, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {k: v for k, v in _job_params(job).items() if k != "platform"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(entrypoints, job)(JobContext("train", "default", {}, params))


@pytest.mark.parametrize("job", sorted(JOB_PARAMS))
@pytest.mark.parametrize("extra, match", [
    ({"fsdp": "2"}, "param.fsdp"), ({"expert": "2"}, "param.expert"),
])
def test_training_jobs_later_slices_raise(job, extra, match):
    """``fsdp``/``expert`` above the world's size raise ``ValueError`` in
    every training job, as in the JAX package on one device (the axes
    themselves train in gloo worlds: ``test_torch_parallel.py``)."""
    params = _job_params(job, **extra)
    with pytest.raises(ValueError, match="not divisible"):
        getattr(entrypoints, job)(JobContext("train", "default", {}, params))
    with pytest.raises(ValueError, match="not divisible"):
        getattr(jax_entrypoints, job)(JaxJobContext(
            "train", "default", {}, {**params, "devices": "1"}))


@pytest.mark.parametrize("job", sorted(JOB_PARAMS))
def test_training_jobs_ignore_moe_every(job):
    """Only ``gpt`` builds MoE blocks; the other jobs ignore ``moe_every``
    and ``num_experts``, as the JAX jobs do: the same model and the same
    first loss as without them."""
    runs = []
    for extra in ({}, {"moe_every": "1", "num_experts": "4"}):
        ctx = JobContext("train", "default", {}, _job_params(
            job, steps="1", data="host", **extra))
        getattr(entrypoints, job)(ctx)
        runs.append(ctx.progress)
    assert runs[1]["steps_done"] == 1
    assert runs[1]["n_params"] == runs[0]["n_params"]
    assert runs[1]["last_loss"] == runs[0]["last_loss"]


def test_device_streams_have_the_host_streams_shapes():
    """``data=device`` draws what the numpy streams give (shapes, dtypes,
    label range), from a torch.Generator: other values than Threefry's."""
    from cron_operator_tpu_torch.workloads import data

    for host, dev, classes in (
            (data.mnist_batches(3), data.device_mnist_batches(3, device="cpu"),
             10),
            (data.imagenet_batches(2, 16, 10),
             data.device_imagenet_batches(2, 16, 10, device="cpu"), 10),
            (data.token_batches(2, 8, 50),
             data.device_token_batches(2, 8, 50, device="cpu"), 50)):
        a, b = next(host), next(dev)
        assert a.keys() == b.keys()
        for k in a:
            assert tuple(a[k].shape) == tuple(b[k].shape), k
            assert str(b[k].dtype) == f"torch.{a[k].dtype}", k
        assert 0 <= int(b["y"].min()) and int(b["y"].max()) < classes
