"""The port's pod runner against the JAX package's, and the port's
entrypoint registry.

Subprocesses on the CPU (``mnist platform=cpu``): the port runner emits the
JAX runner's frame types (``progress``, ``spans`` under ``TPU_TRACE_ID``,
``error`` and ``done``) and progress keys (the port adds ``n_params``),
with ``TPU_PARAM_*`` env under ``key=value`` args, and the same exit codes:
0, 1 on an entrypoint error, 2 on a usage error. SIGTERM mid-run ends in a
``done`` frame with ``cancelled: true`` after the last save is on disk,
and a re-run resumes from it. Two runner processes initialise gloo from the
``JAX_*`` env that the operator renders. The runs that do not depend on
each other start together (``runs``).
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from cron_operator_tpu_torch.backends.registry import (
    JobContext,
    register_entrypoint,
    resolve_entrypoint,
)
from cron_operator_tpu_torch.workloads import entrypoints, runner

ROOT = Path(__file__).resolve().parents[1]
PORT = "cron_operator_tpu_torch.workloads.runner"
JAX = "cron_operator_tpu.workloads.runner"
MNIST = ["mnist", "platform=cpu", "batch_size=8", "steps=2"]
TIMEOUT_S = 240


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "JAX_COORDINATOR", "JAX_NUM",
                                "JAX_PROCESS", "MASTER_", "WORLD_SIZE",
                                "RANK"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _start(module, args, **env):
    return subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=ROOT, env=_env(**env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _frames(stdout):
    return [json.loads(line[len(runner.PROGRESS_PREFIX):])
            for line in stdout.splitlines()
            if line.startswith(runner.PROGRESS_PREFIX)]


def _finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT_S)
    return proc.returncode, _frames(out), err


TRACED = dict(TPU_TRACE_ID="00f067aa0ba902b7", TPU_JOB_NAME="mnist-1",
              TPU_JOB_NAMESPACE="team-a", TPU_PARAM_STEPS="5",
              TPU_PARAM_BATCH_SIZE="8")
CASES = {
    # name: (runner module, args, env)
    "port-ok": (PORT, MNIST, TRACED),
    "jax-ok": (JAX, MNIST, TRACED),
    "port-error": (PORT, ["mnist", "platform=cpu", "steps=many"], {}),
    "jax-error": (JAX, ["mnist", "platform=cpu", "steps=many"], {}),
    "port-unknown": (PORT, ["no-such-job", "platform=cpu"], {}),
    "port-usage": (PORT, [], {}),
    "jax-usage": (JAX, [], {}),
}


@pytest.fixture(scope="module")
def runs():
    procs = {name: _start(module, args, **env)
             for name, (module, args, env) in CASES.items()}
    return {name: _finish(proc) for name, proc in procs.items()}


def test_frames_and_progress_keys_match_the_jax_runner(runs):
    """``steps=2`` in the args overrides ``TPU_PARAM_STEPS=5``; both
    runners trace the run under ``TPU_TRACE_ID``."""
    port, jax = runs["port-ok"], runs["jax-ok"]
    assert port[0] == jax[0] == 0, (port[2][-2000:], jax[2][-2000:])
    assert [f["type"] for f in port[1]] == [f["type"] for f in jax[1]]
    assert [f["type"] for f in port[1]] == ["progress", "spans", "done"]
    done, jdone = port[1][-1], jax[1][-1]
    assert done["cancelled"] is jdone["cancelled"] is False
    assert set(done["progress"]) == set(jdone["progress"]) | {"n_params"}
    assert done["progress"]["steps_done"] == jdone["progress"]["steps_done"] == 2
    span, jspan = port[1][1]["spans"][0], jax[1][1]["spans"][0]
    assert set(span) == set(jspan)
    assert set(span["attrs"]) == set(jspan["attrs"])
    assert span["name"] == "runner" and span["attrs"]["entrypoint"] == "mnist"
    assert span["trace_id"] == TRACED["TPU_TRACE_ID"]
    assert len(span["span_id"]) == len(jspan["span_id"]) == 8


@pytest.mark.parametrize("case, code", [
    ("error", 1), ("usage", 2)])
def test_exit_codes_match_the_jax_runner(runs, case, code):
    port, jax = runs[f"port-{case}"], runs[f"jax-{case}"]
    assert port[0] == jax[0] == code
    assert [f["type"] for f in port[1]] == [f["type"] for f in jax[1]]
    if case == "error":
        frame, jframe = port[1][-1], jax[1][-1]
        assert set(frame) == set(jframe) == {"type", "error", "traceback",
                                              "progress"}
        assert frame["error"].startswith("ValueError")
        assert "Traceback" in frame["traceback"]
    else:
        assert port[1] == [] and "usage" in port[2]


def test_an_unknown_entrypoint_is_an_error_frame(runs):
    code, frames, _ = runs["port-unknown"]
    assert code == 1
    assert frames[-1]["type"] == "error"
    assert "registered" in frames[-1]["error"] and "gpt" in frames[-1]["error"]


def _read_until(proc, predicate, timeout_s=TIMEOUT_S):
    deadline = time.monotonic() + timeout_s
    seen = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        seen.extend(_frames(line))
        if seen and predicate(seen[-1]):
            return seen
    raise AssertionError(f"no such frame: {seen}")


def test_sigterm_stops_gracefully_and_the_rerun_resumes(tmp_path):
    """SIGTERM once a progress frame shows a saved step: exit 0, a ``done``
    frame with ``cancelled: true``, the last save on disk before it; the
    same command again resumes from that step and runs to its target."""
    args = ["mnist", "platform=cpu", "batch_size=8", "steps=400",
            "checkpoint=1", "save_every=2", f"checkpoint_dir={tmp_path}",
            "step_delay_s=0.05"]
    proc = _start(PORT, args, TPU_JOB_NAME="mnist-pre")
    _read_until(proc, lambda f: f["type"] == "progress"
                and f["progress"].get("steps_done", 0) >= 2)
    proc.send_signal(signal.SIGTERM)
    code, frames, err = _finish(proc)
    assert code == 0, err[-2000:]
    done = frames[-1]
    assert done["type"] == "done" and done["cancelled"] is True
    stopped = done["progress"]["steps_done"]
    assert 2 <= stopped < 400 and stopped % 2 == 0
    saved = sorted(int(p.name) for p in (tmp_path / "default" / "mnist-pre")
                   .iterdir() if p.name.isdigit())
    assert saved[-1] == stopped

    rerun = _start(PORT, [*args[:3], f"steps={stopped + 2}", *args[4:]],
                   TPU_JOB_NAME="mnist-pre")
    code, frames, err = _finish(rerun)
    assert code == 0, err[-2000:]
    assert frames[-1]["progress"]["resumed_from_step"] == stopped
    assert frames[-1]["progress"]["steps_done"] == stopped + 2
    assert frames[-1]["cancelled"] is False


def dist_probe(ctx):
    """An entrypoint for the two-process run: all-reduces the ranks."""
    import torch.distributed as dist

    total = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(total)
    ctx.progress.update(rank=dist.get_rank(), world=dist.get_world_size(),
                        backend=dist.get_backend(), total=total)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_init_gloo_from_the_rendered_jax_env():
    """``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``,
    as ``backends/tpu.py`` renders them, set up a gloo group of two; the
    tensor in the progress is cast at the frame."""
    address = f"127.0.0.1:{_free_port()}"
    procs = [_start(PORT, ["test_torch_runner:dist_probe", "platform=cpu"],
                    JAX_COORDINATOR_ADDRESS=address, JAX_NUM_PROCESSES="2",
                    JAX_PROCESS_ID=str(rank)) for rank in (0, 1)]
    results = [_finish(p) for p in procs]
    for rank, (code, frames, err) in enumerate(results):
        assert code == 0, err[-2000:]
        progress = frames[-1]["progress"]
        assert progress == {"rank": rank, "world": 2, "backend": "gloo",
                            "total": [3.0]}


def test_world_comes_from_master_env_then_the_jax_env(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert runner._world() is None
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "w0.job.ns.svc:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    assert runner._world() == {"init_method": "tcp://w0.job.ns.svc:8476",
                               "world_size": 4, "rank": 3}
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "23456")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert runner._world() == {"init_method": "tcp://10.0.0.1:23456",
                               "world_size": 2, "rank": 1}
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert runner._world() is None


def test_params_normalise_and_args_override_env(monkeypatch):
    monkeypatch.setenv("TPU_PARAM_BATCH-SIZE", "8")
    monkeypatch.setenv("TPU_PARAM_STEPS", "5")
    assert runner._gather_params(["steps=2", "Save.Every=3", "bare"]) == {
        "batch_size": "8", "steps": "2", "save_every": "3"}


# --------------------------------------------------------------- registry


@pytest.mark.parametrize("name, fn", [
    ("gpt", "gpt"), ("bert", "bert"), ("mnist", "mnist"),
    ("resnet50", "resnet50"), ("vit", "vit"), ("generate", "generate_job")])
def test_short_names_resolve_to_the_port(name, fn):
    assert resolve_entrypoint(name) is getattr(entrypoints, fn)


def test_refs_import_and_unknown_names_raise():
    assert resolve_entrypoint(
        "cron_operator_tpu_torch.workloads.entrypoints:gpt") is entrypoints.gpt
    with pytest.raises(ValueError, match="registered: .*'generate'"):
        resolve_entrypoint("no-such-job")
    with pytest.raises(ValueError, match="no function"):
        resolve_entrypoint("cron_operator_tpu_torch.workloads.entrypoints:nope")
    probe = register_entrypoint("test-probe", lambda ctx: None)
    assert resolve_entrypoint("test-probe") is probe
    ctx = JobContext("job", "ns", {}, {})
    assert ctx.trace_id is None


def test_frames_cast_what_json_cannot_hold(capsys):
    runner._emit("progress", {"progress": {
        "loss": torch.tensor(1.5), "shape": torch.Size([2]),
        "rows": torch.arange(3)}})
    frame = _frames(capsys.readouterr().out)[0]
    assert frame == {"type": "progress", "progress": {
        "loss": 1.5, "shape": [2], "rows": [0, 1, 2]}}
