#!/usr/bin/env python3
"""End-to-end benchmark of the PyTorch port: a job's spawn to its first
train step, beside ``bench.py``, the JAX package's harness.

It prints ``bench.py``'s one JSON line::

    {"metric": "tick_to_first_train_step_s", "value": ..., "unit": "s",
     "vs_baseline": <90/value>, "extra": {...}}

The measured run is ``resnet50`` at b 128, 224², 40 steps, ``data=fused``,
``steps_per_call=5``, ``flops_accounting=1`` through the port's runner
(``python -m cron_operator_tpu_torch.workloads.runner``), spawned as the
JAX ``LocalExecutor`` spawns a job under subprocess isolation. The port
imports nothing of the JAX package, so this harness cannot start the JAX
control plane's ``CronReconciler``: the anchor is the runner's spawn, not
the tick's workload creation (``extra.anchor`` is ``"runner_spawn"``), and
the value is the run's ``first_step_at`` less the spawn, both on this
host's wall clock. The kernels are built (``ops/_build.py``) and the run is
prewarmed by one discarded run at the same shape before it. MFU is the
run's ``xla_flops_per_step`` (``Trainer.flops_per_step``) times its
steady ``steps_per_s`` over the card's peak (``backends/gpu.py``).

Legs, each a bounded subprocess on the card:

- ``attention_bench``: ``python -m cron_operator_tpu_torch.ops.microbench``
  at ``bench.py``'s shape (seq 2048, batch 4, heads 8, head_dim 64, 20
  iters);
- ``lm_bench``: BERT-base b 8 x 512 through the runner (24 steps, fused
  data, 6 steps a call, ``sync_every=24``);
- ``decode_bench``: ``generate`` (GPT-2 small) at batches 8, 16 and 32,
  prompt 64, 128 new tokens, 3 rounds, each placed against batch x the
  card's HBM rate / ``decode_read_bytes_per_step``;
- ``mfu_sweep``: ``hack/torch_mfu_probe.py`` at batches 64, 128 and 256;
- ``control_plane``: skipped (the JAX control plane's bench).

Run on a machine with a CUDA card: ``python3 hack/torch_bench.py``. There
is no CPU fallback: without a card it exits non-zero unless ``--platform
cpu`` is given, and then the card's legs are skipped. ``--check`` measures
a small ``mnist`` run instead (one spawn, no prewarm).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BASELINE_TARGET_S = 90.0  # BASELINE.json's north star, as bench.py's
STEPS, BATCH, IMAGE, STEPS_PER_CALL = 40, 128, 224, 5
MEASURED = ["resnet50", f"steps={STEPS}", f"batch_size={BATCH}",
            f"image_size={IMAGE}", f"sync_every={STEPS}", "data=fused",
            f"steps_per_call={STEPS_PER_CALL}", "flops_accounting=1"]
# one call: the warm-up step, the capture and the replays the measured run
# makes (the port replays one captured step, whatever the call's length)
PREWARM = MEASURED[:1] + [f"steps={STEPS_PER_CALL}"] + MEASURED[2:]
CHECK_RUN = ["mnist", "steps=4", "batch_size=8", "sync_every=4",
             "data=fused", "steps_per_call=2", "flops_accounting=1"]
PREWARM_TIMEOUT_S = 600.0
MEASURE_TIMEOUT_S = 240.0
ATTENTION_ARGS = ["seq=2048", "batch=4", "heads=8", "head_dim=64", "iters=20"]
DECODE_BATCHES = (8, 16, 32)


def _run(args, timeout):
    """``args`` run from the repo's root to their end or ``timeout``:
    (returncode or None on timeout, stdout, stderr, the spawn's wall
    time). A process past its time gets SIGTERM, then SIGKILL."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    spawn = time.time()
    proc = subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out, err, spawn
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        return None, out, err, spawn


def _failure(rc, out, err, timeout):
    if rc is None:
        return {"error": f"exceeded {timeout:.0f}s"}
    return {"error": f"rc={rc}: {(err or out or '').strip()[-600:]}"}


def runner_progress(job_args, timeout, platform=None):
    """A port runner subprocess (``job_args``: the entrypoint and its
    ``key=value`` params) -> ``(progress, error, spawn)``: exactly one of
    progress and error is None; spawn is the wall time it was started."""
    from cron_operator_tpu_torch.workloads.runner import PROGRESS_PREFIX

    args = [sys.executable, "-m", "cron_operator_tpu_torch.workloads.runner",
            *job_args] + ([f"platform={platform}"] if platform else [])
    rc, out, err, spawn = _run(args, timeout)
    if rc != 0:
        return None, _failure(rc, out, err, timeout), spawn
    progress = {}
    for line in out.splitlines():
        if line.startswith(PROGRESS_PREFIX):
            progress = json.loads(line[len(PROGRESS_PREFIX):]).get(
                "progress") or progress
    if not progress:
        return None, {"error": f"no progress frame: {out[-300:]}"}, spawn
    return progress, None, spawn


def _json_line(args, timeout):
    """The last line of a subprocess's stdout as JSON, or an error."""
    rc, out, err, _ = _run(args, timeout)
    if rc != 0:
        return _failure(rc, out, err, timeout)
    try:
        return json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"error": f"unparseable output: {out[-300:]}"}


def lm_bench(timeout):
    progress, err, _ = runner_progress(
        ["bert", "steps=24", "batch_size=8", "seq_len=512", "sync_every=24",
         "data=fused", "steps_per_call=6", "flops_accounting=1"], timeout)
    if err:
        return err
    if not progress.get("steps_per_s"):
        return {"error": f"no steady-state progress: {progress}"}
    return {
        "model": "bert-base", "batch_size": 8, "seq_len": 512,
        "steps_per_s": progress["steps_per_s"],
        "avg_step_time_s": progress.get("avg_step_time_s"),
        "tokens_per_s": progress.get("tokens_per_s"),
        "last_loss": progress.get("last_loss"),
    }


def decode_leg(batch, progress, hbm):
    """One batch of the decode sweep placed against the HBM roofline:
    ``batch`` tokens a step, each step reading
    ``decode_read_bytes_per_step`` at ``hbm`` bytes/s at best."""
    leg = {"batch_size": batch,
           "decode_tokens_per_s": progress["tokens_per_s"],
           "read_bytes_per_step": progress.get("decode_read_bytes_per_step")}
    if hbm and leg["read_bytes_per_step"]:
        roof = batch * hbm / leg["read_bytes_per_step"]
        leg["hbm_roofline_tokens_per_s"] = round(roof, 1)
        leg["pct_of_hbm_roofline"] = round(
            100.0 * progress["tokens_per_s"] / roof, 2)
    return leg


def decode_bench(kind, timeout):
    """``generate`` (GPT-2 small) swept over batch, each batch against the
    card's HBM roofline (``bench.py``'s ``_decode_bench``). At prompt 64
    the prefill takes the plain attention: 64 is not a multiple of the
    kernels' 128-row blocks."""
    from cron_operator_tpu_torch.backends.gpu import peak_hbm_bytes_per_s

    hbm = peak_hbm_bytes_per_s(kind)
    deadline = time.time() + timeout
    sweep = []
    for batch in DECODE_BATCHES:
        remaining = deadline - time.time()
        if remaining < 30.0:
            sweep.append({"batch_size": batch,
                          "skipped": "decode budget exhausted"})
            continue
        progress, err, _ = runner_progress(
            ["generate", "rounds=3", f"batch_size={batch}", "prompt_len=64",
             "max_new=128"], min(300.0, remaining))
        if err:
            sweep.append({"batch_size": batch, **err})
        elif not progress.get("tokens_per_s"):
            sweep.append({"batch_size": batch,
                          "error": f"no steady throughput: {progress}"})
        else:
            sweep.append(decode_leg(batch, progress, hbm))
    return {
        "model": "gpt-base", "prompt_len": 64, "max_new": 128,
        "read_bytes_model": ("the parameters once a step plus every item's "
                             "full static KV cache; entrypoints.generate_job"),
        "hbm_bytes_per_s": hbm,
        "sweep": sweep,
    }


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def emit(value, extra, error=None) -> int:
    rec = {
        "metric": "tick_to_first_train_step_s",
        "value": value,
        "unit": "s",
        "vs_baseline": round(BASELINE_TARGET_S / value, 3) if value else 0.0,
        "extra": extra,
    }
    if error:
        rec["error"] = error
    print(json.dumps(rec), flush=True)
    return 0 if value is not None else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="cpu to run without a card (tests)")
    ap.add_argument("--check", action="store_true",
                    help="measure a small mnist run, one spawn, no prewarm")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from cron_operator_tpu_torch.backends.gpu import peak_flops_per_chip

    on_card = args.platform != "cpu"
    if on_card and not torch.cuda.is_available():
        print("torch_bench.py: no CUDA device is available; pass --platform "
              "cpu to run on the CPU", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    measured = CHECK_RUN if args.check else MEASURED
    extra = {
        "model": measured[0], "params": measured[1:],
        "baseline_target_s": BASELINE_TARGET_S, "anchor": "runner_spawn",
        "platform": "gpu" if on_card else "cpu", "device_kind": kind,
        "card": card_line() if on_card else None,
    }
    platform = None if on_card else "cpu"

    if args.check:
        extra["prewarm"] = {"skipped": "--check"}
    else:
        t0 = time.time()
        if on_card:
            from cron_operator_tpu_torch.ops import _build

            _build.build_all()
        _, err, _ = runner_progress(PREWARM, PREWARM_TIMEOUT_S, platform)
        extra["prewarm"] = err or {"ok": True,
                                   "seconds": round(time.time() - t0, 1)}
        if err:
            return emit(None, extra, error=f"prewarm failed: {err['error']}")

    card_legs = not args.check and on_card
    skipped = {"skipped": "--check" if args.check else "platform cpu"}
    extra["attention_bench"] = (_json_line(
        [sys.executable, "-m", "cron_operator_tpu_torch.ops.microbench",
         *ATTENTION_ARGS], 300.0) if card_legs else skipped)
    extra["lm_bench"] = lm_bench(240.0) if card_legs else skipped
    extra["decode_bench"] = decode_bench(kind, 600.0) if card_legs else skipped
    extra["control_plane"] = {
        "skipped": "bench.py's control-plane leg runs the JAX package's "
                   "CronReconciler, which the port may not import"}

    progress, err, spawn = runner_progress(measured, MEASURE_TIMEOUT_S,
                                           platform)
    if err:
        return emit(None, extra, error=f"measured run failed: {err['error']}")
    if not progress.get("first_step_at"):
        return emit(None, extra, error=f"no first step: {progress}")
    latency = progress["first_step_at"] - spawn
    steps_per_s = progress.get("steps_per_s")
    flops = progress.get("xla_flops_per_step")
    peak = peak_flops_per_chip(kind)
    batch = int(next(a for a in measured if a.startswith("batch_size="))
                .split("=")[1])
    extra.update({
        "first_step_latency_s": progress.get("first_step_latency_s"),
        "compile_time_s": progress.get("compile_time_s"),
        "steps_per_s": steps_per_s,
        "avg_step_time_s": progress.get("avg_step_time_s"),
        "images_per_s": round(batch * steps_per_s, 2) if steps_per_s else None,
        "xla_flops_per_step": flops,
        "mfu": (round(flops * steps_per_s / peak, 4)
                if flops and steps_per_s and peak else None),
        "last_loss": progress.get("last_loss"),
    })
    extra["mfu_sweep"] = (_json_line(
        [sys.executable, os.path.join(ROOT, "hack", "torch_mfu_probe.py"),
         "batch=64,128,256", "chain=5"], 450.0) if card_legs else skipped)
    return emit(round(latency, 6), extra)


if __name__ == "__main__":
    sys.exit(main())
