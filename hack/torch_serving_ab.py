#!/usr/bin/env python3
"""Serving times of the PyTorch port, compared between checkouts on one card.

Run on a machine with a CUDA card::

    python3 hack/torch_serving_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout of the repo (``.`` for this one). Every
ROOT given is measured in a process of its own that imports
``cron_operator_tpu_torch`` from that root only, in the order given: list
them as A B B A so that a drift of the host or the card falls on both. Each
process builds its root's kernels (not timed) and then measures the serving
slice of ``chip_smoke.py`` (GPT-2 small, seed-0 bf16 weights, 8 prompts of
512 tokens):

- ``prefill_ms``: one prefill, CUDA events over 3 back-to-back calls;
- ``decode_ms``: one decode step at cache position 512, over 20 calls;
- ``k1_host_us``: the host's time to enqueue one ``flash_attention_fwd``
  call at the prefill's attention shape (the strided ``qkv[:, :, i]``
  views), over 200 calls;
- ``first_round_ms``: the first graphed ``generate`` of the model (8
  prompts of 512, 64 new tokens, greedy), its captures included, wall
  time with the card synchronised;
- ``round_ms``: the median of the 3 graphed rounds after it;
- ``decode_device_ms``: the device time of one replayed decode step at
  cache position 512, the card held busy (``device_ms``);
- ``tokens_per_s``: ``generate_job``'s own figure (3 rounds, rounds 2-3).

The first three are medians over 9 repetitions; their minimum and maximum
are printed too. Each process prints one JSON line; the last line holds,
per root, the median of every metric over that root's processes.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPS = 9
PARAMS = {
    "size": "base", "seq_len": "1024", "batch_size": "8", "prompt_len": "512",
    "max_new": "64", "rounds": "3", "temperature": "0", "seed": "0",
}
METRICS = ("prefill_ms", "decode_ms", "k1_host_us", "first_round_ms",
           "round_ms", "decode_device_ms", "tokens_per_s")


def microbench():
    """This checkout's ``cron_operator_tpu_torch/ops/microbench.py``, loaded
    by path: its timers time every root measured, whichever port a root
    holds (the module imports nothing of the port at module level)."""
    path = (Path(__file__).resolve().parents[1] / "cron_operator_tpu_torch"
            / "ops" / "microbench.py")
    spec = importlib.util.spec_from_file_location("ab_microbench", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _host_us(torch, fn, iters: int = 200):
    """Per-call host time to enqueue ``iters`` calls, REPS times."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return times


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import importlib

    import torch

    import cron_operator_tpu_torch
    from cron_operator_tpu_torch.backends.registry import JobContext
    from cron_operator_tpu_torch.models import GPT, GPTConfig
    from cron_operator_tpu_torch.ops import _build
    from cron_operator_tpu_torch.workloads.entrypoints import generate_job
    from cron_operator_tpu_torch.workloads.generate import generate

    bench = microbench()
    event_ms = bench.event_ms
    pkg_root = Path(cron_operator_tpu_torch.__file__).resolve().parents[1]
    if pkg_root != root:
        raise SystemExit(f"imported the port from {pkg_root}, not {root}")
    # the module, not the function of the same name that ops/__init__ exports
    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
    serving = importlib.import_module(
        "cron_operator_tpu_torch.workloads.generate")
    _build.build_all()

    out = {"root": str(root)}
    cfg = GPTConfig(max_len=1024)
    model = GPT(cfg, device="cuda", param_dtype=cfg.dtype)
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        cache = model.new_cache(8)
        series = {"prefill_ms": event_ms(
            torch, lambda: model.prefill(prompt, cache), 3, REPS)}
        token = prompt[:, -1:]

        def decode_step():
            # every timed step decodes at one position (the position is a
            # device tensor since the decode step became capturable)
            if torch.is_tensor(cache.pos):
                cache.pos.fill_(512)
            else:
                cache.pos = 512
            model.decode(token, cache)

        series["decode_ms"] = event_ms(torch, decode_step, 20, REPS)
    qkv = torch.randn(8, 512, 3, 12, 64, generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    series["k1_host_us"] = _host_us(
        torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    for name, values in series.items():
        out[name] = statistics.median(values)
        out[name + "_min_max"] = [min(values), max(values)]
    rounds = []
    with torch.inference_mode():
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(cfg, model, prompt, 64)
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) * 1e3)
    out["first_round_ms"] = rounds[0]
    out["round_ms"] = statistics.median(rounds[1:])
    decoder = serving._decoder(model, 8, True, None)

    def replay():
        decoder.cache.pos.fill_(512)
        decoder.step({"token": token})

    with torch.inference_mode():
        out["decode_device_ms"] = bench.device_ms(torch, replay, 20, REPS)
    del model, cache, qkv, q, k, v
    torch.cuda.empty_cache()

    ctx = JobContext("serving-ab", "default", {}, dict(PARAMS))
    generate_job(ctx)
    out["tokens_per_s"] = ctx.progress["tokens_per_s"]
    return out


def compare(argv, script: Path, measure, metrics, doc: str) -> int:
    """``script``'s command line: ``--measure ROOT`` measures one root in
    this process with ``measure``; a list of roots runs ``script`` once for
    each, in order, each in its own process, and prints every process's
    JSON line, then per root the median of every metric in ``metrics``."""
    if len(argv) >= 2 and argv[0] == "--measure":
        print(json.dumps(measure(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(doc, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        root = Path(root).resolve()
        proc = subprocess.run(
            [sys.executable, str(script), "--measure", str(root)],
            cwd=root, capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    summary = {}
    for run in runs:
        summary.setdefault(run["root"], []).append(run)
    print(json.dumps({root: {m: statistics.median(r[m] for r in rs)
                             for m in metrics}
                      for root, rs in summary.items()}))
    return 0


def main(argv) -> int:
    return compare(argv, Path(__file__).resolve(), measure, METRICS, __doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
