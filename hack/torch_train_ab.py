#!/usr/bin/env python3
"""Training-step times of the PyTorch port, compared between checkouts on one
card.

Run on a machine with a CUDA card::

    python3 hack/torch_train_ab.py [--moe] ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout of the repo (``.`` for this one). Every
ROOT given is measured in a process of its own that imports
``cron_operator_tpu_torch`` from that root only, in the order given: list
them as A B B A so that a drift of the host or the card falls on both. Each
process builds its root's kernels (not timed) and then measures the training
slice of ``chip_smoke.py`` (GPT-2 small, seed-0 f32 weights, bf16 compute,
AdamW, one batch of 8 x 1024 tokens drawn on the card; with ``--moe`` every
second block's FFN is a Switch-MoE layer of 8 experts, as ``chip_smoke.py``'s
MoE phase trains it):

- ``step_ms``: one step (``Trainer.step(sync=False)``), CUDA events over 5
  back-to-back steps, as ``chip_smoke.py`` times it;
- ``device_ms``: the card's busy time in one step, the sum of its kernels'
  device times under ``torch.profiler`` over 3 steps, divided by 3 (a step
  enqueues some 1,500 kernels, more than the card's launch queue holds, so
  holding the card busy does not keep the host's time out of event times);
- ``dispatch_ms``: the host's time to enqueue one step (``StepStats``'s
  ``dispatch_s``), over the steps that ``step_ms`` times;
- ``k2_ms``: the card's time for one ``flash_attention_dq`` call at the
  step's attention shape (b 8, s 1024, h 12, d 64, causal, bf16): CUDA
  events over 20 calls enqueued while ``torch.cuda._sleep`` holds the card
  busy, so that the host's enqueue time is not counted;
- ``tokens_per_s``: ``gpt``'s own figure (10 steps, steps 2-10).

``step_ms``, ``dispatch_ms`` and ``k2_ms`` are medians over their
repetitions, whose minimum and maximum are printed too. Each process prints
one JSON line; the last line holds, per root, the median of every metric
over that root's processes.
"""

from __future__ import annotations

import os
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_serving_ab import REPS, compare, microbench  # noqa: E402

B, S, H, D = 8, 1024, 12, 64
PARAMS = {"size": "base", "batch_size": str(B), "seq_len": str(S),
          "steps": "10"}
MOE = {"moe_every": "2", "num_experts": "8"}
MOE_ENV = "TORCH_TRAIN_AB_MOE"  # set by --moe for the measuring processes
METRICS = ("step_ms", "device_ms", "dispatch_ms", "k2_ms", "tokens_per_s")


def _device_busy_ms(torch, fn, iters: int = 3) -> float:
    """The card's busy time per call of ``fn``: its kernels' device times
    under ``torch.profiler`` over ``iters`` calls, summed, over ``iters``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # a record_function range (the optimizer's step) also carries the device
    # time of the kernels inside it: leave it out of the sum
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA"
                  and not getattr(e, "is_user_annotation", False))
    return busy_us / 1e3 / iters


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import importlib

    import torch

    import cron_operator_tpu_torch
    from cron_operator_tpu_torch.backends.registry import JobContext
    from cron_operator_tpu_torch.models import GPT, GPTConfig
    from cron_operator_tpu_torch.ops import _build
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.entrypoints import gpt
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    event_ms = microbench().event_ms
    pkg_root = Path(cron_operator_tpu_torch.__file__).resolve().parents[1]
    if pkg_root != root:
        raise SystemExit(f"imported the port from {pkg_root}, not {root}")
    # the module, not the function of the same name that ops/__init__ exports
    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
    _build.build_all()

    moe = MOE if os.environ.get(MOE_ENV) == "1" else {}
    out = {"root": str(root), **moe}
    cfg = GPTConfig(max_len=S, **{k: int(v) for k, v in moe.items()})
    model = GPT(cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(0))
    trainer = Trainer(model, TrainConfig(aux_loss_in_output=bool(moe)))
    batch = next(data.device_causal_token_batches(B, S, cfg.vocab_size,
                                                  device="cuda"))
    dispatch = []

    def step():
        dispatch.append(trainer.step(batch, sync=False).dispatch_s * 1e3)

    series = {"step_ms": event_ms(torch, step, 5, REPS)}
    series["dispatch_ms"] = dispatch[-5 * REPS:]
    out["device_ms"] = _device_busy_ms(torch, step)
    del model, trainer, batch
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn(B, S, 3, H, D, generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(B, S, H, D, generator=gen,
                     device="cuda").to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa._delta(o, do)
    series["k2_ms"] = event_ms(
        torch, lambda: fa.flash_attention_dq(q, k, v, do, lse, delta,
                                             causal=True), 20, REPS,
        held=True)
    for name, values in series.items():
        out[name] = statistics.median(values)
        out[name + "_min_max"] = [min(values), max(values)]
    del qkv, q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()

    ctx = JobContext("train-ab", "default", {}, {**PARAMS, **moe})
    gpt(ctx)
    out["tokens_per_s"] = ctx.progress["tokens_per_s"]
    return out


def main(argv) -> int:
    if "--moe" in argv:
        os.environ[MOE_ENV] = "1"
        argv = [a for a in argv if a != "--moe"]
    return compare(argv, Path(__file__).resolve(), measure, METRICS, __doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
