#!/usr/bin/env python3
"""ResNet-50 MFU probe of the PyTorch port, the counterpart of
``hack/mfu_probe.py``.

It sweeps ResNet-50's batch at one image size and, for each batch, times
the port ``Trainer``'s SGD-momentum step (the ``resnet50`` job's optimizer,
lr 0.1, fused data drawn on the card inside the step) two ways:

- **chain**: one ``Trainer`` call of ``chain`` steps (on the card the
  captured step graph replayed ``chain`` times), timed by
  ``ops.microbench.timed_chain`` (span-differenced, CUDA events): the
  device's step with no per-step host work;
- **dispatch**: calls of one step (``steps_per_call=1``: the eager step),
  timed the same way: the device's step plus whatever host dispatch the
  card waits for.

MFU is ``Trainer.flops_per_step`` (``FlopCounterMode`` on the meta
device) over the step time and the card's peak (``backends/gpu.py``). With
``profile_dir=`` a ``torch.profiler`` trace of three chained calls at the
best batch is written there. A batch that fails (out of memory) records its
error and the sweep goes on.

Run on a machine with a CUDA card::

    python3 hack/torch_mfu_probe.py [batch=64,128,256] [image=224]
        [chain=5] [profile_dir=DIR]

Prints one JSON line with the keys of ``hack/mfu_probe.py``. Without a card
it exits non-zero unless ``--platform cpu`` is given; ``--check`` runs a
tiny sweep (ResNet-50 at half width, one batch of 1, image 32, a chain of
1, short spans) and fails when a batch fails or the step's FLOPs were not
counted.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# --check: a smoke of the path on the CPU, ResNet-50's depth at half its
# width (GroupNorm's 32 groups need 32 channels at the stem)
CHECK_PARAMS = {"batch": "1", "image": "32", "chain": "1"}
CHECK_SPAN_S = 0.005
CHECK_WIDTH = 32


def parse(argv, description):
    """(flags, key=value params): ``--platform``, ``--check`` and the JAX
    script's ``key=value`` params."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--platform", default=None,
                    help="cpu to run without a card (tests)")
    ap.add_argument("--check", action="store_true",
                    help="tiny sizes: a smoke of the script's path")
    args, rest = ap.parse_known_args(argv)
    params = dict(a.split("=", 1) for a in rest if "=" in a)
    return args, params


def device_for(platform):
    """The card, or the CPU when asked; None (after saying why) when there
    is no card and the CPU was not asked for."""
    from cron_operator_tpu_torch.utils.device import resolve_device

    try:
        return resolve_device(platform)
    except RuntimeError as exc:
        print(f"{os.path.basename(sys.argv[0])}: {exc}", file=sys.stderr)
        return None


def trainer_call(trainer, batches):
    """c -> c after one ``Trainer`` call of a step for each of ``batches``
    (``{}``: a step that draws its own batch, fused data), enqueued without
    a sync: a ``timed_chain`` body with ``capture=False``, since a call of
    several steps replays the trainer's own step graph. Eager PyTorch
    folds nothing away, so the carry (a loss) passes through."""
    def chain(carry):
        trainer.step(batches, sync=False)
        return carry
    return chain


def main(argv=None) -> int:
    args, params = parse(sys.argv[1:] if argv is None else argv, __doc__)
    if args.check:
        params = {**params, **CHECK_PARAMS}
    batches = [int(b) for b in params.get("batch", "64,128,256").split(",")]
    image = int(params.get("image", "224"))
    chain = int(params.get("chain", "5"))
    profile_dir = params.get("profile_dir")
    span_s = CHECK_SPAN_S if args.check else 0.5
    width = CHECK_WIDTH if args.check else 64

    import torch

    from cron_operator_tpu_torch.backends.gpu import peak_flops_per_chip
    from cron_operator_tpu_torch.models import ResNet50
    from cron_operator_tpu_torch.ops.microbench import release, timed_chain
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    device = device_for(args.platform)
    if device is None:
        return 1
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    peak = peak_flops_per_chip(kind)

    def make_trainer(batch):
        model = ResNet50(width=width, device=device).init_weights(
            torch.Generator(device=device).manual_seed(0))
        return Trainer(model, TrainConfig(optimizer="sgd", learning_rate=0.1),
                       sample_fn=data.imagenet_sample(batch, image))

    results = []
    flops_per_image = None
    for batch in batches:
        rec = {"batch": batch, "image": image}
        try:
            trainer = make_trainer(batch)
            loss = torch.zeros((), device=device)
            t0 = time.perf_counter()
            chain_t, _ = timed_chain(trainer_call(trainer, [{}] * chain), loss,
                                     iters=1, span_s=span_s, capture=False)
            rec["compile_plus_measure_s"] = round(time.perf_counter() - t0, 1)
            flops = trainer.flops_per_step()
            if flops and flops_per_image is None:
                flops_per_image = flops / batch
            if chain_t is not None:
                step_s = chain_t / chain
                rec["chain_step_ms"] = round(step_s * 1e3, 3)
                rec["chain_images_per_s"] = round(batch / step_s, 1)
                if peak and flops:
                    rec["chain_mfu"] = round(flops / step_s / peak, 4)
            else:
                rec["chain_step_ms"] = None
            disp_t, _ = timed_chain(trainer_call(trainer, [{}]), loss, iters=1,
                                    span_s=span_s, capture=False)
            if disp_t is not None:
                rec["dispatch_step_ms"] = round(disp_t * 1e3, 3)
                if peak and flops:
                    rec["dispatch_mfu"] = round(flops / disp_t / peak, 4)
            else:
                rec["dispatch_step_ms"] = None
            del trainer
        except Exception as exc:  # noqa: BLE001 -- one batch that runs out
            rec["error"] = str(exc)[-400:]  # of memory must not end the sweep
        release(device)
        results.append(rec)

    # keyed on images/s, not MFU: an unknown card has no peak, and must not
    # skip a requested trace
    best = max((r for r in results if r.get("chain_images_per_s")),
               key=lambda r: r["chain_images_per_s"], default=None)
    profile_error = None
    if profile_dir and best is not None:
        try:
            from torch.profiler import ProfilerActivity, profile

            trainer = make_trainer(best["batch"])
            call = trainer_call(trainer, [{}] * chain)
            call(None)
            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            with profile(activities=activities) as prof:
                for _ in range(3):
                    call(None)
                if on_card:
                    torch.cuda.synchronize(device)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                profile_dir, f"resnet50_b{best['batch']}.json"))
            del trainer
        except Exception as exc:  # noqa: BLE001 -- an optional trace must
            profile_error = str(exc)[-400:]  # not discard the sweep

    print(json.dumps({
        "device_kind": kind,
        "backend": "gpu" if on_card else "cpu",
        "peak_flops": peak,
        "flops_per_image": flops_per_image,
        "chain_len": chain,
        "timing": "ops.microbench.timed_chain (span-differenced; the "
                  "Trainer's call of chain_len steps, and calls of one)",
        "sweep": results,
        "best": best,
        "profile_dir": profile_dir if best else None,
        "profile_error": profile_error,
    }), flush=True)
    if args.check:
        bad = [r for r in results if r.get("error")]
        if bad or not flops_per_image:
            print(f"check failed: {bad or 'no FLOP count'}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
