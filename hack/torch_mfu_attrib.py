#!/usr/bin/env python3
"""ResNet-50 step-time attribution of the PyTorch port, the counterpart of
``hack/mfu_attrib.py``.

It times the parts of the ``resnet50`` job's step apart, each through
``ops.microbench.timed_chain`` (span-differenced; CUDA events on the card):

- ``rng``: the synthetic batch alone, ``[b, image, image, 3]`` normals and
  int labels drawn on the card from a ``torch.Generator`` (a captured
  chain, the generator registered with its graph);
- ``rng_rbg``: null. JAX's rbg PRNG has no counterpart in torch on CUDA;
- ``fwd``: the forward pass and the loss on a fixed batch, no gradient (a
  captured chain);
- ``fwdbwd``: forward, backward and the SGD-momentum update on a fixed
  batch: a ``Trainer`` call of ``chain`` steps (the step graph replayed);
- ``fwdbwd_nonorm``: the same with every GroupNorm replaced by a learned
  scalar scale, so that the difference to ``fwdbwd`` is GroupNorm's share
  of the step (``groupnorm_share``);
- ``step``: the whole step as the job runs it, fused data drawn inside the
  step: a ``Trainer`` call of ``chain`` steps.

``xla_fwd_flops_per_image`` (the JAX script's key) is the forward's FLOPs
per image from ``FlopCounterMode``, in place of XLA's cost analysis: a
check of the MFU denominator.

Run on a machine with a CUDA card::

    python3 hack/torch_mfu_attrib.py [batch=128] [image=224] [chain=5]

Prints one JSON line. Without a card it exits non-zero unless ``--platform
cpu`` is given; ``--check`` runs ResNet-50 at half width, batch 1, image
32, a chain of 1 and short spans.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mfu_probe import (  # noqa: E402
    CHECK_PARAMS,
    CHECK_SPAN_S,
    CHECK_WIDTH,
    device_for,
    parse,
    trainer_call,
)


def main(argv=None) -> int:
    args, params = parse(sys.argv[1:] if argv is None else argv, __doc__)
    if args.check:
        params = {**params, **CHECK_PARAMS}
    batch = int(params.get("batch", "128"))
    image = int(params.get("image", "224"))
    chain = int(params.get("chain", "5"))
    span_s = CHECK_SPAN_S if args.check else 0.5
    width = CHECK_WIDTH if args.check else 64

    import json

    import torch
    from torch import nn
    from torch.utils.flop_counter import FlopCounterMode

    from cron_operator_tpu_torch.models import ResNet50
    from cron_operator_tpu_torch.models.layers import GroupNorm
    from cron_operator_tpu_torch.ops.microbench import release, timed_chain
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import (
        TrainConfig,
        Trainer,
        cross_entropy_loss,
    )

    device = device_for(args.platform)
    if device is None:
        return 1
    on_card = device.type == "cuda"

    class Scale(nn.Module):
        """GroupNorm's stand-in: a learned scalar scale, no reduction (the
        JAX script's ``_Identity``), so every layer keeps a parameter; the
        residual add and the relu that the norm's epilogue takes follow as
        torch ops."""

        def __init__(self, compute_dtype):
            super().__init__()
            self.scale = nn.Parameter(torch.ones(1, device=device))
            self.compute_dtype = compute_dtype

        def forward(self, x, residual=None, relu=False):
            y = x * self.scale.to(self.compute_dtype)
            if residual is not None:
                y = residual + y
            return torch.relu(y) if relu else y

    def without_norms(module):
        for name, child in module.named_children():
            if isinstance(child, GroupNorm):
                setattr(module, name, Scale(child.compute_dtype))
            else:
                without_norms(child)
        return module

    def model():
        return ResNet50(width=width, device=device).init_weights(
            torch.Generator(device=device).manual_seed(0))

    def timed(body, carry, **kw):
        t, _ = timed_chain(body, carry, iters=chain, span_s=span_s, **kw)
        release(device)
        return round(t * 1e3, 4) if t else None

    def trainer(m, **kw):
        return Trainer(m, TrainConfig(optimizer="sgd", learning_rate=0.1), **kw)

    sample = data.imagenet_sample(batch, image)
    zero = torch.zeros((), device=device)
    out = {"batch": batch, "image": image, "chain": chain,
           "device_kind": (torch.cuda.get_device_name(device) if on_card
                           else "cpu")}

    gen = torch.Generator(device=device).manual_seed(0)

    def rng_body(acc):
        b = sample(gen)
        # the draws reach the carry, as in the JAX script
        return acc + b["x"].mean() + b["y"].sum().float()

    out["rng_ms"] = timed(rng_body, zero, generators=(gen,))
    out["rng_rbg_ms"] = None
    out["rng_rbg_note"] = ("torch has no counterpart of JAX's rbg PRNG on "
                           "CUDA")

    fixed = sample(torch.Generator(device=device).manual_seed(3))
    m = model()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        m(fixed["x"])
    out["xla_fwd_flops_per_image"] = round(
        counter.get_total_flops() / batch / 1e9, 2)

    def fwd_body(acc):
        with torch.no_grad():
            return acc + cross_entropy_loss(m(fixed["x"]), fixed["y"])

    out["fwd_ms"] = timed(fwd_body, zero)

    # a Trainer call of `chain` steps: one replay of its step graph a step
    # on the card, so timed_chain runs it eagerly (capture=False), iters 1
    def per_step(tr, batches):
        t, _ = timed_chain(trainer_call(tr, batches), zero, iters=1,
                           span_s=span_s, capture=False)
        release(device)
        return round(t / chain * 1e3, 4) if t else None

    out["fwdbwd_ms"] = per_step(trainer(m), [fixed] * chain)
    del m
    release(device)
    out["fwdbwd_nonorm_ms"] = per_step(trainer(without_norms(model())),
                                       [fixed] * chain)
    out["step_ms"] = per_step(trainer(model(), sample_fn=sample),
                              [{}] * chain)
    if out["fwdbwd_ms"] and out["fwdbwd_nonorm_ms"]:
        out["groupnorm_share"] = round(
            1 - out["fwdbwd_nonorm_ms"] / out["fwdbwd_ms"], 4)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
