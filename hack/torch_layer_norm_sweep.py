#!/usr/bin/env python3
"""The LayerNorm backward's grid, and where its time goes, on one card.

Run from the root of a checkout, on a machine with an H100::

    python3 hack/torch_layer_norm_sweep.py          # the grid sweep
    python3 hack/torch_layer_norm_sweep.py split    # the launches' split

``ops/csrc/layer_norm.cu``'s backward at GPT-2 small's ``[8192, 768]``,
BERT-base's ``[4096, 768]`` and ViT-B's ``[12608, 768]`` in bf16, at grids
of 66, 132 and 264 blocks (half, one and two an SM of an H100; the C entry
takes at most 264), each set as ``BWD_BLOCKS`` for ``backward_plan`` and
checked within ``layer_norm_tolerance`` of the plain version first. Each
reading is the device time of one call with the card held busy
(``ops.microbench.device_ms``) beside the byte bound. One JSON line a
reading, then the card line. This is the reading behind
``ops/layer_norm.py`` ``BWD_BLOCKS``; it imports nothing of JAX.

``split`` profiles the backward at GPT's and BERT's rows and the forward
at a decode step's ``[8, 768]`` (``torch.profiler``, 50 calls): each
kernel's mean device us a launch (the backward's row kernel and the second
launch that sums the partial rows of dgamma and dbeta), beside the device
time of one whole call with the card held busy; what the call takes
beyond its kernels is the gap between launches.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = {"gpt": (8192, 768), "bert": (4096, 768), "vit": (12608, 768)}
GRIDS = (66, 132, 264)
EPS = 1e-6
HBM_BYTES_PER_S = 3.35e12


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def split(torch, ln, device_ms) -> None:
    from torch.profiler import ProfilerActivity, profile

    cases = {"gpt": (8192, 768, "bwd"), "bert": (4096, 768, "bwd"),
             "decode": (8, 768, "fwd")}
    for name, (t, h, way) in cases.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        x, dy = (torch.randn(t, h, generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        gamma = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(h, generator=gen, device="cuda")
        _, mean, rstd = ln.layer_norm_forward(x, gamma, beta, EPS,
                                              torch.bfloat16)
        if way == "bwd":
            def call():
                ln.layer_norm_backward(dy, x, mean, rstd, gamma, beta)
        else:
            def call():
                ln.layer_norm_forward(x, gamma, beta, EPS, torch.bfloat16)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                call()
            torch.cuda.synchronize()
        kernels = {e.key: e.self_device_time_total / e.count
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and e.count}
        whole = device_ms(torch, call)
        print(json.dumps({
            "split": name, "rows": [t, h], "direction": way,
            "kernel_us": kernels, "call_us": whole * 1e3,
            "gap_us": whole * 1e3 - sum(kernels.values())}), flush=True)


def main() -> None:
    import torch

    from cron_operator_tpu_torch.ops.microbench import device_ms

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    ln = importlib.import_module("cron_operator_tpu_torch.ops.layer_norm")
    if sys.argv[1:2] == ["split"]:
        split(torch, ln, device_ms)
        print(f"card: {card()}")
        return
    for name, (t, h) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        x, dy = (torch.randn(t, h, generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        gamma = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(h, generator=gen, device="cuda")
        y, mean, rstd = ln.layer_norm_reference(x, gamma, beta, EPS,
                                                torch.bfloat16)
        ref = ln.layer_norm_backward_reference(dy, x, mean, rstd, gamma,
                                               beta)
        bounds = ln.layer_norm_tolerance(x, gamma, beta, mean, rstd, y, dy,
                                         ref[0], ref[1])
        moved = 3 * t * h * 2 + 2 * t * 4 + 3 * h * 4
        for grid in GRIDS:
            ln.BWD_BLOCKS = grid
            got = ln.layer_norm_backward(dy, x, mean, rstd, gamma, beta)
            ok = all(bool(((g.float() - w.float()).abs() <= b).all())
                     for g, w, b in zip(got, ref, (
                         bounds["dx"], bounds["dgamma"], bounds["dbeta"])))
            ms = device_ms(torch, lambda: ln.layer_norm_backward(
                dy, x, mean, rstd, gamma, beta))
            bound = moved / HBM_BYTES_PER_S * 1e3
            print(json.dumps({
                "shape": name, "grid": grid, "within_tolerance": ok,
                "ms": ms, "bound_ms": bound, "of_bound": bound / ms}),
                flush=True)
    print(f"card: {card()}")


if __name__ == "__main__":
    main()
