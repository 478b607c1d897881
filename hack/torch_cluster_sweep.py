#!/usr/bin/env python3
"""Cluster sizes of the port's two cluster kernels, timed on one card.

Run from the root of a checkout, on a machine with an H100::

    python3 hack/torch_cluster_sweep.py [decode] [group_norm]

- ``decode``: ``ops/csrc/decode_attn.cu``'s cluster design at GPT-2 small's
  decode shape (b 8, cache 1024, 12 heads of 64, bf16) at a few cache
  positions, for each cluster size the kernel takes, beside the three-pass
  design; each size's occupancy (clusters resident at once).
- ``group_norm``: ``ops/csrc/group_norm.cu``'s cluster forward and cluster
  backward at each of ResNet-50's 12 GroupNorm shapes (b 128, bf16), for
  clusters of 1 to 16 blocks and the widest slab that fits each and half
  of it, beside each direction's two-pass design; each plan's shared
  memory and occupancy.

Each reading is the device time of one call with the card held busy
(``ops.microbench.device_ms``), and every output is checked within its
kernel's tolerance of the plain version first. One JSON line a reading,
then the card line. This is the reading behind the cluster sizes that
``ops/attention.py`` ``decode_plan`` and ``ops/group_norm.py``
``forward_plan`` and ``backward_plan`` choose; it imports nothing of JAX.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (channels, map side) of ResNet-50's GroupNorms at b 128 x 224^2
RESNET50_NORMS = ((64, 112), (64, 56), (128, 56), (256, 56), (128, 28),
                  (256, 28), (512, 28), (256, 14), (512, 14), (1024, 14),
                  (512, 7), (2048, 7))
NORM_BATCH, GROUPS, EPS = 128, 32, 1e-6
DECODE_POSITIONS = (0, 255, 575, 1023)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def sweep_decode(torch, device_ms) -> None:
    attn = importlib.import_module("cron_operator_tpu_torch.ops.attention")
    b, max_len, h, d = 8, 1024, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((b, 1, h, d), (b, max_len, h, d),
                                      (b, max_len, h, d)))
    for pos in DECODE_POSITIONS:
        p = torch.tensor([pos], device="cuda")
        ref = attn.decode_attention_reference(q, k, v, p)
        bound = attn.decode_tolerance(q, k, v, p, ref)
        row = {"pos": pos}
        for cluster in attn.DECODE_CLUSTERS:
            out = attn._launch_decode(q, k, v, p, cluster=cluster)
            if not bool(((out.float() - ref.float()).abs() <= bound).all()):
                raise SystemExit(f"decode cluster {cluster} pos {pos}: "
                                 "outside decode_tolerance")
            row[f"cluster_{cluster}_us"] = 1e3 * device_ms(
                torch, lambda: attn._launch_decode(q, k, v, p,
                                                   cluster=cluster), 20)
            row[f"cluster_{cluster}_resident"] = attn.decode_occupancy(
                q, k, cluster)
        row["three_pass_us"] = 1e3 * device_ms(
            torch, lambda: attn._launch_decode(q, k, v, p, design="fma"), 20)
        emit(kernel="decode_attn", **row)


def norm_plans(plan_at):
    """The plans to time at one shape (``plan_at(cluster=, max_slab=)``: a
    direction's plan there): for each cluster size, the widest slab that
    fits and half of it."""
    for cluster in (1, 2, 4, 8, 16):
        plan = plan_at(cluster=cluster)
        if plan["design"] != "cluster":
            continue
        yield plan
        half = plan_at(cluster=cluster, max_slab=plan["slab"] // 2)
        if half["design"] == "cluster":
            yield half


def within(label: str, got, want, bounds: dict) -> None:
    """Each output within its bound of the plain version, or exit."""
    for key, have in got.items():
        err = (have.float() - want[key].float()).abs()
        if not bool((err <= bounds[key]).all()):
            raise SystemExit(f"{label}: {key} outside group_norm_tolerance")


def sweep_forward(torch, device_ms, gn, x, gamma, beta, c: int,
                  side: int) -> None:
    """The forward at one shape: each cluster plan and the two-pass design,
    each checked against the plain version first."""
    bf16, hw = torch.bfloat16, side * side
    ry, rmean, rrstd = gn.group_norm_reference(x, gamma, beta, GROUPS, EPS,
                                               bf16)
    want = {"y": ry, "mean": rmean, "rstd": rrstd}
    bounds = gn.group_norm_tolerance(x, gamma, beta, GROUPS, rmean, rrstd, ry)
    two_pass = {"design": "two_pass"}
    row = {"c": c, "side": side,
           "plan": gn.forward_plan(NORM_BATCH, c, hw, GROUPS, bf16),
           "two_pass_us": 1e3 * device_ms(torch, lambda: gn._launch_forward(
               x, gamma, beta, GROUPS, EPS, bf16, two_pass), 20)}
    readings = []
    for plan in norm_plans(lambda **kw: gn.forward_plan(
            NORM_BATCH, c, hw, GROUPS, bf16, **kw)):
        got = gn._launch_forward(x, gamma, beta, GROUPS, EPS, bf16, plan)
        within(f"group_norm forward C{c} {side}^2 {plan}",
               dict(zip(want, got)), want, bounds)
        us = 1e3 * device_ms(torch, lambda: gn._launch_forward(
            x, gamma, beta, GROUPS, EPS, bf16, plan), 20)
        readings.append({"cluster": plan["cluster"], "slab": plan["slab"],
                         "pix": plan["pix"], "smem": plan["smem"],
                         "resident": gn.forward_occupancy(x, GROUPS, plan),
                         "us": us})
    emit(kernel="group_norm_fwd", **row, plans=readings)


def sweep_group_norm(torch, device_ms) -> None:
    gn = importlib.import_module("cron_operator_tpu_torch.ops.group_norm")
    gen = torch.Generator(device="cuda").manual_seed(20)
    bf16 = torch.bfloat16
    for c, side in RESNET50_NORMS:
        hw = side * side

        def nhwc():
            return torch.randn(NORM_BATCH, side, side, c, generator=gen,
                               device="cuda").to(bf16).permute(0, 3, 1, 2)

        x, dy = nhwc(), nhwc()
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
        sweep_forward(torch, device_ms, gn, x, gamma, beta, c, side)
        y, mean, rstd = gn.group_norm_forward(x, gamma, beta, GROUPS, EPS,
                                              bf16)
        ref = gn.group_norm_backward_reference(dy, x, mean, rstd, gamma,
                                               GROUPS)
        bounds = gn.group_norm_tolerance(x, gamma, beta, GROUPS, mean, rstd,
                                         y, dy, ref[0])
        two_pass = {"design": "two_pass"}
        row = {"c": c, "side": side, "two_pass_us": 1e3 * device_ms(
            torch, lambda: gn._launch_backward(dy, x, mean, rstd, gamma,
                                               GROUPS, two_pass), 20)}
        readings = []
        keys = ("dx", "dgamma", "dbeta")
        for plan in norm_plans(lambda **kw: gn.backward_plan(
                NORM_BATCH, c, hw, GROUPS, bf16, bf16, **kw)):
            got = gn._launch_backward(dy, x, mean, rstd, gamma, GROUPS, plan)
            within(f"group_norm C{c} {side}^2 {plan}",
                   dict(zip(keys, got)), dict(zip(keys, ref)), bounds)
            us = 1e3 * device_ms(torch, lambda: gn._launch_backward(
                dy, x, mean, rstd, gamma, GROUPS, plan), 20)
            readings.append({"cluster": plan["cluster"], "slab": plan["slab"],
                             "pix": plan["pix"], "smem": plan["smem"],
                             "resident": gn.backward_occupancy(x, GROUPS,
                                                               plan),
                             "us": us})
        emit(kernel="group_norm_bwd", **row, plans=readings)
        del x, dy, y, mean, rstd, ref, bounds
        torch.cuda.empty_cache()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from cron_operator_tpu_torch.ops.microbench import device_ms

    which = set(sys.argv[1:]) or {"decode", "group_norm"}
    if "decode" in which:
        sweep_decode(torch, device_ms)
    if "group_norm" in which:
        sweep_group_norm(torch, device_ms)
    print(f"card: {card()}", flush=True)


if __name__ == "__main__":
    main()
