#!/usr/bin/env python3
"""Device times of the flash-attention kernels K1, K2 and K3, compared
between checkouts on one card.

Run on a machine with a CUDA card::

    python3 hack/torch_flash_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout of the repo (``.`` for this one). Every
ROOT given is measured in a process of its own that imports
``cron_operator_tpu_torch`` from that root only, in the order given: list
them as A B B A so that a drift of the host or the card falls on both. Each
process builds its root's kernels (not timed) and then times one call of
``flash_attention_fwd`` (K1), ``flash_attention_dq`` (K2) and
``flash_attention_dkv`` (K3) in bf16 at the attention shapes of
``chip_smoke.py``'s training jobs, q, k and v the strided views of one fused
projection as the models pass them:

- ``gpt``: b 8, s 1024, h 12, d 64, causal;
- ``bert``: b 8, s 512, h 12, d 64;
- ``vit``: b 64, s 197, h 12, d 64, a length no kernel tile divides (NaN for
  a root whose kernels refuse it).

Each time is the median over 9 repetitions of CUDA events over 50 calls
enqueued while ``torch.cuda._sleep`` holds the card busy (this checkout's
``ops/microbench.py`` ``event_ms``), so that the host's enqueue time is not
counted. Each process prints one JSON line; the last line holds, per root,
the median of every metric over that root's processes.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_serving_ab import REPS, compare, microbench  # noqa: E402

SHAPES = {"gpt": (8, 1024, 12, 64, True), "bert": (8, 512, 12, 64, False),
          "vit": (64, 197, 12, 64, False)}
METRICS = tuple(f"{name}_{k}_ms" for name in SHAPES
                for k in ("k1", "k2", "k3"))


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import importlib

    import torch

    import cron_operator_tpu_torch
    from cron_operator_tpu_torch.ops import _build

    event_ms = microbench().event_ms
    pkg_root = Path(cron_operator_tpu_torch.__file__).resolve().parents[1]
    if pkg_root != root:
        raise SystemExit(f"imported the port from {pkg_root}, not {root}")
    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
    _build.build_all()

    out = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    for name, (b, s, h, d, causal) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(4)
        qkv = torch.randn(b, s, 3, h, d, generator=gen,
                          device="cuda").to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        do = torch.randn(b, s, h, d, generator=gen,
                         device="cuda").to(torch.bfloat16)

        def k1():  # one block of the whole sequence meets the block rule
            return fa.flash_attention_fwd(q, k, v, causal=causal, block_q=s,
                                          block_k=s)

        try:
            o, lse = k1()
        except ValueError:  # a root whose kernels refuse this length
            out.update({f"{name}_{x}_ms": float("nan")
                        for x in ("k1", "k2", "k3")})
            continue
        delta = fa._delta(o, do)
        calls = {
            "k1": k1,
            "k2": lambda: fa.flash_attention_dq(q, k, v, do, lse, delta,
                                                causal=causal),
            "k3": lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta,
                                                 causal=causal),
        }
        for key, fn in calls.items():
            times = event_ms(torch, fn, 50, REPS, held=True)
            out[f"{name}_{key}_ms"] = statistics.median(times)
            out[f"{name}_{key}_ms_min_max"] = [min(times), max(times)]
        del qkv, q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    return compare(argv, Path(__file__).resolve(), measure, METRICS, __doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
