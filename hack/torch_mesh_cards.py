#!/usr/bin/env python3
"""The port's training over a device mesh of one rank per card, on a machine
with several cards.

Run from the root of a checkout::

    python3 hack/torch_mesh_cards.py [N] [--profile NAME]

``N`` (default: every visible card; 2 or 4) ranks, one per card, join an
NCCL process group and each call the port's ``gpt`` entrypoint on
``chip_smoke.MESH_PARAMS`` (GPT-2 small widths, b 8 x 1024 global, bf16
over f32 parameters, AdamW, ``data=host``, ``steps_per_call=1``, 3 steps)
under each strategy of ``STRATEGIES[N]``. The ranks, the one-rank
references, the frozen reading and every check are ``chip_smoke.py``'s
mesh phase's (``spawn_ranks``, ``mesh_references``, ``frozen_reading``,
``mesh_problems``): every rank launches K1, K2 and K3 36 times, all sm90, at
the strategy's local (batch, heads), reports the same losses, and holds the
loss gap and the update distance against one rank's run within
``MESH_LOSS_BOUND`` and ``MESH_UPDATE_BOUND``. ``--profile NAME`` runs one
more step of strategy NAME under ``torch.profiler`` on every rank and
prints rank 0's busy share and top kernels. It prints one JSON line per
run (the losses, both readings, the step ms of steps 2-3 and the mesh's
tokens/s, as the entrypoint publishes them) and the card line, and exits
non-zero on a failure. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MOE = {"moe_every": "2", "num_experts": "8"}
STRATEGIES = {
    # N: {name: (params, local (batch, heads))}
    4: {"data4": ({"devices": "4"}, (2, 12)),
        "fsdp4": ({"fsdp": "4"}, (2, 12)),
        "fsdp2_tensor2": ({"fsdp": "2", "tensor": "2"}, (4, 6)),
        "data2_expert2": ({**MOE, "expert": "2"}, (4, 12))},
    2: {"data2": ({"devices": "2"}, (4, 12)),
        "fsdp2": ({"fsdp": "2"}, (4, 12)),
        "tensor2": ({"tensor": "2"}, (8, 6)),
        "expert2": ({**MOE, "expert": "2"}, (8, 12))},
}


def main(argv) -> int:
    import torch

    import chip_smoke as smoke
    from cron_operator_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        sys.exit("needs CUDA cards")
    profiled = argv[argv.index("--profile") + 1] if "--profile" in argv else None
    args = [a for a in argv if a not in ("--profile", profiled)]
    n = int(args[0]) if args else torch.cuda.device_count()
    if n not in STRATEGIES or n > torch.cuda.device_count():
        sys.exit(f"needs 2 or 4 visible cards, asked for {n} of "
                 f"{torch.cuda.device_count()}")
    _build.build_all()  # once, before the ranks load the libraries
    card = smoke.card_line()
    failed = False
    root = tempfile.mkdtemp(prefix="mesh-cards-")
    try:
        refs = smoke.mesh_references(STRATEGIES[n], root)
        for kind, ref in refs.items():
            print(json.dumps({"run": f"one rank ({kind})",
                              "losses": ref["losses"],
                              "step_ms": ref["step_s"] * 1e3,
                              "tokens_per_s": ref["tokens_per_s"]}),
                  flush=True)
        print(json.dumps({"run": "one rank at lr 0 (frozen)",
                          **smoke.frozen_reading(torch, refs, root)}),
              flush=True)
        for name, (extra, local) in STRATEGIES[n].items():
            ranks = smoke.spawn_ranks(
                n, {**smoke.MESH_PARAMS, **extra}, root, name,
                backend="nccl", cards=n, profile=name == profiled)
            ref = refs["moe" if "moe_every" in extra else "dense"]
            problems, readings = smoke.mesh_problems(torch, ranks, ref, local)
            failed |= bool(problems)
            print(json.dumps({
                "run": name, "cards": n, "params": extra,
                "local_batch_heads": local,
                "launches_per_rank": ranks[0]["counts"],
                "losses": ranks[0]["losses"], **readings,
                "step_ms": ranks[0]["step_s"] * 1e3,
                "tokens_per_s": ranks[0]["tokens_per_s"],
                "problems": problems}), flush=True)
            if "profile" in ranks[0]:
                print(f"{name}, rank 0 of {n}:\n{ranks[0]['profile']}",
                      flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"card: {card}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
