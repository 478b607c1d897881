"""How far ``resnet50`` on two ranks reads from one rank with no fault at
all: the mesh checks' readings (``chip_smoke.mesh_readings``: the largest
per-step loss gap and the update distance) of ``tensor 2`` and of ``data
2``, which splits no parameter and only sums in another order, against a
one-rank run of the same batches, at full width, 224^2, b 16, SGD, on two
gloo ranks of one card (``chip_smoke.spawn_ranks``).

Settings, each a one-rank run then the two-rank legs:

- three steps in bf16 at the job's lr 0.1 and at 0.01, and in f32 with
  TF32 off (``chip_smoke.IMAGE_COMPUTE``) at 0.01 and at 0.001, the last
  with its lr-0 reading (phase 15's setting);
- one step in bf16 and in f32: the update distance is then the first
  gradient's, and the parameters whose updates differ most are listed
  (each one's relative distance and its share of the update).

Prints one JSON line a leg and the card's name and power limit. Run from
the root of a checkout on a machine with a card::

    python3 hack/torch_image_mesh_sweep.py
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BASE = {"batch_size": "16", "image_size": "224", "data": "host",
        "steps_per_call": "1"}
# (steps, compute, lr, legs)
SETTINGS = ((3, "bfloat16", "0.1", ("tensor", "data")),
            (3, "bfloat16", "0.01", ("tensor", "data")),
            (3, "float32", "0.01", ("tensor",)),
            (3, "float32", "0.001", ("tensor", "data", "lr0")),
            (1, "bfloat16", "0.01", ("tensor", "data")),
            (1, "float32", "0.01", ("tensor", "data")))
LEG_PARAMS = {"tensor": {"tensor": "2"}, "data": {"devices": "2"}}
TOP = 8  # parameters listed a one-step leg


def top_differences(torch, delta: str, ref_delta: str) -> list:
    """The parameters whose change differs most from the reference's:
    each one's |d - d_ref| / |d_ref| and its share of |d_ref|^2."""
    a = torch.load(delta, weights_only=True)
    b = torch.load(ref_delta, weights_only=True)
    den = sum(float(b[n].double().square().sum()) for n in b)
    rows = []
    for n in b:
        num = float((a[n].double() - b[n].double()).square().sum())
        ref = float(b[n].double().square().sum())
        rows.append((num, n, (num / max(ref, 1e-30)) ** 0.5, ref / den))
    rows.sort(reverse=True)
    return [{"param": n, "relative": round(r, 4), "share": round(w, 4)}
            for _, n, r, w in rows[:TOP]]


def main() -> int:
    import torch

    import chip_smoke as smoke
    from cron_operator_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    _build.build_all()
    root = tempfile.mkdtemp(prefix="image-mesh-sweep-")
    try:
        for steps, compute, lr, legs in SETTINGS:
            params = {**BASE, "steps": str(steps), "lr": lr}
            if compute == "float32":
                params[smoke.IMAGE_COMPUTE] = compute
            tag = f"{steps}_{compute}_{lr}"
            (ref,) = smoke.spawn_ranks(1, params, root, f"ref_{tag}",
                                       task="resnet50")
            print(json.dumps({"steps": steps, "compute": compute, "lr": lr,
                              "leg": "one rank", "losses": ref["losses"]}),
                  flush=True)
            for leg in legs:
                if leg == "lr0":
                    (run,) = smoke.spawn_ranks(1, {**params, "lr": "0"},
                                               root, f"lr0_{tag}",
                                               task="resnet50")
                    runs = [run]
                else:
                    runs = smoke.spawn_ranks(
                        2, {**params, **LEG_PARAMS[leg]}, root,
                        f"{leg}_{tag}", task="resnet50")
                gap, dist = smoke.mesh_readings(torch, runs, ref, steps)
                line = {"steps": steps, "compute": compute, "lr": lr,
                        "leg": leg, "path": runs[0]["path"],
                        "losses": runs[0]["losses"], "loss_gap": gap,
                        "update_distance": dist}
                if steps == 1 and leg != "lr0":
                    line["top"] = top_differences(torch, runs[0]["delta"],
                                                  ref["delta"])
                print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"card: {smoke.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
