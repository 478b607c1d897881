"""How far the first-step gradient of a ResNet-50 under ``tensor 2`` and
under ``data 2`` reads from one process's, on the CPU with the plain ops.

The model is ResNet-50's full depth and width (stages 3, 4, 6, 3 of
bottleneck blocks, width 64) in f32 with 10 classes, seeded weights, and
``data.imagenet_batches`` at b 2 (``--batch``) and ``--size`` pixels a
side. Two gloo worlds of two rank processes (``tests/torch_mesh_ranks.py``,
the CPU tests' harness) take one SGD step at lr 0.01; the script takes the
same step in this process and prints, for each world, its first loss
beside this process's, the gradient distance |g - g_one| / |g_one| over
every parameter and the five parameters whose gradients differ most.

Run from the root of a checkout (no card needed; a few GB of memory)::

    python3 hack/torch_resnet_split_cpu.py --size 112
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=112)
    parser.add_argument("--batch", type=int, default=2)
    args = parser.parse_args()

    import torch
    from torch_mesh_ranks import (
        _batches,
        _config,
        image_model,
        start_world,
        wait_world,
    )

    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    cfg = {"stages": [3, 4, 6, 3], "width": 64, "image_size": args.size}
    train = {"optimizer": "sgd", "learning_rate": 0.01}
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory(prefix="resnet-split-") as tmp:
        out = Path(tmp)
        net = image_model("resnet", cfg).init_weights(
            torch.Generator().manual_seed(0))
        torch.save(net.state_dict(), out / "weights.pt")
        base = {"kind": "data_parallel", "model": "resnet", "cfg": cfg,
                "stream": "imagenet_batches", "batch": args.batch,
                "weights": str(out / "weights.pt"), "steps": 1, "chunk": 1,
                "train": train}
        legs = {"tensor2": {"tensor": 2}, "data2": {}}  # {}: data over all
        procs = start_world(2, [{**base, "name": n, "axes": a}
                                for n, a in legs.items()], out)
        trainer = Trainer(net, TrainConfig(steps_per_call=1,
                                           stage_async=False, **train))
        loss = trainer.run(_batches(base, _config(base)), 1)[0].loss
        one = {n: p.grad.double() for n, p in net.named_parameters()}
        wait_world(procs, timeout=900)
        for name in legs:
            got = torch.load(out / f"{name}.rank0.pt", weights_only=False)
            grads = {n: g.double() for n, g in got["grads"].items()}
            num = sum(float((grads[n] - one[n]).square().sum()) for n in one)
            den = sum(float(one[n].square().sum()) for n in one)
            top = sorted(((float((grads[n] - one[n]).norm() / one[n].norm()),
                           n) for n in one), reverse=True)[:5]
            print(json.dumps({"leg": name, "size": args.size,
                              "batch": args.batch,
                              "loss": got["losses"][0], "one_loss": loss,
                              "grad_distance": (num / den) ** 0.5,
                              "top": [{"param": n, "relative": r}
                                      for r, n in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
