"""What holding cuDNN to its deterministic kernels changes and costs.

A conv model split over ``tensor`` steps on cuDNN's deterministic kernels
(``parallel.mesh.data_parallel`` returns ``deterministic``, the trainer
sets ``torch.backends.cudnn.deterministic`` for its steps), and what
parts a ``tensor 2`` run from one rank's. Three parts:

1. Accuracy: ``resnet50`` at full width, 224^2, b 16, SGD, built in f32
   with TF32 off (``chip_smoke.IMAGE_COMPUTE``), on two gloo ranks of one
   card (``chip_smoke.spawn_ranks``), one step at lr 0.01 and phase 15's
   three steps at lr 0.001. Legs: one rank on cuDNN's own choice (twice),
   one rank held deterministic (twice; ``chip_smoke.IMAGE_CUDNN``),
   ``tensor 2`` as the trainer runs it (deterministic), ``tensor 2`` with
   the trainer's flag off, and ``data 2``. Each pair prints the mesh
   checks' readings (``chip_smoke.mesh_readings``: the largest per-step
   loss gap and the update distance) and, for one step, the parameters
   whose updates differ most.
2. Cost: the captured step on one card as the jobs build it (bf16 over f32
   parameters, fused data; ``resnet50`` SGD at lr 0.1 at b 32, 64 and 128,
   ViT-B/16 AdamW at b 64), in turns default, deterministic, deterministic,
   default (``chip_smoke.graphed_runs``: ms a step of a replayed call of 8,
   median of 3, its device ms and the peak memory).
3. Norms: what parts ``tensor 2`` from one rank, one step at lr 0.01 as
   in part 1 (and phase 15's three steps for the plain norms): one rank
   built in f64 with plain GroupNorms (``chip_smoke.IMAGE_NORM``) as the
   truth, then one rank and ``tensor 2`` in f32, each on the GroupNorm
   kernels and on the plain norms; each against the truth and against its
   own one rank.

Prints one JSON line a reading and the card's name and power limit. Run
from the root of a checkout on a machine with a card::

    python3 hack/torch_cudnn_modes.py [--only accuracy,cost,norms]
"""

from __future__ import annotations

import contextlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch_image_mesh_sweep as sweep  # noqa: E402  (hack/, beside this)

BASE = {"batch_size": "16", "image_size": "224", "data": "host",
        "steps_per_call": "1"}
SETTINGS = ((1, "0.01"), (3, "0.001"))  # (steps, lr), f32, TF32 off
# leg: (ranks, params over the setting's)
LEGS = {"one_default": (1, {}), "one_default_again": (1, {}),
        "one_deterministic": (1, {"mode": "deterministic"}),
        "one_deterministic_again": (1, {"mode": "deterministic"}),
        "tensor2": (2, {"tensor": "2"}),
        "tensor2_default": (2, {"tensor": "2", "mode": "default"}),
        "data2": (2, {"devices": "2"})}
# (leg, its reference): what each pair tells apart
PAIRS = (("one_default_again", "one_default"),  # cuDNN's own run to run
         ("one_deterministic_again", "one_deterministic"),  # must be 0
         ("one_deterministic", "one_default"),  # the mode alone
         ("tensor2", "one_deterministic"),  # the split alone, one mode
         ("tensor2", "one_default"),  # what phase 15 read before
         ("tensor2_default", "one_default"),  # the split, cuDNN's choice
         ("data2", "one_default"))  # a sum in another order
# part 3: (steps, lr, legs, pairs); a leg's params over BASE and the
# setting's: dtype, norms ("kernels" or "plain"), ranks and strategy
NORM_SETTINGS = (
    (1, "0.01",
     {"truth": ("float64", "plain", 1, {}),
      "one_kernels": ("float32", "kernels", 1, {}),
      "one_plain": ("float32", "plain", 1, {}),
      "tensor2_kernels": ("float32", "kernels", 2, {"tensor": "2"}),
      "tensor2_plain": ("float32", "plain", 2, {"tensor": "2"})},
     (("one_kernels", "truth"), ("one_plain", "truth"),
      ("tensor2_kernels", "truth"), ("tensor2_plain", "truth"),
      ("one_plain", "one_kernels"), ("tensor2_kernels", "one_kernels"),
      ("tensor2_plain", "one_plain"))),
    (3, "0.001",
     {"one_plain": ("float32", "plain", 1, {}),
      "tensor2_plain": ("float32", "plain", 2, {"tensor": "2"})},
     (("tensor2_plain", "one_plain"),)))
COST_RUNS = (("resnet50", 32), ("resnet50", 64), ("resnet50", 128),
             ("vit", 64))
MODES = ("default", "deterministic", "deterministic", "default")


def accuracy(torch, smoke, root: str) -> None:
    for steps, lr in SETTINGS:
        params = {**BASE, "steps": str(steps), "lr": lr,
                  smoke.IMAGE_COMPUTE: "float32"}
        runs = {}
        for leg, (world, extra) in LEGS.items():
            extra = dict(extra)
            mode = extra.pop("mode", None)
            if mode:
                extra[smoke.IMAGE_CUDNN] = mode
            runs[leg] = smoke.spawn_ranks(world, {**params, **extra}, root,
                                          f"{leg}_{steps}", task="resnet50")
            print(json.dumps({"steps": steps, "lr": lr, "leg": leg,
                              "path": runs[leg][0]["path"],
                              "losses": runs[leg][0]["losses"]}), flush=True)
        for leg, ref in PAIRS:
            gap, dist = smoke.mesh_readings(torch, runs[leg], runs[ref][0],
                                            steps)
            line = {"steps": steps, "lr": lr, "leg": leg, "against": ref,
                    "loss_gap": gap, "update_distance": dist}
            if steps == 1:
                line["top"] = sweep.top_differences(
                    torch, runs[leg][0]["delta"], runs[ref][0]["delta"])
            print(json.dumps(line), flush=True)


@contextlib.contextmanager
def cudnn_mode(torch, mode: str):
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = mode == "deterministic"
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def cost(torch, smoke) -> None:
    from cron_operator_tpu_torch.models import ResNet50, ViT, ViTConfig
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    for job, b in COST_RUNS:
        if job == "resnet50":
            def make_model():
                return ResNet50(device="cuda")
            config = TrainConfig(optimizer="sgd", learning_rate=0.1)
            classes = 1000
        else:
            def make_model():
                return ViT(ViTConfig.base(), device="cuda")
            config = TrainConfig()
            classes = ViTConfig.base().num_classes
        sample = data.imagenet_sample(b, 224, classes)

        def make_trainer(mode):
            model = make_model().init_weights(
                torch.Generator(device="cuda").manual_seed(0))
            return Trainer(model, config, sample_fn=sample)

        rows, best = smoke.graphed_runs(
            torch, MODES, make_trainer, lambda mode: cudnn_mode(torch, mode))
        print(json.dumps({"job": job, "batch": b, "runs": rows,
                          "deterministic_over_default":
                          best["deterministic"]["step_ms"]
                          / best["default"]["step_ms"]}), flush=True)


def norms(torch, smoke, root: str) -> None:
    for steps, lr, legs, pairs in NORM_SETTINGS:
        runs = {}
        for leg, (dtype, norm, world, extra) in legs.items():
            params = {**BASE, "steps": str(steps), "lr": lr, **extra,
                      smoke.IMAGE_COMPUTE: dtype}
            if norm == "plain":
                params[smoke.IMAGE_NORM] = "plain"
            runs[leg] = smoke.spawn_ranks(world, params, root,
                                          f"norms_{leg}_{steps}",
                                          task="resnet50")
            print(json.dumps({"part": "norms", "steps": steps, "lr": lr,
                              "leg": leg, "path": runs[leg][0]["path"],
                              "losses": runs[leg][0]["losses"]}), flush=True)
        for leg, ref in pairs:
            gap, dist = smoke.mesh_readings(torch, runs[leg], runs[ref][0],
                                            steps)
            line = {"part": "norms", "steps": steps, "lr": lr, "leg": leg,
                    "against": ref, "loss_gap": gap,
                    "update_distance": dist}
            if steps == 1:
                line["top"] = sweep.top_differences(
                    torch, runs[leg][0]["delta"], runs[ref][0]["delta"])
            print(json.dumps(line), flush=True)


PARTS = ("accuracy", "cost", "norms")


def main() -> int:
    import torch

    import chip_smoke as smoke
    from cron_operator_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    _build.build_all()
    root = tempfile.mkdtemp(prefix="cudnn-modes-")
    parts = PARTS
    if "--only" in sys.argv:
        parts = sys.argv[sys.argv.index("--only") + 1].split(",")
    try:
        if "accuracy" in parts:
            accuracy(torch, smoke, root)
        if "cost" in parts:
            cost(torch, smoke)
        if "norms" in parts:
            norms(torch, smoke, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"card: {smoke.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
