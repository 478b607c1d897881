#!/usr/bin/env python3
"""How many eager steps a meshed step needs before its CUDA graph capture
over NCCL, on the installed torch.

Run from the root of a checkout on a machine with a CUDA card::

    python3 hack/torch_graph_warmup_probe.py [--paths ddp,fsdp]
                                             [--warmups 1,2,3,11]

For each path and each warm-up count W it starts one process: a one-rank
NCCL process group on ``cuda:0`` and the port's ``Trainer`` over a one-rank
mesh (``ddp``: a ``data`` axis, ``DistributedDataParallel``; ``fsdp``: a
mesh that names ``fsdp``, FSDP2) with ``train.MESH_GRAPH_WARMUP`` set to W,
GPT-2 small widths at b 2 x 256 (seed 0, the numpy ``causal_token_batches``),
W + 8 steps in calls of 4, so the step graph is captured after W eager
steps and replayed; then the same steps eagerly (calls of one step). It
prints one JSON line per run: whether the run ended, the end of its error
when it did not, the replays, and whether the losses and every parameter
equal the eager run's to the bit; then the least W that passed for each
path, and the card line. Each run is a process of its own, since a failed
capture can leave the card's context unusable. It imports nothing of JAX
and exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPE = {"batch": 2, "seq": 256}
CHUNK = 4
AXES = {"ddp": {"data": 1}, "fsdp": {"data": 1, "fsdp": 1}}


def one_run(path: str, warmup: int, port: int, out: str) -> None:
    """One process: the graphed run and the eager run of ``path`` at
    ``warmup``, their comparison written to ``out``."""
    os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    import torch
    import torch.distributed as dist

    from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
    from cron_operator_tpu_torch.parallel.mesh import MeshPlan, make_mesh
    from cron_operator_tpu_torch.workloads import data, train

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{port}")
    train.MESH_GRAPH_WARMUP = warmup
    steps = warmup + 2 * CHUNK
    mesh = make_mesh(MeshPlan(AXES[path]), device_type="cuda")

    def run(chunk):
        cfg = GPTConfig(max_len=SHAPE["seq"])
        model = GPT(cfg, device="cuda").init_weights(
            torch.Generator(device="cuda").manual_seed(0))
        trainer = train.Trainer(model, train.TrainConfig(
            steps_per_call=chunk), mesh=mesh)
        stats = trainer.run(data.causal_token_batches(
            SHAPE["batch"], SHAPE["seq"], cfg.vocab_size), steps)
        params = [p.detach().full_tensor() if hasattr(p, "full_tensor")
                  else p.detach().clone() for p in model.parameters()]
        return [s.loss for s in stats], params, trainer.replayed_steps

    try:
        graph_losses, graph_params, replays = run(CHUNK)
        eager_losses, eager_params, _ = run(1)
        ends = [CHUNK * i - 1 for i in range(1, len(graph_losses))] + [-1]
        equal = ([eager_losses[i] for i in ends] == graph_losses
                 and all(torch.equal(a, b)
                         for a, b in zip(graph_params, eager_params)))
        Path(out).write_text(json.dumps({
            "replays": replays, "equal": equal, "losses": graph_losses}))
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    opts = dict(zip(argv[::2], argv[1::2]))
    paths = opts.get("--paths", "ddp,fsdp").split(",")
    warmups = [int(w) for w in opts.get("--warmups", "1,2,3,11").split(",")]
    from cron_operator_tpu_torch.ops import _build

    _build.build_all()  # once, before the runs load the libraries
    least = {}
    with tempfile.TemporaryDirectory() as tmp:
        for path in paths:
            for warmup in warmups:
                out = os.path.join(tmp, f"{path}-{warmup}.json")
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    port = sock.getsockname()[1]
                try:
                    proc = subprocess.run(
                        [sys.executable, __file__, "--one", path,
                         str(warmup), str(port), out], cwd=ROOT,
                        capture_output=True, text=True, timeout=300)
                except subprocess.TimeoutExpired as err:
                    print(json.dumps({"path": path, "warmup": warmup,
                                      "error": f"timed out: {err}"}),
                          flush=True)
                    continue
                result = {"path": path, "warmup": warmup,
                          "exit": proc.returncode}
                if proc.returncode == 0:
                    result.update(json.loads(Path(out).read_text()))
                    if result["equal"] and result["replays"] > 0:
                        least.setdefault(path, warmup)
                else:  # the first error raised, and the last
                    err = proc.stderr
                    first = err.find("Error")
                    result["error"] = (err[max(0, first - 1500):first + 1500]
                                       + "\n...\n" + err[-1500:])
                print(json.dumps(result), flush=True)
    print(json.dumps({"least_warmup": least,
                      "torch": torch.__version__}), flush=True)
    print(f"card: {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one_run(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        sys.exit(main(sys.argv[1:]))
