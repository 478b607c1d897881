#!/usr/bin/env python3
"""The readings of ``chip_smoke.py``'s mesh checks on the CPU, at GPT tiny.

Run from the root of a checkout::

    python3 hack/torch_mesh_readings.py [ROOT]

Runs ``chip_smoke.run_gpt`` (the ``gpt`` entrypoint at ``size=tiny``,
``seq_len`` 128, b 8, AdamW, ``data=host``, 3 steps, ``platform=cpu``)
once on one process as the reference, once at lr 0 (parameters that never
move), and as two-rank gloo worlds under ``devices=2``, ``fsdp=2`` and
``tensor=2``, and prints for each the loss gap and the update distance
against the reference (``chip_smoke.mesh_readings``), beside the bounds
the card's checks use. The worlds import the port from ROOT (default:
this checkout), so that a copy of the checkout with a deliberate fault
shows what the checks read on it; the reference always runs this one.
Every process runs with one thread. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PARAMS = {"platform": "cpu", "size": "tiny", "seq_len": "128",
          "batch_size": "8", "steps": "3", "data": "host",
          "steps_per_call": "1", "attention": "xla"}
RUNS = {"frozen (lr 0)": (1, {"lr": "0"}), "data2": (2, {"devices": "2"}),
        "fsdp2": (2, {"fsdp": "2"}), "tensor2": (2, {"tensor": "2"})}


def rank_main(root: str, rank: int, world: int, port: int, params: dict,
              out: str) -> None:
    """One rank: ``run_gpt`` from ``root``'s ``chip_smoke.py`` and port."""
    sys.path.insert(0, root)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    # run_gpt's card calls: its synchronise and its peak-memory reading
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    import chip_smoke

    if world > 1:
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                init_method=f"tcp://127.0.0.1:{port}")
    try:
        Path(out).write_text(json.dumps(
            chip_smoke.run_gpt(torch, params, out + ".delta.pt")))
    finally:
        if world > 1:
            dist.destroy_process_group()


def spawn(root: str, world: int, params: dict, tmp: str, name: str) -> list:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    outs = [os.path.join(tmp, f"{name}.{r}.json") for r in range(world)]
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", root, str(r), str(world),
         str(port), json.dumps(params), outs[r]], env=env)
        for r in range(world)]
    if any(p.wait() for p in procs):
        sys.exit(f"{name}: a rank failed")
    ranks = [json.loads(Path(o).read_text()) for o in outs]
    ranks[0]["delta"] = outs[0] + ".delta.pt"
    return ranks


def main(argv) -> int:
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke

    root = str(Path(argv[0]).resolve()) if argv else str(HERE)
    with tempfile.TemporaryDirectory() as tmp:
        (ref,) = spawn(str(HERE), 1, PARAMS, tmp, "reference")
        print(json.dumps({"run": "one process", "losses": ref["losses"]}))
        for name, (world, extra) in RUNS.items():
            ranks = spawn(root if world > 1 else str(HERE), world,
                          {**PARAMS, **extra}, tmp, name.split()[0])
            gap, dist = chip_smoke.mesh_readings(torch, ranks, ref)
            print(json.dumps({
                "run": name, "root": root if world > 1 else str(HERE),
                "losses": ranks[0]["losses"], "loss_gap": gap,
                "update_distance": dist,
                "bounds": [chip_smoke.MESH_LOSS_BOUND,
                           chip_smoke.MESH_UPDATE_BOUND]}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  int(sys.argv[5]), json.loads(sys.argv[6]), sys.argv[7])
    else:
        sys.exit(main(sys.argv[1:]))
