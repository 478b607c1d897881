#!/usr/bin/env python3
"""Which ways of moving the ring's K/V blocks capture in a CUDA graph over
NCCL, on a machine with several cards.

Run from the root of a checkout::

    python3 hack/torch_nccl_capture_probe.py [N]

For each way of ``PROBES``, ``N`` (default: every visible card) rank
processes, one per card, join an NCCL process group of their own; every
rank hops a K and a V block (bf16 ``[8, 256, 12, 64]``) one place up the
ring twice eagerly (the warm-up), then captures the same hop as a CUDA
graph and replays it with new values: the reading is ``ok`` when the
replay moved what the peer wrote, else the error the capture or the replay
raised, or ``timeout`` when the ranks did not end within ``TIMEOUT_S``. The
ways: ``parallel/ring.py``'s own hop (``_hop``: ``dist.batch_isend_irecv``
and ``wait`` over NCCL, the one the ring runs), and
``dist.all_to_all_single`` with the whole block to one peer. It prints a
JSON line ``{way: reading}`` for each way, and the card line; it imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SHAPE = (8, 256, 12, 64)
TIMEOUT_S = 120  # a way whose ranks run longer reads "timeout"


def _all_to_all(dist, torch, group, blocks):
    n, me = dist.get_world_size(group), dist.get_rank(group)
    flat = torch.cat([t.reshape(-1) for t in blocks])
    out = torch.empty_like(flat)
    sends = [flat.numel() if r == (me + 1) % n else 0 for r in range(n)]
    recvs = [flat.numel() if r == (me - 1) % n else 0 for r in range(n)]
    dist.all_to_all_single(out, flat, recvs, sends, group=group)
    return [part.view_as(t) for part, t in
            zip(out.split([t.numel() for t in blocks]), blocks)]


def _ring_hop(dist, torch, group, blocks):
    from cron_operator_tpu_torch.parallel.ring import _hop

    return _hop(blocks, group, 1)


PROBES = {"all_to_all_single": _all_to_all, "ring._hop": _ring_hop}


def _rank(name: str, rank: int, world: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    dist.init_process_group("nccl", rank=rank, world_size=world,
                            init_method=f"tcp://127.0.0.1:{port}",
                            device_id=torch.device("cuda", rank))
    group = dist.group.WORLD
    way = PROBES[name]
    blocks = [torch.full(SHAPE, float(rank + 10 * i), device="cuda",
                         dtype=torch.bfloat16) for i in range(2)]
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                way(dist, torch, group, blocks)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = way(dist, torch, group, blocks)
        for i, t in enumerate(blocks):
            t.fill_(float(100 + rank + 10 * i))
        graph.replay()
        torch.cuda.synchronize()
        src = (rank - 1) % world
        want = [float(100 + src + 10 * i) for i in range(2)]
        ok = all(bool((g == w).all()) for g, w in zip(got, want))
        reading = "ok" if ok else (
            f"replay moved {[g.flatten()[0].item() for g in got]}, "
            f"not {want}")
    except Exception as err:  # noqa: BLE001 -- the reading is the error
        reading = f"{type(err).__name__}: {err}"[:600]
    if rank == 0:
        print(json.dumps({name: reading}), flush=True)
    os._exit(0)  # no teardown: a failed capture may leave NCCL waiting


def main(argv) -> int:
    import torch

    if argv[:1] == ["--rank"]:
        _rank(argv[1], int(argv[2]), int(argv[3]), int(argv[4]))
        return 0
    world = int(argv[0]) if argv else torch.cuda.device_count()
    if world < 2 or world > torch.cuda.device_count():
        sys.exit(f"needs 2 or more cards, asked for {world} of "
                 f"{torch.cuda.device_count()}")
    failed = False
    for name in PROBES:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", name, str(r), str(world),
             str(port)], cwd=ROOT) for r in range(world)]
        try:
            for proc in procs:
                failed |= proc.wait(timeout=TIMEOUT_S) != 0
        except subprocess.TimeoutExpired:
            print(json.dumps({name: "timeout"}), flush=True)
            failed = True
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.splitlines()[0] if card else 'unknown'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
