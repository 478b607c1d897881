#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, on a machine with one card.

Run from the root of a checkout::

    python3 hack/torch_gloo_cuda_probe.py [cuda|cpu]

For each collective of ``PROBES`` the script starts two rank processes of a
gloo process group that share ``cuda:0`` (or the CPU), runs the collective
once on small float32 tensors of that device, checks the values against
what the collective must give, and reports ``ok``, the error it raised, or
the signal that ended a rank. A crash ends only that probe's ranks. It
prints one JSON line, ``{collective: reading}``, and the card line. This is
the reading behind ``parallel/ring.py``'s choice of the host-staged hop for
gloo groups; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys


def _send_recv(dist, torch, rank, device):
    peer = 1 - rank
    out = torch.empty(4, device=device)
    ops = [dist.P2POp(dist.isend, torch.full((4,), float(rank), device=device),
                      peer),
           dist.P2POp(dist.irecv, out, peer)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.tolist() == [float(peer)] * 4


def _all_to_all(dist, torch, rank, device):
    out = torch.empty(4, device=device)
    dist.all_to_all_single(out, torch.arange(4.0, device=device) + 10 * rank)
    want = [0.0, 1.0, 10.0, 11.0] if rank == 0 else [2.0, 3.0, 12.0, 13.0]
    return out.tolist() == want


def _all_to_all_autograd(dist, torch, rank, device):
    from torch.distributed.nn.functional import all_to_all_single

    x = (torch.arange(4.0, device=device) + 10 * rank).requires_grad_()
    out = all_to_all_single(torch.empty(4, device=device), x)
    out.sum().backward()
    want = [0.0, 1.0, 10.0, 11.0] if rank == 0 else [2.0, 3.0, 12.0, 13.0]
    return out.tolist() == want and x.grad.tolist() == [1.0] * 4


def _all_reduce(dist, torch, rank, device):
    x = torch.full((4,), float(rank + 1), device=device)
    dist.all_reduce(x)
    return x.tolist() == [3.0] * 4


def _all_gather(dist, torch, rank, device):
    out = torch.empty(4, device=device)
    dist.all_gather_into_tensor(out, torch.full((2,), float(rank),
                                                device=device))
    return out.tolist() == [0.0, 0.0, 1.0, 1.0]


def _functional_all_gather(dist, torch, rank, device):
    from torch.distributed import _functional_collectives as funcol

    out = funcol.all_gather_tensor(
        torch.full((2,), float(rank), device=device), 0,
        list(range(dist.get_world_size())))
    return out.tolist() == [0.0, 0.0, 1.0, 1.0]


PROBES = {
    "send_recv": _send_recv,
    "all_to_all_single": _all_to_all,
    "nn.functional.all_to_all_single": _all_to_all_autograd,
    "all_reduce": _all_reduce,
    "all_gather_into_tensor": _all_gather,
    "functional all_gather_tensor": _functional_all_gather,
}


def _rank(name: str, rank: int, port: int, device: str) -> int:
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=2,
                            init_method=f"tcp://127.0.0.1:{port}")
    try:
        good = PROBES[name](dist, torch, rank, device)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    print(json.dumps({"values_right": bool(good)}), flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def probe(name: str, device: str, timeout: float = 120.0) -> str:
    """One collective's reading: ``ok``, ``wrong values``, the end of the
    error a rank printed, ``signal N`` or ``timed out``."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", name, str(r), str(port), device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    readings = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            proc.communicate()
            readings.append("timed out")
            continue
        if proc.returncode < 0:
            readings.append(f"signal {-proc.returncode}")
        elif proc.returncode:
            lines = [x for x in err.strip().splitlines() if x.strip()]
            readings.append("error: " + (lines[-1][-300:] if lines else "?"))
        else:
            good = json.loads(out.strip().splitlines()[-1])["values_right"]
            readings.append("ok" if good else "wrong values")
    bad = [r for r in readings if r != "ok"]
    return bad[0] if bad else "ok"


def main(argv) -> int:
    device = argv[0] if argv else "cuda"
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    readings = {name: probe(name, device) for name in PROBES}
    print(json.dumps({"torch": torch.__version__, "device": device,
                      "gloo": readings}))
    if device == "cuda":
        print("card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        sys.exit(_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                       sys.argv[5]))
    sys.exit(main(sys.argv[1:]))
