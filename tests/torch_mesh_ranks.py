"""Rank bodies of the port's gloo worlds on the CPU.

    python tests/torch_mesh_ranks.py <jobs.json>

runs as one rank of a world whose ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK`` come from the environment: it joins a gloo process
group, runs each job of ``jobs.json`` in order over a mesh of the whole
world, and writes each job's results to ``<out>/<name>.rank<r>.pt``.
:func:`start_world` starts such a world, :func:`wait_world` waits for
it. This file imports
torch, numpy and the port only.

Jobs (dicts):

- ``train``: a GPT (``cfg``: ``GPTConfig.tiny`` overrides, f32) loaded from
  ``weights`` (a state dict file) trains ``steps`` steps of the numpy
  ``causal_token_batches(batch, seq, 1024)`` under ``axes``; results: the
  losses, the first step's gradients, gathered whole, and the parameters'
  placements.
- ``chain``: a GPT tiny from seed 0 trains on fused data to ``steps`` with
  a checkpoint store at ``dir`` (``save_every``), resuming from its newest
  step; results: the restored step, the parameters right after the
  restore, and the losses.
- ``split``: :func:`_split`; ``moe``: :func:`_moe`; ``refuse``:
  :func:`_refuse`.

:func:`mesh_probe` is an entrypoint for the port's runner.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[1]


def _config(job):
    import torch

    from cron_operator_tpu_torch.models.gpt import GPTConfig

    return GPTConfig.tiny(dtype=torch.float32, attention_impl="xla",
                          **job.get("cfg", {}))


def _whole(t):
    from torch.distributed.tensor import DTensor

    t = t.detach()
    # a replicated DTensor's full_tensor() is its local tensor, not a copy
    return (t.full_tensor() if isinstance(t, DTensor) else t).clone()


def _train(job, mesh) -> Dict[str, Any]:
    import torch

    from cron_operator_tpu_torch.models.gpt import GPT
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    cfg = _config(job)
    model = GPT(cfg)
    model.load_state_dict(torch.load(job["weights"], weights_only=True))
    trainer = Trainer(model, TrainConfig(
        steps_per_call=1, stage_async=False,
        aux_loss_in_output=model.has_moe,
        **job.get("train", {})), mesh=mesh)
    batches = data.causal_token_batches(job["batch"], cfg.max_len,
                                        cfg.vocab_size)
    stats = trainer.run(batches, 1)
    grads = {n: _whole(p.grad) for n, p in model.named_parameters()}
    stats += trainer.run(batches, job["steps"])
    return {
        "losses": [s.loss for s in stats],
        "grads": grads,
        "placements": {n: [str(pl) for pl in p.placements]
                       for n, p in model.named_parameters()},
    }


def _chain(job, mesh) -> Dict[str, Any]:
    import torch

    from cron_operator_tpu_torch.models.gpt import GPT
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    cfg = _config(job)
    model = GPT(cfg).init_weights(torch.Generator().manual_seed(0))
    store = CheckpointStore("ns", "chain", root=job["dir"], max_to_keep=100)
    try:
        trainer = Trainer(
            model, TrainConfig(steps_per_call=1,
                               save_every=job["save_every"]),
            sample_fn=data.causal_token_sample(job["batch"], cfg.max_len,
                                               cfg.vocab_size),
            checkpoint=store, mesh=mesh)
        restored = {n: _whole(p) for n, p in model.named_parameters()}
        step0 = trainer.steps_done
        import itertools

        stats = trainer.run(itertools.repeat({}), job["steps"])
    finally:
        store.close()
    return {"restored_step": step0, "restored": restored,
            "losses": [s.loss for s in stats]}


def _split(job, mesh) -> Dict[str, Any]:
    """A GPT tiny whose rank 0 resumes from the store at ``dir`` and every
    other rank from an empty store at ``empty``: the Trainer's constructor
    raises; results: its message on this rank (None if it did not)."""
    import torch

    from cron_operator_tpu_torch.models.gpt import GPT
    from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    model = GPT(_config(job)).init_weights(torch.Generator().manual_seed(0))
    root = job["dir"] if torch.distributed.get_rank() == 0 else job["empty"]
    store = CheckpointStore("ns", "chain", root=root, max_to_keep=100)
    try:
        Trainer(model, TrainConfig(steps_per_call=1), checkpoint=store,
                mesh=mesh)
    except RuntimeError as err:
        return {"error": str(err)}
    finally:
        store.close()
    return {"error": None}


def _moe(job, mesh) -> Dict[str, Any]:
    """``moe_ffn`` with its expert-stacked weights on ``Shard(0)`` over the
    ``expert`` axis (``moe_param_sharding``) and the tokens over the batch
    axes: the output, the aux loss and the gradients, gathered whole."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    from cron_operator_tpu_torch.parallel.mesh import batch_placements
    from cron_operator_tpu_torch.parallel.moe import (
        init_moe_params,
        moe_ffn,
        moe_param_sharding,
    )
    from cron_operator_tpu_torch.workloads.data import local_rows

    gen = torch.Generator().manual_seed(job["seed"])
    params = init_moe_params(gen, d_model=job["d"], d_ff=job["f"],
                             n_experts=job["experts"])
    x = torch.randn(job["tokens"], job["d"], generator=gen)
    placements = moe_param_sharding(params, mesh)
    placed = {k: distribute_tensor(v, mesh, placements[k],
                                   src_data_rank=None).requires_grad_()
              for k, v in params.items()}
    xs = DTensor.from_local(local_rows(x, mesh), mesh, batch_placements(mesh),
                            run_check=False)
    y, aux = moe_ffn(placed, xs)
    ((y ** 2).mean() + 0.01 * aux).backward()
    return {"y": _whole(y), "aux": _whole(aux),
            "grads": {k: _whole(v.grad) for k, v in placed.items()},
            "placements": {k: [str(p) for p in v.placements]
                           for k, v in placed.items()}}


def _refuse(job, mesh) -> Dict[str, Any]:
    """The kernel wrappers given DTensors: each raises ``TypeError``."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    # the module (the package's name ``flash_attention`` is the function)
    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
    local = torch.zeros(1, 128, 2, 64)
    q = DTensor.from_local(local, mesh, [Replicate()] * mesh.ndim,
                           run_check=False)
    lse = torch.zeros(2, 128, 1)
    calls = {
        "flash_attention": lambda: fa.flash_attention(q, q, q),
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(q, q, q),
        "flash_attention_dq": lambda: fa.flash_attention_dq(
            q, q, q, q, lse, lse),
        "flash_attention_dkv": lambda: fa.flash_attention_dkv(
            q, q, q, q, lse, lse),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except TypeError as err:
            out[name] = str(err)
    return {"refused": out}


def mesh_probe(ctx) -> None:
    """An entrypoint for the port's runner: publishes the device and the
    mesh that a training job of these params gets on this rank."""
    from cron_operator_tpu_torch.workloads.entrypoints import _train_device

    device, mesh = _train_device(ctx)
    ctx.progress.update(
        device=str(device),
        mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
        coordinate=list(mesh.get_coordinate()))
    ctx.publish()


def _rank_main(jobs_file: str) -> int:
    import torch
    import torch.distributed as dist

    from cron_operator_tpu_torch.parallel.mesh import mesh_for_devices

    torch.set_num_threads(1)
    spec = json.loads(Path(jobs_file).read_text())
    rank = int(os.environ["RANK"])
    dist.init_process_group(
        "gloo", rank=rank, world_size=int(os.environ["WORLD_SIZE"]),
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"))
    try:
        for job in spec["jobs"]:
            mesh = mesh_for_devices(device_type="cpu", **job["axes"])
            run = {"train": _train, "chain": _chain, "split": _split,
                   "moe": _moe, "refuse": _refuse}[job["kind"]]
            out = run(job, mesh)
            out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
            torch.save(out, Path(spec["out"]) / f"{job['name']}.rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(world: int, jobs: List[Dict[str, Any]], out: Path):
    """Starts ``jobs`` in a gloo world of ``world`` rank processes (one
    thread each); :func:`wait_world` waits for it."""
    out.mkdir(parents=True, exist_ok=True)
    jobs_file = out / f"jobs-{world}-{_free_port()}.json"
    jobs_file.write_text(json.dumps({"jobs": jobs, "out": str(out)}))
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world))
    return [subprocess.Popen(
        [sys.executable, __file__, str(jobs_file)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    ) for r in range(world)]


def wait_world(procs, timeout: float = 600.0) -> None:
    """Waits for a world's ranks; raises with their stderr when one
    fails (a timeout kills them all)."""
    deadline = time.monotonic() + timeout
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
            errors.append(f"rank {r} timed out:\n{err[-3000:]}")
            continue
        if p.returncode:
            errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    if errors:
        raise RuntimeError("\n".join(errors))


def spawn_world(world: int, jobs: List[Dict[str, Any]], out: Path) -> None:
    """:func:`start_world`, then :func:`wait_world`."""
    wait_world(start_world(world, jobs, out))


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1]))
