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

- ``train``: a GPT (``cfg``: ``GPTConfig.tiny`` overrides, f32; a BERT
  with ``"model": "bert"``, a ViT with ``"model": "vit"``) loaded from
  ``weights`` (a state dict file) trains ``steps`` steps of the numpy
  ``causal_token_batches(batch, seq, 1024)`` (``"stream": "token_batches"``
  for BERT's, ``"imagenet_batches"`` for ViT's) under ``axes``; results:
  the losses, the first step's gradients, gathered whole, and the
  parameters' placements and shapes. ``contiguous_qkv`` splits the fused
  ``qkv`` rows over ``tensor`` as one contiguous block a rank (a wrong
  split, which the tests must catch). ``loss`` (``lm`` or ``fused``)
  trains on the jobs' LM loss (``entrypoints.lm_loss``: the model's hidden
  states, under ``tensor`` its ``VocabPiece``, and the tied or the chunked
  loss) in place of ``cross_entropy_loss`` on the logits; then the results
  also hold this rank's block of the tied table after the steps
  (``table``). ``wrong_offset`` hands every ``tensor`` rank the offset 0
  for its block of the vocab (a wrong merge, which the tests must
  catch).
- ``chain``: a GPT tiny (``cfg`` overrides; with MoE blocks its aux loss
  added) from seed 0 trains on fused data to ``steps`` with
  a checkpoint store at ``dir`` (``save_every``), resuming from its newest
  step; results: the restored step, the parameters right after the
  restore, and the losses.
- ``data_parallel``: :func:`_data_parallel`; ``moe_group``:
  :func:`_moe_group`; ``moe_expert``: :func:`_moe_expert`.
- ``split``: :func:`_split`; ``moe``: :func:`_moe`; ``refuse``:
  :func:`_refuse`; ``attention``: :func:`_attention`; ``body``:
  :func:`_body`; ``hop``:
  :func:`_hop`; ``guards``: :func:`_guards`; ``pipe_guards``:
  :func:`_pipe_guards`; ``pipeline``: :func:`_pipeline`; ``lm_job``:
  :func:`_lm_job`; ``tensor_restore``: :func:`_tensor_restore`;
  ``tensor_collectives``: :func:`_tensor_collectives`.

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

    from cron_operator_tpu_torch.models.bert import BertConfig
    from cron_operator_tpu_torch.models.gpt import GPTConfig
    from cron_operator_tpu_torch.models.vit import ViTConfig

    maker = {"bert": BertConfig.tiny, "vit": ViTConfig.tiny}.get(
        job.get("model"), GPTConfig.tiny)
    lm = {"return_hidden": True} if job.get("loss") else {}
    return maker(**{"dtype": torch.float32, "attention_impl": "xla",
                    **lm, **job.get("cfg", {})})


def _trainer_kwargs(job, mesh) -> Dict[str, Any]:
    """The Trainer's ``loss_fn`` under the job's ``loss`` (none: the
    Trainer's default, ``cross_entropy_loss`` on the logits)."""
    from cron_operator_tpu_torch.workloads.entrypoints import lm_loss

    if not job.get("loss"):
        return {}
    return {"loss_fn": lm_loss(mesh, job["loss"] == "fused")[1]}


def _model(job):
    from cron_operator_tpu_torch.models.bert import Bert
    from cron_operator_tpu_torch.models.gpt import GPT
    from cron_operator_tpu_torch.models.vit import ViT

    return {"bert": Bert, "vit": ViT}.get(job.get("model"), GPT)(_config(job))


def _batches(job, cfg):
    """The job's numpy stream (``stream``): token batches of the model's
    length and vocab, or ViT's images of its size and classes."""
    from cron_operator_tpu_torch.workloads import data

    stream = getattr(data, job.get("stream", "causal_token_batches"))
    if job.get("model") == "vit":
        return stream(job["batch"], cfg.image_size, cfg.num_classes)
    return stream(job["batch"], cfg.max_len, cfg.vocab_size)


def qkv_arrays(seed: int, b: int, s: int, h: int, kv_h: int, d: int):
    """Seeded numpy q ``[b, s, h, d]``, k and v ``[b, s, kv_h, d]``, f32:
    the inputs that the ranks and the test process share."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((b, s, h, d), (b, s, kv_h, d), (b, s, kv_h, d)))


def pipeline_arrays(seed: int, n_stages: int, width: int, batch: int):
    """Seeded numpy stage parameters ``[{"w": [width, width], "b":
    [width]}]`` and input ``[batch, width]`` of the pipeline cases."""
    import numpy as np

    rng = np.random.default_rng(seed)
    stages = [{"w": rng.standard_normal((width, width), dtype=np.float32)
               / width ** 0.5,
               "b": rng.standard_normal(width, dtype=np.float32) * 0.1}
              for _ in range(n_stages)]
    return stages, rng.standard_normal((batch, width), dtype=np.float32)


def pipeline_stage(p, x):
    """The pipeline cases' stage: ``relu(x @ w + b)``."""
    import torch

    return torch.relu(x @ p["w"] + p["b"])


def _whole(t):
    from torch.distributed.tensor import DTensor

    t = t.detach()
    # a replicated DTensor's full_tensor() is its local tensor, not a copy
    return (t.full_tensor() if isinstance(t, DTensor) else t).clone()


def _weights(job, timeout: float = 300.0):
    """The state dict at ``job["weights"]``, waiting up to ``timeout`` s
    for the file: a test process may write it (by a rename) after it
    started the world."""
    import torch

    path = Path(job["weights"])
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no weights at {path}")
        time.sleep(0.1)
    return torch.load(path, weights_only=True)


def _whole_params(model, tensors) -> Dict[str, Any]:
    """``tensors`` (``(name, tensor)`` pairs of ``model``'s parameters, or
    of their gradients) whole: a DTensor's full tensor, and a piece of a
    parameter split over ``tensor`` or ``expert`` gathered over its group
    (``parallel.mesh.tensor_parallel``; every rank calls this)."""
    from cron_operator_tpu_torch.parallel.mesh import tensor_parallel

    split = tensor_parallel(model)
    out = {}
    for name, t in tensors:
        t = _whole(t)
        out[name] = t if split is None else split.gather(name, t)
    return out


def _train(job, mesh) -> Dict[str, Any]:
    import torch

    from cron_operator_tpu_torch.models import bert, gpt
    from cron_operator_tpu_torch.models.layers import (
        GroupedQKVProjection,
        VocabPiece,
    )
    from cron_operator_tpu_torch.parallel.mesh import TensorSplit
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    cfg = _config(job)
    model = _model(job)
    model.load_state_dict(_weights(job))
    rule = GroupedQKVProjection.tensor_splits
    if job.get("contiguous_qkv"):
        GroupedQKVProjection.tensor_splits = lambda self, t: {
            k: TensorSplit(0) for k in rule(self, t)}
    piece = gpt.vocab_piece
    if job.get("wrong_offset"):
        gpt.vocab_piece = bert.vocab_piece = lambda w, v, group: (
            w if group is None else VocabPiece(w, 0, v, group))
    try:
        trainer = Trainer(model, TrainConfig(
            steps_per_call=1, stage_async=False,
            aux_loss_in_output=getattr(model, "has_moe", False),
            **job.get("train", {})), mesh=mesh, **_trainer_kwargs(job, mesh))
        batches = _batches(job, cfg)
        stats = trainer.run(batches, 1)
        grads = _whole_params(model, ((n, p.grad)
                                      for n, p in model.named_parameters()))
        stats += trainer.run(batches, job["steps"])
    finally:
        GroupedQKVProjection.tensor_splits = rule
        gpt.vocab_piece = bert.vocab_piece = piece
    out = {
        "losses": [s.loss for s in stats],
        "grads": grads,
        "placements": {n: placements(p, mesh)
                       for n, p in model.named_parameters()},
        "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
        "final": _whole_params(model, model.named_parameters()),
        "path": _path(model),
    }
    if job.get("loss"):
        out["table"] = _whole(model.tok_emb.weight)
        if "tensor" in mesh.mesh_dim_names:
            out["tensor_index"] = mesh.get_local_rank("tensor")
    return out


def _path(model) -> str:
    """How a trainer holds ``model`` over its mesh: ``fsdp`` (FSDP2),
    ``dtensor`` (placed parameters) or ``ddp`` (plain parameters)."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    if isinstance(model, FSDPModule):
        return "fsdp"
    first = next(model.parameters())
    return "dtensor" if isinstance(first, DTensor) else "ddp"


def _data_parallel(job, mesh) -> Dict[str, Any]:
    """:func:`_train`'s results, and under ``chunked`` the losses, the
    final parameters and the model FLOPs a step
    (``Trainer.flops_per_step``) of the same steps trained in calls of
    ``chunk`` steps (staged by the trainer's background thread). With
    ``rank_order``, also the losses (``rank_order_losses``) of
    :func:`_train` with the MoE blocks routing every rank's tokens in rank
    order (``parallel.moe.token_order`` giving the identity)."""
    import torch

    from cron_operator_tpu_torch.parallel import moe
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    out = _train(job, mesh)
    cfg = _config(job)
    model = _model(job)
    model.load_state_dict(_weights(job))
    trainer = Trainer(model, TrainConfig(
        steps_per_call=job["chunk"],
        aux_loss_in_output=getattr(model, "has_moe", False),
        **job.get("train", {})), mesh=mesh, **_trainer_kwargs(job, mesh))
    stats = trainer.run(_batches(job, cfg), job["steps"])
    out["chunked"] = {
        "losses": [s.loss for s in stats],
        "final": _whole_params(model, model.named_parameters()),
        "flops": trainer.flops_per_step()}
    if job.get("rank_order"):
        real = moe.token_order

        def rank_order(group, tokens, rows=1, seq_blocks=1, device=None):
            order, _ = real(group, tokens, device=device)
            me = torch.distributed.get_rank(group)
            return order, order[me * tokens:(me + 1) * tokens]

        moe.token_order = rank_order
        try:
            out["rank_order_losses"] = _train(job, mesh)["losses"]
        finally:
            moe.token_order = real
    return out


def _moe_group(job, mesh) -> Dict[str, Any]:
    """``moe_ffn`` on this rank's rows of a seeded token batch with
    ``group`` the mesh's batch group: the output rows, the aux loss, this
    rank's input gradient and the parameters' gradients summed over the
    ranks (the objective is the one-device one split over them), on the
    index path (``moe_ffn``) and on the dense one (``moe_ffn_reference``,
    under ``"dense"``); and the output of the same rows routed among this
    rank's tokens alone."""
    import torch
    import torch.distributed as dist

    from cron_operator_tpu_torch.parallel.mesh import batch_group
    from cron_operator_tpu_torch.parallel.moe import (
        init_moe_params,
        moe_ffn,
        moe_ffn_reference,
    )
    from cron_operator_tpu_torch.workloads.data import local_rows

    group = batch_group(mesh)
    gen = torch.Generator().manual_seed(job["seed"])
    init = init_moe_params(gen, d_model=job["d"], d_ff=job["f"],
                           n_experts=job["experts"])
    rows = local_rows(torch.randn(job["tokens"], job["d"], generator=gen),
                      mesh)
    kw = {"capacity_factor": job["capacity_factor"]}
    ranks = dist.get_world_size(group)

    def run(fn):
        params = {k: v.clone().requires_grad_() for k, v in init.items()}
        x = rows.clone().requires_grad_()
        y, aux = fn(params, x, group=group, **kw)
        ((y ** 2).sum() / job["tokens"] + 0.01 * aux / ranks).backward()
        grads = {}
        for name, p in params.items():
            dist.all_reduce(p.grad, group=group)
            grads[name] = p.grad
        return {"y": y.detach(), "aux": aux.detach(), "x_grad": x.grad,
                "grads": grads}

    out = run(moe_ffn)
    alone, _ = moe_ffn(init, rows, **kw)
    return {**out, "alone": alone, "dense": run(moe_ffn_reference)}


def _moe_expert(job, mesh) -> Dict[str, Any]:
    """``moe_ffn`` and ``moe_ffn_reference`` on this rank's rows of a
    seeded token batch, with ``group`` the mesh's batch group and
    ``expert_group`` its ``expert`` group, each rank holding its experts'
    ``wi`` and ``wo``: the output rows, the aux loss, this rank's input
    gradient, the router's gradient summed over the batch group (whole on
    every rank of the expert group already) and, under ``router_summed``,
    summed over the expert group too (counted n times), and ``wi``/``wo``'s
    gradients summed over the batch group and gathered whole over the
    expert group; ``rows``: this rank's rows of the batch."""
    import torch
    import torch.distributed as dist

    from cron_operator_tpu_torch.parallel.mesh import (
        EXPERT_AXIS,
        TensorSplit,
        batch_group,
        batch_rows,
    )
    from cron_operator_tpu_torch.parallel.moe import (
        init_moe_params,
        moe_ffn,
        moe_ffn_reference,
    )

    group, experts = batch_group(mesh), mesh.get_group(EXPERT_AXIS)
    me, n = dist.get_rank(experts), dist.get_world_size(experts)
    gen = torch.Generator().manual_seed(job["seed"])
    init = init_moe_params(gen, d_model=job["d"], d_ff=job["f"],
                           n_experts=job["experts"])
    x_all = torch.randn(job["tokens"], job["d"], generator=gen)
    rows = batch_rows(mesh, job["tokens"])
    split = TensorSplit(0)
    ranks = dist.get_world_size(group)

    def run(fn):
        params = {k: (v if k == "router" else split.local(v, me, n))
                  .clone().requires_grad_() for k, v in init.items()}
        x = x_all[rows].clone().requires_grad_()
        y, aux = fn(params, x, group=group, expert_group=experts,
                    capacity_factor=job["capacity_factor"])
        ((y ** 2).sum() / job["tokens"] + 0.01 * aux / ranks).backward()
        grads = {}
        for name, p in params.items():
            dist.all_reduce(p.grad, group=group)
            if name == "router":
                grads[name] = p.grad.clone()
                dist.all_reduce(p.grad, group=experts)
                summed = p.grad
            else:
                pieces = [torch.empty_like(p.grad) for _ in range(n)]
                dist.all_gather(pieces, p.grad.contiguous(), group=experts)
                grads[name] = split.whole(pieces)
        return {"y": y.detach(), "aux": aux.detach(), "x_grad": x.grad,
                "grads": grads, "router_summed": summed}

    return {"index": run(moe_ffn), "dense": run(moe_ffn_reference),
            "rows": _slice(rows)}


def placements(p, mesh) -> List[str]:
    """``p``'s placement on each axis of ``mesh``, as strings: a DTensor's
    (``R`` on an axis its own mesh, FSDP2's, does not span), ``R`` on every
    axis for a plain tensor (a DDP parameter, or one FSDP2 leaves whole)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return ["R"] * mesh.ndim
    on = dict(zip(p.device_mesh.mesh_dim_names, map(str, p.placements)))
    return [on.get(name, "R") for name in mesh.mesh_dim_names]


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
                               save_every=job["save_every"],
                               aux_loss_in_output=model.has_moe),
            sample_fn=data.causal_token_sample(job["batch"], cfg.max_len,
                                               cfg.vocab_size),
            checkpoint=store, mesh=mesh, **_trainer_kwargs(job, mesh))
        restored = _whole_params(model, model.named_parameters())
        step0 = trainer.steps_done
        import itertools

        stats = trainer.run(itertools.repeat({}), job["steps"])
    finally:
        store.close()
    return {"restored_step": step0, "restored": restored,
            "losses": [s.loss for s in stats]}


def _tensor_restore(job, mesh) -> Dict[str, Any]:
    """A GPT tiny (``cfg``, seed 0) whose trainer restores the newest step
    of the store at ``dir`` once one is there (up to 300 s: the test
    process writes it while this world runs), and rank 0 saves the
    trainer's ``host_state`` (every tensor gathered whole) at that step
    into the store at ``out_dir``; results: the restored step and the
    parameters' shapes on this rank."""
    import torch

    from cron_operator_tpu_torch.models.gpt import GPT
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    cfg = _config(job)
    store = CheckpointStore("ns", "chain", root=job["dir"], max_to_keep=100)
    deadline = time.monotonic() + 300
    while store.latest_step() is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint under {job['dir']}")
        time.sleep(0.2)
    model = GPT(cfg).init_weights(torch.Generator().manual_seed(0))
    try:
        trainer = Trainer(
            model, TrainConfig(steps_per_call=1,
                               aux_loss_in_output=model.has_moe),
            sample_fn=data.causal_token_sample(job["batch"], cfg.max_len,
                                               cfg.vocab_size),
            checkpoint=store, mesh=mesh, **_trainer_kwargs(job, mesh))
        state = trainer.host_state()
    finally:
        store.close()
    if torch.distributed.get_rank() == 0:
        out = CheckpointStore("ns", "chain", root=job["out_dir"])
        out.save(trainer.steps_done, state)
        out.close()
    torch.distributed.barrier()
    return {"restored_step": trainer.steps_done,
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def _tensor_collectives(job, mesh) -> Dict[str, Any]:
    """The Megatron pair over the ``tensor`` group, on rank-dependent
    inputs ``x_r = seed(r)`` and cotangents ``w_r``: ``copy_to_tensor``'s
    output and its input's gradient, ``reduce_from_tensor``'s likewise, and
    a row-parallel ``Linear`` (``layers.row_parallel``: this rank's input
    columns of a seeded whole layer, on its columns of a seeded input)
    with the whole layer's output beside it."""
    import torch
    import torch.distributed as dist

    from cron_operator_tpu_torch.models.layers import Linear, row_parallel
    from cron_operator_tpu_torch.parallel.mesh import (
        TENSOR_AXIS,
        TensorSplit,
        copy_to_tensor,
        reduce_from_tensor,
    )

    group = mesh.get_group(TENSOR_AXIS)
    r, t = dist.get_rank(group), dist.get_world_size(group)
    out = {}
    for name, fn in (("copy", copy_to_tensor), ("reduce", reduce_from_tensor)):
        gen = torch.Generator().manual_seed(job["seed"] + r)
        x = torch.randn(3, 4, generator=gen).requires_grad_()
        w = torch.randn(3, 4, generator=gen)
        y = fn(x, group)
        (y * w).sum().backward()
        out[name] = {"x": x.detach(), "w": w, "y": y.detach(),
                     "grad": x.grad}
    gen = torch.Generator().manual_seed(job["seed"])
    whole = Linear(8, 6, compute_dtype=torch.float32)
    with torch.no_grad():
        whole.weight.copy_(torch.randn(6, 8, generator=gen))
        whole.bias.copy_(torch.randn(6, generator=gen))
    x = torch.randn(2, 8, generator=gen)
    piece = Linear(8 // t, 6, compute_dtype=torch.float32)
    with torch.no_grad():
        piece.weight.copy_(TensorSplit(1).local(whole.weight, r, t))
        piece.bias.copy_(whole.bias)
    cols = TensorSplit(1).local(x, r, t)
    out["row_parallel"] = {"y": row_parallel(piece, cols, group).detach(),
                           "whole": whole(x).detach()}
    return out


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


def _attention(job, mesh) -> Dict[str, Any]:
    """Sequence-parallel attention (``impl`` ring or ulysses) on the seeded
    ``qkv_arrays(*job["qkv"])``, three ways: the public function on plain
    global tensors (k and v repeated to q's heads, as the JAX dispatch
    does before it), :func:`ops.attention.multi_head_attention` on
    DTensors laid out by ``batch_placements(mesh, seq_dim=1)`` (grouped
    k/v as they are), and the same dispatch on this rank's plain block
    (rows and positions) with the mesh passed, as the plain path's layers
    call it, for ``impl`` and for ``xla`` (the sequence gathered). Results:
    each way's output and the gradients of ``sum(out ** 2)``, whole, or on
    the plain blocks this rank's (``local``, with its ``rows`` and
    ``positions``)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from cron_operator_tpu_torch.ops.attention import multi_head_attention
    from cron_operator_tpu_torch.parallel.mesh import (
        batch_placements,
        batch_rows,
        seq_block,
    )
    from cron_operator_tpu_torch.parallel.ring import ring_attention
    from cron_operator_tpu_torch.parallel.ulysses import ulysses_attention

    q, k, v = (torch.from_numpy(a) for a in qkv_arrays(*job["qkv"]))
    group = q.shape[2] // k.shape[2]
    fn = ring_attention if job["impl"] == "ring" else ulysses_attention
    plain = [t.clone().requires_grad_() for t in
             (q, k.repeat_interleave(group, 2), v.repeat_interleave(group, 2))]
    out = fn(*plain, mesh, causal=job["causal"])
    (out ** 2).sum().backward()
    place = batch_placements(mesh, seq_dim=1)
    placed = [distribute_tensor(t, mesh, place, src_data_rank=None)
              .requires_grad_() for t in (q, k, v)]
    out_d = multi_head_attention(*placed, causal=job["causal"],
                                 impl=job["impl"])
    (out_d ** 2).sum().backward()
    local = {}
    for impl in (job["impl"], "xla"):
        blocks = [_local_block(t, mesh).clone().requires_grad_()
                  for t in (q, k, v)]
        out_l = multi_head_attention(*blocks, causal=job["causal"],
                                     impl=impl, mesh=mesh)
        (out_l ** 2).sum().backward()
        local[impl] = {"out": out_l.detach(),
                       "grads": [t.grad for t in blocks]}
    return {"out": _whole(out), "grads": [t.grad.clone() for t in plain],
            "out_dispatch": _whole(out_d),
            "grads_dispatch": [_whole(t.grad) for t in placed],
            "placements": [str(p) for p in out_d.placements],
            "local": local, "rows": _slice(batch_rows(mesh, q.shape[0])),
            "positions": _slice(seq_block(mesh, q.shape[1]))}


def _local_block(t, mesh):
    """This rank's rows and block of positions of ``[b, s, ...]`` ``t``, as
    the plain path holds a batch split over the batch axes and ``seq``."""
    from cron_operator_tpu_torch.workloads.data import local_rows

    return local_rows(t, mesh, seq_dim=1)


def _slice(s) -> List[int]:
    return [s.start, s.stop]


def body_arrays(seed: int, b: int, s: int, h: int, d: int):
    """Seeded numpy q, k, v and the output's gradient dO, each ``[b, s, h,
    d]`` f32: the inputs of the ``body`` cases."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d), dtype=np.float32)
                 for _ in range(4))


def _body(job, mesh) -> Dict[str, Any]:
    """A sequence-parallel body (``impl`` ring or ulysses) on the seeded
    ``body_arrays(*job["qkv"])`` in ``dtype`` (default f32), through the
    public function on plain global tensors, with dO fed to its output;
    for the ring also :func:`parallel.ring.ring_attention_local_reference`
    through the same scaffolding. Results: each way's output and the
    gradients of q, k and v, whole, and the block calls this rank's body
    made (``(causal, rows)`` of each ``flash_attention_block`` call)."""
    from functools import partial

    import torch

    fa = importlib.import_module(
        "cron_operator_tpu_torch.ops.flash_attention")
    from cron_operator_tpu_torch.parallel import ring
    from cron_operator_tpu_torch.parallel.ulysses import ulysses_attention

    dtype = getattr(torch, job.get("dtype", "float32"))
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in body_arrays(*job["qkv"]))
    causal = job["causal"]

    def run(fn):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*xs, mesh, causal=causal)
        out.backward(do)
        return out.detach(), [x.grad for x in xs]

    def reference(q, k, v, mesh, causal):
        body = partial(ring.ring_attention_local_reference, mesh=mesh,
                       causal=causal)
        return ring.seq_sharded_call(body, q, k, v, mesh, seq_axis="seq",
                                     causal=causal, op_name="reference")

    calls = []
    block = fa.flash_attention_block

    def counted(q, k, v, *, causal=False):
        calls.append((causal, q.shape[1]))
        return block(q, k, v, causal=causal)

    fa.flash_attention_block = counted
    try:
        fn = ring.ring_attention if job["impl"] == "ring" else \
            ulysses_attention
        out, grads = run(fn)
    finally:
        fa.flash_attention_block = block
    result = {"out": out, "grads": grads, "calls": calls,
              "coord": mesh.get_local_rank("seq")}
    if job["impl"] == "ring":
        result["ref_out"], result["ref_grads"] = run(reference)
    return result


def _hop(job, mesh) -> Dict[str, Any]:
    """:func:`parallel.ring.ppermute` by ``shift`` over ``axis``: each rank
    sends its coordinate, weights what it receives by its coordinate + 1
    and differentiates the sum; then the same hop with the host-staged path
    forced. Results: the coordinate, what came in, the input's gradient and
    what the staged hop brought."""
    import torch

    from cron_operator_tpu_torch.parallel import ring

    group = mesh.get_group(job["axis"])
    coord = mesh.get_local_rank(job["axis"])
    x = torch.full((3,), float(coord), requires_grad=True)
    out = ring.ppermute(x, group, shift=job["shift"])
    (out * (coord + 1)).sum().backward()
    direct = ring.stages_through_host
    ring.stages_through_host = lambda group, tensors: True
    try:
        staged = ring.ppermute((x.detach(), x.detach() * 2), group,
                               shift=job["shift"])
    finally:
        ring.stages_through_host = direct
    return {"coord": coord, "out": out.detach(), "grad": x.grad,
            "staged": [t.clone() for t in staged]}


def _error(call) -> Any:
    try:
        call()
    except ValueError as err:
        return str(err)
    return None


def _guards(job, mesh) -> Dict[str, Any]:
    """The guards of ring and Ulysses on a mesh whose ``seq`` axis is the
    world: the ``ValueError`` message of each refused call (None if it did
    not raise), and the fallbacks' largest gap to plain attention."""
    import torch

    from cron_operator_tpu_torch.parallel.mesh import mesh_for_devices
    from cron_operator_tpu_torch.parallel.ring import (
        _single_device_attention,
        ring_attention,
    )
    from cron_operator_tpu_torch.parallel.ulysses import ulysses_attention

    ring = mesh.size()
    gen = torch.Generator().manual_seed(1)
    odd = torch.ones(2, 8 * ring + 1, 2, 8)
    one = torch.randn(1, 8 * ring + 1, 2, 8, generator=gen)
    q = torch.randn(2, 16, 2, 8, generator=gen)
    flat = mesh_for_devices(device_type="cpu")  # no seq axis
    heads = torch.ones(2, 8 * ring, ring + 1, 8)
    return {
        "indivisible": _error(lambda: ring_attention(odd, odd, odd, mesh)),
        "batch_of_one": (ring_attention(one, one, one, mesh)
                         - _single_device_attention(one, one, one,
                                                    causal=False)
                         ).abs().max().item(),
        "heads": _error(lambda: ulysses_attention(heads, heads, heads, mesh)),
        "degenerate": (ring_attention(q, q, q, flat, causal=True)
                       - _single_device_attention(q, q, q, causal=True)
                       ).abs().max().item(),
    }


def _pipe_guards(job, mesh) -> Dict[str, Any]:
    """The ``ValueError`` messages of ``spmd_pipeline``'s checks (None where
    it did not raise): no ``pipe`` axis, a stage count unequal to the
    axis, a batch that does not divide into microbatches and, with a data
    axis, a per-shard batch that does not."""
    import torch

    from cron_operator_tpu_torch.parallel.mesh import mesh_for_devices
    from cron_operator_tpu_torch.parallel.pipeline import spmd_pipeline

    world = mesh.size()
    stages, x = pipeline_arrays(0, 4, 16, 8)
    stacked = {n: torch.stack([torch.from_numpy(s[n]) for s in stages])
               for n in ("w", "b")}
    x = torch.from_numpy(x)

    def call(mesh, n_stages, microbatches):
        return _error(lambda: spmd_pipeline(
            pipeline_stage, {n: t[:n_stages] for n, t in stacked.items()},
            x, mesh=mesh, n_microbatches=microbatches))

    flat = mesh_for_devices(device_type="cpu")
    pipe = mesh_for_devices(device_type="cpu", pipe=world)
    half = mesh_for_devices(device_type="cpu", pipe=2)  # x data world / 2
    return {"no_pipe": call(flat, world, 4),
            "stages": call(pipe, 4 if world == 2 else 2, 4),
            "microbatches": call(pipe, world, 3),
            "per_shard": call(half, 2, 8)}


def _pipeline(job, mesh) -> Dict[str, Any]:
    """:func:`parallel.pipeline.spmd_pipeline` of :func:`pipeline_stage`
    over the seeded ``pipeline_arrays(*job["arrays"])`` in
    ``job["microbatches"]`` microbatches: with plain stacked parameters
    (the output, the gradients of ``sum(y ** 2)`` for x and every stacked
    tensor) and with DTensor ones placed by ``pipeline_param_sharding``
    (the output, the gradients gathered whole, and their placements)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from cron_operator_tpu_torch.parallel.pipeline import (
        pipeline_param_sharding,
        spmd_pipeline,
        stack_pipeline_stages,
    )

    stages, x = pipeline_arrays(*job["arrays"])
    stacked = {n: t.requires_grad_() for n, t in stack_pipeline_stages(
        [{n: torch.from_numpy(a) for n, a in s.items()} for s in stages]
    ).items()}
    x = torch.from_numpy(x).requires_grad_()
    m = job["microbatches"]
    y = spmd_pipeline(pipeline_stage, stacked, x, mesh=mesh, n_microbatches=m)
    (y ** 2).sum().backward()
    place = pipeline_param_sharding(stacked, mesh)
    placed = {n: distribute_tensor(t.detach(), mesh, place[n],
                                   src_data_rank=None).requires_grad_()
              for n, t in stacked.items()}
    y_d = spmd_pipeline(pipeline_stage, placed, x.detach(), mesh=mesh,
                        n_microbatches=m)
    (y_d ** 2).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad,
            "grads": {n: t.grad for n, t in stacked.items()},
            "y_dtensor": y_d.detach(),
            "grads_dtensor": {n: _whole(t.grad) for n, t in placed.items()},
            "placements": {n: [str(p) for p in t.placements]
                           for n, t in placed.items()}}


class _LossBeat:
    """A job's watchdog that records its loss at each step's beat."""

    def __init__(self, ctx, losses):
        self.ctx, self.losses = ctx, losses

    def beat(self):
        self.losses.append(self.ctx.progress["last_loss"])


def _lm_job(job, mesh) -> Dict[str, Any]:
    """The ``gpt`` or ``bert`` entrypoint (``entry``) with ``params`` over
    the world, once as it is and once with the former loss wiring
    (``lm_loss`` giving the model's f32 logits and ``cross_entropy_loss``):
    each run's per-step losses (``steps_per_call=1``) and its calls of the
    loss kernels' forward wrapper (``ops.xent.softmax_xent_forward``)."""
    from cron_operator_tpu_torch.backends.registry import JobContext
    from cron_operator_tpu_torch.ops import xent
    from cron_operator_tpu_torch.workloads import entrypoints
    from cron_operator_tpu_torch.workloads.train import cross_entropy_loss

    forward, lm_loss = xent.softmax_xent_forward, entrypoints.lm_loss
    runs = {}
    for route in ("job", "former"):
        calls = []

        def spy(*args):
            calls.append(1)
            return forward(*args)

        xent.softmax_xent_forward = spy
        if route == "former":
            entrypoints.lm_loss = lambda *a, **k: (False, cross_entropy_loss)
        losses = []
        ctx = JobContext("train", "default", {}, dict(job["params"]))
        ctx.watchdog = _LossBeat(ctx, losses)
        try:
            getattr(entrypoints, job["entry"])(ctx)
        finally:
            xent.softmax_xent_forward, entrypoints.lm_loss = forward, lm_loss
        runs[route] = {"losses": losses, "kernel_calls": len(calls)}
    return {"runs": runs}


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
            run = {"train": _train, "data_parallel": _data_parallel,
                   "moe_group": _moe_group, "moe_expert": _moe_expert,
                   "chain": _chain, "split": _split,
                   "moe": _moe, "refuse": _refuse, "attention": _attention,
                   "body": _body, "hop": _hop, "guards": _guards,
                   "pipe_guards": _pipe_guards,
                   "pipeline": _pipeline, "lm_job": _lm_job,
                   "tensor_restore": _tensor_restore,
                   "tensor_collectives": _tensor_collectives}[job["kind"]]
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
