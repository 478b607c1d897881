#!/usr/bin/env python3
"""The port's training over a device mesh of one rank per card, on a machine
with several cards.

Run from the root of a checkout::

    python3 hack/torch_mesh_cards.py [N] [--profile NAME] [--only A,B]

``N`` (default: every visible card; 2 or 4) ranks, one per card, join an
NCCL process group and each call the port's ``gpt`` entrypoint on
``chip_smoke.MESH_PARAMS`` (GPT-2 small widths, b 8 x 1024 global, bf16
over f32 parameters, AdamW, ``data=host``, ``steps_per_call=1``, 3 steps)
under each strategy of ``STRATEGIES[N]``. Every mesh trains plain modules
(DDP, FSDP2; under ``tensor`` each rank keeps its heads and its half of
the FFN, the Megatron split; under ``expert`` each rank keeps its 4 of the
MoE blocks' 8 experts, the ranks of an ``expert`` group holding the same
rows and gathering the experts' outputs). The ranks, the one-rank
references, the frozen readings and every check are ``chip_smoke.py``'s
mesh phase's (``spawn_ranks``, ``mesh_references``, ``frozen_readings``,
``mesh_problems``): every rank takes the strategy's path, launches K1, K2
and K3 36 times, all sm90, at the strategy's local (batch, heads),
reports the same losses, and holds the loss gap and the update distance
against one rank's run within ``MESH_LOSS_BOUND`` and
``MESH_UPDATE_BOUND``. The image legs of ``STRATEGIES`` (a job field of
``resnet50`` or ``mnist``) run that job at ``IMAGE_PARAMS`` (its default
global batch, 6 eager steps; ``resnet50`` built in f32 at lr 0.001, as
phase 15 checks it: ``chip_smoke.MESH_IMAGE_PARAMS``) under ``data`` or
``tensor`` (each rank the
MLP's slice of its first pair of hidden layers, or each ResNet block's
slice of its first two convs at its first norm's group boundaries),
against one rank's run and its lr-0 reading, held by
``chip_smoke.image_mesh_problems`` (under ``resnet50`` the GroupNorm
kernels 53 times a step each way, at the rank's shapes and by epilogue).

On four cards it then runs, from ``chip_smoke.py``'s phases 16 and 18:

- ``SEQ_LEGS``: ring ``gpt`` under ``seq`` 2 (two ranks), ``seq`` 4,
  ``data`` 2 x ``seq`` 2 and ``fsdp`` 2 x ``seq`` 2 (the shipped Crons'
  layout), and Ulysses ``bert`` under ``seq`` 2, each on the plain path
  (DDP, or FSDP2 with ``fsdp``) held by ``seq_problems`` (K1-K3 launched by
  the bodies' rule, ``seq_launches``) against one rank's
  ``attention=flash`` run of the same batches (K1-K3 over the whole
  sequence, with its lr-0 reading), the hops over NCCL, the steps eager
  (``steps_per_call=1``);
- ``PIPE_STAGES``: ``spmd_pipeline`` of 2 and of 4 GPT-2-small layers over
  as many ranks, held by ``pipeline_problems`` (``PIPE_REL_BOUND``);
- ``GRAPH_LEGS``: ``data`` 4, ``fsdp`` 4, ring ``seq`` 4, ring ``fsdp``
  2 x ``seq`` 2, ``fsdp`` 2 x ``tensor`` 2, ``data`` 2 x ``tensor`` 2 and
  the MoE GPT under ``data`` 2 x ``expert`` 2 at ``GRAPH_MESH_PARAMS`` (24
  steps in calls of 8: captured over NCCL after ``MESH_GRAPH_WARMUP``
  eager steps, the ring's hops, the ``tensor`` blocks' all-reduces, the
  experts' all-gathers and the other collectives inside the graph,
  replayed) against the same job in
  calls of one step: the losses and every parameter the same bits on every
  rank, K1-K3 by ``seq_launches``, the replayed call's step ms and the
  NCCL kernels in it (and their device ms a step);
- ``IMAGE_GRAPH_LEGS``: ``resnet50`` and ``mnist`` under ``data`` 4 and
  ``data`` 2 x ``tensor`` 2 at ``IMAGE_PARAMS`` in 24 steps of calls of 8,
  captured and replayed as the graph legs (the pairs' all-reduces inside
  the graph), held to the same bits against calls of one step, the
  GroupNorm kernels 53 times a step each way under ``resnet50``.

Every strategy and graph leg also prints each rank's loss kernel launches
(forward, backward), the loss forward kernel's ``[rows, columns, real
columns, first column]`` and each rank's peak memory; under ``tensor`` the
loss runs on the rank's block of the vocab rows
(``chip_smoke.tensor_xent_shape``), which a leg checks.

``--profile NAME`` runs one more step of strategy NAME under
``torch.profiler`` on every rank and prints rank 0's busy share and top
kernels; ``--only`` runs the named runs alone (the references they need
too). It prints one JSON line per run and the card line, and exits
non-zero on a failure. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MOE = {"moe_every": "2", "num_experts": "8"}
STRATEGIES = {
    # N: {name: (params, local (batch, heads), the trainer's path, job)};
    # an image job's local entry is its rows a rank
    4: {"data4": ({"devices": "4"}, (2, 12), "ddp", "gpt"),
        "fsdp4": ({"fsdp": "4"}, (2, 12), "fsdp", "gpt"),
        "fsdp2_tensor2": ({"fsdp": "2", "tensor": "2"}, (4, 6), "fsdp",
                          "gpt"),
        "data2_tensor2": ({"tensor": "2"}, (4, 6), "ddp", "gpt"),
        "data2_expert2": ({**MOE, "expert": "2"}, (4, 12), "ddp", "gpt"),
        "fsdp2_expert2": ({**MOE, "fsdp": "2", "expert": "2"}, (4, 12),
                          "fsdp", "gpt"),
        # the image jobs: their rows over data, or the MLP's first pair and
        # each ResNet block's first two convs over tensor
        "resnet50_data4": ({"devices": "4"}, 32, "ddp", "resnet50"),
        "resnet50_data2_tensor2": ({"tensor": "2"}, 64, "ddp", "resnet50"),
        "mnist_data4": ({"devices": "4"}, 64, "ddp", "mnist"),
        "mnist_data2_tensor2": ({"tensor": "2"}, 128, "ddp", "mnist")},
    2: {"data2": ({"devices": "2"}, (4, 12), "ddp", "gpt"),
        "fsdp2": ({"fsdp": "2"}, (4, 12), "fsdp", "gpt"),
        "tensor2": ({"tensor": "2"}, (8, 6), "ddp", "gpt"),
        "expert2": ({**MOE, "expert": "2"}, (8, 12), "ddp", "gpt"),
        "resnet50_tensor2": ({"tensor": "2"}, 128, "ddp", "resnet50"),
        "mnist_tensor2": ({"tensor": "2"}, 256, "ddp", "mnist")},
}
# The image jobs' params on the cards: each job's default batch (global),
# eager steps (with phase 15's precision and rate for the checks); the graph
# legs' the same as the job runs them (bf16, its lr) in calls of GRAPH_CHUNK
IMAGE_PARAMS = {
    "resnet50": {"batch_size": "128", "image_size": "224", "steps": "6",
                 "data": "host", "steps_per_call": "1"},
    "mnist": {"batch_size": "256", "steps": "6", "data": "host",
              "steps_per_call": "1"}}
# name: (ranks, job, params over MESH_PARAMS); the reference is one rank's
# run of the job at attention=flash (K1-K3 over the whole sequence, the
# arithmetic the bodies run on their blocks)
SEQ_LEGS = {
    "seq2_ring": (2, "gpt", {"attention": "ring", "seq": "2"}),
    "seq4_ring": (4, "gpt", {"attention": "ring", "seq": "4"}),
    "data2_seq2": (4, "gpt", {"attention": "ring", "seq": "2"}),
    # the shipped Crons' layout (fsdp x seq, ring), on four cards
    "fsdp2_seq2": (4, "gpt", {"attention": "ring", "seq": "2", "fsdp": "2"}),
    "seq2_ulysses": (2, "bert", {"seq_len": "512", "attention": "ulysses",
                                 "seq": "2"}),
}
PIPE_STAGES = (2, 4)
# name: params over GRAPH_MESH_PARAMS, K1-K3's local (batch, heads)
GRAPH_LEGS = {"data4_graph": ({"devices": "4"}, (2, 12)),
              "fsdp4_graph": ({"fsdp": "4"}, (2, 12)),
              "seq4_ring_graph": ({"attention": "ring", "seq": "4"}, (8, 12)),
              "fsdp2_seq2_graph": ({"attention": "ring", "seq": "2",
                                    "fsdp": "2"}, (4, 12)),
              # the Megatron blocks, the batch over fsdp or data
              "fsdp2_tensor2_graph": ({"fsdp": "2", "tensor": "2"}, (4, 6)),
              "data2_tensor2_graph": ({"tensor": "2"}, (4, 6)),
              # the MoE GPT's experts over expert, the batch over data
              "data2_expert2_graph": ({**MOE, "expert": "2"}, (4, 12))}
# name: (job, params over IMAGE_PARAMS[job] in calls of GRAPH_CHUNK, rows a
# rank): the image jobs' captured steps, their column/row pairs'
# all-reduces inside the graph under tensor
IMAGE_GRAPH_LEGS = {
    "resnet50_data4_graph": ("resnet50", {"devices": "4"}, 32),
    "resnet50_data2_tensor2_graph": ("resnet50", {"tensor": "2"}, 64),
    "mnist_data4_graph": ("mnist", {"devices": "4"}, 64),
    "mnist_data2_tensor2_graph": ("mnist", {"tensor": "2"}, 128)}
LEG_TIMEOUT_S = 240  # a rank of a leg that runs longer fails the leg


def attempt(name: str, leg) -> bool:
    """``leg()`` (which returns whether it failed); a rank that failed or
    timed out (``chip_smoke.fail``'s exit, the wait's timeout) fails this
    leg alone, and the script goes on to the next. Returns whether it
    failed."""
    try:
        return leg()
    except (SystemExit, subprocess.TimeoutExpired) as err:
        print(json.dumps({"run": name, "problems": [repr(err)]}), flush=True)
        return True


def seq_leg(smoke, torch, root, refs, name) -> bool:
    """One sequence-parallel leg over NCCL (its reference first, once per
    job and params); returns whether it failed."""
    world, job, extra = SEQ_LEGS[name]
    params = {**smoke.MESH_PARAMS, **extra}
    plain = {k: v for k, v in params.items() if k not in ("seq", "fsdp")}
    plain["attention"] = "flash"
    key = json.dumps([job, plain], sort_keys=True)
    if key not in refs:
        (ref,) = smoke.spawn_ranks(1, plain, root, f"ref_{name}", task=job,
                                   timeout=LEG_TIMEOUT_S)
        frozen = smoke.frozen_reading(torch, {"ref": ref}, root, plain,
                                      "ref", job)
        refs[key] = ref
        print(json.dumps({"run": f"one rank ({job}, attention=flash)",
                          "losses": ref["losses"],
                          "step_ms": ref["step_s"] * 1e3, "lr0": frozen}),
              flush=True)
    ranks = smoke.spawn_ranks(world, params, root, name, backend="nccl",
                              cards=world, task=job, timeout=LEG_TIMEOUT_S)
    problems, (gap, dist) = smoke.seq_problems(torch, ranks, refs[key])
    got = ranks[0]
    print(json.dumps({
        "run": name, "cards": world, "job": job, "params": extra,
        "losses": got["losses"], "loss_gap": gap, "update_distance": dist,
        "step_ms": got["step_s"] * 1e3, "tokens_per_s": got["tokens_per_s"],
        "body_device_ms": got["body_device_ms"],
        "step_device_ms": got["step_device_ms"],
        "body_share": got["body_share"],
        "body_split_ms": got["body_split_ms"],
        "by_mask": [r["by_mask"] for r in ranks],
        "cron": [r["cron"] for r in ranks if "cron" in r],
        "peak_gib": max(r["peak_gib"] for r in ranks),
        "problems": problems}), flush=True)
    return bool(problems)


def pipe_leg(smoke, stages, root) -> bool:
    """``spmd_pipeline`` over ``stages`` ranks; returns whether it
    failed."""
    ranks = smoke.spawn_ranks(stages, {}, root, f"pipe{stages}",
                              backend="nccl", cards=stages, task="pipeline",
                              timeout=LEG_TIMEOUT_S)
    problems = smoke.pipeline_problems(ranks, stages)
    print(json.dumps({
        "run": f"pipe{stages}", "cards": stages,
        "launches_per_rank": ranks[0]["counts"],
        **{k: max(r[k] for r in ranks)
           for k in ("y", "x_grad", "stage_grads")},
        "other_layers": min(r["other_layer"] for r in ranks),
        "bound": smoke.PIPE_REL_BOUND, "problems": problems}), flush=True)
    return bool(problems)


def local_tokens(extra: dict) -> int:
    """A rank's tokens of the b 8 x 1024 global batch on four cards: the
    batch and ``seq`` axes split them, the ``tensor`` and ``expert`` ranks
    hold the same ones."""
    same = int(extra.get("tensor", 1)) * int(extra.get("expert", 1))
    return 8 * 1024 // (4 // same)


def xent_problems(smoke, name, ranks, rows) -> list:
    """Under a ``tensor`` axis of t ranks (t from the leg's params), the
    loss kernels on each rank's block of GPT-2 small's vocab rows at
    ``rows`` tokens (the ``tensor`` index is the rank's last coordinate);
    else at the whole padded vocab."""
    params = dict(STRATEGIES.get(4, {}).get(name, ({},))[0],
                  **GRAPH_LEGS.get(name, ({},))[0])
    t = int(params.get("tensor", 1))
    problems = []
    for r, got in enumerate(ranks):
        want = (smoke.tensor_xent_shape(rows, t, r % t) if t > 1
                else [rows, 50304, smoke.GPT2_VOCAB, 0])
        if got["xent_shapes"] != [want]:
            problems.append(f"rank {r}: the loss kernels at "
                            f"{got['xent_shapes']}, not {want}")
    return problems


def xent_readings(ranks) -> dict:
    """Each rank's loss kernel launches, shapes and peak memory."""
    return {"xent_launches": [r["xent"] for r in ranks],
            "xent_shapes": [r["xent_shapes"] for r in ranks],
            "peak_gib_by_rank": [r["peak_gib"] for r in ranks]}


def graph_leg(smoke, name, root) -> bool:
    """A captured meshed step on four cards against its eager run; returns
    whether it failed."""
    from cron_operator_tpu_torch.workloads.train import MESH_GRAPH_WARMUP

    extra, local = GRAPH_LEGS[name]
    ranks = smoke.spawn_ranks(4, {**smoke.GRAPH_MESH_PARAMS, **extra}, root,
                              name, backend="nccl", cards=4, task="graph",
                              timeout=LEG_TIMEOUT_S)
    problems = []
    for r, got in enumerate(ranks):
        ends = got["eager_losses"][smoke.GRAPH_CHUNK - 1::smoke.GRAPH_CHUNK]
        if got["losses"] != ends or not got["same_bits"]:
            problems.append(f"rank {r}: graphed losses {got['losses']} "
                            f"against eager {ends}, parameters the same "
                            f"bits: {got['same_bits']}")
        # the wrappers count every replay; the launchers' Python calls
        # (by mask) are the eager steps' and the capture's alone
        want = sum(smoke.seq_launches(got, smoke.GRAPH_MESH_STEPS))
        calls = smoke.seq_launches(got, MESH_GRAPH_WARMUP + 1)
        if got["counts"] != [want] * 3 or got["by_mask"] != [calls] * 3 or {
                tuple(x[1:]) for x in got["shapes"]} != {local}:
            problems.append(f"rank {r}: K1/K2/K3 {got['counts']}, not "
                            f"{want} each, launcher calls [full, causal] "
                            f"{got['by_mask']}, not {calls} each, at "
                            f"{got['shapes']}")
        if got["replayed"] != smoke.GRAPH_MESH_STEPS - MESH_GRAPH_WARMUP:
            problems.append(f"rank {r}: {got['replayed']} steps replayed")
        if got["path"] not in ("ddp", "fsdp"):
            problems.append(f"rank {r} trained on the {got['path']} path")
        if got["losses"] != ranks[0]["losses"]:
            problems.append(f"rank {r} reports other losses")
        if got["xent"] != [smoke.GRAPH_MESH_STEPS] * 2:
            problems.append(f"rank {r}: loss kernels {got['xent']}")
    problems += xent_problems(smoke, name, ranks, local_tokens(extra))
    nccl_ms = sum(ms for ms, _ in ranks[0]["nccl"].values())
    print(json.dumps({
        "run": name, "cards": 4, "params": extra, "warmup": MESH_GRAPH_WARMUP,
        "path": ranks[0]["path"], "counts": [r["counts"] for r in ranks],
        "by_mask": [r["by_mask"] for r in ranks],
        "replayed": ranks[0]["replayed"], "losses": ranks[0]["losses"],
        "step_ms": ranks[0]["step_ms"],
        "kernel_ms_per_step": ranks[0]["busy_ms"], "nccl": ranks[0]["nccl"],
        "nccl_ms_per_step": nccl_ms / smoke.GRAPH_CHUNK,
        "peak_gib": ranks[0]["peak_gib"], **xent_readings(ranks),
        "problems": problems}), flush=True)
    return bool(problems)


def image_leg(smoke, torch, root, refs, name, n, profiled) -> bool:
    """An image job's strategy over NCCL on ``n`` cards (its one-rank
    reference and lr-0 reading first, once per job), held by
    ``chip_smoke.image_mesh_problems``; returns whether it failed."""
    extra, rows, path, job = STRATEGIES[n][name]
    # the checks' precision and rate, as chip_smoke's phase 15 reads them
    params = {**IMAGE_PARAMS[job], **{
        k: v for k, v in smoke.MESH_IMAGE_PARAMS[job].items()
        if k in ("lr", smoke.IMAGE_COMPUTE)}}
    if job not in refs:
        (ref,) = smoke.spawn_ranks(1, params, root, f"ref_{job}", task=job,
                                   timeout=LEG_TIMEOUT_S)
        frozen = smoke.frozen_reading(torch, {job: ref}, root, params, job,
                                      job)
        refs[job] = ref
        print(json.dumps({"run": f"one rank ({job})", "losses": ref["losses"],
                          "step_ms": ref["step_s"] * 1e3,
                          "peak_gib": ref["peak_gib"], "lr0": frozen}),
              flush=True)
    ranks = smoke.spawn_ranks(n, {**params, **extra}, root, name,
                              backend="nccl", cards=n, task=job,
                              profile=name == profiled, timeout=LEG_TIMEOUT_S)
    dtype = params.get(smoke.IMAGE_COMPUTE, "bfloat16")
    problems, readings = smoke.image_mesh_problems(
        torch, ranks, refs[job], job, int(params["steps"]), rows,
        "tensor" in extra, path, dtype)
    print(json.dumps({
        "run": name, "cards": n, "job": job, "params": extra, "dtype": dtype,
        "path": ranks[0]["path"], "rows_per_rank": rows,
        "losses": ranks[0]["losses"], **readings,
        "step_ms": ranks[0]["step_s"] * 1e3,
        "norms_per_rank": ranks[0]["norms"],
        "norm_shapes": ranks[0]["norm_shapes"],
        "peak_gib_by_rank": [r["peak_gib"] for r in ranks],
        "problems": problems}), flush=True)
    if "profile" in ranks[0]:
        print(f"{name}, rank 0 of {n}:\n{ranks[0]['profile']}", flush=True)
    return bool(problems)


def image_graph_leg(smoke, name, root) -> bool:
    """An image job's captured meshed step on four cards against its eager
    run (the losses and every parameter the same bits), its GroupNorm
    kernels 53 times a step each way under resnet50 (a replay counted
    once); returns whether it failed."""
    from cron_operator_tpu_torch.workloads.train import MESH_GRAPH_WARMUP

    job, extra, rows = IMAGE_GRAPH_LEGS[name]
    steps = smoke.GRAPH_MESH_STEPS
    params = {**IMAGE_PARAMS[job], "steps": str(steps),
              "steps_per_call": str(smoke.GRAPH_CHUNK), **extra}
    ranks = smoke.spawn_ranks(4, params, root, name, backend="nccl", cards=4,
                              task=f"graph:{job}", timeout=LEG_TIMEOUT_S)
    per_step = (sum(n for _, _, n in smoke.RESNET50_NORMS)
                if job == "resnet50" else 0)
    problems = []
    for r, got in enumerate(ranks):
        ends = got["eager_losses"][smoke.GRAPH_CHUNK - 1::smoke.GRAPH_CHUNK]
        if got["losses"] != ends or not got["same_bits"]:
            problems.append(f"rank {r}: graphed losses {got['losses']} "
                            f"against eager {ends}, parameters the same "
                            f"bits: {got['same_bits']}")
        if got["replayed"] != steps - MESH_GRAPH_WARMUP:
            problems.append(f"rank {r}: {got['replayed']} steps replayed")
        if got["path"] not in ("ddp", "fsdp"):
            problems.append(f"rank {r} trained on the {got['path']} path")
        if got["losses"] != ranks[0]["losses"]:
            problems.append(f"rank {r} reports other losses")
        if got["whole_digest"] != ranks[0]["whole_digest"]:
            problems.append(f"rank {r}'s whole parameters are not rank 0's "
                            "bits")
        if got["norms"] != [per_step * steps] * 2:
            problems.append(f"rank {r}: GroupNorm kernels {got['norms']}, "
                            f"not {per_step * steps} each way")
    nccl_ms = sum(ms for ms, _ in ranks[0]["nccl"].values())
    print(json.dumps({
        "run": name, "cards": 4, "job": job, "params": extra,
        "rows_per_rank": rows, "warmup": MESH_GRAPH_WARMUP,
        "path": ranks[0]["path"], "norms": [r["norms"] for r in ranks],
        "replayed": ranks[0]["replayed"], "losses": ranks[0]["losses"],
        "step_ms": ranks[0]["step_ms"],
        "kernel_ms_per_step": ranks[0]["busy_ms"], "nccl": ranks[0]["nccl"],
        "nccl_ms_per_step": nccl_ms / smoke.GRAPH_CHUNK,
        "peak_gib_by_rank": [r["peak_gib"] for r in ranks],
        "problems": problems}), flush=True)
    return bool(problems)


def main(argv) -> int:
    import torch

    import chip_smoke as smoke
    from cron_operator_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        sys.exit("needs CUDA cards")
    opts = {a: argv[argv.index(a) + 1] for a in ("--profile", "--only")
            if a in argv}
    args = [a for a in argv if a not in opts and a not in opts.values()]
    profiled = opts.get("--profile")
    only = set(opts["--only"].split(",")) if "--only" in opts else None

    def wanted(name):
        return only is None or name in only

    n = int(args[0]) if args else torch.cuda.device_count()
    if n not in STRATEGIES or n > torch.cuda.device_count():
        sys.exit(f"needs 2 or 4 visible cards, asked for {n} of "
                 f"{torch.cuda.device_count()}")
    _build.build_all()  # once, before the ranks load the libraries
    card = smoke.card_line()
    failed = False
    root = tempfile.mkdtemp(prefix="mesh-cards-")
    try:
        strategies = {k: v for k, v in STRATEGIES[n].items()
                      if wanted(k) and v[3] == "gpt"}
        images = [k for k, v in STRATEGIES[n].items()
                  if wanted(k) and v[3] != "gpt"]
        refs = smoke.mesh_references(strategies, root) if strategies else {}
        for kind, ref in refs.items():
            print(json.dumps({"run": f"one rank ({kind})",
                              "losses": ref["losses"],
                              "step_ms": ref["step_s"] * 1e3,
                              "tokens_per_s": ref["tokens_per_s"]}),
                  flush=True)
        for kind, frozen in smoke.frozen_readings(torch, refs,
                                                  root).items():
            print(json.dumps({"run": f"one rank at lr 0 ({kind}, frozen)",
                              **frozen}), flush=True)

        def strategy(name, extra, local, path):
            ranks = smoke.spawn_ranks(
                n, {**smoke.MESH_PARAMS, **extra}, root, name,
                backend="nccl", cards=n, profile=name == profiled,
                timeout=LEG_TIMEOUT_S)
            ref = refs["moe" if "moe_every" in extra else "dense"]
            problems, readings = smoke.mesh_problems(torch, ranks, ref, local,
                                                     path)
            if n == 4:
                problems += xent_problems(smoke, name, ranks,
                                          local_tokens(extra))
            print(json.dumps({
                "run": name, "cards": n, "params": extra,
                "path": ranks[0]["path"],
                "local_batch_heads": local,
                "launches_per_rank": ranks[0]["counts"],
                "losses": ranks[0]["losses"], **readings,
                "step_ms": ranks[0]["step_s"] * 1e3,
                "tokens_per_s": ranks[0]["tokens_per_s"],
                **xent_readings(ranks), "problems": problems}), flush=True)
            if "profile" in ranks[0]:
                print(f"{name}, rank 0 of {n}:\n{ranks[0]['profile']}",
                      flush=True)
            return bool(problems)

        for name, (extra, local, path, _) in strategies.items():
            failed |= attempt(name, lambda: strategy(name, extra, local,
                                                     path))
        image_refs = {}
        for name in images:
            failed |= attempt(name, lambda: image_leg(
                smoke, torch, root, image_refs, name, n, profiled))
        if n == 4:
            seq_refs = {}
            for name in filter(wanted, SEQ_LEGS):
                failed |= attempt(name, lambda: seq_leg(
                    smoke, torch, root, seq_refs, name))
            for stages in PIPE_STAGES:
                if wanted(f"pipe{stages}"):
                    failed |= attempt(f"pipe{stages}", lambda: pipe_leg(
                        smoke, stages, root))
            for name in filter(wanted, GRAPH_LEGS):
                failed |= attempt(name, lambda: graph_leg(smoke, name, root))
            for name in filter(wanted, IMAGE_GRAPH_LEGS):
                failed |= attempt(name, lambda: image_graph_leg(
                    smoke, name, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"card: {card}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
