"""The plain ``expert`` path on cards: two ranks of an NCCL process group,
one a card, train a GPT with Switch-MoE blocks whose experts split over
``expert`` (``parallel.mesh.split_over_tensor``: each rank keeps 2 of the
4 experts' ``wi`` and ``wo``, the router and every other parameter whole),
both ranks on the same rows, the experts' outputs gathered over the pair
inside the step:

- calls of 4 steps replayed from one step captured over NCCL after
  ``MESH_GRAPH_WARMUP`` eager steps, against the same steps in calls of one
  (every step eager): the losses and every rank's parameters the same
  bits, the whole ones the same bits on both ranks;
- K1, K2 and K3 launched once a layer and step, at the local shape: every
  row of the batch (the ranks of an ``expert`` group hold the same rows)
  and every head.

Needs two CUDA cards and nvcc; skips with fewer. It imports only torch and
the port: ``python -m pytest --noconftest -m cuda
tests/test_torch_expert_plain_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import importlib
import os
import socket

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cron_operator_tpu_torch.models import GPT, GPTConfig
from cron_operator_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    MeshPlan,
    make_mesh,
)
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.train import (
    MESH_GRAPH_WARMUP,
    TrainConfig,
    Trainer,
)

CASE_TIMEOUT_S = 300  # as the other card tests: the first build included
CHUNK = 4
STEPS = MESH_GRAPH_WARMUP + 2 * CHUNK
RANKS = 2
BATCH, SEQ = 2, 128
LAUNCHERS = ("_launch", "_launch_dq", "_launch_dkv")


def _run(mesh, chunk):
    """A GPT (head dim 64 in bf16: the sm90 kernels; 4 heads; every second
    block 4 experts) trained over ``mesh`` in calls of ``chunk`` steps: the
    losses, this rank's parameters, the steps replayed, and K1-K3's
    launches and the (batch, heads) they launched at."""
    # the module, not the function that ``ops`` exports under its name
    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

    cfg = GPTConfig.tiny(hidden_size=256, max_len=SEQ, moe_every=2,
                         num_experts=4)
    model = GPT(cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(0))
    trainer = Trainer(model, TrainConfig(steps_per_call=chunk,
                                         aux_loss_in_output=True), mesh=mesh)
    wrappers = (fa.flash_attention, fa.flash_attention_dq,
                fa.flash_attention_dkv)
    start = [fn.launches for fn in wrappers]
    shapes, inner = set(), {a: getattr(fa, a) for a in LAUNCHERS}
    for attr, launch in inner.items():
        def traced(q, *args, _launch=launch):
            shapes.add((q.shape[0], q.shape[2]))
            return _launch(q, *args)
        setattr(fa, attr, traced)
    try:
        stats = trainer.run(data.causal_token_batches(BATCH, SEQ,
                                                      cfg.vocab_size), STEPS)
    finally:
        for attr, launch in inner.items():
            setattr(fa, attr, launch)
    torch.cuda.synchronize()
    # on the host: the test holds the two ranks' parameters side by side
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return ([s.loss for s in stats], params, trainer.replayed_steps,
            [fn.launches - s for fn, s in zip(wrappers, start)],
            sorted(shapes))


def _rank(rank, port, out):
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", rank=rank, world_size=RANKS,
                            init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = make_mesh(MeshPlan({"data": 1, EXPERT_AXIS: RANKS}),
                         device_type="cuda")
        graph = _run(mesh, CHUNK)
        eager = _run(mesh, 1)
        torch.save({"graph": graph, "eager": eager}, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if torch.cuda.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} CUDA cards: NCCL takes one rank a card "
                    "and CUDA graphs have no CPU mode")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = str(tmp_path_factory.mktemp("expert_cards") / "rank")
    mp.spawn(_rank, args=(port, out), nprocs=RANKS)
    return [torch.load(f"{out}.{r}.pt", weights_only=False)
            for r in range(RANKS)]


@pytest.mark.cuda
def test_captured_expert_step_equals_the_eager_step(ranks):
    for got in ranks:
        graph_losses, graph_params, replayed = got["graph"][:3]
        eager_losses, eager_params = got["eager"][:2]
        assert replayed == STEPS - MESH_GRAPH_WARMUP
        ends = [CHUNK * i - 1 for i in range(1, len(graph_losses))] + [-1]
        assert graph_losses == [eager_losses[i] for i in ends]
        assert graph_losses == ranks[0]["graph"][0]  # the global loss
        for name, value in graph_params.items():
            assert torch.equal(value, eager_params[name]), name
    wi = ranks[0]["graph"][1]["layers.1.moe.wi"]
    assert wi.shape == (2, 256, 512)  # 2 of the 4 experts
    for name, value in ranks[0]["graph"][1].items():
        if ".moe.w" not in name:  # whole: the same bits on both ranks
            assert torch.equal(value, ranks[1]["graph"][1][name]), name


@pytest.mark.cuda
def test_expert_kernels_launch_at_the_local_shape(ranks):
    """Two layers, one K1, K2 and K3 launch a layer and step, replays
    counted; every launch at the whole batch's rows and all 4 heads."""
    for got in ranks:
        for run in (got["graph"], got["eager"]):
            launches, shapes = run[3:]
            assert launches == [2 * STEPS] * 3
            assert shapes == [(BATCH, 4)]
