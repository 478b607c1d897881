"""The plain ``tensor`` path on cards: two ranks of an NCCL process group,
one a card, train a GPT whose blocks keep their heads and their half of
the FFN (``parallel.mesh.split_over_tensor``, the Megatron layout), the
blocks' partial sums and their inputs' gradients summed by the pair of
collectives inside the step:

- calls of 4 steps replayed from one step captured over NCCL after
  ``MESH_GRAPH_WARMUP`` eager steps, against the same steps in calls of one
  (every step eager): the losses and every rank's pieces the same bits;
  K1-K3 launched at the local heads;
- a row-parallel ``Linear`` (``Linear(x, tensor_group=)``) in bf16 on
  the card gives the whole layer's output within one bf16 rounding of its
  magnitude, its bias added once (twice would move it by the bias).

Needs two CUDA cards and nvcc; skips with fewer. It imports only torch and
the port: ``python -m pytest --noconftest -m cuda
tests/test_torch_tensor_plain_cuda.py``.
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
from cron_operator_tpu_torch.models.layers import Linear
from cron_operator_tpu_torch.parallel.mesh import (
    TENSOR_AXIS,
    MeshPlan,
    TensorSplit,
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


def _run(mesh, chunk):
    """A GPT (head dim 64 in bf16: the sm90 kernels; 4 heads, 2 a rank)
    trained over ``mesh`` in calls of ``chunk`` steps: the losses, this
    rank's parameters, the steps replayed and K1's launches."""
    # the module, not the function that ``ops`` exports under its name
    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

    cfg = GPTConfig.tiny(hidden_size=256, max_len=128)
    model = GPT(cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(0))
    trainer = Trainer(model, TrainConfig(steps_per_call=chunk), mesh=mesh)
    start = fa.flash_attention.launches
    stats = trainer.run(data.causal_token_batches(2, 128, cfg.vocab_size),
                        STEPS)
    torch.cuda.synchronize()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return ([s.loss for s in stats], params, trainer.replayed_steps,
            fa.flash_attention.launches - start)


def _row_parallel(group, rank):
    """A seeded bf16 ``Linear(512, 256)`` whole and as this rank's
    row-parallel piece, on the same seeded input: both outputs, f32."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    whole = Linear(512, 256, compute_dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        whole.weight.copy_(torch.randn(256, 512, generator=gen,
                                       device="cuda") / 512 ** 0.5)
        whole.bias.copy_(4 + torch.randn(256, generator=gen, device="cuda"))
    x = torch.randn(64, 512, generator=gen, device="cuda")
    piece = Linear(512 // RANKS, 256, compute_dtype=torch.bfloat16,
                   device="cuda")
    with torch.no_grad():
        piece.weight.copy_(TensorSplit(1).local(whole.weight, rank, RANKS))
        piece.bias.copy_(whole.bias)
    got = piece(TensorSplit(1).local(x, rank, RANKS), tensor_group=group)
    return got.float().cpu(), whole(x).float().cpu()


def _rank(rank, port, out):
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", rank=rank, world_size=RANKS,
                            init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = make_mesh(MeshPlan({"data": 1, TENSOR_AXIS: RANKS}),
                         device_type="cuda")
        graph = _run(mesh, CHUNK)
        eager = _run(mesh, 1)
        row = _row_parallel(mesh.get_group(TENSOR_AXIS), rank)
        torch.save({"graph": graph, "eager": eager, "row": row},
                   f"{out}.{rank}.pt")
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
    out = str(tmp_path_factory.mktemp("tensor_cards") / "rank")
    mp.spawn(_rank, args=(port, out), nprocs=RANKS)
    return [torch.load(f"{out}.{r}.pt", weights_only=False)
            for r in range(RANKS)]


@pytest.mark.cuda
def test_captured_tensor_step_equals_the_eager_step(ranks):
    for got in ranks:
        graph_losses, graph_params, replayed, graph_k1 = got["graph"]
        eager_losses, eager_params, _, eager_k1 = got["eager"]
        assert replayed == STEPS - MESH_GRAPH_WARMUP
        ends = [CHUNK * i - 1 for i in range(1, len(graph_losses))] + [-1]
        assert graph_losses == [eager_losses[i] for i in ends]
        assert graph_losses == ranks[0]["graph"][0]  # the global loss
        for name, value in graph_params.items():
            assert torch.equal(value, eager_params[name]), name
        # two layers, one launch a layer and step, replays counted
        assert graph_k1 == eager_k1 == 2 * STEPS
    qkv = ranks[0]["graph"][1]["layers.0.attn.qkv.weight"]
    assert qkv.shape == (3 * 2 * 64, 256)  # 2 of the 4 heads of q, k, v


@pytest.mark.cuda
def test_a_row_parallel_bias_is_added_once(ranks):
    for got in ranks:
        piece, whole = got["row"]
        torch.testing.assert_close(piece, whole, rtol=0,
                                   atol=2 ** -7 * whole.abs().max().item())
