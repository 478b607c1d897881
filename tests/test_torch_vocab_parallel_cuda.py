"""The vocab-parallel LM loss on cards.

- The loss kernels of ``ops/csrc/xent.cu`` in their slice forms, at the
  slices of GPT-2 small's vocab that ``chip_smoke.py``'s phase 21 holds:
  a ``tensor`` rank's T of 4096 rows and its block of the table (rank 0 and
  rank 1 of 2, ``[4096, 25152]`` with 25152 and 25105 real columns; rank 3
  of 4, ``[4096, 12608]`` with 12433), bf16: each slice's logsumexp within
  ``xent_tolerance`` of its plain version and its label logit the same
  bits; the slices merged within ``merge_tolerance`` of the whole row's
  kernel; each slice's gradient from the merged logsumexp within
  ``xent_tolerance``, exact zeros past its real columns. One card.
- Four ranks of an NCCL process group, one a card, train a GPT (vocab
  1000: each ``tensor`` rank's block of 512 rows, rank 1's ending in
  padding) on the jobs' LM loss under ``data 2 x tensor 2``: calls of 4
  steps replayed from one step captured after ``MESH_GRAPH_WARMUP`` eager
  steps against the same steps in calls of one, the losses and every
  rank's parameters the same bits, the loss kernels launched once a step
  each on the rank's ``[T, 512]`` slice, the padding rows still zero.
  Needs four cards; skips with fewer.
- A block that starts past the vocab's end (no real column) gives -inf,
  0 and zeros, as its plain versions. One card.

It imports only torch and the port: ``python -m pytest --noconftest -m
cuda tests/test_torch_vocab_parallel_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import os
import socket

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cron_operator_tpu_torch.models import GPT, GPTConfig
from cron_operator_tpu_torch.models.layers import vocab_split
from cron_operator_tpu_torch.ops import xent
from cron_operator_tpu_torch.parallel.mesh import (
    TENSOR_AXIS,
    MeshPlan,
    make_mesh,
)
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.entrypoints import lm_loss
from cron_operator_tpu_torch.workloads.train import (
    MESH_GRAPH_WARMUP,
    TrainConfig,
    Trainer,
)

CASE_TIMEOUT_S = 300  # as the other card tests: the first build included
GPT2_VOCAB = 50257
ROWS = 4096
# (tensor ranks, the rank's index)
SLICES = {"rank0_of_2": (2, 0), "rank1_of_2": (2, 1), "rank3_of_4": (4, 3)}
CHUNK = 4
STEPS = MESH_GRAPH_WARMUP + 2 * CHUNK
RANKS = 4
VOCAB = 1000


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the loss kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(t, seed):
    """Seeded bf16 logits ``[ROWS, Vt]`` (3 x standard normal, NaN past the
    vocab, which no kernel may read) and int64 labels in the vocab."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    width = vocab_split(GPT2_VOCAB).padded(t)
    x = torch.randn(ROWS, width, generator=gen, device="cuda").mul_(3)
    x[:, GPT2_VOCAB:] = float("nan")
    y = torch.randint(0, GPT2_VOCAB, (ROWS,), generator=gen, device="cuda")
    return x.to(torch.bfloat16), y


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SLICES))
def test_slice_kernels_hold_their_plain_versions(card, name):
    t, index = SLICES[name]
    split = vocab_split(GPT2_VOCAB)
    per = split.padded(t) // t
    x, y = _inputs(t, seed=t)
    g = torch.full((), 0.37, device=card)
    parts = []
    for r in range(t):
        lo, real = split.offset(r, t)
        piece = x[:, lo:lo + per].contiguous()
        parts.append((piece, lo, real) + xent.softmax_xent_forward(
            piece, y, real, lo, GPT2_VOCAB))
    loss, lse = xent.softmax_xent_forward(x, y, GPT2_VOCAB)
    ref_loss, ref_lse = xent.softmax_xent_forward_reference(x, y, GPT2_VOCAB)
    lses = torch.stack([p[4] for p in parts])
    got_loss, got_lse = xent.merge_slices(lses,
                                          torch.stack([p[3] for p in parts]))
    bounds = xent.merge_tolerance(
        xent.xent_tolerance(x, y, GPT2_VOCAB, ref_loss, ref_lse), lses, lse)
    assert ((got_lse - lse).abs() <= bounds["lse"]).all()
    assert ((got_loss - loss).abs() <= bounds["loss"]).all()

    piece, lo, real, picked, slse = parts[index]
    assert (per, real) == {"rank0_of_2": (25152, 25152),
                           "rank1_of_2": (25152, 25105),
                           "rank3_of_4": (12608, 12433)}[name]
    ref_picked, ref_slse = xent.softmax_xent_forward_reference(
        piece, y, real, lo, GPT2_VOCAB)
    assert torch.equal(picked, ref_picked)
    fwd = xent.xent_tolerance(piece, y, real, ref_picked, ref_slse, lo=lo)
    assert ((slse - ref_slse).abs() <= fwd["lse"]).all()
    dx = xent.softmax_xent_backward(piece, y, got_lse, g, real, lo,
                                    GPT2_VOCAB)
    ref_dx = xent.softmax_xent_backward_reference(piece, y, g, real, lo,
                                                  got_lse)
    bwd = xent.xent_tolerance(piece, y, real, ref_picked, got_lse, g, ref_dx,
                              lo=lo)
    err = (dx[:, :real].float() - ref_dx[:, :real].float()).abs()
    assert (err <= bwd["dlogits"]).all()
    assert not dx[:, real:].any()


@pytest.mark.cuda
def test_a_slice_without_a_real_column(card):
    """A rank whose block starts past the vocab's end (vocab 130 at 4
    ranks: rank 3's 64 columns from 192): the forward gives each row a
    logsumexp of -inf and a label logit of 0 (NaN for a label outside the
    vocab), the backward exact zeros, as the plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(64, 64, generator=gen, device=card).to(torch.bfloat16)
    y = torch.randint(0, 130, (64,), generator=gen, device=card)
    y[0] = 130
    picked, lse = xent.softmax_xent_forward(x, y, 0, 192, 130)
    want = xent.softmax_xent_forward_reference(x, y, 0, 192, 130)
    assert torch.equal(picked.isnan(), want[0].isnan())
    assert torch.equal(picked[1:], want[0][1:]) and not picked[1:].any()
    assert torch.equal(lse, want[1]) and (lse == float("-inf")).all()
    g = torch.ones((), device=card)
    dx = xent.softmax_xent_backward(x, y, torch.zeros(64, device=card), g,
                                    0, 192, 130)
    assert not dx.any()


def _run(mesh, chunk):
    """A GPT (head dim 64 in bf16, vocab 1000) trained over ``mesh`` on the
    LM loss in calls of ``chunk`` steps: the losses, this rank's
    parameters, the steps replayed, the loss kernels' launches and the
    forward kernel's logits shapes."""
    cfg = GPTConfig.tiny(hidden_size=256, max_len=128, vocab_size=VOCAB,
                         return_hidden=True)
    model = GPT(cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(0))
    trainer = Trainer(model, TrainConfig(steps_per_call=chunk), mesh=mesh,
                      loss_fn=lm_loss(mesh)[1])
    shapes, launch = set(), xent._launch_forward

    def traced(logits, labels, real, lo, total):
        shapes.add((*logits.shape, real, lo))
        return launch(logits, labels, real, lo, total)

    xent._launch_forward = traced
    start = [xent.softmax_xent_forward.launches,
             xent.softmax_xent_backward.launches]
    try:
        stats = trainer.run(data.causal_token_batches(4, 128, VOCAB), STEPS)
        torch.cuda.synchronize()
    finally:
        xent._launch_forward = launch
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    launches = [xent.softmax_xent_forward.launches - start[0],
                xent.softmax_xent_backward.launches - start[1]]
    return ([s.loss for s in stats], params, trainer.replayed_steps,
            launches, sorted(shapes))


def _rank(rank, port, out):
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", rank=rank, world_size=RANKS,
                            init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = make_mesh(MeshPlan({"data": 2, TENSOR_AXIS: 2}),
                         device_type="cuda")
        graph = _run(mesh, CHUNK)
        eager = _run(mesh, 1)
        torch.save({"graph": graph, "eager": eager,
                    "index": mesh.get_local_rank(TENSOR_AXIS)},
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
    out = str(tmp_path_factory.mktemp("vocab_cards") / "rank")
    mp.spawn(_rank, args=(port, out), nprocs=RANKS)
    return [torch.load(f"{out}.{r}.pt", weights_only=False)
            for r in range(RANKS)]


@pytest.mark.cuda
def test_captured_vocab_parallel_step_equals_the_eager_step(ranks):
    split = vocab_split(VOCAB)
    for got in ranks:
        graph_losses, graph_params, replayed, graph_xent, shapes = got["graph"]
        eager_losses, eager_params, _, eager_xent, _ = got["eager"]
        assert replayed == STEPS - MESH_GRAPH_WARMUP
        ends = [CHUNK * i - 1 for i in range(1, len(graph_losses))] + [-1]
        assert graph_losses == [eager_losses[i] for i in ends]
        assert graph_losses == ranks[0]["graph"][0]  # the global loss
        for name, value in graph_params.items():
            assert torch.equal(value, eager_params[name]), name
        # once a step each way, replays counted
        assert graph_xent == eager_xent == [STEPS, STEPS]
        # a data rank's 2 rows of 128 tokens, the rank's block of 512 rows
        lo, real = split.offset(got["index"], 2)
        assert shapes == [(2 * 128, 512, real, lo)]
        table = graph_params["tok_emb.weight"]
        assert table.shape == (512, 256)
        assert not table[real:].any()
