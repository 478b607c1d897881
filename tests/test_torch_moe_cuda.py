"""Switch-MoE on the card: the MoE GPT's training step captured as a CUDA
graph and replayed against the eager step, its decode step's graph against
the eager decode loop, ``moe_ffn`` on the card against its CPU result, and
its index path (dispatch and combine gathered by token index) against the
dense one-hot formulation ``moe_ffn_reference``.

Needs a CUDA card and nvcc (the flash kernels have no CPU mode, and a CUDA
graph needs a card); skips without one. It imports only torch and the
port, so it also runs where JAX is not installed: ``python -m pytest
--noconftest -m cuda tests/test_torch_moe_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import importlib
from dataclasses import replace

import pytest
import torch

from cron_operator_tpu_torch.models import GPT, GPTConfig
from cron_operator_tpu_torch.parallel import moe as port_moe
from cron_operator_tpu_torch.parallel.moe import (
    _capacity,
    init_moe_params,
    moe_ffn,
    moe_ffn_reference,
    router_top1,
)
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.generate import generate
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

CASE_TIMEOUT_S = 300  # as the kernel card tests: the first build included
STEPS = 6
# head dim 64 in bf16: the sm90 kernels; seq 128 takes the flash path;
# layers 1 and 3 of 4 are MoE blocks of 4 experts
CFG = GPTConfig.tiny(hidden_size=256, num_layers=4, max_len=128, moe_every=2,
                     num_experts=4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no "
                    "CPU mode")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _train(batches, graphed: bool):
    """STEPS steps from seed-0 weights, as one replayed graph or as eager
    steps. Returns the last loss, the parameters and the K1 launches."""
    model = GPT(CFG, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(0))
    trainer = Trainer(model, TrainConfig(lr_schedule="cosine",
                                         schedule_steps=STEPS,
                                         aux_loss_in_output=True))
    before = fa.flash_attention.launches
    if graphed:
        loss = trainer.step(list(batches)).loss
        assert trainer._graph is not None and trainer._graph.replays == STEPS - 1
    else:
        loss = [trainer.step(b).loss for b in batches][-1]
    torch.cuda.synchronize()
    return (loss, dict(model.named_parameters()),
            fa.flash_attention.launches - before)


@pytest.mark.cuda
def test_moe_graph_replay_matches_the_eager_step(cuda_device):
    """The routing and the index build (argmax, cumsum, a scatter into a
    buffer with a spare entry) read nothing on the host, so the MoE step
    captures; replayed it gives the eager steps' loss and parameters to
    the bit, with K1 launched once a layer a step."""
    sample = data.causal_token_sample(2, 128, CFG.vocab_size)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [sample(gen) for _ in range(STEPS)]
    eager = _train(batches, graphed=False)
    graphed = _train(batches, graphed=True)
    assert eager[0] == graphed[0]
    for n, p in eager[1].items():
        assert torch.equal(p, graphed[1][n]), n
    assert eager[2] == graphed[2] == CFG.num_layers * STEPS


@pytest.mark.cuda
def test_moe_decode_graph_matches_the_eager_loop(cuda_device):
    """Generation through the captured MoE decode step (capture, then
    replays only) gives the eager loop's greedy tokens."""
    cfg = replace(CFG, max_len=192)
    model = GPT(cfg, device="cuda", param_dtype=cfg.dtype)
    model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
    prompt = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    eager = [generate(cfg, model, prompt, 16, captured=False)
             for _ in range(2)]
    graphed = [generate(cfg, model, prompt, 16) for _ in range(2)]
    for a, b in zip(eager, graphed):
        assert a.shape == (4, 144)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda_device, dtype):
    """The same inputs on the card and on the CPU: the same routes (the
    dispatch from f32 routing over the same values), outputs within the
    compute dtype's rounding (f32: summation order, 1e-5 of the largest
    output; bf16: 2^-7 relative plus 2^-7 of the largest output, two
    roundings of bf16 products accumulated in f32) and the aux within
    1e-6."""
    gen = torch.Generator().manual_seed(0)
    params = init_moe_params(gen, d_model=256, d_ff=1024, n_experts=8)
    x = torch.randn(2048, 256, generator=gen).to(dtype)
    cap = _capacity(2048, 8, 1.25)
    routes = [router_top1(x.to(dev).float() @ params["router"].to(dev),
                          cap)[1].cpu() for dev in ("cpu", "cuda")]
    assert torch.equal(*routes)
    y_cpu, aux_cpu = moe_ffn(params, x)
    y, aux = moe_ffn({k: v.cuda() for k, v in params.items()}, x.cuda())
    y = y.cpu().float()
    y_cpu = y_cpu.float()
    assert torch.isfinite(y).all()
    scale = y_cpu.abs().max().item()
    if dtype == torch.float32:
        bound = 1e-5 * scale
    else:
        bound = 2 ** -7 * y_cpu.abs() + 2 ** -7 * scale
    assert ((y - y_cpu).abs() <= bound).all()
    assert abs(aux.item() - aux_cpu.item()) <= 1e-6


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [0.5, 1.25], ids=["dropped", "default"])
def test_index_path_is_the_dense_path_to_the_bit(cuda_device, monkeypatch,
                                                 factor):
    """bf16 over f32 parameters at 2048 tokens and 8 experts: the output,
    and dX through the dispatch (both paths route detached logits, so the
    router's path adds nothing to dX), are the dense products' bits: each
    of their rows has one non-zero term, which cuBLAS accumulates in f32
    and rounds once, as the gathers' bf16 product does."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_moe_params(gen, d_model=256, d_ff=1024, n_experts=8)
    x = torch.randn(2048, 256, generator=gen, device="cuda").bfloat16()
    real = port_moe.router_top1_indices
    monkeypatch.setattr(port_moe, "router_top1_indices",
                        lambda lg, c: real(lg.detach(), c))

    def run(fn):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        xl = x.clone().requires_grad_()
        y, _ = fn(leaves, xl, capacity_factor=factor,
                  compute_dtype=torch.bfloat16)
        (y.float() ** 2).mean().backward()
        return y.detach(), xl.grad, leaves["wo"].grad

    index, dense = run(moe_ffn), run(moe_ffn_reference)
    assert torch.isfinite(index[0].float()).all()
    assert index[0].abs().max() > 0 and index[1].abs().max() > 0
    for got, want in zip(index, dense):
        assert torch.equal(_bits(got), _bits(want))
    again = run(moe_ffn)
    for got, want in zip(again, index):
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_moe_greedy_tokens_are_the_dense_paths(cuda_device, monkeypatch):
    """The MoE GPT's greedy continuation (eager) on the index path and with
    the dense formulation swapped into ``MoEBlock``: the same tokens."""
    gpt = importlib.import_module("cron_operator_tpu_torch.models.gpt")
    model = GPT(CFG, device="cuda", param_dtype=CFG.dtype)
    model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
    prompt = torch.randint(0, CFG.vocab_size, (4, 64), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    index = generate(CFG, model, prompt, 16, captured=False)
    monkeypatch.setattr(gpt, "moe_ffn", moe_ffn_reference)
    dense = generate(CFG, model, prompt, 16, captured=False)
    assert index.shape == (4, 80)
    assert torch.equal(index, dense)
