"""The residual add folded into the LayerNorm kernels, and the prefill
graphs' bookkeeping, on the CPU.

``ops.layer_norm.add_layer_norm`` (``s = x + r`` and the norm of s in one
Function) is, on a CPU tensor, torch's add followed by ``layer_norm`` to
the bit: s, y and the gradients of x, r, gamma and beta, in bf16 and f32,
with s feeding a later op or not. ``layer_norm_tolerance`` with
``dx_norm`` admits the folded dx rounded once from f64 (the kernel's
rounding) against the plain version's two roundings. GPT (dense and MoE),
BERT and ViT, whose blocks now leave each residual add to the norm after
it (``models.gpt.fold_blocks``), give the logits and gradients of the
blocks run one by one with torch's adds, to the bit; a ``DecoderLayer``
called alone keeps its ``(x, aux)`` contract; on a DTensor the add stays
torch's and the norm takes each rank's own rows (the unfolded arithmetic).
JAX parity of the folded models is held by ``tests/test_torch_gpt.py``,
``test_torch_moe.py``, ``test_torch_bert.py``, ``test_torch_vit.py`` and
``test_torch_generate.py``, which run through the fold.

The serving entries (``workloads.generate._decoder``): which entry a call
takes, the prefill graphs an entry keeps per prompt length in LRU order up
to ``_PREFILLS_CAP``, a dead model's entry dropped; no card is touched
(the graphs are built, never called).
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import gc
import importlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from cron_operator_tpu_torch.models import (
    GPT,
    Bert,
    BertConfig,
    GPTConfig,
    ViT,
    ViTConfig,
)
from cron_operator_tpu_torch.models.gpt import DecoderLayer
from cron_operator_tpu_torch.models.layers import LayerNorm

ln = importlib.import_module("cron_operator_tpu_torch.ops.layer_norm")
layers = importlib.import_module("cron_operator_tpu_torch.models.layers")
serving = importlib.import_module("cron_operator_tpu_torch.workloads.generate")

EPS = 1e-6
H = 128


def _tensors(dtype, param_dtype=torch.float32, rows=(2, 6), seed=0):
    """Seeded x, r, dy, ds in ``dtype`` and gamma, beta in
    ``param_dtype``."""
    rng = np.random.default_rng(seed)
    x, r, dy, ds = (torch.from_numpy(
        rng.standard_normal((*rows, H)).astype(np.float32)).to(dtype)
        for _ in range(4))
    gamma = torch.from_numpy(
        (1 + 0.1 * rng.standard_normal(H)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.standard_normal(H)).astype(np.float32))
    return x, r, dy, ds, gamma.to(param_dtype), beta.to(param_dtype)


def _grads(fn, x, r, gamma, beta, dy, ds):
    """``fn``'s (s, y) and the gradients of x, r, gamma, beta under
    ``(s, y)`` seeded with ``(ds, dy)`` (ds None: s feeds nothing)."""
    leaves = [t.clone().requires_grad_() for t in (x, r, gamma, beta)]
    s, y = fn(*leaves)
    if ds is None:
        y.backward(dy)
    else:
        torch.autograd.backward((s, y), (ds, dy))
    return (s.detach(), y.detach(), *(t.grad for t in leaves))


def _unfolded(x, r, gamma, beta):
    s = x + r
    return s, ln.layer_norm(s, gamma, beta, eps=EPS)


def _folded(x, r, gamma, beta):
    return ln.add_layer_norm(x, r, gamma, beta, eps=EPS)


@pytest.mark.parametrize("residual_grad", [True, False], ids=["ds", "no_ds"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_params", "bf16_params"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_fold_is_add_then_layer_norm_to_the_bit(dtype, param_dtype,
                                                      residual_grad):
    x, r, dy, ds, gamma, beta = _tensors(dtype, param_dtype)
    ds = ds if residual_grad else None
    got = _grads(_folded, x, r, gamma, beta, dy, ds)
    want = _grads(_unfolded, x, r, gamma, beta, dy, ds)
    for name, g, w in zip(("s", "y", "dx", "dr", "dgamma", "dbeta"), got,
                          want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert torch.equal(got[2], got[3])  # x and r take one dx


def test_plain_wrappers_are_the_references():
    x, r, dy, ds, gamma, beta = _tensors(torch.bfloat16, seed=1)
    s, y, mean, rstd = ln.add_layer_norm_forward(x, r, gamma, beta, EPS,
                                                 torch.bfloat16)
    assert torch.equal(s, x + r)
    want = ln.layer_norm_reference(x + r, gamma, beta, EPS, torch.bfloat16)
    for a, b in zip((y, mean, rstd), want):
        assert torch.equal(a, b)
    dx, dgamma, dbeta = ln.add_layer_norm_backward(dy, ds, s, mean, rstd,
                                                   gamma, beta)
    norm = ln.layer_norm_backward_reference(dy, s, mean, rstd, gamma, beta)
    assert torch.equal(dx, norm[0] + ds)
    assert torch.equal(dgamma, norm[1]) and torch.equal(dbeta, norm[2])
    alone = ln.add_layer_norm_backward(dy, None, s, mean, rstd, gamma, beta)
    assert torch.equal(alone[0], norm[0])


def test_plain_wrappers_count_no_launch():
    before = (ln.add_layer_norm_forward.launches,
              ln.add_layer_norm_backward.launches)
    x, r, dy, ds, gamma, beta = _tensors(torch.float32, seed=2)
    _grads(_folded, x, r, gamma, beta, dy, ds)
    assert (ln.add_layer_norm_forward.launches,
            ln.add_layer_norm_backward.launches) == before


def test_tolerance_admits_one_rounding_of_the_folded_dx():
    """The kernel adds ds to the f32 dx of the norm and rounds once; the
    plain version rounds the norm's dx, adds and rounds again. The folded
    dx taken in f64 and rounded once to bf16 lies within the bound that
    ``dx_norm`` widens."""
    x, r, dy, ds, gamma, beta = _tensors(torch.bfloat16, seed=3,
                                         rows=(4, 32))
    s, y, mean, rstd = ln.add_layer_norm_reference(x, r, gamma, beta, EPS,
                                                   torch.bfloat16)
    dx, dgamma, _ = ln.add_layer_norm_backward_reference(dy, ds, s, mean,
                                                         rstd, gamma, beta)
    dx_norm = ln.layer_norm_backward_reference(dy, s, mean, rstd, gamma,
                                               beta)[0]
    s64, dy64, g64 = s.double(), dy.double(), gamma.double()
    m64 = s64.mean(-1, keepdim=True)
    r64 = 1 / torch.sqrt(((s64 - m64) ** 2).mean(-1, keepdim=True) + EPS)
    xhat = (s64 - m64) * r64
    gd = g64 * dy64
    once = (r64 * (gd - gd.mean(-1, keepdim=True)
                   - xhat * (gd * xhat).mean(-1, keepdim=True))
            + ds.double()).to(torch.bfloat16)
    bounds = ln.layer_norm_tolerance(s, gamma, beta, mean, rstd, y, dy, dx,
                                     dgamma, dx_norm=dx_norm)
    err = (once.float() - dx.float()).abs().reshape(-1, H)
    assert bool((err <= bounds["dx"]).all())
    plain = ln.layer_norm_tolerance(s, gamma, beta, mean, rstd, y, dy, dx,
                                    dgamma)
    assert bool((bounds["dx"] >= plain["dx"]).all())


def _unfolded_add_norm(self, x, r):
    """``LayerNorm.add_norm`` as the models ran before the fold: torch's
    add, then the norm alone."""
    if r is not None:
        x = x + r
    return x, self(x)


MODELS = {
    "gpt": lambda: GPT(GPTConfig.tiny(max_len=64, dtype=torch.float32)),
    "gpt_bf16": lambda: GPT(GPTConfig.tiny(max_len=64)),
    "moe": lambda: GPT(GPTConfig.tiny(max_len=64, dtype=torch.float32,
                                      moe_every=2, num_experts=4)),
    "bert": lambda: Bert(BertConfig.tiny(max_len=64, dtype=torch.float32)),
    "vit": lambda: ViT(ViTConfig.tiny(dtype=torch.float32)),
}


def _inputs(name, model):
    rng = np.random.default_rng(4)
    if name == "vit":
        size = model.config.image_size
        return torch.from_numpy(rng.standard_normal(
            (2, size, size, 3)).astype(np.float32))
    return torch.from_numpy(rng.integers(0, 1024, (2, 16)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_folded_models_are_the_unfolded_blocks_bits(name, monkeypatch):
    """Each model's output and every parameter's gradient with the fold,
    and with torch's adds and the norms alone swapped in."""
    runs = []
    for unfold in (False, True):
        if unfold:
            monkeypatch.setattr(LayerNorm, "add_norm", _unfolded_add_norm)
        model = MODELS[name]().init_weights(torch.Generator().manual_seed(0))
        out = model(_inputs(name, model))
        if isinstance(out, tuple):
            out = out[0]
        out.float().pow(2).mean().backward()
        runs.append((out.detach(), [p.grad for p in model.parameters()]))
    (out, grads), (want, want_grads) = runs
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


def test_a_layer_called_alone_keeps_its_contract():
    """``DecoderLayer(x)`` (a pipeline stage) returns ``(x + branch,
    aux)``; with ``fold`` the residual stream and the branch apart."""
    cfg = GPTConfig.tiny(max_len=64, dtype=torch.float32)
    layer = DecoderLayer(cfg)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0, 0.05, generator=torch.Generator().manual_seed(5))
    x = torch.randn(2, 16, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        out, aux = layer(x)
        stream, branch, aux2 = layer(x, fold=True)
    assert aux is None and aux2 is None
    assert out.shape == x.shape and torch.equal(out, stream + branch)


@pytest.fixture
def one_rank_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("tensor",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("placement", [Replicate(), Shard(0)],
                         ids=["replicate", "rows"])
def test_a_dtensor_layer_keeps_the_unfolded_arithmetic(one_rank_mesh,
                                                       monkeypatch,
                                                       placement):
    """A ``DecoderLayer`` whose parameters and input are DTensors (the
    ``tensor``/``expert``/``seq`` meshes): the fold's kernels are never
    reached, the adds stay torch's and each norm runs on each rank's own
    rows, and the output is the plain layer's."""
    cfg = GPTConfig.tiny(max_len=64, dtype=torch.float32,
                         attention_impl="xla")
    plain = DecoderLayer(cfg)
    with torch.no_grad():
        for p in plain.parameters():
            p.normal_(0, 0.05, generator=torch.Generator().manual_seed(7))
    placed = DecoderLayer(cfg)
    placed.load_state_dict(plain.state_dict())
    for mod in placed.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, torch.nn.Parameter(distribute_tensor(
                p.detach(), one_rank_mesh, [Replicate()])))
    folds = []
    real = layers.add_layer_norm
    monkeypatch.setattr(layers, "add_layer_norm",
                        lambda *a, **k: folds.append(1) or real(*a, **k))
    x = torch.randn(2, 16, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        want, _ = plain(x)
        assert folds == [1]  # the plain layer folds its attention add
        folds.clear()
        got, _ = placed(distribute_tensor(x, one_rank_mesh, [placement]))
    assert folds == []
    torch.testing.assert_close(got.full_tensor(), want, rtol=0, atol=1e-6)


@pytest.fixture
def fresh_entries(monkeypatch):
    monkeypatch.setattr(serving, "_DECODERS", serving.OrderedDict())
    return serving._DECODERS


def _serving_model(seed=0):
    model = GPT(GPTConfig.tiny(max_len=64, dtype=torch.float32))
    return model.init_weights(torch.Generator().manual_seed(seed)).eval()


def test_which_entry_a_call_takes(fresh_entries):
    model = _serving_model()
    gen = torch.Generator()
    first = serving._decoder(model, 2, True, None)
    assert serving._decoder(model, 2, True, None) is first
    assert serving._decoder(model, 4, True, None) is not first
    sampled = serving._decoder(model, 2, False, gen)
    assert sampled is not first
    assert serving._decoder(model, 2, False, gen) is sampled
    # another generator gets an entry of its own in the same slot
    other = serving._decoder(model, 2, False, torch.Generator())
    assert other is not sampled and other.generator is not gen
    assert list(fresh_entries) == [(id(model), 2, True),
                                   (id(model), 4, True),
                                   (id(model), 2, False)]
    assert first.pool is None  # made on the card only


def test_prefill_graphs_are_kept_per_length_least_recent_out(
        fresh_entries, monkeypatch):
    monkeypatch.setattr(serving, "_PREFILLS_CAP", 2)
    entry = serving._decoder(_serving_model(), 2, True, None)
    g16 = entry.prefill(16)
    assert entry.prefill(16) is g16
    g8 = entry.prefill(8)
    assert list(entry.prefills) == [16, 8]
    assert entry.prefill(16) is g16  # used again: now the most recent
    assert list(entry.prefills) == [8, 16]
    entry.prefill(4)  # past the cap: 8, the least recent, goes
    assert list(entry.prefills) == [16, 4]
    assert entry.prefill(8) is not g8
    assert list(entry.prefills) == [4, 8]
    assert all(g._pool is entry.pool for g in entry.prefills.values())


def test_entries_are_bounded_and_a_dead_models_entry_dropped(
        fresh_entries, monkeypatch):
    monkeypatch.setattr(serving, "_DECODERS_CAP", 2)
    a, b, c = (_serving_model(seed) for seed in range(3))
    serving._decoder(a, 2, True, None)
    serving._decoder(b, 2, True, None)
    serving._decoder(a, 2, True, None)  # a is the most recent now
    serving._decoder(c, 2, True, None)  # b, the least recent, goes
    assert list(fresh_entries) == [(id(a), 2, True), (id(c), 2, True)]
    dead_key = (id(c), 2, True)
    del c
    gc.collect()
    d = _serving_model(3)
    serving._decoder(d, 2, True, None)
    assert dead_key not in fresh_entries or fresh_entries[dead_key].model() \
        is d
    assert len(fresh_entries) <= 2
    assert all(e.model() is not None for e in fresh_entries.values())


def test_eager_generation_is_unchanged_by_the_fold(monkeypatch):
    """Greedy tokens of the eager loop (the CPU's path) with the fold and
    with torch's adds and the norms alone swapped in."""
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, 1024, (2, 8)))
    model = _serving_model()
    folded = serving.generate(model.config, model, prompt, 8)
    monkeypatch.setattr(LayerNorm, "add_norm", _unfolded_add_norm)
    assert torch.equal(folded, serving.generate(model.config, model, prompt,
                                                8))
