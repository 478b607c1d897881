"""The tied output embedding at a padded width (``models/layers.py``
``tied_logits``): a vocab that is not a multiple of 64 multiplies against a
table padded with zero rows and is cut back before anyone sees it.

- The logits keep width V, and an argmax over all-negative logits stays
  below V (a padded column would be 0, above every real logit).
- Logits and the tied table's gradient equal the unpadded product's, the
  gradient at ``[V, E]`` (GPT and BERT, f32).
- Serving keeps one padded table: a bf16 model reuses it across decode
  calls (the same buffer), and an in-place write of the weight (a
  checkpoint's ``load_state_dict``) refills that buffer, never serving the
  old table.
- A DTensor table (a ``tensor``/``expert``/``seq`` mesh) takes the product
  unpadded, as before.
- ``Trainer.flops_per_step`` counts the true vocab.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, distribute_tensor

from cron_operator_tpu_torch.models import Bert, BertConfig, GPT, GPTConfig
from cron_operator_tpu_torch.models import layers
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.train import Trainer

V = 1000  # pads to 1024


def _gpt(dtype=torch.float32, param_dtype=torch.float32, **over):
    cfg = GPTConfig.tiny(vocab_size=V, max_len=64, dtype=dtype, **over)
    return GPT(cfg, param_dtype=param_dtype).init_weights(
        torch.Generator().manual_seed(0))


def _ids(b=2, s=16, seed=1):
    return torch.randint(0, V, (b, s), generator=torch.Generator().manual_seed(seed))


def test_padded_width():
    assert layers.padded_vocab(V) == 1024
    assert layers.padded_vocab(50257) == 50304
    assert layers.padded_vocab(30522) == 30528
    assert layers.padded_vocab(1024) == 1024


def test_no_caller_sees_a_padded_column():
    model = _gpt()
    with torch.no_grad():
        # every real logit negative: ln_f's output is all ones, the table
        # all negative
        model.ln_f.weight.zero_()
        model.ln_f.bias.fill_(1.0)
        model.tok_emb.weight.abs_().neg_().sub_(1e-3)
        ids = _ids()
        logits = model(ids)
        assert logits.shape == (2, 16, V) and logits.dtype == torch.float32
        assert (logits < 0).all() and (logits.argmax(-1) < V).all()
        cache = model.new_cache(2)
        last = model.prefill(ids, cache)
        step = model.decode(ids[:, -1:], cache)
    for out in (last, step):
        assert out.shape == (2, V) and (out < 0).all()
        assert (out.argmax(-1) < V).all()


def _unpadded(monkeypatch):
    # one row a multiple: every vocab takes the product unpadded
    monkeypatch.setattr(layers, "VOCAB_ROWS_MULTIPLE", 1)


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_logits_and_table_gradient_equal_the_unpadded_product(monkeypatch,
                                                              family):
    def run():
        if family == "gpt":
            model = _gpt()
        else:
            cfg = BertConfig.tiny(vocab_size=V, max_len=64,
                                  dtype=torch.float32)
            model = Bert(cfg).init_weights(torch.Generator().manual_seed(0))
        logits = model(_ids())
        logits.square().mean().backward()
        return logits.detach(), model.tok_emb.weight.grad

    padded = run()
    _unpadded(monkeypatch)
    plain = run()
    assert padded[1].shape == (V, 128)
    for got, want in zip(padded, plain):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_bf16_training_gradient_comes_back_in_the_weights_dtype(monkeypatch):
    """bf16 products over f32 masters: the padded bf16 table is made in
    one pass from the f32 weight, and its gradient returns to the f32
    weight at ``[V, E]``, as the unpadded cast's does."""
    def run():
        model = _gpt(dtype=torch.bfloat16)
        model(_ids()).square().mean().backward()
        return model.tok_emb.weight.grad

    padded = run()
    _unpadded(monkeypatch)
    plain = run()
    assert padded.dtype == torch.float32 and padded.shape == (V, 128)
    torch.testing.assert_close(padded, plain, rtol=2e-2, atol=1e-6)


def test_serving_reuses_one_padded_table_and_refills_it():
    model = _gpt(dtype=torch.bfloat16, param_dtype=torch.bfloat16).eval()
    ids = _ids()
    with torch.inference_mode():
        cache = model.new_cache(2)
        model.prefill(ids, cache)
        table = model._vocab_table._table
        assert table.shape == (1024, 128) and table.dtype == torch.bfloat16
        assert not table.is_inference()
        ptr = table.data_ptr()
        model.decode(ids[:, -1:], cache)
        model.decode(ids[:, -1:], cache)
        assert model._vocab_table._table.data_ptr() == ptr
        assert torch.equal(table[:V], model.tok_emb.weight)
        assert not table[V:].any()
    # a checkpoint restore writes the weight in place
    other = _gpt(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    with torch.no_grad():
        other.tok_emb.weight.mul_(-2.0)
    model.load_state_dict(other.state_dict())
    with torch.inference_mode():
        cache = model.new_cache(2)
        got = model.prefill(ids, cache)
        assert model._vocab_table._table.data_ptr() == ptr  # refilled in place
        assert torch.equal(model._vocab_table._table[:V], other.tok_emb.weight)
        want = other.eval().prefill(ids, other.new_cache(2))
    assert torch.equal(got, want)


def test_autograd_steps_pad_at_use():
    """A step with autograd never takes the serving copy: the table it
    multiplies carries the weight's gradient."""
    model = _gpt()
    model(_ids()).sum().backward()
    assert model._vocab_table._table is None
    assert model.tok_emb.weight.grad is not None


@pytest.fixture
def one_rank_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("tensor",))
    finally:
        dist.destroy_process_group()


def test_a_dtensor_table_is_not_padded(monkeypatch, one_rank_mesh):
    def no_pad(*args, **kwargs):
        raise AssertionError("padded a DTensor table")

    monkeypatch.setattr(layers, "_pad_rows", no_pad)
    gen = torch.Generator().manual_seed(3)
    w = distribute_tensor(torch.randn(V, 32, generator=gen), one_rank_mesh,
                          [Replicate()])
    x = distribute_tensor(torch.randn(2, 5, 32, generator=gen), one_rank_mesh,
                          [Replicate()])
    got = layers.tied_logits(x, w, torch.float32, layers.PaddedTable())
    want = layers.linear(x, w.to(torch.float32)).float()
    assert got.shape == (2, 5, V)
    assert torch.equal(got.full_tensor(), want.full_tensor())


def test_flops_per_step_counts_the_true_vocab():
    b, s = 2, 64
    model = _gpt()  # max_len 64: the sequence
    cfg = model.config
    trainer = Trainer(model, sample_fn=data.causal_token_sample(b, s, V))
    trainer.step({})
    weights = sum(p.numel() for n, p in model.named_parameters()
                  if p.dim() == 2 and "pos_emb" not in n)
    d = cfg.hidden_size // cfg.num_heads
    attention = cfg.num_layers * 12 * d * b * cfg.num_heads * s * (s + 1) // 2
    assert model.tok_emb.weight.shape[0] == V
    assert trainer.flops_per_step() == 6 * b * s * weights + attention
