"""BERT's training grads through the Hopper flash kernels against the
plain-attention path, on the card: the counterpart of
``tests/test_ops.py``'s BERT flash-vs-dense check.

Needs a CUDA card and nvcc (the kernels have no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_models_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import importlib
from dataclasses import replace

import pytest
import torch

from cron_operator_tpu_torch.models import Bert, BertConfig
from cron_operator_tpu_torch.workloads.train import cross_entropy_loss

fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

CASE_TIMEOUT_S = 300  # as the kernel card tests: the first build included


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _grads(cfg, state, ids):
    model = Bert(cfg, device="cuda")
    model.load_state_dict(state)
    logits = model(ids)
    # tests/test_ops.py's loss: it weighs every logit, not only the target's
    torch.mean(torch.sum(torch.log_softmax(logits, -1) ** 2, -1)).backward()
    torch.cuda.synchronize()
    return {n: p.grad.float() for n, p in model.named_parameters()}


@pytest.mark.cuda
def test_bert_train_grads_flash_vs_plain_f32(cuda_device):
    """f32 BERT tiny (head dim 32: the fma kernels) at s 128: every grad
    within 5e-4 of its largest magnitude, as tests/test_ops.py allows."""
    cfg = BertConfig.tiny(dtype=torch.float32, max_len=128)
    model = Bert(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    state = model.state_dict()
    ids = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    before = (fa.flash_attention.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    flash = _grads(replace(cfg, attention_impl="flash"), state, ids)
    after = (fa.flash_attention.launches, fa.flash_attention_dq.launches,
             fa.flash_attention_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [cfg.num_layers] * 3
    plain = _grads(replace(cfg, attention_impl="xla"), state, ids)
    for name, g in plain.items():
        scale = g.abs().max().item() or 1.0
        assert (flash[name] - g).abs().max().item() / scale < 5e-4, name


@pytest.mark.cuda
def test_bert_train_grads_flash_vs_plain_bf16_sm90(cuda_device):
    """bf16 BERT with head dim 64 (the sm90 kernels, non-causal) at s 256:
    the flash path's grads stay within twice the plain bf16 path's distance
    from an f32 run (one vector, L2), as ``chip_smoke.py`` holds BERT-base."""
    cfg = BertConfig.tiny(hidden_size=256, max_len=256)
    model = Bert(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    state = model.state_dict()
    ids = torch.randint(0, cfg.vocab_size, (2, 256), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    before = dict(fa.flash_attention_dkv.launches_by_design)
    flash = _grads(replace(cfg, attention_impl="flash"), state, ids)
    assert (fa.flash_attention_dkv.launches_by_design["sm90"]
            - before["sm90"]) == cfg.num_layers
    plain = _grads(replace(cfg, attention_impl="xla"), state, ids)
    exact = _grads(replace(cfg, attention_impl="xla", dtype=torch.float32),
                   state, ids)

    def vec(grads):
        return torch.cat([grads[n].flatten() for n in sorted(grads)])

    g_fp = (vec(flash) - vec(plain)).norm().item()
    g_p32 = (vec(plain) - vec(exact)).norm().item()
    assert torch.isfinite(vec(flash)).all()
    assert g_fp <= 2 * g_p32, (g_fp, g_p32)
