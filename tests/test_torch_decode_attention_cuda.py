"""The decode-attention kernel (``ops/csrc/decode_attn.cu``) against its
plain version, on the card: every head dim and both dtypes it takes, MHA
and GQA, the first, a middle and the last cache position; bit-identical
reruns; positions past ``pos`` never read; a CUDA graph captured once and
replayed while ``pos`` advances on the device, with its launches counted
once per replay; and the GPT decode step launching it once a layer.

Needs a CUDA card and nvcc (the kernel has no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_decode_attention_cuda.py``.
"""

import faulthandler
import importlib

import numpy as np
import pytest
import torch

from cron_operator_tpu_torch.models import GPT, GPTConfig

attn = importlib.import_module("cron_operator_tpu_torch.ops.attention")
fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

CASE_TIMEOUT_S = 300  # as the flash kernels' card tests: the build included


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _inputs(seed, b, max_len, h, kv_h, d, device, dtype):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        .to(device, dtype)
        for shape in ((b, 1, h, d), (b, max_len, kv_h, d),
                      (b, max_len, kv_h, d))
    ]


def _assert_matches_plain(q, k, v, pos, out):
    ref = attn.decode_attention_reference(q, k, v, pos)
    bound = attn.decode_tolerance(q, k, v, pos, ref)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out.float()).all())
    assert bool(((out.float() - ref.float()).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_h", [4, 2, 1])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("pos", [0, 150, 299])
def test_kernel_matches_plain(cuda_device, dtype, kv_h, d, pos):
    q, k, v = _inputs(3, 2, 300, 4, kv_h, d, cuda_device, dtype)
    p = torch.tensor([pos], device=cuda_device)
    before = attn.decode_attention.launches
    out = attn.decode_attention(q, k, v, p)
    again = attn.decode_attention(q, k, v, p)
    torch.cuda.synchronize()
    assert attn.decode_attention.launches == before + 2
    _assert_matches_plain(q, k, v, p, out)
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_serving_shape_and_garbage_past_pos(cuda_device):
    """GPT-2 small's decode (b 8, cache 1024, 12 heads of 64, bf16): the
    kernel never reads past ``pos``, so NaN there changes nothing."""
    q, k, v = _inputs(4, 8, 1024, 12, 12, 64, cuda_device, torch.bfloat16)
    for pos in (0, 511, 575, 1023):
        p = torch.tensor([pos], device=cuda_device)
        out = attn.decode_attention(q, k, v, p)
        _assert_matches_plain(q, k, v, p, out)
        kg, vg = k.clone(), v.clone()
        kg[:, pos + 1:] = float("nan")
        vg[:, pos + 1:] = float("inf")
        assert torch.equal(attn.decode_attention(q, kg, vg, p), out)


@pytest.mark.cuda
def test_graph_replays_at_the_advancing_position(cuda_device):
    """One capture, replayed while ``pos`` (a device tensor) advances on the
    card: each replay attends over one more position, as the eager calls
    do, and each counts one launch."""
    q, k, v = _inputs(5, 2, 256, 4, 2, 64, cuda_device, torch.bfloat16)
    pos = torch.tensor([10], device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        attn.decode_attention(q, k, v, pos)  # warm up outside the capture
        graph = torch.cuda.CUDAGraph()
        with fa.capture_launches(side.cuda_stream) as tally, \
                torch.cuda.graph(graph, stream=side):
            out = attn.decode_attention(q, k, v, pos)
            pos.add_(1)
    torch.cuda.current_stream().wait_stream(side)
    assert tally == {(attn.decode_attention, "fma"): 1}
    pos.fill_(10)
    before = attn.decode_attention.launches
    for step in range(5):
        graph.replay()
        fa.count_replays(tally, 1)
        torch.cuda.synchronize()
        want = attn.decode_attention(q, k, v,
                                     torch.tensor([10 + step], device=cuda_device))
        assert torch.equal(out, want)
    assert int(pos) == 15
    assert attn.decode_attention.launches == before + 5 + 5


@pytest.mark.cuda
def test_gpt_decode_launches_the_kernel_once_a_layer(cuda_device):
    cfg = GPTConfig.tiny(hidden_size=256, max_len=128)
    model = GPT(cfg, device="cuda", param_dtype=cfg.dtype).init_weights(
        torch.Generator(device="cuda").manual_seed(0)).eval()
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda")
    with torch.inference_mode():
        cache = model.new_cache(2)
        model.prefill(prompt, cache)
        before = attn.decode_attention.launches
        logits = model.decode(prompt[:, -1:], cache)
        torch.cuda.synchronize()
    assert attn.decode_attention.launches == before + cfg.num_layers
    assert logits.shape == (2, cfg.vocab_size) and bool(torch.isfinite(logits).all())
