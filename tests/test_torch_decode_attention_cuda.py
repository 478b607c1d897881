"""The decode-attention kernel (``ops/csrc/decode_attn.cu``) against its
plain version, on the card: every head dim and both dtypes it takes, MHA
and GQA, the first, a middle and the last cache position; the cluster
design at its edges (pos 0, a box's last and the next's first position,
the cache's last, a ``max_len`` that does not fill the cluster's boxes)
and the three-pass design where the plan keeps it; bit-identical reruns;
positions past ``pos`` never read; a CUDA graph captured once and replayed
while ``pos`` advances on the device, with its launches counted once per
replay; and the GPT decode step launching it once a layer.

Needs a CUDA card and nvcc (the kernel has no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_decode_attention_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

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
    assert tally == {(attn.decode_attention, "cluster"): 1}
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
@pytest.mark.parametrize("dtype, kv_h, d", [
    (torch.bfloat16, 4, 32), (torch.bfloat16, 2, 128), (torch.bfloat16, 2, 256),
    (torch.float32, 4, 64), (torch.float32, 8, 128)])
def test_cluster_design_at_its_edges(cuda_device, dtype, kv_h, d):
    """``max_len`` 1000 (63 boxes of 16 dealt round 4 ranks: the last box
    partial, the last rank one box short) at group 1, 2 and 4: pos 0 (one
    rank, one row), 15 and 16 and 127 and 128 (a rank's box ends, the next
    rank's begins), 999; the two designs and clusters of 2, 8 and 16 agree
    within the tolerance on the same inputs, reruns are bit-identical, and
    NaN/inf past ``pos`` changes nothing."""
    q, k, v = _inputs(6, 3, 1000, 8, kv_h, d, cuda_device, dtype)
    assert attn.decode_plan(1000, 8 // kv_h, d, dtype)["design"] == "cluster"
    for pos in (0, 15, 16, 127, 128, 999):
        p = torch.tensor([pos], device=cuda_device)
        before = dict(attn.decode_attention.launches_by_design)
        out = attn.decode_attention(q, k, v, p)
        again = attn.decode_attention(q, k, v, p)
        three_pass = attn._launch_decode(q, k, v, p, design="fma")
        torch.cuda.synchronize()
        assert attn.decode_attention.launches_by_design["cluster"] == (
            before["cluster"] + 2)
        _assert_matches_plain(q, k, v, p, out)
        _assert_matches_plain(q, k, v, p, three_pass)
        assert torch.equal(out, again)
        for cluster in (2, 8, 16):
            _assert_matches_plain(q, k, v, p, attn._launch_decode(
                q, k, v, p, cluster=cluster))
        kg, vg = k.clone(), v.clone()
        kg[:, pos + 1:] = float("nan")
        vg[:, pos + 1:] = float("inf")
        assert torch.equal(attn.decode_attention(q, kg, vg, p), out)


@pytest.mark.cuda
def test_a_shape_beyond_the_cluster_tiles_keeps_three_passes(cuda_device):
    """d 256 in f32 over 2048 positions: a rank's 256 rows of K pass a
    block's shared memory, so the plan keeps the three-pass design."""
    q, k, v = _inputs(7, 2, 2048, 4, 2, 256, cuda_device, torch.float32)
    assert attn.decode_plan(2048, 2, 256, torch.float32)["design"] == "fma"
    p = torch.tensor([1500], device=cuda_device)
    before = dict(attn.decode_attention.launches_by_design)
    out = attn.decode_attention(q, k, v, p)
    torch.cuda.synchronize()
    assert attn.decode_attention.launches_by_design == {
        **before, "fma": before["fma"] + 1}
    _assert_matches_plain(q, k, v, p, out)


@pytest.mark.cuda
def test_cluster_occupancy_is_reported(cuda_device):
    q, k, _ = _inputs(8, 8, 1024, 12, 12, 64, cuda_device, torch.bfloat16)
    assert attn.decode_occupancy(q, k) >= 1


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
    assert attn.decode_plan(cfg.max_len, 1, cfg.hidden_size // cfg.num_heads,
                            cfg.dtype)["design"] == "cluster"
    assert logits.shape == (2, cfg.vocab_size) and bool(torch.isfinite(logits).all())
