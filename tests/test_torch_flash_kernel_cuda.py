"""The Hopper flash-attention kernel against its plain version, on the card.

Needs a CUDA card and nvcc (the kernel has no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_flash_kernel_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

# Seconds one test may take, the kernels' first build included. A kernel
# that never finishes (an mbarrier phase error) would hang the session: the
# watchdog prints every thread's stack and ends the process instead.
CASE_TIMEOUT_S = 300


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _inputs(seed, b, s, h, kv_h, d, device, dtype):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        .to(device, dtype)
        for shape in ((b, s, h, d), (b, s, kv_h, d), (b, s, kv_h, d))
    ]


def _assert_matches_plain(q, k, v, causal, o, lse):
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
    bound = fa.forward_tolerance(q, k, v, o_ref, lse_ref, causal=causal)
    assert bool(torch.isfinite(o.float()).all())
    assert bool(((o.float() - o_ref.float()).abs() <= bound).all())
    assert (lse - lse_ref).abs().max().item() < 1e-4  # f32 on both sides


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_h", [4, 2, 1])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_kernel_matches_plain(cuda_device, dtype, causal, kv_h, d):
    q, k, v = _inputs(5, 2, 256, 4, kv_h, d, cuda_device, dtype)
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    # bf16 at d 64/128 runs the sm90 design, which rounds P to bf16 as the
    # TPU kernel does: the bound of fa.forward_tolerance; f32 within 1e-4
    _assert_matches_plain(q, k, v, causal, o, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 192, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_h", [4, 2, 1])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_design_matches_plain(cuda_device, d, kv_h, causal, s):
    """The bf16 wgmma/TMA forward, including a last half tile of 64 rows
    (s 64 and 192 at d 128, whose blocks are 128 rows); reruns are
    bit-identical."""
    q, k, v = _inputs(11, 2, s, 4, kv_h, d, cuda_device, torch.bfloat16)
    block = 64 if s % 128 else None
    before = fa.flash_attention.launches_by_design["sm90"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, block_q=block,
                                    block_k=block)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=causal, block_q=block,
                                      block_k=block)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_design["sm90"] == before + 2
    _assert_matches_plain(q, k, v, causal, o, lse)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_strided_fused_qkv_views(cuda_device):
    """q/k/v as the strided ``qkv[:, :, i]`` views of a fused projection go
    in without a copy and give the contiguous result."""
    qkv = torch.randn(2, 128, 3, 4, 64, device=cuda_device,
                      dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert all(fa._tma_ready(x) for x in (q, k, v))
    before = fa.flash_attention.launches_by_design["sm90"]
    o, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    o_c, _ = fa.flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True
    )
    assert fa.flash_attention.launches_by_design["sm90"] == before + 2
    assert torch.equal(o, o_c)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_misaligned_input_is_copied_and_runs_sm90(cuda_device, d):
    """An input whose base TMA cannot take (2 bytes off 16) is copied and
    still runs the sm90 kernel; the plain version never runs on the card."""
    q, k, v = _inputs(3, 1, 128, 2, 2, d, cuda_device, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, device=cuda_device, dtype=q.dtype)
    q_off = buf[1:].view(q.shape)
    q_off.copy_(q)
    assert not fa._tma_ready(q_off)
    counts = dict(fa.flash_attention.launches_by_design)
    o, lse = fa.flash_attention_fwd(q_off, k, v, causal=True)
    o_ref, lse_ref = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_design == {
        "sm90": counts["sm90"] + 2, "fma": counts["fma"]}
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, d, design", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 32, "fma"), (torch.bfloat16, 256, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma"),
])
def test_launch_counted_under_its_design(cuda_device, dtype, d, design):
    q, k, v = _inputs(2, 1, 128, 2, 2, d, cuda_device, dtype)
    counts = dict(fa.flash_attention.launches_by_design)
    fa.flash_attention_fwd(q, k, v, causal=True)
    counts[design] += 1
    assert fa.flash_attention.launches_by_design == counts
