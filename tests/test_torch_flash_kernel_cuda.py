"""The Hopper flash-attention kernel against its plain version, on the card.

Needs a CUDA card and nvcc (the kernel has no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_flash_kernel_cuda.py``.
"""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, b, s, h, kv_h, d, device, dtype):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        .to(device, dtype)
        for shape in ((b, s, h, d), (b, s, kv_h, d), (b, s, kv_h, d))
    ]


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
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
    diff = (o.float() - o_ref.float()).abs()
    if dtype == torch.bfloat16:
        # both sides round one f32 result to bf16: at most one bf16 ulp
        assert bool((diff <= 2.0 ** -7 * o_ref.float().abs() + 1e-4).all())
    else:
        assert diff.max().item() < 1e-4  # f32 summation order
    assert (lse - lse_ref).abs().max().item() < 1e-4


@pytest.mark.cuda
def test_strided_fused_qkv_views(cuda_device):
    """q/k/v as the strided ``qkv[:, :, i]`` views of a fused projection go
    in without a copy and give the contiguous result."""
    qkv = torch.randn(2, 128, 3, 4, 64, device=cuda_device,
                      dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    o_c, _ = fa.flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True
    )
    assert torch.equal(o, o_c)
