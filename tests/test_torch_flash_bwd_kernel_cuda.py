"""The Hopper flash-attention backward kernels K2 (dQ) and K3 (dK, dV)
against their plain versions, on the card.

Needs a CUDA card and nvcc (the kernels have no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_flash_bwd_kernel_cuda.py``.

Tolerances: in f32 the two sides differ only in summation order,
``1e-4 * max|ref|``; in bf16 both accumulate in f32 and round once, so an
element may differ by one bf16 ulp on top: ``2^-7 |ref| + 1e-4 * max|ref|``.
"""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, b, s, h, kv_h, d, device, dtype):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        .to(device, dtype)
        for shape in ((b, s, h, d), (b, s, kv_h, d), (b, s, kv_h, d),
                      (b, s, h, d))
    ]


def _assert_close(got, ref):
    ref = ref.float()
    diff = (got.float() - ref).abs()
    floor = 1e-4 * ref.abs().max().item()
    if got.dtype == torch.bfloat16:
        assert bool((diff <= 2.0 ** -7 * ref.abs() + floor).all())
    else:
        assert diff.max().item() <= floor


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_h", [4, 2, 1])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_kernels_match_plain(cuda_device, dtype, causal, kv_h, d):
    q, k, v, do = _inputs(5, 2, 256, 4, kv_h, d, cuda_device, dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == (before[0] + 1, before[1] + 1)
    refs = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    for got, ref, x in zip(grads, refs, (q, k, v)):
        assert got.shape == x.shape and got.dtype == x.dtype
        _assert_close(got, ref)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)  # no atomics: bit-identical run to run


@pytest.mark.cuda
def test_autograd_through_strided_views(cuda_device):
    """Gradients through ``flash_attention`` from the strided
    ``qkv[:, :, i]`` views of a fused projection land in the fused tensor,
    and equal those of contiguous copies."""
    qkv = torch.randn(2, 128, 3, 4, 64, device=cuda_device,
                      dtype=torch.bfloat16, requires_grad=True)
    do = torch.randn(2, 128, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    out = fa.flash_attention(*qkv.unbind(2), causal=True)
    (g_fused,) = torch.autograd.grad(out, qkv, do)
    parts = [t.detach().contiguous().requires_grad_() for t in qkv.unbind(2)]
    out_c = fa.flash_attention(*parts, causal=True)
    g_parts = torch.autograd.grad(out_c, parts, do)
    assert torch.equal(g_fused, torch.stack(g_parts, dim=2))


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(cuda_device):
    """A shape the kernels refuse raises on the card; it is not computed by
    the plain version instead."""
    q = torch.zeros(1, 128, 2, 48, device=cuda_device)
    lse = torch.zeros(2, 128, 1, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_dq(q, q, q, q, lse, lse, causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_dkv(q, q, q, q, lse, lse, causal=True)
