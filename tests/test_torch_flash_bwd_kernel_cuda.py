"""The Hopper flash-attention backward kernels K2 (dQ) and K3 (dK, dV)
against their plain versions, on the card.

Needs a CUDA card and nvcc (the kernels have no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_flash_bwd_kernel_cuda.py``.

Tolerances: in f32 the two sides differ only in summation order,
``1e-4 * max|ref|``. In bf16, dQ takes the bound of ``fa.dq_tolerance`` and
dK and dV that of ``fa.dkv_tolerance``: the fma design keeps P and dS in f32
and may differ by one bf16 ulp on top, ``2^-7 |ref| + 1e-4 * max|ref|``;
the sm90 designs of K2 and K3 round dS (and P) to bf16 before their
products, as the TPU kernels do, and their bounds add that rounding.
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
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _inputs(seed, b, s, h, kv_h, d, device, dtype):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        .to(device, dtype)
        for shape in ((b, s, h, d), (b, s, kv_h, d), (b, s, kv_h, d),
                      (b, s, h, d))
    ]


def _assert_grads_close(q, k, v, do, lse, delta, causal, dq, dk, dv):
    dq_ref = fa.flash_attention_dq_reference(q, k, v, do, lse, delta,
                                             causal=causal)
    dk_ref, dv_ref = fa.flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                                      causal=causal)
    for got, ref, x in zip((dq, dk, dv), (dq_ref, dk_ref, dv_ref), (q, k, v)):
        assert got.shape == x.shape and got.dtype == x.dtype
        assert bool(torch.isfinite(got.float()).all())
    bounds = (fa.dq_tolerance(q, k, v, do, lse, delta, dq_ref, causal=causal),
              *fa.dkv_tolerance(q, k, v, do, lse, delta, dk_ref, dv_ref,
                                causal=causal))
    for got, ref, bound in zip((dq, dk, dv), (dq_ref, dk_ref, dv_ref), bounds):
        assert bool(((got.float() - ref.float()).abs() <= bound).all())


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
    _assert_grads_close(q, k, v, do, lse, fa._delta(o, do), causal, *grads)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)  # no atomics: bit-identical run to run


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 192, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_h", [4, 2, 1])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_dkv_matches_plain(cuda_device, d, kv_h, causal, s):
    """K3's bf16 wgmma/TMA design, GQA groups 1/2/4, bit-identical reruns."""
    q, k, v, do = _inputs(13, 2, s, 4, kv_h, d, cuda_device, torch.bfloat16)
    block = 64 if s % 128 else None
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, block_q=block,
                                    block_k=block)
    delta = fa._delta(o, do)
    before = fa.flash_attention_dkv.launches_by_design["sm90"]
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, causal=causal)
    dk2, dv2 = fa.flash_attention_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_dkv.launches_by_design["sm90"] == before + 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, causal=causal)
    _assert_grads_close(q, k, v, do, lse, delta, causal, dq, dk, dv)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 192, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_h", [4, 2, 1])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_dq_matches_plain(cuda_device, d, kv_h, causal, s):
    """K2's bf16 wgmma/TMA design, GQA groups 1/2/4, within
    ``dq_tolerance``, bit-identical reruns."""
    q, k, v, do = _inputs(17, 2, s, 4, kv_h, d, cuda_device, torch.bfloat16)
    block = 64 if s % 128 else None
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, block_q=block,
                                    block_k=block)
    delta = fa._delta(o, do)
    before = fa.flash_attention_dq.launches_by_design["sm90"]
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, causal=causal)
    dq2 = fa.flash_attention_dq(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_dq.launches_by_design["sm90"] == before + 2
    assert torch.equal(dq, dq2)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, causal=causal)
    _assert_grads_close(q, k, v, do, lse, delta, causal, dq, dk, dv)


@pytest.mark.cuda
def test_sm90_dkv_through_strided_and_misaligned_inputs(cuda_device):
    """Strided ``qkv[:, :, i]`` views go to TMA as they are; a dO whose base
    TMA cannot take is copied; both still run the sm90 kernels (K2 and K3)
    and give the contiguous inputs' grads."""
    qkv = torch.randn(2, 256, 3, 4, 64, device=cuda_device,
                      dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 256, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    buf = torch.empty(do.numel() + 1, device=cuda_device, dtype=do.dtype)
    do_off = buf[1:].view(do.shape)
    do_off.copy_(do)
    assert not fa._tma_ready(do_off)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa._delta(o, do)
    counts = [dict(fn.launches_by_design)
              for fn in (fa.flash_attention_dq, fa.flash_attention_dkv)]
    got = (fa.flash_attention_dq(q, k, v, do_off, lse, delta, causal=True),
           *fa.flash_attention_dkv(q, k, v, do_off, lse, delta, causal=True))
    contiguous = (q.contiguous(), k.contiguous(), v.contiguous(), do, lse,
                  delta)
    ref = (fa.flash_attention_dq(*contiguous, causal=True),
           *fa.flash_attention_dkv(*contiguous, causal=True))
    for fn, before in zip((fa.flash_attention_dq, fa.flash_attention_dkv),
                          counts):
        assert fn.launches_by_design == {"sm90": before["sm90"] + 2,
                                         "fma": before["fma"]}
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


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
def test_cuda_tensors_never_take_the_plain_version(cuda_device, monkeypatch):
    """A shape the kernels refuse raises on the card, in either design; it
    is not computed by the plain version instead, which a CUDA tensor never
    reaches."""
    def never(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("flash_attention_dq_reference",
                 "flash_attention_dkv_reference"):
        monkeypatch.setattr(fa, name, never)
    q = torch.zeros(1, 128, 2, 48, device=cuda_device)
    lse = torch.zeros(2, 128, 1, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_dq(q, q, q, q, lse, lse, causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_dkv(q, q, q, q, lse, lse, causal=True)
    # the sm90 design (bf16, d 64) with an LSE that is not [b*h, s, 1]
    q = torch.zeros(1, 128, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    flat = torch.zeros(2, 128, device=cuda_device)
    with pytest.raises(ValueError, match="lse must be contiguous"):
        fa.flash_attention_dq(q, q, q, q, flat, lse, causal=True)
    with pytest.raises(ValueError, match="lse must be contiguous"):
        fa.flash_attention_dkv(q, q, q, q, flat, lse, causal=True)
    dq = fa.flash_attention_dq(q, q, q, q, lse, lse, causal=True)
    dk, dv = fa.flash_attention_dkv(q, q, q, q, lse, lse, causal=True)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g.float()).all()) for g in (dq, dk, dv))
