"""The flash-attention kernels K1, K2 and K3 at sequence lengths that no
tile divides, against their plain versions, on the card.

Needs a CUDA card and nvcc (the kernels have no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_flash_ragged_cuda.py``.

Both designs: ``sm90`` (bf16 at head dim 64 and 128) and ``fma`` (f32, and
bf16 at head dims 32 and 256). The last query tile and the last key tile
are partial: a key past ``seq`` must take no softmax mass, a query row past
``seq`` must add nothing to dK and dV, and no kernel may read a row past
``seq`` of its inputs, of the LSE or of Delta. Tolerances:
``fa.forward_tolerance`` for O (the LSE within 1e-4, f32 on both sides),
``fa.dq_tolerance`` and ``fa.dkv_tolerance`` for the gradients, each for
the design that runs (see ``ops/flash_attention.py``). At s 1 dQ and dK
vanish in exact arithmetic (one key takes all the mass) and both sides
hold rounding residue: there they also take ``fa.vanishing_grad_floor``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
attention = importlib.import_module("cron_operator_tpu_torch.ops.attention")

RAGGED = (1, 63, 65, 197, 200, 255, 1000)
# (dtype, head dim): two of each design
SHAPES = [(torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 64),
          (torch.bfloat16, 32)]
H = 4
# Seconds one test may take, the kernels' first build included. A kernel
# that never finishes (an mbarrier phase error) would hang the run: the
# watchdog prints every thread's stack and ends the process instead.
CASE_TIMEOUT_S = 300


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _inputs(seed, b, s, kv_h, d, device, dtype):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        .to(device, dtype)
        for shape in ((b, s, H, d), (b, s, kv_h, d), (b, s, kv_h, d),
                      (b, s, H, d))
    ]


def _fwd(q, k, v, causal):
    """K1 through the public entry, whose block rule a single block of the
    whole sequence meets at any length (the kernel's tiles do not follow
    the blocks)."""
    s = q.shape[1]
    return fa.flash_attention_fwd(q, k, v, causal=causal, block_q=s,
                                  block_k=s)


def _run(q, k, v, do, causal, lse_delta=None):
    """K1, then K2 and K3 on its LSE and Delta (or on ``lse_delta``)."""
    o, lse = _fwd(q, k, v, causal)
    lse, delta = lse_delta or (lse, fa._delta(o, do))
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, causal=causal)
    return o, lse, delta, dq, dk, dv


def _assert_match_plain(q, k, v, do, causal, o, lse, delta, dq, dk, dv):
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
    for got in (o, lse, dq, dk, dv):
        assert bool(torch.isfinite(got.float()).all())
    bound = fa.forward_tolerance(q, k, v, o_ref, lse_ref, causal=causal)
    assert bool(((o.float() - o_ref.float()).abs() <= bound).all())
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    refs = (fa.flash_attention_dq_reference(q, k, v, do, lse, delta,
                                            causal=causal),
            *fa.flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                              causal=causal))
    bounds = (fa.dq_tolerance(q, k, v, do, lse, delta, refs[0],
                              causal=causal),
              *fa.dkv_tolerance(q, k, v, do, lse, delta, *refs[1:],
                                causal=causal))
    if q.shape[1] == 1:
        floors = fa.vanishing_grad_floor(q, k, v, do, lse, causal=causal)
        bounds = (bounds[0] + floors[0], bounds[1] + floors[1], bounds[2])
    for got, ref, bound in zip((dq, dk, dv), refs, bounds):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert bool(((got.float() - ref.float()).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv_h", [4, 2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype, d", SHAPES)
@pytest.mark.parametrize("s", RAGGED)
def test_kernels_match_plain_at_ragged_lengths(cuda_device, s, dtype, d,
                                               causal, kv_h):
    q, k, v, do = _inputs(s, 2, s, kv_h, d, cuda_device, dtype)
    design = fa._design(dtype, d)
    before = [fn.launches_by_design[design] for fn in (
        fa.flash_attention, fa.flash_attention_dq, fa.flash_attention_dkv)]
    first = _run(q, k, v, do, causal)
    again = _run(q, k, v, do, causal)
    torch.cuda.synchronize()
    assert [fn.launches_by_design[design] - n for fn, n in zip(
        (fa.flash_attention, fa.flash_attention_dq, fa.flash_attention_dkv),
        before)] == [2, 2, 2]
    for a, b in zip(first, again):
        assert torch.equal(a, b)  # no atomics: bit-identical run to run
    _assert_match_plain(q, k, v, do, causal, *first)


def _in_nan(x, pad_rows=37):
    """``x`` [b, s, h, d] as a view into a buffer of b + 1 batches of s +
    ``pad_rows`` rows that holds NaN everywhere else: past s in every batch,
    and a whole next batch."""
    b, s, h, d = x.shape
    buf = torch.full((b + 1, s + pad_rows, h, d), float("nan"),
                     dtype=x.dtype, device=x.device)
    view = buf[:b, :s]
    view.copy_(x)
    return view


def _row_view_in_nan(t, pad=256):
    """Contiguous f32 ``t`` [b*h, s, 1] as a view one value into a buffer
    of NaN (a base 4 bytes off 16, which the kernels take), ``pad`` more
    NaN after it: a read past the last head's rows would meet them."""
    n = t.numel()
    buf = torch.full((n + 1 + pad,), float("nan"), device=t.device)
    buf[1:1 + n] = t.flatten()
    return buf[1:1 + n].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype, d", SHAPES)
@pytest.mark.parametrize("s", [65, 197])
def test_rows_past_seq_are_never_read(cuda_device, s, dtype, d, causal):
    """q, k, v and dO as views into NaN buffers (rows past s, and the next
    batch's rows), the LSE and Delta followed by NaN: every output is
    finite and equal to the run on clean contiguous copies."""
    clean = _inputs(40 + s, 2, s, 2, d, cuda_device, dtype)
    dirty = [_in_nan(x) for x in clean]
    assert not dirty[0].is_contiguous()
    want = _run(*clean, causal)
    o, lse = _fwd(*dirty[:3], causal)
    delta = fa._delta(o, dirty[3])
    got = _run(*dirty, causal, (_row_view_in_nan(lse),
                                _row_view_in_nan(delta)))
    torch.cuda.synchronize()
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a.float()).all())
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, d", [(torch.bfloat16, 64),
                                      (torch.float32, 64)])
def test_a_captured_ragged_step_replays_equal_to_eager(cuda_device, dtype, d):
    """ViT-B/16's 197 tokens through ``multi_head_attention``'s ``auto``,
    forward and backward, captured as one CUDA graph: each replay gives the
    eager step's bits and counts one launch of each kernel."""
    q, k, v, do = _inputs(7, 2, 197, H, d, cuda_device, dtype)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def step():
        for leaf in leaves:
            leaf.grad = None
        out = attention.multi_head_attention(*leaves)
        out.backward(do)
        return out

    want = step().detach().clone()
    want_grads = [leaf.grad.clone() for leaf in leaves]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()  # warm-up on the capture's stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with fa.capture_launches(stream.cuda_stream) as tally:
        with torch.cuda.graph(graph, stream=stream):
            out = step()
    fns = (fa.flash_attention, fa.flash_attention_dq, fa.flash_attention_dkv)
    before = [fn.launches for fn in fns]
    for _ in range(3):
        graph.replay()
    fa.count_replays(tally, 3)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    for leaf, w in zip(leaves, want_grads):
        assert torch.equal(leaf.grad, w)
    assert [fn.launches - n for fn, n in zip(fns, before)] == [3, 3, 3]


@pytest.mark.cuda
def test_auto_at_197_runs_the_sm90_kernels(cuda_device):
    """ViT-B/16's attention shape at a small batch: ``auto`` launches K1,
    K2 and K3 of the sm90 design once each, within their bounds."""
    q = torch.randn(2, 197, 12, 64, device=cuda_device, dtype=torch.bfloat16)
    do = torch.randn_like(q)
    k, v = (torch.randn_like(q) for _ in range(2))
    fns = (fa.flash_attention, fa.flash_attention_dq, fa.flash_attention_dkv)
    before = [fn.launches_by_design["sm90"] for fn in fns]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention.multi_head_attention(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    assert [fn.launches_by_design["sm90"] - n
            for fn, n in zip(fns, before)] == [1, 1, 1]
    o, lse = _fwd(q, k, v, False)
    _assert_match_plain(q, k, v, do, False, out.detach(), lse,
                        fa._delta(o, do), *(leaf.grad for leaf in leaves))
