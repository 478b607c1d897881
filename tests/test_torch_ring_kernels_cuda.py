"""The sequence-parallel bodies on the card: ring attention's blocks through
K1-K3 (``ops.flash_attention.flash_attention_block``) merged by their LSEs,
and Ulysses' attention on its local heads, against K1-K3 over the whole
sequence.

Needs a CUDA card and nvcc (the kernels have no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_ring_kernels_cuda.py``.

One process, no process group: ``parallel.ring.ring_attention_local`` runs
once per ring position on a mesh stand-in, its hops replaced by slices of
the whole K and V (so the blocks' K/V gradients add up in the whole
tensors' gradients, as the reverse hops add them), at bf16 d 64 (the sm90
design), rings of 2 and 4, causal and not, at 1024 tokens and at 520 (local
blocks of 260 and 130 rows, which no tile divides). The output and the
gradients are held to the block function over the whole sequence within
``parallel.ring.body_tolerances``; each block's K1, K2 and K3 to their
plain versions within ``forward_tolerance``, ``dq_tolerance`` and
``dkv_tolerance``; K1-K3 launch once per computed block, all sm90; a rerun
gives the same bits.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
ring = importlib.import_module("cron_operator_tpu_torch.parallel.ring")

pytestmark = pytest.mark.cuda

B, H, D = 2, 4, 64
CASE_TIMEOUT_S = 300  # the kernels' first build included
KERNELS = (fa.flash_attention, fa.flash_attention_dq, fa.flash_attention_dkv)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _inputs(seed, s, device, h=H):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, s, h, D),
                                                 dtype=np.float32))
            .to(device, torch.bfloat16) for _ in range(4)]


def _sm90(kernel):
    return kernel.launches_by_design["sm90"], kernel.launches


def _ring(monkeypatch, q, k, v, do, ring_size, causal):
    """Every position of a ring of ``ring_size`` over the whole ``q``, ``k``
    and ``v``: ``ring_attention_local`` on each position's block, the hop
    bringing the slices of the whole K and V that it would; the output and
    the whole tensors' gradients."""
    s = q.shape[1]
    t = s // ring_size
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    outs = []
    for mine in range(ring_size):
        held = iter(range(1, ring_size))

        def hop(tensors, group, shift=1, mine=mine, held=held):
            src = (mine - next(held)) % ring_size
            return tuple(x[:, src * t:(src + 1) * t] for x in leaves[1:])

        monkeypatch.setattr(ring, "ppermute", hop)
        mesh = SimpleNamespace(mesh_dim_names=("seq",), shape=(ring_size,),
                               get_group=lambda axis: None,
                               get_local_rank=lambda axis, mine=mine: mine)
        rows = slice(mine * t, (mine + 1) * t)
        out = ring.ring_attention_local(
            leaves[0][:, rows], leaves[1][:, rows], leaves[2][:, rows],
            mesh=mesh, causal=causal)
        out.backward(do[:, rows])
        outs.append(out.detach())
    return [torch.cat(outs, 1)] + [x.grad for x in leaves]


def _whole(q, k, v, do, causal):
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, _ = fa.flash_attention_block(*leaves, causal=causal)
    out.backward(do)
    return [out.detach()] + [x.grad for x in leaves]


def _within(got, want, bounds):
    for key, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), key
        err = (g.float() - w.float()).abs()
        assert (err <= bounds[key]).all(), (key, err.max().item())


@pytest.mark.parametrize("s", [1024, 520])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ring_size", [2, 4])
def test_ring_body_matches_the_whole_sequence(cuda_device, monkeypatch, s,
                                              causal, ring_size):
    q, k, v, do = _inputs(ring_size * 10 + int(causal), s, cuda_device)
    before = [_sm90(kernel) for kernel in KERNELS]
    got = _ring(monkeypatch, q, k, v, do, ring_size, causal)
    torch.cuda.synchronize()
    blocks = (ring_size * (ring_size + 1) // 2 if causal
              else ring_size * ring_size)
    for kernel, (sm90, total) in zip(KERNELS, before):
        assert _sm90(kernel) == (sm90 + blocks, total + blocks)
    want = _whole(q, k, v, do, causal)
    _within(got, want, ring.body_tolerances(q, k, v, do, causal=causal,
                                            blocks=ring_size))
    again = _ring(monkeypatch, q, k, v, do, ring_size, causal)
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # no atomics: bit-identical run to run


@pytest.mark.parametrize("s", [1024, 520])
@pytest.mark.parametrize("ring_size", [2, 4])
def test_each_block_matches_its_plain_version(cuda_device, s, ring_size):
    """Every block a causal ring runs (the diagonal causal, the ones below
    it in full) at its shape: K1 against ``flash_attention_reference``,
    K2 and K3 on its LSE and on ``Delta - dlse`` against their plain
    versions on the same inputs."""
    q, k, v, do = _inputs(50 + ring_size, s, cuda_device)
    t = s // ring_size
    dlse = torch.randn(B * H, t, 1, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(3))
    for mine in range(ring_size):
        qr, dor = q[:, mine * t:(mine + 1) * t], do[:, mine * t:(mine + 1) * t]
        for src in range(mine + 1):
            kb, vb = (x[:, src * t:(src + 1) * t] for x in (k, v))
            causal = src == mine
            o, lse = fa.flash_attention_block(qr, kb, vb, causal=causal)
            o_ref, lse_ref = fa.flash_attention_reference(qr, kb, vb,
                                                          causal=causal)
            bound = fa.forward_tolerance(qr, kb, vb, o_ref, lse_ref,
                                         causal=causal)
            assert ((o.float() - o_ref.float()).abs() <= bound).all()
            assert (lse - lse_ref).abs().max() <= 1e-4
            delta = (fa._delta(o, dor) - dlse).contiguous()
            dq = fa.flash_attention_dq(qr, kb, vb, dor, lse, delta,
                                       causal=causal)
            dk, dv = fa.flash_attention_dkv(qr, kb, vb, dor, lse, delta,
                                            causal=causal)
            dq_ref = fa.flash_attention_dq_reference(qr, kb, vb, dor, lse,
                                                     delta, causal=causal)
            dk_ref, dv_ref = fa.flash_attention_dkv_reference(
                qr, kb, vb, dor, lse, delta, causal=causal)
            dq_b = fa.dq_tolerance(qr, kb, vb, dor, lse, delta, dq_ref,
                                   causal=causal)
            dk_b, dv_b = fa.dkv_tolerance(qr, kb, vb, dor, lse, delta, dk_ref,
                                          dv_ref, causal=causal)
            for g, w, bnd in ((dq, dq_ref, dq_b), (dk, dk_ref, dk_b),
                              (dv, dv_ref, dv_b)):
                assert ((g.float() - w.float()).abs() <= bnd).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("par", [2, 4])
def test_ulysses_heads_match_the_whole_sequence(cuda_device, causal, par):
    """Ulysses' attention between its all-to-alls: the block function on
    each coordinate's ``h / P`` heads over the whole sequence, one K1, K2
    and K3 launch each, all sm90; together the whole tensors' arithmetic,
    within ``body_tolerances`` at one block."""
    h = 12
    q, k, v, do = _inputs(70 + par, 512, cuda_device, h=h)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = [_sm90(kernel) for kernel in KERNELS]
    outs = []
    for j in range(par):
        heads = slice(j * h // par, (j + 1) * h // par)
        out, _ = fa.flash_attention_block(*(x[:, :, heads] for x in leaves),
                                          causal=causal)
        out.backward(do[:, :, heads])
        outs.append(out.detach())
    torch.cuda.synchronize()
    for kernel, (sm90, total) in zip(KERNELS, before):
        assert _sm90(kernel) == (sm90 + par, total + par)
    got = [torch.cat(outs, 2)] + [x.grad for x in leaves]
    _within(got, _whole(q, k, v, do, causal),
            ring.body_tolerances(q, k, v, do, causal=causal, blocks=1))
