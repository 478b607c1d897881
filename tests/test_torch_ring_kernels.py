"""The sequence-parallel bodies on the flash block function
(``ops.flash_attention.flash_attention_block``): ring attention's blocks
merged by their LSEs (``parallel.ring.ring_attention_local``) and Ulysses'
attention between its all-to-alls, on the CPU, where the block function
runs the kernels' plain versions.

One gloo world of 4 rank processes (``tests/torch_mesh_ranks.py``, one
thread each) runs every case, once for the module, on meshes of seq 2
(data 2 x seq 2) and seq 4, from the same seeded numpy inputs (b 2, s 160,
h 4, d 16: local blocks of 80 and 40 rows, neither a multiple of the
kernels' 64-row tiles):

- f32, causal and not: the output within ``ATOL`` and the gradients (of
  ``sum(out * dO)``) within ``GRAD_RTOL`` of their largest magnitude of
  JAX's ``ring_attention`` / ``ulysses_attention`` on a mesh of the same
  axes, of the dense port, and for the ring of
  ``ring_attention_local_reference`` (the former online-softmax body);
- the block calls each rank makes: rank ``r`` of a causal ring ``r + 1``
  (its own block causal, the earlier ones in full), every block of a
  non-causal ring in full, one call over the whole sequence for Ulysses;
- bf16: the body's output and gradients against the block function over
  the whole sequence within ``parallel.ring.body_tolerances``.

In this process: the block function's gradients through ``o`` and ``lse``
against autograd of ``flash_attention_reference``; the merge's guard for a
row that saw no key; and a tensor that reports CUDA sent through the ring
and Ulysses bodies reaching the three launchers (monkeypatched, no nvcc)
and never the plain body.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.parallel.mesh import mesh_for_devices as jax_mesh
from cron_operator_tpu.parallel.ring import ring_attention as jax_ring
from cron_operator_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from cron_operator_tpu_torch.parallel import ring, ulysses
from cron_operator_tpu_torch.parallel.ring import (
    _single_device_attention,
    body_tolerances,
    merge_blocks,
)
from torch_mesh_ranks import body_arrays, start_world, wait_world

# the module, not the function that the ops package exports by its name
fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

ATOL = 1e-5  # values, f32, as in test_torch_ring.py
GRAD_RTOL = 1e-5  # gradients, of each tensor's largest magnitude
QKV = (17, 2, 160, 4, 16)  # seed, b, s, h, d
WORLD = 4
MESHES = {"seq2": {"seq": 2}, "seq4": {"seq": 4}}  # seq2: data 2 x seq 2
F32_CASES = [(impl, m, c) for impl in ("ring", "ulysses") for m in MESHES
             for c in (False, True)]
BF16_CASES = [("ring", "seq2", True), ("ring", "seq4", True),
              ("ring", "seq4", False), ("ulysses", "seq2", True)]


def _name(impl, mesh_name, causal, dtype="float32"):
    return f"{impl}-{mesh_name}-{'causal' if causal else 'full'}-{dtype}"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("body_world")
    jobs = [{"kind": "body", "name": _name(i, m, c, dtype), "axes": MESHES[m],
             "impl": i, "causal": c, "qkv": list(QKV), "dtype": dtype}
            for dtype, cases in (("float32", F32_CASES),
                                 ("bfloat16", BF16_CASES))
            for i, m, c in cases]
    wait_world(start_world(WORLD, jobs, out), timeout=300)
    return {job["name"]: [torch.load(out / f"{job['name']}.rank{r}.pt",
                                     weights_only=False)
                          for r in range(WORLD)] for job in jobs}


def _close(got, want, rtol=GRAD_RTOL):
    want = torch.as_tensor(np.array(want))
    atol = rtol * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _jax(impl, mesh_name, causal):
    """JAX's function over a mesh of the same axes: the output and the
    gradients of sum(out * dO)."""
    seq = MESHES[mesh_name]["seq"]
    mesh = jax_mesh(jax.devices("cpu")[:WORLD], seq=seq)
    q, k, v, do = (jnp.asarray(a) for a in body_arrays(*QKV))
    fn = jax_ring if impl == "ring" else jax_ulysses

    def f(q, k, v):
        return fn(q, k, v, mesh, causal=causal)

    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * do),
                             argnums=(0, 1, 2)))(q, k, v)
    return out, grads


def _dense(causal):
    q, k, v, do = (torch.from_numpy(a) for a in body_arrays(*QKV))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = _single_device_attention(*leaves, causal=causal)
    out.backward(do)
    return out.detach(), [x.grad for x in leaves]


_IDS = [_name(*c) for c in F32_CASES]


@pytest.mark.parametrize("impl, mesh_name, causal", F32_CASES, ids=_IDS)
def test_body_matches_jax(world, impl, mesh_name, causal):
    out, grads = _jax(impl, mesh_name, causal)
    for got in world[_name(impl, mesh_name, causal)]:
        _close(got["out"], out, ATOL)
        for g, want in zip(got["grads"], grads):
            _close(g, want)


@pytest.mark.parametrize("impl, mesh_name, causal", F32_CASES, ids=_IDS)
def test_body_matches_the_dense_port(world, impl, mesh_name, causal):
    out, grads = _dense(causal)
    for got in world[_name(impl, mesh_name, causal)]:
        assert (got["out"] - out).abs().max() <= ATOL
        for g, want in zip(got["grads"], grads):
            _close(g, want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_its_plain_version(world, mesh_name, causal):
    """The block body against ``ring_attention_local_reference``, the former
    online-softmax body, through the same scaffolding and hops."""
    for got in world[_name("ring", mesh_name, causal)]:
        assert (got["out"] - got["ref_out"]).abs().max() <= ATOL
        for g, want in zip(got["grads"], got["ref_grads"]):
            _close(g, want)


@pytest.mark.parametrize("impl, mesh_name, causal", F32_CASES, ids=_IDS)
def test_block_calls_follow_the_mask(world, impl, mesh_name, causal):
    """Ring rank r of a causal ring calls the block function r + 1 times:
    its own block causal first, then the earlier ranks' in full (the later
    ones add nothing); a non-causal ring calls it once per block, in full;
    Ulysses once, over the whole sequence."""
    seq = MESHES[mesh_name]["seq"]
    t = QKV[2] // seq
    for got in world[_name(impl, mesh_name, causal)]:
        r = got["coord"]
        if impl == "ulysses":
            want = [(causal, QKV[2])]
        elif causal:
            want = [(True, t)] + [(False, t)] * r
        else:
            want = [(False, t)] * seq
        assert got["calls"] == want


@pytest.mark.parametrize("impl, mesh_name, causal", BF16_CASES,
                         ids=[_name(*c, "bfloat16") for c in BF16_CASES])
def test_bf16_body_within_body_tolerances(world, impl, mesh_name, causal):
    """bf16: the body's roundings (each block's o rounded before the f32
    merge, dO scaled and rounded per block, partial gradients added in
    bf16) stay within ``body_tolerances`` of the block function over the
    whole sequence (one block; its plain version here)."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in body_arrays(*QKV))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, _ = fa.flash_attention_block(*leaves, causal=causal)
    out.backward(do)
    blocks = MESHES[mesh_name]["seq"] if impl == "ring" else 1
    bounds = body_tolerances(q, k, v, do, causal=causal, blocks=blocks)
    want = [out.detach()] + [x.grad for x in leaves]
    for got in world[_name(impl, mesh_name, causal, "bfloat16")]:
        for key, g, w in zip(("o", "dq", "dk", "dv"),
                             [got["out"]] + got["grads"], want):
            err = (g.float() - w.float()).abs()
            assert (err <= bounds[key]).all(), (key, float(err.max()))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("through", ["o", "lse", "both"])
def test_block_function_gradients(causal, through):
    """The block function's backward (``Delta - dlse`` in Delta's place)
    against autograd of ``flash_attention_reference``, through ``o``, the
    LSE or both, at 40 rows."""
    gen = torch.Generator().manual_seed(23)
    b, s, h, d = 2, 40, 3, 16
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen) for _ in range(4))
    dlse = torch.randn(b * h, s, 1, generator=gen)

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o, lse = fn(*leaves, causal=causal)
        loss = 0.0
        if through in ("o", "both"):
            loss = loss + (o * do).sum()
        if through in ("lse", "both"):
            loss = loss + (lse * dlse).sum()
        loss.backward()
        return [o.detach(), lse.detach()] + [x.grad for x in leaves]

    got = grads(fa.flash_attention_block)
    want = grads(fa.flash_attention_reference)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        # the LSE alone does not reach V: autograd leaves its gradient None
        _close(g, torch.zeros_like(g) if w is None else w)


def test_merge_reads_a_keyless_row_as_no_mass():
    """A block row that saw no key (LSE_MASKED, o 0) takes no weight: the
    merge gives the other block's row to the bit."""
    gen = torch.Generator().manual_seed(29)
    b, t, h, d = 1, 3, 2, 4
    outs = [torch.randn(b, t, h, d, generator=gen) for _ in range(2)]
    lses = [torch.randn(b * h, t, 1, generator=gen) for _ in range(2)]
    lses[1][:, 0] = fa.LSE_MASKED
    outs[1][:, 0] = 0.0
    merged = merge_blocks(outs, lses)
    assert torch.equal(merged[:, 0], outs[0][:, 0])
    assert torch.isfinite(merged).all()
    one = merge_blocks(outs[:1], lses[:1])  # one block: its own bits
    assert torch.equal(one, outs[0])


class _OnTheCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: what the bodies
    and the wrappers see of a tensor on the card."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


def _plain(x):
    return x.as_subclass(torch.Tensor)


@pytest.fixture
def launches(monkeypatch):
    """The three launchers replaced by their plain versions, each call
    recorded as (kernel, causal); the plain bodies fail the test."""
    calls = []

    def k1(q, k, v, causal):
        calls.append(("K1", causal))
        return fa.flash_attention_reference(*map(_plain, (q, k, v)),
                                            causal=causal)

    def k2(q, k, v, do, lse, delta, causal):
        calls.append(("K2", causal))
        return fa.flash_attention_dq_reference(
            *map(_plain, (q, k, v, do)), lse, delta, causal=causal)

    def k3(q, k, v, do, lse, delta, causal):
        calls.append(("K3", causal))
        return fa.flash_attention_dkv_reference(
            *map(_plain, (q, k, v, do)), lse, delta, causal=causal)

    def plain_body(*args, **kw):
        pytest.fail("a body ran plain attention on the card")

    monkeypatch.setattr(fa, "_launch", k1)
    monkeypatch.setattr(fa, "_launch_dq", k2)
    monkeypatch.setattr(fa, "_launch_dkv", k3)
    for name in ("online_softmax_step", "_single_device_attention",
                 "ring_attention_local_reference"):
        monkeypatch.setattr(ring, name, plain_body)
    return calls


def _fake_mesh(seq):
    return SimpleNamespace(mesh_dim_names=("seq",), shape=(seq,),
                           get_group=lambda axis: None,
                           get_local_rank=lambda axis: _fake_mesh.rank)


@pytest.mark.parametrize("mine", [0, 1, 2, 3])
def test_ring_on_the_card_launches_the_kernels(monkeypatch, launches, mine):
    """Rank ``mine`` of a causal ring of 4 on a tensor that reports CUDA
    (hops replaced by the blocks they would bring): K1 ``mine + 1`` times,
    the diagonal causal, K2 and K3 as often in the backward, never the
    plain body; its rows of the whole sequence's attention."""
    seq, t = 4, 40
    q, k, v, do = (torch.from_numpy(a) for a in body_arrays(31, 1, seq * t,
                                                            2, 16))
    blocks = [(k[:, i * t:(i + 1) * t], v[:, i * t:(i + 1) * t])
              for i in range(seq)]
    hops = iter(range(1, seq))

    def hop(tensors, group, shift=1):
        i = next(hops)
        return tuple(x.as_subclass(_OnTheCard)
                     for x in blocks[(mine - i) % seq])

    monkeypatch.setattr(ring, "ppermute", hop)
    _fake_mesh.rank = mine
    rows = slice(mine * t, (mine + 1) * t)
    leaves = [x[:, rows].clone().as_subclass(_OnTheCard).requires_grad_()
              for x in (q, k, v)]
    out = ring.ring_attention_local(*leaves, mesh=_fake_mesh(seq),
                                    causal=True)
    n = mine + 1
    assert launches == [("K1", True)] + [("K1", False)] * (n - 1)
    out.backward(do[:, rows])
    assert sorted(launches[n:]) == sorted(
        [("K2", True), ("K3", True)] + [("K2", False), ("K3", False)]
        * (n - 1))
    want = _single_device_attention(q, k, v, causal=True)[:, rows]
    assert (_plain(out) - want).abs().max() <= ATOL


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_on_the_card_launches_the_kernels(monkeypatch, launches,
                                                  causal):
    """Ulysses on a tensor that reports CUDA (a seq axis of 1, the
    all-to-all the identity): one K1, K2 and K3 launch, never the plain
    body."""
    monkeypatch.setattr(ulysses, "_all_to_all", lambda x, group: x.clone())
    _fake_mesh.rank = 0
    q, k, v, do = (torch.from_numpy(a) for a in body_arrays(37, 1, 40, 2, 16))
    leaves = [x.clone().as_subclass(_OnTheCard).requires_grad_()
              for x in (q, k, v)]
    out = ulysses.ulysses_attention_local(*leaves, mesh=_fake_mesh(1),
                                          causal=causal)
    out.backward(do)
    assert launches == [("K1", causal), ("K2", causal), ("K3", causal)]
    want = _single_device_attention(q, k, v, causal=causal)
    assert (_plain(out) - want).abs().max() <= ATOL
