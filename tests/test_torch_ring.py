"""The port's sequence parallelism (``parallel/ring.py``, ``parallel/ulysses.py``
and their routes through ``ops/attention.py`` and the training jobs), in
gloo worlds on the CPU.

Worlds of 2 and 4 rank processes (``tests/torch_mesh_ranks.py``, one
thread each) are spawned together, once for the module; the test process
runs the port's dense attention and the one-process port, and the JAX
package on meshes of the same axes over its virtual CPU devices, beside
them, all from the same seeded numpy inputs in f32.

- Ring and Ulysses attention (the cases of ``tests/test_parallel.py``'s
  ``TestRingAttention`` and ``TestUlyssesAttention``) under seq 2, seq 4
  and data 2 x seq 2, causal and not: the public function on global
  tensors and the dispatch on DTensors with grouped-query K/V (4 query
  heads, 2 K/V heads) give the dense port's values within 1e-5 and its
  gradients within 1e-5 of their largest magnitude, and the JAX
  function's (and JAX's dispatch's) within the same bounds; the dispatch
  on each rank's plain block with the mesh passed (the plain path), and
  ``xla`` there (the sequence gathered), give the dense port's rows and
  gradients within the same bounds; fully masked
  rows give 0; the degenerate mesh and a batch of 1 give plain attention;
  an indivisible sequence and an indivisible head count raise.
- The hop (``ppermute``): coordinate i receives i - shift, its transpose
  sends the gradient back; the host-staged path (gloo groups with CUDA
  tensors) moves the same values and is chosen for exactly that case.
- Workloads (``tests/test_workloads.py`` 52-117 and
  ``test_bert_trains_with_ulysses``): tiny BERT with ring attention under
  seq 2 x tensor 2 (the ring over each rank's two heads), tiny GPT with
  ring and Switch-MoE blocks under seq 2, tiny GPT with GQA and RoPE under
  ring seq 2, and tiny BERT with Ulysses under seq 2 (all on the plain
  path, DDP):
  3 steps of the numpy batches from converted JAX weights, losses within
  rtol 1e-5 of the one-process port and within 5e-5 of the JAX ``Trainer``
  on its mesh (the bound of ``test_torch_parallel.py``), every rank
  reporting the same global loss.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.models import GPT as JaxGPT
from cron_operator_tpu.models import Bert as JaxBert
from cron_operator_tpu.models import BertConfig as JaxBertConfig
from cron_operator_tpu.models import GPTConfig as JaxGPTConfig
from cron_operator_tpu.ops.attention import multi_head_attention as jax_mha
from cron_operator_tpu.parallel.mesh import mesh_for_devices as jax_mesh
from cron_operator_tpu.parallel.ring import ring_attention as jax_ring
from cron_operator_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu_torch.models.bert import Bert, BertConfig
from cron_operator_tpu_torch.models.convert import params_from_flax
from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
from cron_operator_tpu_torch.parallel import ring
from cron_operator_tpu_torch.parallel.ring import (
    _single_device_attention,
    online_softmax_result,
    online_softmax_step,
)
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer
from torch_mesh_ranks import qkv_arrays, start_world, wait_world

ATOL = 1e-5  # values, f32, against the dense port and JAX
GRAD_RTOL = 1e-5  # gradients, of each tensor's largest magnitude
LOSS_RTOL = 1e-5  # against the one-process port
LOSS_ATOL = 5e-5  # against the JAX Trainer
QKV = (3, 4, 32, 4, 2, 8)  # seed, b, s, h, kv heads, d
# name: (world, axes)
MESHES = {"seq2": (2, {"seq": 2}), "seq4": (4, {"seq": 4}),
          "data2_seq2": (4, {"seq": 2})}
SEQ, BATCH, STEPS = 32, 4, 3
MOE = {"moe_every": 2, "num_experts": 4}
# name: (world, axes, model, model overrides, stream, the trainer's path:
# seq meshes train plain modules, with tensor too for GPT and BERT)
RUNS = {
    "bert_ring_seq2_tensor2": (4, {"seq": 2, "tensor": 2}, "bert",
                               {"attention_impl": "ring"}, "token_batches",
                               "ddp"),
    "gpt_ring_moe_seq2": (2, {"seq": 2}, "gpt",
                          {"attention_impl": "ring", **MOE},
                          "causal_token_batches", "ddp"),
    "gpt_gqa_rope_ring_seq2": (2, {"seq": 2}, "gpt",
                               {"attention_impl": "ring", "num_kv_heads": 2,
                                "rope": True}, "causal_token_batches", "ddp"),
    "bert_ulysses_seq2": (2, {"seq": 2}, "bert",
                          {"attention_impl": "ulysses"}, "token_batches",
                          "ddp"),
}
SP_TRAIN = {"seq_dim_in_batch": 1, "labels_follow_seq": True}


def _flax(model, over, mesh):
    """The JAX model over ``mesh`` and its seed-0 parameters, as numpy."""
    maker = JaxBertConfig.tiny if model == "bert" else JaxGPTConfig.tiny
    cfg = maker(dtype=jnp.float32, max_len=SEQ, **over)
    cls = JaxBert if model == "bert" else JaxGPT
    # the parameters do not depend on the attention: init the plain model
    plain = cls(replace(cfg, attention_impl="xla"))
    params = plain.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, SEQ), jnp.int32))["params"]
    return cls(cfg, mesh=mesh), jax.tree_util.tree_map(np.asarray, params)


def _port(model, over):
    maker = BertConfig.tiny if model == "bert" else GPTConfig.tiny
    cfg = maker(dtype=torch.float32, max_len=SEQ, **over)
    return (Bert if model == "bert" else GPT)(cfg)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq_worlds")
    jobs = {2: [], 4: []}
    for name, (world, axes) in MESHES.items():
        for impl in ("ring", "ulysses"):
            for causal in (False, True):
                jobs[world].append({
                    "kind": "attention", "name": f"{impl}-{name}-{causal}",
                    "axes": axes, "impl": impl, "causal": causal,
                    "qkv": list(QKV)})
    for world in jobs:
        axes = {"seq": world}
        jobs[world] += [
            {"kind": "hop", "name": f"hop{world}", "axes": axes,
             "axis": "seq", "shift": 1},
            {"kind": "hop", "name": f"hop{world}_back", "axes": axes,
             "axis": "seq", "shift": -1},
            {"kind": "guards", "name": f"guards{world}", "axes": axes}]
    result = {"flax": {}, "weights": {}}
    for name, (world, axes, model, over, stream, _) in RUNS.items():
        mesh = jax_mesh(jax.devices("cpu")[:world], **axes)
        net, params = _flax(model, over, mesh)
        weights = params_from_flax(params, _port(model, over).config)
        path = out / f"{name}.weights.pt"
        torch.save(weights, path)
        result["flax"][name] = (net, mesh, params)
        result["weights"][name] = weights
        jobs[world].append({
            "kind": "train", "name": name, "axes": axes, "model": model,
            "cfg": {"max_len": SEQ, **over}, "stream": stream,
            "weights": str(path), "batch": BATCH, "steps": STEPS,
            "train": SP_TRAIN})
    running = [start_world(w, js, out) for w, js in jobs.items()]
    for procs in running:
        wait_world(procs)
    for world, js in jobs.items():
        for job in js:
            result[job["name"]] = [
                torch.load(out / f"{job['name']}.rank{r}.pt",
                           weights_only=False) for r in range(world)]
    return result


def _close(got, want, rtol=GRAD_RTOL):
    want = torch.as_tensor(np.array(want))
    atol = rtol * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _dense(causal):
    """The dense port on the global inputs (K/V repeated): the output and
    the gradients of sum(out ** 2) for q and the grouped k and v."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv_arrays(*QKV))
    group = q.shape[2] // k.shape[2]
    out = _single_device_attention(q, k.repeat_interleave(group, 2),
                                   v.repeat_interleave(group, 2),
                                   causal=causal)
    (out ** 2).sum().backward()
    return out.detach(), [t.grad for t in (q, k, v)]


def _jax(impl, mesh_name, causal):
    """JAX's function on the repeated inputs and JAX's dispatch on the
    grouped ones, over a mesh of the same axes: outputs and gradients."""
    world, axes = MESHES[mesh_name]
    mesh = jax_mesh(jax.devices("cpu")[:world], **axes)
    q, k, v = (jnp.asarray(a) for a in qkv_arrays(*QKV))
    group = q.shape[2] // k.shape[2]
    fn = jax_ring if impl == "ring" else jax_ulysses

    def plain(q, k, v):
        return fn(q, k, v, mesh, causal=causal)

    def dispatch(q, k, v):
        return jax_mha(q, k, v, causal=causal, impl=impl, mesh=mesh)

    rep = (q, jnp.repeat(k, group, 2), jnp.repeat(v, group, 2))
    out = {}
    for name, f, args in (("plain", plain, rep), ("dispatch", dispatch,
                                                  (q, k, v))):
        out[name] = jax.jit(f)(*args)
        out[name + "_grads"] = jax.jit(jax.grad(
            lambda *a, f=f: jnp.sum(f(*a) ** 2), argnums=(0, 1, 2)))(*args)
    return out


CASES = [(impl, m, c) for impl in ("ring", "ulysses") for m in MESHES
         for c in (False, True)]


@pytest.mark.parametrize("impl, mesh_name, causal", CASES,
                         ids=[f"{i}-{m}-{'causal' if c else 'full'}"
                              for i, m, c in CASES])
def test_matches_dense_and_jax(worlds, impl, mesh_name, causal):
    """TestRingAttention.test_matches_reference and
    TestUlyssesAttention.test_matches_reference/test_grads_match_reference,
    over the same mesh axes, with GQA through the dispatch."""
    ranks = worlds[f"{impl}-{mesh_name}-{causal}"]
    want, want_grads = _dense(causal)
    ref = _jax(impl, mesh_name, causal)
    group = QKV[3] // QKV[4]
    for got in ranks:
        for key in ("out", "out_dispatch"):
            assert (got[key] - want).abs().max() <= ATOL
        _close(got["out"], ref["plain"], ATOL)
        _close(got["out_dispatch"], ref["dispatch"], ATOL)
        for g, w, j in zip(got["grads_dispatch"], want_grads,
                           ref["dispatch_grads"]):
            _close(g, w)
            _close(g, j)
        # the plain way took repeated K/V: sum its gradients per group
        plain = [got["grads"][0]] + [
            g.unflatten(2, (-1, group)).sum(3) for g in got["grads"][1:]]
        for g, w in zip(plain, want_grads):
            _close(g, w)
        for g, j in zip(got["grads"], ref["plain_grads"]):
            _close(g, j)
    assert ranks[0]["placements"] == ["S(0)", "S(1)"]  # batch, sequence


@pytest.mark.parametrize("impl, mesh_name, causal", CASES,
                         ids=[f"{i}-{m}-{'causal' if c else 'full'}"
                              for i, m, c in CASES])
def test_local_blocks_match_dense(worlds, impl, mesh_name, causal):
    """The dispatch on each rank's plain block of rows and positions with
    the mesh passed (the plain path's layers, grouped K/V): ``ring`` or
    ``ulysses`` run their body on the blocks, ``xla`` gathers the sequence;
    each gives the dense port's rows of the output, and its gradients of
    the summed ``sum(out ** 2)`` (the other blocks' parts brought back by
    the reverse hops, all-to-alls or gathers)."""
    want, want_grads = _dense(causal)
    for got in worlds[f"{impl}-{mesh_name}-{causal}"]:
        rows, positions = (slice(*got[k]) for k in ("rows", "positions"))
        for way in (impl, "xla"):
            local = got["local"][way]
            assert (local["out"] - want[rows, positions]).abs().max() <= ATOL
            for g, w in zip(local["grads"], want_grads):
                _close(g, w[rows, positions])


def test_grad_flows_through_ring(worlds):
    """TestRingAttention.test_grad_flows_through_ring: finite gradients of
    the right shape, the ring's reverse hops included."""
    for got in worlds["ring-seq2-False"]:
        for g, shape in zip(got["grads"], [(4, 32, 4, 8)] * 3):
            assert g.shape == shape and torch.isfinite(g).all()


@pytest.mark.parametrize("world", [2, 4])
def test_guards(worlds, world):
    """TestRingAttention.test_degenerate_mesh_falls_back and
    test_indivisible_seq_raises_for_real_batch, and
    TestUlyssesAttention.test_head_divisibility_enforced."""
    got = worlds[f"guards{world}"][0]
    assert "does not divide" in got["indivisible"]
    assert got["batch_of_one"] <= ATOL  # a batch of 1 falls back
    assert "heads" in got["heads"]
    assert got["degenerate"] <= ATOL  # no seq axis: plain attention


def test_fully_masked_rows_give_zero():
    """The -inf guards of the ring step: a row masked on every block folds
    to 0 with finite gradients, and a row masked on one block keeps what
    the other gave."""
    gen = torch.Generator().manual_seed(5)
    s1 = torch.randn(1, 1, 3, 4, generator=gen)
    s2 = torch.randn(1, 1, 3, 4, generator=gen)
    v1 = torch.randn(1, 4, 1, 2, generator=gen, requires_grad=True)
    v2 = torch.randn(1, 4, 1, 2, generator=gen, requires_grad=True)
    s1[..., 0, :] = float("-inf")  # row 0 masked everywhere
    s2[..., 0, :] = float("-inf")
    s2[..., 1, :] = float("-inf")  # row 1 masked on the second block only
    carry = (torch.zeros(1, 1, 3, 2), torch.full((1, 1, 3), float("-inf")),
             torch.zeros(1, 1, 3))
    carry = online_softmax_step(carry, s1, v1)
    out = online_softmax_result(online_softmax_step(carry, s2, v2))
    assert torch.equal(out[:, 0], torch.zeros(1, 1, 2))
    one = torch.softmax(s1[0, 0, 1], -1) @ v1[0, :, 0]
    assert torch.allclose(out[0, 1, 0], one, atol=1e-6)
    out.sum().backward()
    assert torch.isfinite(v1.grad).all() and torch.isfinite(v2.grad).all()


@pytest.mark.parametrize("name", ["hop2", "hop2_back", "hop4", "hop4_back"])
def test_hop_and_its_transpose(worlds, name):
    """ppermute: coordinate i receives what i - shift sent; the backward is
    the reverse hop, so x's gradient on i is the weight (coordinate + 1) of
    the rank that received it, i + shift; the host-staged hop moves the
    same values."""
    ranks = worlds[name]
    n = len(ranks)
    shift = -1 if name.endswith("back") else 1
    for got in ranks:
        c = got["coord"]
        assert torch.equal(got["out"], torch.full((3,), float((c - shift) % n)))
        assert torch.equal(got["grad"],
                           torch.full((3,), float((c + shift) % n + 1)))
        assert torch.equal(got["staged"][0], got["out"])
        assert torch.equal(got["staged"][1], got["out"] * 2)


def test_hop_stages_cuda_tensors_over_gloo_only(monkeypatch):
    """The hop goes through pinned host buffers for CUDA tensors over a
    gloo group (gloo's send and receive take host memory only) and
    directly otherwise: CPU tensors over gloo, anything over NCCL."""
    cuda = SimpleNamespace(is_cuda=True)
    cpu = SimpleNamespace(is_cuda=False)
    backends = {"g": "gloo", "n": "nccl"}
    monkeypatch.setattr(ring.dist, "get_backend", backends.get)
    assert ring.stages_through_host("g", [cuda])
    assert ring.stages_through_host("g", [cpu, cuda])
    assert not ring.stages_through_host("g", [cpu])
    assert not ring.stages_through_host("n", [cuda])


def _one_process(name, weights):
    """The one-process port run of a RUNS entry: its losses."""
    world, axes, model, over, stream, _ = RUNS[name]
    net = _port(model, over)
    net.load_state_dict(weights)
    trainer = Trainer(net, TrainConfig(
        steps_per_call=1, stage_async=False,
        aux_loss_in_output=getattr(net, "has_moe", False)))
    stats = trainer.run(getattr(data, stream)(BATCH, SEQ, 1024), STEPS)
    return [s.loss for s in stats]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sequence_parallel_training_matches_one_process(worlds, name):
    ranks = worlds[name]
    assert [r["path"] for r in ranks] == [RUNS[name][5]] * len(ranks)
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]  # the global loss, everywhere
    got = ranks[0]["losses"]
    assert len(got) == STEPS
    np.testing.assert_allclose(got, _one_process(name, worlds["weights"][name]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sequence_parallel_training_matches_the_jax_trainer(worlds, name):
    """tests/test_workloads.py's test_bert_tp_sp_step,
    test_gpt_ring_sp_step_with_moe and test_gpt_gqa_rope_under_ring_sp, and
    test_parallel.py's test_bert_trains_with_ulysses, held to the JAX
    Trainer's losses on a mesh of the same axes."""
    world, axes, model, over, stream, _ = RUNS[name]
    net, mesh, params = worlds["flax"][name]
    trainer = JaxTrainer(
        lambda p, x: net.apply({"params": p}, x), params, mesh,
        JaxTrainConfig(steps_per_call=1, stage_async=False,
                       aux_loss_in_output=model == "gpt", **SP_TRAIN))
    stats = trainer.run(getattr(jax_data, stream)(BATCH, SEQ, 1024), STEPS)
    got = worlds[name][0]["losses"]
    assert max(abs(a - s.loss) for a, s in zip(got, stats)) <= LOSS_ATOL


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_vit_refuses_sequence_parallel_attention(impl):
    """``vit`` refuses ``attention=ring|ulysses`` (a recorded divergence:
    the JAX job ignores the param)."""
    from cron_operator_tpu_torch.backends.registry import JobContext
    from cron_operator_tpu_torch.workloads.entrypoints import vit

    ctx = JobContext("train", "default", {}, {
        "platform": "cpu", "size": "tiny", "steps": "1", "attention": impl})
    with pytest.raises(ValueError, match="gpt and bert"):
        vit(ctx)
