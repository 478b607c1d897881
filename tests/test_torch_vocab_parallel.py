"""The tied vocab table and the LM loss split over ``tensor``, in gloo
worlds on the CPU.

Under a ``tensor`` axis of t ranks a GPT or BERT rank keeps its block of
the tied table's vocab rows (``parallel.mesh.VocabSplit``: V padded to a
multiple of 64 t, ``Vt / t`` rows a rank, the rows past V zero), embeds
the tokens that fall in its rows, multiplies the final hidden states by
its rows alone and runs the loss on its columns, each row's logsumexp and
label logit merged over the group (``ops.xent.vocab_parallel_cross_entropy``,
and ``chunked_cross_entropy`` for ``fused_xent=1``). The tiny models here
take a vocab of 1000, so that the last rank's block ends in padding (the
tiny configs' own 1024 divides), and one run a vocab of 130 under
``tensor 4``, whose last rank holds no real row.

- Each run of :data:`RUNS` trains on the jobs' LM loss (``lm_loss``): its
  path; the losses of 5 steps and the first step's gradients (gathered
  whole) against the one-process port on the same loss (rtol 1e-5, atol
  1e-5 of each tensor's largest magnitude) and the JAX sharded ``Trainer``
  on a mesh of the same axes (losses within 5e-5, gradients ``jax.grad``'s
  within rtol 1e-4), the bounds of ``tests/test_torch_tensor_plain.py``;
  calls of 4 steps equal to calls of one, to the bit; each rank's model
  FLOPs those of one device; each rank's block of the table the rows the
  split gives it, the padding rows still zero after the steps.
- A checkpoint written under ``tensor 2``, restored by one process as
  ``[V, hidden]`` and written again, then restored under ``tensor 4`` and
  written from its gathered state, holds the same bits at every stage.
- Every rank told the offset 0 for its block (a wrong merge) gives losses
  far outside the bound that the right offset meets.
- The slice forms of the loss's plain versions, merged over t slices,
  equal the whole row within ``ops.xent.merge_tolerance``, and the slice
  at offset 0 with every column real is the whole row's function to the
  bit.

The card's side is ``tests/test_torch_vocab_parallel_cuda.py`` and
``chip_smoke.py``'s phases 15 and 21.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.models import GPT as JaxGPT
from cron_operator_tpu.models import Bert as JaxBert
from cron_operator_tpu.models import BertConfig as JaxBertConfig
from cron_operator_tpu.models import GPTConfig as JaxGPTConfig
from cron_operator_tpu.parallel.mesh import mesh_for_devices as jax_mesh
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu.workloads.train import cross_entropy_loss as jax_xent
from cron_operator_tpu_torch.models.bert import Bert, BertConfig
from cron_operator_tpu_torch.models.convert import params_from_flax
from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig
from cron_operator_tpu_torch.models.layers import VocabPiece, vocab_split
from cron_operator_tpu_torch.ops import xent
from cron_operator_tpu_torch.parallel.mesh import VocabSplit
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
from cron_operator_tpu_torch.workloads.entrypoints import lm_loss
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer
from test_torch_parallel import LOSS_ATOL, _close
from test_torch_tensor_plain import _wait_for_step
from torch_mesh_ranks import start_world, wait_world

SEQ, BATCH, STEPS, CHUNK = 32, 4, 5, 4
VOCAB = 1000  # the last rank's block of 512 (t 2) or 256 (t 4) rows ends in padding
MOE = {"moe_every": 2, "num_experts": 2, "moe_capacity_factor": 1.0}
CLIP = 0.5
# name: (world, axes, model, model overrides, train overrides, path, loss)
RUNS = {
    "gpt_tensor2": (2, {"tensor": 2}, "gpt", {}, {}, "ddp", "lm"),
    # the clip (about a seventh of the first step's norm) bites
    "gpt_data2_tensor2_clip": (4, {"tensor": 2}, "gpt", {},
                               {"grad_clip_norm": CLIP}, "ddp", "lm"),
    "gpt_tensor4": (4, {"tensor": 4}, "gpt", {}, {}, "ddp", "lm"),
    "bert_fsdp2_tensor2": (4, {"fsdp": 2, "tensor": 2}, "bert", {}, {},
                           "fsdp", "lm"),
    "gpt_moe_data2_tensor2": (4, {"tensor": 2}, "gpt", MOE, {}, "ddp", "lm"),
    "gpt_fused_tensor2": (2, {"tensor": 2}, "gpt", {}, {}, "ddp", "fused"),
    # rows 0-63, 64-127, 128-129 and none of the 130 on the four ranks
    "gpt_v130_tensor4": (4, {"tensor": 4}, "gpt", {"vocab_size": 130}, {},
                         "ddp", "lm"),
}
STREAMS = {"gpt": "causal_token_batches", "bert": "token_batches"}
CHAIN = {"cfg": {"max_len": SEQ, "vocab_size": VOCAB}, "batch": BATCH,
         "loss": "lm"}


def _over(over):
    return {"vocab_size": VOCAB, **over}


def _vocab(name):
    return _over(RUNS[name][3])["vocab_size"]


def _port_model(model, over, return_hidden=True):
    maker = BertConfig.tiny if model == "bert" else GPTConfig.tiny
    cls = Bert if model == "bert" else GPT
    return cls(maker(dtype=torch.float32, attention_impl="xla", max_len=SEQ,
                     return_hidden=return_hidden, **_over(over)))


def _jax_model(model, over):
    maker = JaxBertConfig.tiny if model == "bert" else JaxGPTConfig.tiny
    cls = JaxBert if model == "bert" else JaxGPT
    return cls(maker(dtype=jnp.float32, max_len=SEQ, attention_impl="xla",
                     **_over(over)))


def _stream(pkg, model, vocab):
    return getattr(pkg, STREAMS[model])(BATCH, SEQ, vocab)


def _flax_params(model, over):
    params = jax.jit(_jax_model(model, over).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _converted(model, over, params):
    cfg = (BertConfig.tiny if model == "bert" else GPTConfig.tiny)(
        dtype=torch.float32, max_len=SEQ, **_over(over))
    return params_from_flax(params, cfg)


def _one_process(name, weights):
    """The one-process port on the run's loss: losses, the first step's
    gradients and the model FLOPs a step."""
    _, _, model, over, train_kw, _, loss = RUNS[name]
    net = _port_model(model, over)
    net.load_state_dict(weights)
    trainer = Trainer(net, TrainConfig(
        steps_per_call=1, stage_async=False,
        aux_loss_in_output=getattr(net, "has_moe", False), **train_kw),
        loss_fn=lm_loss(None, loss == "fused")[1])
    batches = _stream(data, model, _vocab(name))
    stats = trainer.run(batches, 1)
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    stats += trainer.run(batches, STEPS)
    return {"losses": [s.loss for s in stats], "grads": grads,
            "flops": trainer.flops_per_step()}


def _jax_reference(name):
    """The JAX sharded Trainer's losses on a mesh of the run's axes and the
    first step's (clipped) ``jax.grad`` on one device, as numpy."""
    import optax

    world, axes, model, over, train_kw = RUNS[name][:5]
    params = _flax_params(model, over)
    net = _jax_model(model, over)
    trainer = JaxTrainer(
        lambda p, x: net.apply({"params": p}, x), params,
        jax_mesh(jax.devices("cpu")[:world], **axes),
        JaxTrainConfig(steps_per_call=1, stage_async=False,
                       aux_loss_in_output=model == "gpt", **train_kw))
    stream = _stream(jax_data, model, _vocab(name))
    losses = [s.loss for s in trainer.run(stream, STEPS)]
    batch = next(_stream(jax_data, model, _vocab(name)))

    def loss_of(p):
        out = net.apply({"params": p}, batch["x"])
        if model == "gpt":
            logits, aux = out
            return jax_xent(logits, batch["y"]) + aux
        return jax_xent(out, batch["y"])

    grads = jax.jit(jax.grad(loss_of))(params)
    clip = train_kw.get("grad_clip_norm", 0)
    if clip:
        clip = optax.clip_by_global_norm(clip)
        grads, _ = clip.update(grads, clip.init(grads))
    return losses, jax.tree_util.tree_map(np.asarray, grads)


def _one_rank_round_trip(src, dst) -> int:
    """One process restores the newest step at ``src`` (the table whole,
    ``[V, hidden]``) and writes its ``host_state`` at that step to
    ``dst``; returns the step."""
    model = _port_model("gpt", {}).init_weights(
        torch.Generator().manual_seed(0))
    assert tuple(model.tok_emb.weight.shape) == (VOCAB, 128)
    store = CheckpointStore("ns", "chain", root=src, max_to_keep=100)
    out = CheckpointStore("ns", "chain", root=dst)
    try:
        trainer = Trainer(
            model, TrainConfig(steps_per_call=1),
            sample_fn=data.causal_token_sample(BATCH, SEQ, VOCAB),
            checkpoint=store, loss_fn=lm_loss()[1])
        out.save(trainer.steps_done, trainer.host_state())
    finally:
        out.close()
        store.close()
    return trainer.steps_done


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The ranks' results, and the one-process port's and the JAX
    package's beside them (the JAX package's in three processes of its
    own, while the ranks run)."""
    pool = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
        "spawn"))
    references = {name: pool.submit(_jax_reference, name) for name in RUNS}
    out = tmp_path_factory.mktemp("vocab_parallel_worlds")
    saved, resaved, gathered = (str(out / d) for d in
                                ("saved", "resaved", "gathered"))
    # the tensor 2 save first: the one-process leg waits for it
    jobs = {2: [{**CHAIN, "kind": "chain", "name": "save", "dir": saved,
                 "axes": {"tensor": 2}, "steps": 2, "save_every": 2}],
            4: []}
    result = {"weights": {}, "one": {}}
    for name, (world, axes, model, over, train_kw, _, loss) in RUNS.items():
        job = {"kind": "data_parallel", "name": name, "axes": axes,
               "model": model, "stream": STREAMS[model],
               "cfg": {"max_len": SEQ, **_over(over)}, "loss": loss,
               "weights": str(out / f"{name}.weights.pt"), "batch": BATCH,
               "steps": STEPS, "chunk": CHUNK, "train": train_kw}
        jobs[world].append(job)
        if name == "gpt_tensor2":
            jobs[2].append({**job, "kind": "train", "name": "wrong_offset",
                            "wrong_offset": True})
    jobs[4].append({**CHAIN, "kind": "tensor_restore", "name": "restore",
                    "dir": resaved, "out_dir": gathered,
                    "axes": {"tensor": 4}})
    running = [start_world(w, js, out) for w, js in jobs.items()]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny models, beside 6 ranks and the pool
    try:
        made = {}
        for name, (_, _, model, over, _, _, _) in RUNS.items():
            key = (model, tuple(sorted(over.items())))
            if key not in made:
                made[key] = _converted(model, over,
                                       _flax_params(model, over))
            result["weights"][name] = made[key]
            path = out / f"{name}.weights.pt"
            torch.save(made[key], f"{path}.tmp")
            os.replace(f"{path}.tmp", path)  # whole when a rank sees it
        _wait_for_step(saved)
        result["round_trip_step"] = _one_rank_round_trip(saved, resaved)
        for name in RUNS:
            result["one"][name] = _one_process(name, result["weights"][name])
        result["jax"] = {name: f.result() for name, f in references.items()}
    finally:
        torch.set_num_threads(threads)
        pool.shutdown(cancel_futures=True)
        for procs in running:
            wait_world(procs)
    for world, js in jobs.items():
        for job in js:
            result[job["name"]] = [
                torch.load(out / f"{job['name']}.rank{r}.pt",
                           weights_only=False) for r in range(world)]
    result["payloads"] = [
        torch.load(f"{root}/ns/chain/2/state.pt", weights_only=True)
        for root in (saved, resaved, gathered)]
    return result


@pytest.mark.parametrize("run", sorted(RUNS))
def test_vocab_split_trains_as_one_process(worlds, run):
    ranks = worlds[run]
    assert [r["path"] for r in ranks] == [RUNS[run][5]] * len(ranks)
    ref = worlds["one"][run]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]  # the global loss
    for got in ranks:  # every rank gathers the same whole gradients
        assert len(got["losses"]) == STEPS
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        for name, g in ref["grads"].items():
            _close(got["grads"][name], g)
    if RUNS[run][4].get("grad_clip_norm"):  # the clip bit: norm == CLIP
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in ref["grads"].values()]))
        assert abs(float(norm) - CLIP) <= 1e-5


@pytest.mark.parametrize("run", sorted(RUNS))
def test_vocab_split_trains_as_the_jax_sharded_trainer(worlds, run):
    model, over = RUNS[run][2:4]
    want, jax_grads = worlds["jax"][run]
    got = worlds[run][0]
    assert max(abs(a - b) for a, b in zip(got["losses"], want)) <= LOSS_ATOL
    for name, g in _converted(model, over, jax_grads).items():
        _close(got["grads"][name], g, rtol=1e-4)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_vocab_split_calls_of_several_steps_equal_calls_of_one(worlds, run):
    for got in worlds[run]:
        chunked = got["chunked"]
        assert chunked["losses"] == [got["losses"][CHUNK - 1],
                                     got["losses"][-1]]
        for name, value in got["final"].items():
            assert torch.equal(chunked["final"][name], value), name


@pytest.mark.parametrize("run", sorted(RUNS))
def test_vocab_split_flops_count_the_whole_table(worlds, run):
    """Each rank counts a step's FLOPs with the table whole at the true
    vocab, as one process does."""
    want = worlds["one"][run]["flops"]
    assert want
    for got in worlds[run]:
        assert got["chunked"]["flops"] == want


@pytest.mark.parametrize("run", sorted(RUNS))
def test_each_rank_holds_its_rows_and_zero_padding(worlds, run):
    """Rank i of the ``tensor`` group holds rows ``i * Vt / t`` on of the
    whole table after the steps, ``Vt / t`` of them, the rows past V still
    exact zeros; the gathered table has V rows."""
    _, axes, model, over = RUNS[run][:4]
    vocab, t = _vocab(run), axes["tensor"]
    split = vocab_split(vocab)
    per = split.padded(t) // t
    assert per % 64 == 0
    for got in worlds[run]:
        whole = got["final"]["tok_emb.weight"]
        assert tuple(whole.shape) == (vocab, 128)
        index = got["tensor_index"]
        lo, real = split.offset(index, t)
        table = got["table"]
        assert tuple(table.shape) == (per, 128)
        assert got["shapes"]["tok_emb.weight"] == (per, 128)
        assert torch.equal(table[:real], whole[lo:lo + real])
        assert not table[real:].any()
    reals = [split.offset(i, t)[1] for i in range(t)]
    assert sum(reals) == vocab
    if run == "gpt_v130_tensor4":
        assert reals == [64, 64, 2, 0]


def test_a_checkpoint_crosses_vocab_splits_bit_exact(worlds):
    """tensor 2 writes step 2 (the table's blocks gathered and cut to V),
    one process restores it as ``[V, hidden]`` and writes it again, tensor
    4 restores that (each rank padding and cutting its block) and writes
    its gathered state: the three files hold the same bits."""
    assert worlds["round_trip_step"] == 2
    assert [r["restored_step"] for r in worlds["restore"]] == [2] * 4
    assert worlds["restore"][0]["shapes"]["tok_emb.weight"] == (256, 128)
    saved, resaved, gathered = worlds["payloads"]
    assert tuple(saved["params"]["tok_emb.weight"].shape) == (VOCAB, 128)
    assert saved["step"] == 2 and saved["optimizer"]["state"]

    def same(a, b, path=""):
        if torch.is_tensor(a):
            assert torch.is_tensor(b) and a.dtype == b.dtype, path
            assert torch.equal(a, b), path
        elif isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}/{i}")
        else:
            assert a == b, path

    same(saved, resaved)
    same(saved, gathered)


def test_a_merge_at_the_wrong_offset_gives_other_losses(worlds):
    """Every rank told that its block starts at row 0 looks up and picks
    the wrong rows: its losses leave the one-process ones by far more than
    the bound the right offset meets."""
    ref = np.array(worlds["one"]["gpt_tensor2"]["losses"])
    bound = 1e-5 * np.abs(ref).max()
    for got in worlds["wrong_offset"]:
        wrong = np.array(got["losses"])
        assert wrong.shape == ref.shape and np.isfinite(wrong).all()
        assert np.abs(wrong - ref).max() > 100 * bound


# ------------------------------------------------- the plain versions


def _slices(x, vocab, t):
    """``x [T, V]``'s blocks by :func:`vocab_split` among ``t`` ranks, each
    with its offset and real columns."""
    split = vocab_split(vocab)
    out = []
    for i in range(t):
        lo, real = split.offset(i, t)
        out.append((split.local(x.T, i, t).T.contiguous(), lo, real))
    return out


def _logits(seed, t_rows, vocab, offset=0.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(3 * rng.standard_normal((t_rows, vocab),
                                                 dtype=np.float32) + offset)
    y = torch.from_numpy(rng.integers(0, vocab, t_rows))
    y[0], y[1] = 0, vocab - 1
    return x, y


@pytest.mark.parametrize("vocab, t", [(1000, 2), (1000, 4), (130, 4),
                                      (50257, 2)],
                         ids=["v1000_t2", "v1000_t4", "v130_t4", "gpt2_t2"])
def test_slices_merged_equal_the_whole_row(vocab, t):
    """The slice forms of the plain forward, merged over the ``t`` blocks
    (``merge_slices``), give each row's loss and logsumexp within
    ``merge_tolerance`` of the whole row's; the slice backward from the
    merged logsumexp gives the whole row's gradient within
    ``xent_tolerance``, zeros in every padding column, in f32."""
    x, y = _logits(vocab + t, 64, vocab, offset=5.0)
    g = torch.tensor(0.37)
    loss, lse = xent.softmax_xent_forward_reference(x, y, vocab)
    dx = xent.softmax_xent_backward_reference(x, y, g, vocab)
    parts = [(piece, lo, real,
              xent.softmax_xent_forward_reference(piece, y, real, lo, vocab))
             for piece, lo, real in _slices(x, vocab, t)]
    picked = torch.stack([p[3][0] for p in parts])
    lses = torch.stack([p[3][1] for p in parts])
    got_loss, got_lse = xent.merge_slices(lses, picked)
    bounds = xent.merge_tolerance(
        xent.xent_tolerance(x, y, vocab, loss, lse, g, dx), lses, lse)
    assert ((got_lse - lse).abs() <= bounds["lse"]).all()
    assert ((got_loss - loss).abs() <= bounds["loss"]).all()
    whole_bound = xent.xent_tolerance(x, y, vocab, loss, got_lse, g, dx)
    grads = []
    for piece, lo, real, _ in parts:
        d = xent.softmax_xent_backward_reference(piece, y, g, real, lo,
                                                 got_lse)
        assert not d[:, real:].any()
        grads.append(d[:, :real])
    got_dx = torch.cat(grads, dim=1)
    assert got_dx.shape == dx.shape
    assert ((got_dx - dx).abs() <= whole_bound["dlogits"]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_whole_row_slice_is_todays_function_to_the_bit(dtype):
    """Offset 0 with every column real is the whole row: the forward's
    ``(loss, lse)`` and the backward's gradient, plain and through the
    wrappers on CPU tensors, are the whole-row function's bits, on padded
    logits too."""
    x, y = _logits(3, 32, 1000)
    x = torch.cat([x, torch.full((32, 24), float("nan"))], 1).to(dtype)
    g = torch.tensor(0.5)
    want = xent.softmax_xent_forward_reference(x, y, 1000)
    for got in (xent.softmax_xent_forward_reference(x, y, 1000, 0, 1000),
                xent.softmax_xent_forward(x, y, 1000, 0, 1000),
                xent.softmax_xent_forward(x, y, 1000)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    dx = xent.softmax_xent_backward_reference(x, y, g, 1000)
    assert torch.equal(
        xent.softmax_xent_backward(x, y, want[1], g, 1000, 0, 1000), dx)


def test_a_wrong_offset_lands_outside_the_merge_bound():
    """The blocks merged with the last block's offset one row off (its
    labels' logits read a column early) leave the bound that the right
    offsets meet."""
    vocab, t = 1000, 2
    x, y = _logits(11, 64, vocab)
    loss, lse = xent.softmax_xent_forward_reference(x, y, vocab)
    slices = _slices(x, vocab, t)
    outs = [xent.softmax_xent_forward_reference(
        piece, y, real, lo - (i == t - 1), vocab)
        for i, (piece, lo, real) in enumerate(slices)]
    lses = torch.stack([o[1] for o in outs])
    got_loss, _ = xent.merge_slices(lses, torch.stack([o[0] for o in outs]))
    bounds = xent.merge_tolerance(
        xent.xent_tolerance(x, y, vocab, loss, lse), lses, lse)
    assert ((got_loss - loss).abs() > 100 * bounds["loss"]).any()


def test_a_label_outside_the_vocab_is_nan_on_the_whole_vocab():
    """A label at V (inside the last block's padding columns) or -1 makes
    the merged loss NaN, decided on the whole vocab and not the slice; the
    other rows stay finite."""
    vocab, t = 1000, 2
    x, y = _logits(5, 8, vocab)
    y[2], y[3] = vocab, -1
    outs = [xent.softmax_xent_forward_reference(piece, y, real, lo, vocab)
            for piece, lo, real in _slices(x, vocab, t)]
    loss, _ = xent.merge_slices(torch.stack([o[1] for o in outs]),
                                torch.stack([o[0] for o in outs]))
    assert torch.isnan(loss[2:4]).all()
    assert torch.isfinite(loss[[0, 1, 4, 5, 6, 7]]).all()


@pytest.mark.parametrize("vocab, t, per, last_real", [
    (50257, 2, 25152, 25105), (50257, 4, 12608, 12433),
    (30522, 2, 15296, 15226), (1000, 2, 512, 488), (1000, 4, 256, 232),
    (130, 4, 64, 0), (1024, 2, 512, 512)],
    ids=["gpt2_t2", "gpt2_t4", "bert_t2", "v1000_t2", "v1000_t4", "v130_t4",
         "v1024_t2"])
def test_the_split_gives_each_rank_a_multiple_of_64_rows(vocab, t, per,
                                                         last_real):
    """``Vt / t`` rows a rank, Vt the vocab rounded up to a multiple of 64
    t; the last rank's real rows; the pieces laid end to end and cut to V
    give the whole back, and the whole shape is ``[V, hidden]``."""
    split = vocab_split(vocab)
    assert split.padded(t) // t == per and per % 64 == 0
    assert split.offset(t - 1, t) == ((t - 1) * per, last_real)
    whole = torch.randn(vocab, 8, generator=torch.Generator().manual_seed(t))
    pieces = [split.local(whole, i, t) for i in range(t)]
    assert all(p.shape == (per, 8) for p in pieces)
    assert not pieces[-1][last_real:].any()
    assert torch.equal(split.whole(pieces), whole)
    assert split.whole_size(per, t) == vocab
    assert isinstance(split, VocabSplit)


def test_lm_loss_dispatches_on_the_tables_form():
    """Both LM losses take a rank's ``VocabPiece`` in place of the table;
    a whole table keeps the one-card losses (their bits)."""
    x = torch.randn(2, 4, 8, generator=torch.Generator().manual_seed(0))
    table = torch.randn(100, 8, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 100, (2, 4), generator=torch.Generator().manual_seed(2))
    for fused in (False, True):
        _, loss_fn = lm_loss(None, fused)
        want = (xent.chunked_cross_entropy if fused
                else xent.tied_cross_entropy)(x, table, y)
        assert torch.equal(loss_fn((x, table), y), want)
    piece = VocabPiece(table[:64], 0, 100, None)
    assert piece.real == 64
    assert VocabPiece(table[:64], 64, 100, None).real == 36
    assert VocabPiece(table[:64], 128, 100, None).real == 0
