"""The port's checkpoints against the JAX package's.

- ``tests/test_checkpoint.py`` case by case on the port's
  ``CheckpointStore`` and ``Trainer``: lineage naming, resume and the
  total-step target, per-job isolation, the fallback chain past torn steps
  with its metrics sink, the empty lineage, train-then-serve through
  ``generate_job checkpoint_from``, the read-only open; and the cases the
  port adds: retention, ``flush_open_stores``, ``restore_resharded``
  placing a template's tensors. (The executor's preempt-then-resume is in
  ``tests/test_torch_operator_e2e.py``.)
- Parity: the JAX ``Trainer`` with its Orbax store and the port's with its
  store, on the MLP from converted weights and ``data=host``: 10 steps
  saved every 5, then a resume to 20, give the same losses (1e-5
  relative) and resume from the same step.
- Fused data: a resumed run equals an uninterrupted one to the bit (losses,
  parameters, optimizer state), since the generator's state is saved.
- Calls are cut at ``save_every`` multiples, so saves land on their steps,
  and ``steps_per_call=auto`` resolves to ``min(8, save_every)``.

Everything runs on the CPU in f32 unless stated.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.models.mlp import MLP as JaxMLP
from cron_operator_tpu.parallel.mesh import mesh_for_devices
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.checkpoint import (
    CheckpointStore as JaxCheckpointStore,
)
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu_torch.backends.registry import (
    JobContext,
    resolve_entrypoint,
)
from cron_operator_tpu_torch.models import MLP
from cron_operator_tpu_torch.models.convert import mlp_params_from_flax
from cron_operator_tpu_torch.workloads import data as datasets
from cron_operator_tpu_torch.workloads import entrypoints
from cron_operator_tpu_torch.workloads.checkpoint import (
    CheckpointStore,
    flush_open_stores,
    job_family,
)
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer


def test_job_family_strips_tick_suffix():
    assert job_family("bert-1785339801") == "bert"
    assert job_family("my-cron-name-1785339801") == "my-cron-name"
    # non-tick numeric suffixes stay (too short to be a unix timestamp)
    assert job_family("resnet-50") == "resnet-50"
    assert job_family("plain") == "plain"


def _trainer(store, save_every=1, **kw):
    model = MLP(features=(32,), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    return Trainer(model, TrainConfig(optimizer="sgd", save_every=save_every,
                                      **kw),
                   checkpoint=store)


class TestTrainerResume:
    def test_restore_continues_from_saved_step(self, tmp_path):
        # Cross-tick resume is opt-in (lineage="family"): the default
        # per-job lineage keeps concurrent Allow/Replace ticks isolated.
        t1 = _trainer(CheckpointStore("ns", "job-1785339000",
                                      root=str(tmp_path), lineage="family"))
        t1.run(datasets.mnist_batches(16, seed=9), steps=3)
        assert t1.steps_done == 3
        t1.checkpoint.close()

        # Same cron family, next tick: restores step 3 and runs only 4-5.
        t2 = _trainer(CheckpointStore("ns", "job-1785339060",
                                      root=str(tmp_path), lineage="family"))
        assert t2.steps_done == 3
        assert torch.equal(t1.model.dense[0].weight, t2.model.dense[0].weight)
        stats = t2.run(datasets.mnist_batches(16, seed=9), steps=5)
        assert [s.step for s in stats] == [4, 5]
        t2.checkpoint.close()

    def test_target_reached_runs_nothing(self, tmp_path):
        store = CheckpointStore("ns", "done-1785339000", root=str(tmp_path),
                                lineage="family")
        t1 = _trainer(store)
        t1.run(datasets.mnist_batches(16), steps=2)
        t1.checkpoint.close()
        t2 = _trainer(CheckpointStore("ns", "done-1785339099",
                                      root=str(tmp_path), lineage="family"))
        stats = t2.run(datasets.mnist_batches(16), steps=2)
        assert stats == [] and t2.steps_done == 2
        t2.checkpoint.close()

    def test_default_lineage_isolates_ticks(self, tmp_path):
        # Default (per-job) lineage: a later tick must not see an earlier
        # tick's checkpoints.
        t1 = _trainer(CheckpointStore("ns", "iso-1785339000",
                                      root=str(tmp_path)))
        t1.run(datasets.mnist_batches(16), steps=2)
        t1.checkpoint.close()
        t2 = _trainer(CheckpointStore("ns", "iso-1785339060",
                                      root=str(tmp_path)))
        assert t2.steps_done == 0
        t2.checkpoint.close()


class Sink:
    def __init__(self):
        self.series = {}

    def inc(self, series, value=1):
        self.series[series] = self.series.get(series, 0) + value


class TestRestoreFallbackChain:
    """A torn save (preemption mid-write, a disk fault under the root)
    leaves the newest retained step unreadable: resume walks back to the
    previous retained step instead of crashing the restarted job."""

    def _saved_store(self, tmp_path, steps=(1, 2, 3)):
        store = CheckpointStore("ns", "torn", root=str(tmp_path))
        for s in steps:
            store.save(s, {"params": {"w": torch.arange(8.0)}, "step": s})
        store.wait()
        store.close()
        return tmp_path / "ns" / "torn"

    def _truncate_step(self, lineage_dir, step):
        # Empty every payload file, so that the step still lists as
        # committed (the torn-save shape: the directory survives, the data
        # does not).
        for p in (lineage_dir / str(step)).rglob("*"):
            if p.is_file():
                p.write_bytes(b"")

    def test_truncated_latest_falls_back_to_previous_step(self, tmp_path):
        lineage = self._saved_store(tmp_path)
        self._truncate_step(lineage, 3)
        store = CheckpointStore("ns", "torn", root=str(tmp_path))
        sink = Sink()
        store.instrument(sink)
        try:
            # Step 3 still lists: a bare latest_step() restore would die.
            assert store.latest_step() == 3
            like = {"params": {"w": torch.zeros(8)}}
            step, out = store.restore_latest(like)
            assert step == 2
            assert out["step"] == 2
            assert torch.equal(out["params"]["w"], torch.arange(8.0))
            assert store.fallbacks == 1
            assert sink.series == {"workload_checkpoint_fallbacks_total": 1}
        finally:
            store.close()

    def test_all_steps_truncated_raises(self, tmp_path):
        lineage = self._saved_store(tmp_path, steps=(1, 2))
        self._truncate_step(lineage, 1)
        self._truncate_step(lineage, 2)
        store = CheckpointStore("ns", "torn", root=str(tmp_path))
        try:
            with pytest.raises(Exception):
                store.restore_latest({"params": {"w": torch.zeros(8)}})
            assert store.fallbacks == 2
        finally:
            store.close()

    def test_empty_lineage_raises_file_not_found(self, tmp_path):
        store = CheckpointStore("ns", "fresh", root=str(tmp_path))
        try:
            with pytest.raises(FileNotFoundError, match="no checkpoint"):
                store.restore_latest({"w": torch.zeros(1)})
            assert store.fallbacks == 0
        finally:
            store.close()


def test_restore_resharded_waits_for_the_mesh(tmp_path):
    """``restore_resharded`` places each tensor that the template names as
    the template's is (plain tensors onto their device here; DTensors onto
    their mesh in ``test_torch_mesh.py``'s elastic chain), keeps what it
    does not name, and refuses a mismatched template, as ``restore``
    does."""
    store = CheckpointStore("ns", "elastic", root=str(tmp_path))
    store.save(2, {"params": {"w": torch.arange(4.0)}, "step": 2})
    store.wait()
    try:
        out = store.restore_resharded(2, {"params": {"w": torch.zeros(4)}})
        assert torch.equal(out["params"]["w"], torch.arange(4.0))
        assert out["step"] == 2
        with pytest.raises(ValueError, match="expected"):
            store.restore_resharded(2, {"params": {"w": torch.zeros(5)}})
        with pytest.raises(ValueError, match="expected"):
            store.restore(2, {"params": {"w": torch.zeros(5)}})
    finally:
        store.close()


class TestTrainThenServe:
    """A cron-scheduled training job checkpoints a lineage; a scheduled
    generate job serves the newest parameters from it (no optimizer
    state needed)."""

    def test_generate_restores_trained_params(self, tmp_path, monkeypatch):
        common_model = {"size": "tiny", "seq_len": "16", "platform": "cpu"}
        train_ctx = JobContext(
            name="lm-train-1700000000", namespace="default", job={},
            params={
                **common_model, "steps": "3", "batch_size": "8",
                "checkpoint": "1", "save_every": "3",
                "checkpoint_lineage": "family",
                "checkpoint_dir": str(tmp_path),
            },
        )
        resolve_entrypoint("gpt")(train_ctx)
        assert train_ctx.progress["steps_done"] == 3

        # The family lineage is the tick-suffix-stripped name.
        store = CheckpointStore("default", "lm-train", root=str(tmp_path))
        trained = store.restore_params()
        store.close()

        # The serve path must hand generate() the trained parameters (in
        # the serving dtype), not a fresh init.
        served = {}
        real_generate = entrypoints.generate

        def spy(cfg, model, prompt, max_new, **kw):
            served["params"] = {k: v.clone()
                                for k, v in model.state_dict().items()}
            return real_generate(cfg, model, prompt, max_new, **kw)

        monkeypatch.setattr(entrypoints, "generate", spy)
        serve_ctx = JobContext(
            name="lm-serve", namespace="default", job={},
            params={
                **common_model, "rounds": "1", "batch_size": "2",
                "prompt_len": "4", "max_new": "4",
                "checkpoint_from": "lm-train",
                "checkpoint_dir": str(tmp_path),
            },
        )
        resolve_entrypoint("generate")(serve_ctx)
        assert serve_ctx.progress["restored_from_step"] == 3
        assert serve_ctx.progress["steps_done"] == 1
        assert served["params"].keys() == trained.keys()
        for name, value in served["params"].items():
            assert value.dtype == torch.bfloat16, name
            assert torch.equal(value, trained[name].to(torch.bfloat16)), (
                f"serve job did not use the trained checkpoint ({name})")

    def test_restore_params_missing_lineage_raises(self, tmp_path):
        store = CheckpointStore("default", "ghost", root=str(tmp_path))
        try:
            with pytest.raises(FileNotFoundError, match="no checkpoint"):
                store.restore_params()
        finally:
            store.close()

    def test_serve_with_typoed_lineage_raises_without_littering(
        self, tmp_path
    ):
        """Read-only open: a mistyped checkpoint_from raises and creates no
        empty lineage directory in the shared root."""
        ctx = JobContext(
            name="serve-typo", namespace="default", job={},
            params={
                "size": "tiny", "seq_len": "16", "platform": "cpu",
                "rounds": "1", "batch_size": "2", "prompt_len": "4",
                "max_new": "4", "checkpoint_from": "gpt-nightly-tarin",
                "checkpoint_dir": str(tmp_path),
            },
        )
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            resolve_entrypoint("generate")(ctx)
        assert not (tmp_path / "default" / "gpt-nightly-tarin").exists()


def test_retention_keeps_the_newest_max_to_keep(tmp_path):
    store = CheckpointStore("ns", "keep", root=str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, {"params": {}, "step": s})
    store.wait()
    assert store.all_steps() == [3, 4] and store.latest_step() == 4
    # only committed steps are listed: no temporary directory is left
    assert sorted(os.listdir(store.directory)) == ["3", "4"]
    store.close()
    reader = CheckpointStore("ns", "keep", root=str(tmp_path), create=False)
    with pytest.raises(PermissionError):
        reader.save(5, {"params": {}, "step": 5})
    assert reader.restore(4)["step"] == 4
    reader.close()


def test_flush_open_stores_drains_pending_saves(tmp_path):
    a = CheckpointStore("ns-a", "job-a", root=str(tmp_path))
    b = CheckpointStore("ns-b", "job-b", root=str(tmp_path))
    try:
        big = {"params": {"w": torch.zeros(1 << 20)}, "step": 1}
        a.save(1, big)
        b.save(1, big)
        assert flush_open_stores("ns-a", "job-a") == 1
        assert a.latest_step() == 1
        assert flush_open_stores("ns-missing") == 0
        assert flush_open_stores() >= 2
        assert b.latest_step() == 1
    finally:
        a.close()
        b.close()
    # a closed store is out of the registry
    assert flush_open_stores("ns-a") == 0


def test_a_failed_write_raises_at_wait(tmp_path):
    store = CheckpointStore("ns", "bad", root=str(tmp_path))
    store.save(1, {"params": {}, "step": lambda: 0})  # torch.save refuses
    with pytest.raises(Exception):
        store.wait()
    assert store.all_steps() == []
    assert not os.listdir(store.directory)  # the temporary step is gone
    store.close()


# ---------------------------------------------------------------- parity


# AdamW at 1e-4. After the resume the host stream starts again, and on
# batches seen before the two packages' f32 rounding (2.4e-7 at steps 1-10)
# grows to 4.6e-6 at step 11, in uninterrupted runs alike (each package's
# resumed run equals its own uninterrupted one to the bit). At the default
# 1e-3 those batches are memorised (loss 0.17) and the same rounding is
# 1.2e-5 of the loss; at 1e-4 the largest is 3.0e-6.
PARITY_LR = 1e-4


def _jax_run(root, steps, batches):
    jmodel = JaxMLP(dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"])
    trainer = JaxTrainer(
        lambda p, x: jmodel.apply({"params": p}, x),
        jax.tree_util.tree_map(jnp.array, params),
        mesh_for_devices(jax.devices("cpu")[:1]),
        JaxTrainConfig(save_every=5, steps_per_call=1, stage_async=False,
                       learning_rate=PARITY_LR),
        checkpoint=JaxCheckpointStore("ns", "parity", root=root),
    )
    resumed = trainer.steps_done
    stats = trainer.run(batches, steps)
    trainer.checkpoint.close()
    return resumed, [s.loss for s in stats], params


def _port_run(root, steps, batches, params):
    model = MLP(dtype=torch.float32, device="cpu")
    model.load_state_dict(mlp_params_from_flax(params))
    trainer = Trainer(model, TrainConfig(save_every=5, steps_per_call=1,
                                         stage_async=False,
                                         learning_rate=PARITY_LR),
                      checkpoint=CheckpointStore("ns", "parity", root=root))
    resumed = trainer.steps_done
    stats = trainer.run(batches, steps)
    trainer.checkpoint.close()
    return resumed, [s.loss for s in stats]


def test_checkpointed_mlp_matches_the_jax_trainer(tmp_path):
    """AdamW (lr 1e-4), one step a call: 10 steps with saves at 5 and 10,
    then fresh
    trainers on the same lineage resume at 10 and train to 20 on a host
    stream that starts again from its first batch, in both packages.
    Losses agree within 1e-5 relative at every step, and both keep the
    newest 3 steps."""
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    j0, jl1, params = _jax_run(jroot, 10, jax_data.mnist_batches(16, seed=3))
    t0, tl1 = _port_run(troot, 10, datasets.mnist_batches(16, seed=3),
                        params)
    j1, jl2, _ = _jax_run(jroot, 20, jax_data.mnist_batches(16, seed=3))
    t1, tl2 = _port_run(troot, 20, datasets.mnist_batches(16, seed=3),
                        params)
    assert (j0, t0) == (0, 0)
    assert j1 == t1 == 10
    jstore = JaxCheckpointStore("ns", "parity", root=jroot)
    tstore = CheckpointStore("ns", "parity", root=troot)
    assert jstore.all_steps() == tstore.all_steps() == [10, 15, 20]
    jstore.close()
    tstore.close()
    want, got = jl1 + jl2, tl1 + tl2
    assert len(got) == len(want) == 20
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b), (got, want)


# ------------------------------------------------------------ fused data


def _fused(store=None, steps_per_call=4):
    model = MLP(features=(64,), device="cpu").init_weights(
        torch.Generator().manual_seed(1))
    return Trainer(model, TrainConfig(save_every=4,
                                      steps_per_call=steps_per_call),
                   sample_fn=datasets.mnist_sample(8), checkpoint=store)


def test_fused_data_resume_is_bit_exact(tmp_path):
    """12 steps at once against 8 steps, a save, and a fresh model and
    trainer that restore step 8 and train to 12: the same losses at steps
    9-12, the same parameter bits and the same optimizer state, since the
    fused generator's state travels in the checkpoint."""
    whole = _fused()
    losses = {}
    whole.run(iter(lambda: {}, None), 12,
              on_step=lambda s: losses.__setitem__(s.step, s.loss))
    first = _fused(CheckpointStore("ns", "fused", root=str(tmp_path)))
    first.run(iter(lambda: {}, None), 8)
    first.checkpoint.close()
    resumed = _fused(CheckpointStore("ns", "fused", root=str(tmp_path)))
    assert resumed.steps_done == 8
    got = {}
    resumed.run(iter(lambda: {}, None), 12,
                on_step=lambda s: got.__setitem__(s.step, s.loss))
    resumed.checkpoint.close()
    assert sorted(got) == [9, 10, 11, 12]
    assert got[12] is not None and got[12] == losses[12]
    for (name, a), b in zip(whole.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in sa["state"].items():
        for key, value in st.items():
            assert torch.equal(value, sb["state"][i][key]), (i, key)
    assert torch.equal(whole._data_gen.get_state(),
                       resumed._data_gen.get_state())


@pytest.mark.parametrize("steps_per_call, expect", [
    (4, [3, 6, 9]), ("auto", [3, 6, 9]), (1, [3, 6, 9])])
def test_saves_land_on_their_steps(tmp_path, steps_per_call, expect):
    """Calls never cross a ``save_every`` multiple: with save_every 3 the
    saves are at 3, 6 and 9 whatever the call length, each with its stall
    in ``ckpt_s`` on its step; ``auto`` resolves to min(8, save_every)."""
    store = CheckpointStore("ns", f"snap-{steps_per_call}",
                            root=str(tmp_path), max_to_keep=5)
    trainer = _trainer(store, save_every=3, steps_per_call=steps_per_call)
    if steps_per_call == "auto":
        assert trainer.resolved_steps_per_call == 3
    ckpt = {}
    trainer.run(datasets.mnist_batches(8), 10,
                on_step=lambda s: ckpt.__setitem__(s.step, s.ckpt_s))
    store.close()
    assert store.all_steps() == expect
    assert [s for s, t in sorted(ckpt.items()) if t > 0] == expect
    no_store = _trainer(None, save_every=3, steps_per_call="auto")
    assert no_store.resolved_steps_per_call == 8


def test_training_entrypoint_resumes_and_publishes_it(tmp_path):
    """``param.checkpoint=1``: a re-run of the same job publishes
    ``resumed_from_step`` and ``steps_done`` up front and trains only the
    remainder; a re-run at the target runs nothing and keeps both."""
    params = {"platform": "cpu", "batch_size": "8", "checkpoint": "1",
              "save_every": "2", "checkpoint_dir": str(tmp_path)}
    first = JobContext("mlp", "default", {}, {**params, "steps": "4"})
    resolve_entrypoint("mnist")(first)
    assert "resumed_from_step" not in first.progress
    again = JobContext("mlp", "default", {}, {**params, "steps": "6"})
    resolve_entrypoint("mnist")(again)
    assert again.progress["resumed_from_step"] == 4
    assert again.progress["steps_done"] == 6
    assert [e["step"] for e in again.progress["step_timeline"]] == [5, 6]
    done = JobContext("mlp", "default", {}, {**params, "steps": "6"})
    resolve_entrypoint("mnist")(done)
    assert done.progress["resumed_from_step"] == 6
    assert done.progress["steps_done"] == 6
    assert "first_step_at" not in done.progress
    store = CheckpointStore("default", "mlp", root=str(tmp_path))
    assert store.all_steps() == [2, 4, 6]
    store.close()


def test_moe_lineage_resumes_and_serves(tmp_path, monkeypatch):
    """An MoE ``gpt`` lineage (every second block 4 experts, fused data)
    saved at step 2 and resumed to 4 ends with the parameters of an
    uninterrupted 4-step run, to the bit; ``generate_job checkpoint_from``
    with the same MoE params serves them (cast to the serving dtype), and
    its greedy tokens are those of an f32 model loaded from the step."""
    from cron_operator_tpu_torch.models import GPT, GPTConfig
    from cron_operator_tpu_torch.workloads.generate import generate

    model_params = {"platform": "cpu", "size": "tiny", "seq_len": "16",
                    "moe_every": "2", "num_experts": "4"}
    train = {**model_params, "batch_size": "2", "data": "fused",
             "checkpoint": "1", "save_every": "2"}

    def run(name, root, steps):
        ctx = JobContext(name, "default", {}, {
            **train, "steps": str(steps), "checkpoint_dir": str(root)})
        resolve_entrypoint("gpt")(ctx)
        return ctx.progress

    run("moe-lm", tmp_path / "a", 2)
    resumed = run("moe-lm", tmp_path / "a", 4)
    assert resumed["resumed_from_step"] == 2 and resumed["steps_done"] == 4
    run("moe-lm", tmp_path / "b", 4)
    trained = {}
    for root in ("a", "b"):
        store = CheckpointStore("default", "moe-lm", root=str(tmp_path / root))
        assert store.latest_step() == 4
        trained[root] = store.restore_params()
        store.close()
    assert any(".moe.wi" in name for name in trained["a"])
    for name, value in trained["a"].items():
        assert torch.equal(value, trained["b"][name]), name

    served = {}
    real_generate = entrypoints.generate

    def spy(cfg, model, prompt, max_new, **kw):
        served["params"] = {k: v.clone() for k, v in model.state_dict().items()}
        served["out"] = real_generate(cfg, model, prompt, max_new, **kw)
        served["prompt"] = prompt.clone()
        return served["out"]

    monkeypatch.setattr(entrypoints, "generate", spy)
    ctx = JobContext("moe-serve", "default", {}, {
        **model_params, "rounds": "1", "batch_size": "2", "prompt_len": "4",
        "max_new": "4", "checkpoint_from": "moe-lm",
        "checkpoint_dir": str(tmp_path / "a")})
    resolve_entrypoint("generate")(ctx)
    assert ctx.progress["restored_from_step"] == 4
    for name, value in served["params"].items():
        assert torch.equal(value, trained["a"][name].to(torch.bfloat16)), name
    cfg = GPTConfig.tiny(max_len=16, moe_every=2, num_experts=4)
    model = GPT(cfg)
    model.load_state_dict(trained["a"])
    want = generate(cfg, model.eval(), served["prompt"], 4)
    assert torch.equal(served["out"], want)
