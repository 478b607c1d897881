"""Checkpoints around the captured training step, on the card.

- A restore lands before the capture: a fresh trainer that restores step 4
  and trains to 8 in one call (warm-up step, capture, replays) equals an
  uninterrupted run of 8 to the bit, through the flash kernels.
- The fused data generator's state after a call of K replayed steps equals
  its state after K eager steps, so the state a checkpoint saves between
  calls is the one the next step draws from.
- A save between calls copies what the parameters hold at that step (in
  stream order after the call's last replay, before the next is enqueued);
  fused AdamW's ``step`` tensors come back on the card.

Needs a CUDA card and nvcc; skips without one. It imports only torch and
the port: ``python -m pytest --noconftest -m cuda
tests/test_torch_checkpoint_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import itertools

import pytest
import torch

from cron_operator_tpu_torch.models import GPT, GPTConfig
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

CASE_TIMEOUT_S = 300  # as the other card tests: the first build included


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no "
                    "CPU mode")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _trainer(store=None, steps_per_call=4):
    # head dim 64 in bf16 and seq 128: the sm90 kernels
    cfg = GPTConfig.tiny(hidden_size=256, max_len=128)
    model = GPT(cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(0))
    return Trainer(model, TrainConfig(save_every=4,
                                      steps_per_call=steps_per_call),
                   sample_fn=data.causal_token_sample(2, 128, cfg.vocab_size),
                   checkpoint=store)


def _run(trainer, steps):
    trainer.run(itertools.repeat({}), steps)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_restore_before_the_capture_resumes_exactly(cuda_device, tmp_path):
    whole = _trainer()
    _run(whole, 8)
    first = _trainer(CheckpointStore("ns", "card", root=str(tmp_path)))
    _run(first, 4)
    first.checkpoint.close()
    resumed = _trainer(CheckpointStore("ns", "card", root=str(tmp_path)))
    assert resumed.steps_done == 4
    for st in resumed.optimizer.state.values():
        assert st["step"].is_cuda and st["step"].dtype == torch.float32
    _run(resumed, 8)
    resumed.checkpoint.close()
    assert resumed._graph is not None and resumed._graph.replays == 3
    for (name, a), b in zip(whole.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    sw, sr = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in sw["state"].items():
        for key, value in st.items():
            assert torch.equal(value, sr["state"][i][key]), (i, key)


@pytest.mark.cuda
def test_generator_state_after_replays_equals_eager(cuda_device):
    eager, graph = _trainer(), _trainer()
    for _ in range(6):
        eager.step({}, sync=False)
    graph.step({}, chunk=3)  # warm-up step, capture, 2 replays
    graph.step({}, chunk=3)  # 3 replays
    torch.cuda.synchronize()
    assert torch.equal(eager._data_gen.get_state(), graph._data_gen.get_state())
    for a, b in zip(eager.model.parameters(), graph.model.parameters()):
        assert torch.equal(a, b)


class _Recorder:
    """A store that keeps what it is given."""

    def __init__(self):
        self.saved = {}

    def latest_step(self):
        return None

    def save(self, step, state):
        self.saved[step] = state

    def wait(self):
        pass


@pytest.mark.cuda
def test_a_save_between_calls_copies_that_steps_parameters(cuda_device):
    recorder = _Recorder()
    trainer = _trainer(recorder)
    _run(trainer, 8)  # calls of 4 steps, saves at 4 and 8
    reference = _trainer()
    _run(reference, 4)
    assert sorted(recorder.saved) == [4, 8]
    at4, at8 = recorder.saved[4], recorder.saved[8]
    assert at4["step"] == 4 and at8["step"] == 8
    for name, value in reference.model.state_dict().items():
        assert at4["params"][name].device.type == "cpu"
        assert torch.equal(at4["params"][name], value.cpu()), name
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(at8["params"][name], value.cpu()), name
    assert not all(torch.equal(at4["params"][n], at8["params"][n])
                   for n in at4["params"])
