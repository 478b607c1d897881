"""The plain meshed step captured over NCCL on the card: a one-rank NCCL
process group, the port's ``Trainer`` over a one-rank mesh (``data``:
``DistributedDataParallel``; a mesh that names ``fsdp``: FSDP2), calls of 4
steps replayed from one captured step after ``MESH_GRAPH_WARMUP`` eager
steps, against the same steps in calls of one (every step eager): the
losses and every parameter the same bits.

Needs a CUDA card and nvcc; skips without one. It imports only torch and
the port: ``python -m pytest --noconftest -m cuda
tests/test_torch_mesh_graph_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import os
import socket

import pytest
import torch
import torch.distributed as dist

from cron_operator_tpu_torch.models import GPT, GPTConfig
from cron_operator_tpu_torch.parallel.mesh import MeshPlan, make_mesh
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.train import (
    MESH_GRAPH_WARMUP,
    TrainConfig,
    Trainer,
)

CASE_TIMEOUT_S = 300  # as the other card tests: the first build included
CHUNK = 4
STEPS = MESH_GRAPH_WARMUP + 2 * CHUNK
AXES = {"ddp": {"data": 1}, "fsdp": {"data": 1, "fsdp": 1}}


@pytest.fixture
def nccl_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and CUDA graphs have no CPU "
                    "mode")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{port}")
    yield
    dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()


def _run(mesh, chunk):
    # head dim 64 in bf16: the sm90 kernels; seq 128 takes the flash path
    cfg = GPTConfig.tiny(hidden_size=256, max_len=128)
    model = GPT(cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(0))
    trainer = Trainer(model, TrainConfig(steps_per_call=chunk), mesh=mesh)
    stats = trainer.run(data.causal_token_batches(2, 128, cfg.vocab_size),
                        STEPS)
    params = [(p.to_local() if hasattr(p, "to_local") else p).detach()
              .clone() for p in model.parameters()]
    return [s.loss for s in stats], params, trainer.replayed_steps


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(AXES))
def test_captured_meshed_step_equals_the_eager_step(nccl_world, path):
    mesh = make_mesh(MeshPlan(AXES[path]), device_type="cuda")
    graph_losses, graph_params, replayed = _run(mesh, CHUNK)
    eager_losses, eager_params, _ = _run(mesh, 1)
    assert replayed == STEPS - MESH_GRAPH_WARMUP
    ends = [CHUNK * i - 1 for i in range(1, len(graph_losses))] + [-1]
    assert graph_losses == [eager_losses[i] for i in ends]
    for a, b in zip(graph_params, eager_params):
        assert torch.equal(a, b)
