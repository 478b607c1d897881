"""The training loss of the ``gpt`` and ``bert`` jobs on the padded logits
(``ops/xent.py`` ``softmax_cross_entropy``, ``tied_cross_entropy``)
against the former wiring and the JAX package's, on the CPU.

- ``softmax_cross_entropy`` on CPU logits (the plain versions through the
  autograd Function) equals ``cross_entropy_loss`` of the cut f32 logits to
  the bit, loss and gradient, in bf16 and f32, with leading dims, for
  vocabs that are and are not a multiple of 64; the padded columns' gradient
  is zero; the plain forward and backward are the reference's autograd;
  meta tensors give the shapes; DTensors raise.
- ``xent_tolerance`` bounds the plain f32 version against the same loss
  evaluated in f64 (a second order of the same sums) and is not vacuous.
- Tiny ``gpt`` jobs (dense, Switch-MoE, ``fused_xent=1``) and a tiny
  ``bert`` job, ``data=host``, give the per-step losses of the former
  wiring (the model's f32 logits and ``cross_entropy_loss``) to the bit
  over three steps, through the loss's plain forward; a trainer built as
  the jobs build it at vocab 1000 (a padded table) leaves the former
  wiring's losses and parameters to the bit, and the same model FLOPs.
- Trainers built as the jobs build them (f32, tiny GPT dense, MoE and at
  vocab 1000, tiny BERT) from converted JAX weights give the JAX
  ``Trainer``'s losses with its ``cross_entropy_loss`` over three steps
  within ``LOSS_ATOL``, as ``tests/test_torch_train.py``.
- In one gloo world of 2 rank processes (``tests/torch_mesh_ranks.py``),
  the jobs over ``data`` (DDP), ``fsdp`` (FSDP2), ``seq`` (DDP, ring GPT
  and Ulysses BERT) and ``tensor`` (DDP over each rank's heads, FFN slice
  and block of the table's vocab rows) meshes take the loss on the padded
  logits, with the former wiring's losses to the bit; under ``tensor``
  the vocab-parallel loss (each rank's slice of the logits, merged over
  the group) sums the exponentials in another order than the former f32
  log-softmax of the gathered logits, and its losses stay within
  ``TENSOR_LOSS_BOUND`` of the former wiring's.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, distribute_tensor

from cron_operator_tpu.models.bert import Bert as JaxBert
from cron_operator_tpu.models.bert import BertConfig as JaxBertConfig
from cron_operator_tpu.models.gpt import GPT as JaxGPT
from cron_operator_tpu.models.gpt import GPTConfig as JaxGPTConfig
from cron_operator_tpu.parallel.mesh import mesh_for_devices
from cron_operator_tpu.workloads import data as jax_data
from cron_operator_tpu.workloads.train import TrainConfig as JaxTrainConfig
from cron_operator_tpu.workloads.train import Trainer as JaxTrainer
from cron_operator_tpu_torch.backends.registry import JobContext
from cron_operator_tpu_torch.models import GPT, Bert, BertConfig, GPTConfig
from cron_operator_tpu_torch.models.convert import params_from_flax
from cron_operator_tpu_torch.ops import xent
from cron_operator_tpu_torch.workloads import data, entrypoints
from cron_operator_tpu_torch.workloads.train import (
    TrainConfig,
    Trainer,
    cross_entropy_loss,
)
from torch_mesh_ranks import start_world, wait_world

LOSS_ATOL = 5e-5  # per step, as tests/test_torch_train.py
SEQ = 32


def _former_lm_loss(mesh=None, fused_xent=False):
    """The wiring before the loss kernels: the model's f32 logits and
    ``cross_entropy_loss`` (``fused_xent`` unchanged)."""
    if fused_xent:
        return True, entrypoints._chunked_loss
    return False, cross_entropy_loss


# ------------------------------------------------------ the loss itself


CASES = {  # name: (logits shape, vocab)
    "padded_3d": ((2, 3, 1024), 1000),
    "padded_odd": ((7, 320), 257),
    "unpadded": ((4, 64), 64),
}


def _logits(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(3 * rng.standard_normal(shape, np.float32))
    return x.to(dtype)


def _labels(shape, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, shape[:-1]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_equals_the_former_loss_to_the_bit(case, dtype):
    shape, v = CASES[case]
    x, y = _logits(shape, dtype), _labels(shape, v)
    former = x.clone().requires_grad_()
    want = cross_entropy_loss(former[..., :v].float(), y)
    want.backward()
    new = x.clone().requires_grad_()
    got = xent.softmax_cross_entropy(new, y, v)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    assert torch.equal(got, want)
    assert new.grad.dtype == dtype and torch.equal(new.grad, former.grad)
    assert bool((new.grad[..., v:] == 0).all())
    assert (xent.softmax_xent_forward.launches,
            xent.softmax_xent_backward.launches) == (0, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plain_versions_are_the_references_autograd(dtype):
    shape, v = CASES["padded_odd"]
    x, y = _logits(shape, dtype, seed=2), _labels(shape, v, seed=3)
    leaf = x.clone().requires_grad_()
    ref = xent.softmax_cross_entropy_reference(leaf, y, v)
    g = torch.tensor(0.37)
    (ref * g).backward()
    loss, lse = xent.softmax_xent_forward_reference(x, y, v)
    assert torch.equal(loss.mean(), ref.detach())
    assert torch.allclose(lse, torch.logsumexp(x[:, :v].float(), -1))
    dx = xent.softmax_xent_backward_reference(x, y, g, v)
    assert torch.equal(dx, leaf.grad)


def test_meta_tensors_give_the_shapes():
    x = torch.empty(2, 5, 1024, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    y = torch.empty(2, 5, dtype=torch.int64, device="meta")
    loss = xent.softmax_cross_entropy(x, y, 1000)
    loss.backward()
    assert loss.shape == () and loss.device.type == "meta"
    assert x.grad.shape == x.shape and x.grad.dtype == torch.bfloat16


def test_refuses_what_does_not_fit():
    x, y = _logits((4, 64), torch.float32), _labels((4, 64), 60)
    with pytest.raises(ValueError, match="do not fit"):
        xent.softmax_cross_entropy(x, y, 65)
    with pytest.raises(ValueError, match="do not fit"):
        xent.softmax_cross_entropy(x, y[:3], 60)


@pytest.fixture
def one_rank_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("tensor",))
    finally:
        dist.destroy_process_group()


def test_a_dtensor_raises(one_rank_mesh):
    x = distribute_tensor(_logits((4, 64), torch.float32), one_rank_mesh,
                          [Replicate()])
    y = _labels((4, 64), 64)
    with pytest.raises(TypeError, match="DTensor"):
        xent.softmax_cross_entropy(x, y, 64)
    with pytest.raises(TypeError, match="DTensor"):
        xent.softmax_xent_forward(x, y, 64)


def _f64_results(x, y, v, g):
    """The loss, lse and gradient in f64: the same sums in another order
    and precision, a stand-in for a second implementation."""
    x64 = x[:, :v].double()
    lse = torch.logsumexp(x64, -1)
    loss = lse - x64.gather(1, y[:, None])[:, 0]
    p = torch.exp(x64 - lse[:, None])
    p[torch.arange(len(y)), y] -= 1
    d = torch.zeros(x.shape, dtype=x.dtype)
    d[:, :v] = (p * (g.double() / len(y))).to(x.dtype)
    return loss, lse, d


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("offset", [0.0, 100.0])
def test_tolerance_holds_the_plain_version_to_f64(dtype, offset):
    t, vp, v = 64, 2048, 2001
    x = (_logits((t, vp), torch.float32, seed=4) + offset).to(dtype)
    y = _labels((t, vp), v, seed=5)
    g = torch.tensor(0.5)
    loss, lse = xent.softmax_xent_forward_reference(x, y, v)
    dx = xent.softmax_xent_backward_reference(x, y, g, v)
    bounds = xent.xent_tolerance(x, y, v, loss, lse, g, dx)
    loss64, lse64, dx64 = _f64_results(x, y, v, g)
    assert bool(((lse.double() - lse64).abs() <= bounds["lse"]).all())
    assert bool(((loss.double() - loss64).abs() <= bounds["loss"]).all())
    assert float((loss.mean().double() - loss64.mean()).abs()) <= float(
        bounds["mean"])
    err = (dx[:, :v].double() - dx64[:, :v].double()).abs()
    assert bool((err <= bounds["dlogits"]).all())
    # not vacuous: the lse bound is under 2^-12 of it, the gradient's under
    # two bf16 units in the last place (f32: 2^-12 of it) where not tiny
    assert bool((bounds["lse"] <= 2.0 ** -12 * lse.abs()).all())
    big = dx[:, :v].float().abs() > 1e-6
    most = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -12}[dtype]
    assert bool((bounds["dlogits"][big]
                 <= most * dx[:, :v].float().abs()[big]).all())


# ------------------------------------------------------------ the jobs


JOB_PARAMS = {
    "gpt": {"platform": "cpu", "size": "tiny", "seq_len": str(SEQ),
            "batch_size": "2", "steps": "3", "attention": "xla",
            "data": "host", "steps_per_call": "1", "stage_async": "0"},
}
JOB_PARAMS["bert"] = dict(JOB_PARAMS["gpt"])
JOBS = {  # name: (entrypoint, extra params)
    "gpt": ("gpt", {}),
    "gpt_moe": ("gpt", {"moe_every": "2", "num_experts": "4"}),
    "gpt_fused_xent": ("gpt", {"fused_xent": "1"}),
    "bert": ("bert", {}),
}


class _LossBeat:
    """A watchdog that records the job's loss at each step's beat."""

    def __init__(self, ctx, losses):
        self.ctx, self.losses = ctx, losses

    def beat(self):
        self.losses.append(self.ctx.progress["last_loss"])


def _job_losses(entry, params):
    losses = []
    ctx = JobContext("train", "default", {}, dict(params))
    ctx.watchdog = _LossBeat(ctx, losses)
    getattr(entrypoints, entry)(ctx)
    return losses


@pytest.mark.parametrize("job", sorted(JOBS))
def test_jobs_give_the_former_losses_to_the_bit(job, monkeypatch):
    entry, extra = JOBS[job]
    params = {**JOB_PARAMS[entry], **extra}
    calls = []
    forward = xent.softmax_xent_forward

    def spy(*args):
        calls.append(args[0].shape)
        return forward(*args)

    monkeypatch.setattr(xent, "softmax_xent_forward", spy)
    got = _job_losses(entry, params)
    fused = "fused_xent" in extra
    assert len(calls) == (0 if fused else 3)
    assert all(shape == (2 * SEQ, 1024) for shape in calls)  # no pad at 1024
    monkeypatch.setattr(entrypoints, "lm_loss", _former_lm_loss)
    want = _job_losses(entry, params)
    assert len(calls) == (0 if fused else 3)  # the former wiring: none
    assert len(got) == 3 and all(np.isfinite(got))
    assert got == want


def _gpt_trainer(route, dtype, vocab=1000, seed=0):
    return_hidden, loss_fn = route()
    cfg = GPTConfig.tiny(vocab_size=vocab, max_len=SEQ, dtype=dtype,
                         return_hidden=return_hidden)
    model = GPT(cfg).init_weights(torch.Generator().manual_seed(seed))
    return Trainer(model, TrainConfig(steps_per_call=1), loss_fn=loss_fn)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_padded_vocab_trains_as_the_former_wiring(dtype):
    runs = []
    for route in (entrypoints.lm_loss, _former_lm_loss):
        trainer = _gpt_trainer(route, dtype)
        stats = trainer.run(data.causal_token_batches(2, SEQ, 1000), 3)
        runs.append(([s.loss for s in stats], trainer.model.state_dict(),
                     trainer.flops_per_step()))
    assert runs[0][0] == runs[1][0]
    for name, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][name]), name
    assert runs[0][2] == runs[1][2] and runs[0][2] > 0


# --------------------------------------------------- against the JAX loss


JAX_RUNS = {  # name: (model, config overrides, vocab)
    "gpt": ("gpt", {}, 1024),
    "gpt_moe": ("gpt", {"moe_every": 2, "num_experts": 4}, 1024),
    "gpt_vocab1000": ("gpt", {"vocab_size": 1000}, 1000),
    "bert": ("bert", {}, 1024),
}


@pytest.mark.parametrize("run", sorted(JAX_RUNS))
def test_the_jobs_loss_matches_the_jax_trainer(run):
    kind, over, vocab = JAX_RUNS[run]
    if kind == "gpt":
        jax_cls, jax_maker, cls, maker = (JaxGPT, JaxGPTConfig.tiny, GPT,
                                          GPTConfig.tiny)
        stream = "causal_token_batches"
    else:
        jax_cls, jax_maker, cls, maker = (JaxBert, JaxBertConfig.tiny, Bert,
                                          BertConfig.tiny)
        stream = "token_batches"
    jcfg = jax_maker(dtype=jnp.float32, attention_impl="xla", max_len=SEQ,
                     **over)
    params = jax.tree_util.tree_map(np.asarray, jax_cls(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"])
    jmodel = jax_cls(jcfg)
    jtrainer = JaxTrainer(
        lambda p, x: jmodel.apply({"params": p}, x), params,
        mesh_for_devices(jax.devices("cpu")[:1]),
        JaxTrainConfig(steps_per_call=1, stage_async=False,
                       aux_loss_in_output=kind == "gpt"))
    want = [s.loss for s in jtrainer.run(
        getattr(jax_data, stream)(2, SEQ, vocab), 3)]
    return_hidden, loss_fn = entrypoints.lm_loss()
    tcfg = maker(dtype=torch.float32, attention_impl="xla", max_len=SEQ,
                 return_hidden=return_hidden, **over)
    model = cls(tcfg)
    model.load_state_dict(params_from_flax(params, tcfg))
    trainer = Trainer(model, TrainConfig(
        steps_per_call=1, aux_loss_in_output=getattr(model, "has_moe",
                                                     False)),
        loss_fn=loss_fn)
    got = [s.loss for s in trainer.run(getattr(data, stream)(2, SEQ, vocab),
                                       3)]
    assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_ATOL, (got, want)


# ------------------------------------------------------------ the meshes


# The largest gap between the vocab-parallel loss's per-step losses and
# the former wiring's in the tiny bf16 gpt job under tensor 2: the first two
# steps' losses agree to the bit (AdamW's first update is the gradients'
# signs), and the rounding of the merged sums moves the second update (8.6e-5
# at step 3 on the CPU).
TENSOR_LOSS_BOUND = 1e-3
MESH_JOBS = {  # name: (entrypoint, mesh params, the loss kernels' route,
    #                  the bound on the gap to the former wiring's losses)
    "gpt_tensor": ("gpt", {"tensor": "2"}, True, TENSOR_LOSS_BOUND),
    "gpt_data": ("gpt", {}, True, 0.0),
    "gpt_fsdp": ("gpt", {"fsdp": "2"}, True, 0.0),
    "bert_data": ("bert", {}, True, 0.0),
    "gpt_seq": ("gpt", {"seq": "2", "attention": "ring"}, True, 0.0),
    "bert_seq": ("bert", {"seq": "2", "attention": "ulysses"}, True, 0.0),
}


@pytest.fixture(scope="module", autouse=True)
def started_world(tmp_path_factory):
    """The world of every mesh case, started with the module's first test
    so that its ranks run beside the other tests; killed at the end if a
    failure left it running."""
    out = tmp_path_factory.mktemp("xent_world")
    jobs = [{"kind": "lm_job", "name": name, "axes": {}, "entry": entry,
             "params": {**JOB_PARAMS[entry], "batch_size": "4", **axes}}
            for name, (entry, axes, _, _) in MESH_JOBS.items()]
    procs = start_world(2, jobs, out)
    yield out, procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def world(started_world):
    out, procs = started_world
    wait_world(procs)
    return {name: [torch.load(out / f"{name}.rank{r}.pt", weights_only=False)
                   for r in range(2)] for name in MESH_JOBS}


@pytest.mark.parametrize("job", sorted(MESH_JOBS))
def test_meshes_take_their_loss_path(world, job):
    kernels, bound = MESH_JOBS[job][2:]
    for rank in world[job]:
        runs = rank["runs"]
        assert len(runs["job"]["losses"]) == 3
        assert all(np.isfinite(runs["job"]["losses"]))
        if bound:
            gaps = np.abs(np.subtract(runs["job"]["losses"],
                                      runs["former"]["losses"]))
            assert gaps.max() <= bound
        else:
            assert runs["job"]["losses"] == runs["former"]["losses"]
        assert runs["job"]["kernel_calls"] == (3 if kernels else 0)
        assert runs["former"]["kernel_calls"] == 0
    assert world[job][0]["runs"] == world[job][1]["runs"]


def test_lm_loss_picks_the_route_by_mesh(one_rank_mesh):
    """No mesh or a mesh of batch axes: the loss on the padded logits; a
    mesh whose ``tensor`` axis is 1 counts as a plain one."""
    assert entrypoints.lm_loss() == (True, entrypoints._tied_loss)
    assert entrypoints.lm_loss(one_rank_mesh) == (True, entrypoints._tied_loss)
    assert entrypoints.lm_loss(None, True) == (True, entrypoints._chunked_loss)
