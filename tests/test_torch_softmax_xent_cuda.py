"""The loss kernels (``ops/csrc/xent.cu``) against their plain versions, on
the card: GPT-2 small's ``[8192, 50304]`` logits with vocab 50257 and
BERT-base's ``[4096, 30528]`` with 30522, in bf16 and f32, labels at 0 and
V - 1 among them, NaN in the padded columns (which must be ignored), and
logits offset by +100; each row's loss and logsumexp and the mean within
``xent_tolerance``, the gradient within one unit in the last place of the
logits' dtype of the plain version's (and the f32 rounding the tolerance
states), the padded columns exact zeros, reruns bit-identical. The
autograd Function on the card launches each kernel once a step; a CUDA
graph capture of its forward and backward replays equal to eager, counted
once a replay. A graphed tiny GPT step built as the ``gpt`` job builds it
(vocab 1000, padded to 1024) launches each kernel once a step, equals its
eager steps to the bit, and makes no f32 tensor of logits' size and no
cut copy of the logits (a ``TorchDispatchMode`` sees every op of the
first graphed call, the capture included). Layouts the kernels cannot read
in place raise.

Needs a CUDA card and nvcc (the kernels have no CPU mode); skips without a
card. It imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_softmax_xent_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import importlib

import numpy as np
import pytest
import torch

from cron_operator_tpu_torch.models import GPT, GPTConfig
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.entrypoints import lm_loss
from cron_operator_tpu_torch.workloads.train import Trainer

xent = importlib.import_module("cron_operator_tpu_torch.ops.xent")
fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

pytestmark = pytest.mark.cuda

CASE_TIMEOUT_S = 300  # as the other kernels' card tests: the build included
# (T, Vp, V): GPT-2 small's b 8 x 1024 and BERT-base's b 8 x 512
SHAPES = {"gpt": (8192, 50304, 50257), "bert": (4096, 30528, 30522)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _inputs(shape, dtype, device, seed=0, offset=0.0,
            label_dtype=torch.int64):
    """Seeded logits ``[T, Vp]`` (3 x standard normal plus ``offset``, NaN
    in the padded columns) and labels ``[T]`` with 0 and V - 1 among
    them."""
    t, vp, v = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(3 * rng.standard_normal((t, vp), np.float32) + offset)
    x[:, v:] = float("nan")
    y = torch.from_numpy(rng.integers(0, v, t))
    y[0], y[1] = 0, v - 1
    return x.to(device, dtype), y.to(device, label_dtype)


def _bits(t):
    kind = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.view(kind)


def _check_pair(x, y, v, g):
    """The kernels against the plain versions on ``x``, ``y``: within
    ``xent_tolerance``, padded columns zero, reruns the same bits."""
    loss, lse = xent.softmax_xent_forward(x, y, v)
    dx = xent.softmax_xent_backward(x, y, lse, g, v)
    torch.cuda.synchronize()
    ref_loss, ref_lse = xent.softmax_xent_forward_reference(x, y, v)
    ref_dx = xent.softmax_xent_backward_reference(x, y, g, v)
    bounds = xent.xent_tolerance(x, y, v, ref_loss, ref_lse, g, ref_dx)
    for name, got, want in (("lse", lse, ref_lse), ("loss", loss, ref_loss),
                            ("dlogits", dx[:, :v], ref_dx[:, :v])):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert bool(torch.isfinite(got).all()), name
        err = (got.float() - want.float()).abs()
        assert bool((err <= bounds[name]).all()), (
            name, float((err / bounds[name]).max()))
    mean_err = (loss.mean() - ref_loss.mean()).abs()
    assert float(mean_err) <= float(bounds["mean"])
    assert bool((dx[:, v:] == 0).all()) and not dx[:, v:].isnan().any()
    again_loss, again_lse = xent.softmax_xent_forward(x, y, v)
    again_dx = xent.softmax_xent_backward(x, y, again_lse, g, v)
    assert torch.equal(_bits(loss), _bits(again_loss))
    assert torch.equal(_bits(lse), _bits(again_lse))
    assert torch.equal(_bits(dx), _bits(again_dx))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernels_match_the_plain_versions(cuda_device, shape, dtype):
    x, y = _inputs(SHAPES[shape], dtype, cuda_device)
    g = torch.ones((), device=cuda_device)
    _check_pair(x, y, SHAPES[shape][2], g)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_offset_logits_stay_within_the_bounds(cuda_device, shape):
    """Logits near +100 (a stability case, as GroupNorm's mean-100 one):
    the online max keeps every exp in range."""
    for dtype in (torch.bfloat16, torch.float32):
        x, y = _inputs(SHAPES[shape], dtype, cuda_device, seed=1,
                       offset=100.0)
        _check_pair(x, y, SHAPES[shape][2],
                    torch.full((), 0.37, device=cuda_device))


def test_int32_labels_and_a_vocab_inside_one_vector(cuda_device):
    """int32 labels, and vocabs that end 1 and 7 columns into a vector."""
    for v in (8 * 100 + 1, 8 * 100 + 7):
        x, y = _inputs((64, 8 * 104, v), torch.bfloat16, cuda_device, seed=2,
                       label_dtype=torch.int32)
        _check_pair(x, y, v, torch.ones((), device=cuda_device))


def test_function_launches_each_kernel_once(cuda_device):
    """``softmax_cross_entropy`` on the card: the kernels' loss and
    gradient, one launch of each."""
    x, y = _inputs((512, 1024, 1000), torch.bfloat16, cuda_device, seed=3)
    x[:, 1000:] = 0
    leaf = x.clone().requires_grad_()
    counts = (xent.softmax_xent_forward.launches,
              xent.softmax_xent_backward.launches)
    loss = xent.softmax_cross_entropy(leaf.view(8, 64, 1024), y.view(8, 64),
                                      1000)
    loss.backward()
    assert (xent.softmax_xent_forward.launches - counts[0],
            xent.softmax_xent_backward.launches - counts[1]) == (1, 1)
    rows, lse = xent.softmax_xent_forward(x, y, 1000)
    assert torch.equal(loss, rows.mean())
    g = torch.ones((), device=cuda_device)
    assert torch.equal(leaf.grad, xent.softmax_xent_backward(x, y, lse, g,
                                                             1000))


def test_captured_loss_replays_equal_to_eager(cuda_device):
    x, y = _inputs((256, 2048, 2000), torch.bfloat16, cuda_device, seed=4)
    x[:, 2000:] = 0
    leaf = x.clone().requires_grad_()

    def step():
        leaf.grad = None
        loss = xent.softmax_cross_entropy(leaf, y, 2000)
        loss.backward()
        return loss

    want = step().detach().clone()
    want_grad = leaf.grad.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm-up on the side stream, as make_graphed_callables
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = xent.softmax_xent_forward.launches
    with fa.capture_launches(side.cuda_stream) as tally, \
            torch.cuda.graph(graph, stream=side):
        got = step()
    assert xent.softmax_xent_forward.launches == before
    for _ in range(3):
        graph.replay()
    fa.count_replays(tally, 3)
    torch.cuda.synchronize()
    assert xent.softmax_xent_forward.launches == before + 3
    assert torch.equal(got, want) and torch.equal(leaf.grad, want_grad)


def _tiny_trainer(device):
    """A tiny GPT (vocab 1000: its table padded to 1024 rows) trained as
    the ``gpt`` job trains it, on fused data."""
    return_hidden, loss_fn = lm_loss()
    cfg = GPTConfig.tiny(vocab_size=1000, max_len=128,
                         return_hidden=return_hidden)
    model = GPT(cfg, device=device).init_weights(
        torch.Generator(device=device).manual_seed(0))
    return Trainer(model, loss_fn=loss_fn,
                   sample_fn=data.causal_token_sample(2, 128, 1000))


def test_graphed_tiny_gpt_step_makes_no_f32_logits(cuda_device):
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    t, v, vp = 2 * 128, 1000, 1024
    made = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for r in tree_leaves(out):
                if (isinstance(r, torch.Tensor) and r.dim() >= 2
                        and r.shape[-1] in (v, vp) and r.numel() >= t * v):
                    made.append((str(func), tuple(r.shape), r.dtype))
            return out

    counts = (xent.softmax_xent_forward.launches,
              xent.softmax_xent_backward.launches)
    trainer = _tiny_trainer(cuda_device)
    with Watch():
        graph_loss = trainer.step({}, chunk=2).loss  # warm-up, capture, replay
    assert (xent.softmax_xent_forward.launches - counts[0],
            xent.softmax_xent_backward.launches - counts[1]) == (2, 2)
    assert made, "the watch saw no logits"
    assert all(dtype == torch.bfloat16 and shape[-1] == vp
               for _, shape, dtype in made), made
    graph_params = [p.detach().clone() for p in trainer.model.parameters()]
    eager = _tiny_trainer(cuda_device)
    eager.step({}, sync=False)
    eager_loss = eager.step({}).loss
    assert eager_loss == graph_loss
    for a, b in zip(graph_params, eager.model.parameters()):
        assert torch.equal(a, b.detach())


def test_layouts_the_kernels_cannot_read_raise(cuda_device):
    x, y = _inputs((16, 1024, 1000), torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        xent.softmax_cross_entropy(x[:, :1016], y, 1000)
    with pytest.raises(ValueError, match="16-byte"):
        xent.softmax_xent_forward(x[:, :1020], y, 1000)
    with pytest.raises(ValueError, match="int32 or int64"):
        xent.softmax_xent_forward(x, y.to(torch.int16), 1000)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        xent.softmax_xent_forward(x.half(), y, 1000)
    with pytest.raises(ValueError, match="do not fit"):
        xent.softmax_cross_entropy(x, y, 1025)
    with pytest.raises(ValueError, match="does not fit"):
        xent.softmax_xent_forward(x, y, 1025)
