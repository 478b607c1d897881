"""One-token decode attention (``ops.attention.decode_attention``) on the CPU.

The plain version ``decode_attention_reference`` is the arithmetic that
``models/gpt.py`` ``DecoderLayer._decode_attention`` ran inline before the
decode kernel came (kept below as ``_inline_decode``, verbatim): the two
agree to the bit, for MHA and GQA, f32 and bf16, at the first, a middle and
the last cache position. The JAX parity of the whole decode is held by
``tests/test_torch_generate.py``. Positions past ``pos`` never change the
output. The dispatch: a CPU tensor takes the plain version, a tensor on the
card launches the kernel or raises (never the plain version), a DTensor
and any other device raise, and a shape the kernel does not take is
refused before anything is built. The kernel itself runs in
``tests/test_torch_decode_attention_cuda.py`` on the card.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import importlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, distribute_tensor

from cron_operator_tpu_torch.models import GPT, GPTConfig

attn = importlib.import_module("cron_operator_tpu_torch.ops.attention")

B, L, H, D = 2, 64, 4, 32


def _inline_decode(cfg, q, k, v, cache_k, cache_v, pos):
    """``DecoderLayer._decode_attention`` as it read before the decode
    kernel, with ``self.config`` passed as ``cfg``."""
    b, _, h, d = q.shape
    kv_h = k.shape[2]
    cache_k.index_copy_(1, pos, k)
    cache_v.index_copy_(1, pos, v)
    qg = q.reshape(b, kv_h, h // kv_h, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float())
    scores = scores * (1.0 / d ** 0.5)
    written = torch.arange(cfg.max_len, device=q.device) <= pos
    scores = scores.masked_fill(~written, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs.float(), cache_v.float())
    return out.to(cfg.dtype).reshape(b, 1, h, d)


def _inputs(kv_h, dtype, seed=0, b=B, max_len=L, h=H, d=D):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dtype)

    return (draw(b, 1, h, d), draw(b, 1, kv_h, d), draw(b, 1, kv_h, d),
            draw(b, max_len, kv_h, d), draw(b, max_len, kv_h, d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kv_h", [H, H // 2], ids=["group1", "group2"])
@pytest.mark.parametrize("pos", [0, L // 2 - 3, L - 1],
                         ids=["first", "middle", "last"])
def test_plain_version_is_the_inline_decode_to_the_bit(dtype, kv_h, pos):
    cfg = GPTConfig.tiny(max_len=L, num_heads=H, hidden_size=H * D,
                         num_kv_heads=kv_h, dtype=dtype)
    q, k, v, ck, cv = _inputs(kv_h, dtype)
    p = torch.tensor([pos])
    want = _inline_decode(cfg, q, k, v, ck.clone(), cv.clone(), p)
    ck2, cv2 = ck.clone(), cv.clone()
    ck2.index_copy_(1, p, k)
    cv2.index_copy_(1, p, v)
    got = attn.decode_attention_reference(q, ck2, cv2, p)
    assert got.dtype == dtype and got.shape == (B, 1, H, D)
    assert torch.equal(got, want)
    # and the layer, which writes the cache and then calls the wrapper
    layer = GPT(cfg).layers[0]
    ck3, cv3 = ck.clone(), cv.clone()
    assert torch.equal(layer._decode_attention(q, k, v, ck3, cv3, p), want)
    assert torch.equal(ck3, ck2) and torch.equal(cv3, cv2)


@pytest.mark.parametrize("kv_h", [H, H // 2], ids=["group1", "group2"])
def test_positions_past_pos_change_nothing(kv_h):
    q, _, _, ck, cv = _inputs(kv_h, torch.bfloat16, seed=1)
    pos = 20
    p = torch.tensor([pos])
    zeroed_k, zeroed_v = ck.clone(), cv.clone()
    zeroed_k[:, pos + 1:] = 0
    zeroed_v[:, pos + 1:] = 0
    junk_k, junk_v = ck.clone(), cv.clone()
    junk_k[:, pos + 1:] = 3e4  # large, finite: masked scores, 0 probabilities
    junk_v[:, pos + 1:] = -7e4
    want = attn.decode_attention(q, zeroed_k, zeroed_v, p)
    assert torch.equal(attn.decode_attention(q, junk_k, junk_v, p), want)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    monkeypatch.setattr(attn.decode_attention, "launches", 0)
    q, _, _, ck, cv = _inputs(H, torch.float32)
    p = torch.tensor([9])
    out = attn.decode_attention(q, ck, cv, p)
    assert torch.equal(out, attn.decode_attention_reference(q, ck, cv, p))
    assert attn.decode_attention.launches == 0


class _OnTheCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: what the wrapper
    sees on a machine whose card cannot be reached."""

    @property
    def is_cuda(self):
        return True


def test_a_cuda_tensor_raises_rather_than_falling_back(monkeypatch):
    def no_card(name):
        raise RuntimeError(f"cannot build {name}: no CUDA toolkit or card")

    monkeypatch.setattr(attn, "_decode_lib", None)
    monkeypatch.setattr(attn._build, "load", no_card)
    monkeypatch.setattr(attn.decode_attention, "launches", 0)
    monkeypatch.setattr(attn, "decode_attention_reference",
                        lambda *a: pytest.fail("fell back to the plain version"))
    q, _, _, ck, cv = _inputs(H, torch.bfloat16)
    q = q.as_subclass(_OnTheCard)
    with pytest.raises(RuntimeError, match="no CUDA toolkit or card"):
        attn.decode_attention(q, ck, cv, torch.tensor([3]))
    assert attn.decode_attention.launches == 0


def test_other_devices_raise():
    q = torch.empty(B, 1, H, D, device="meta")
    c = torch.empty(B, L, H, D, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        attn.decode_attention(q, c, c, torch.zeros(1, dtype=torch.int64,
                                                   device="meta"))


@pytest.fixture
def one_rank_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_a_dtensor_raises(one_rank_mesh):
    q, _, _, ck, cv = _inputs(H, torch.float32)
    q = distribute_tensor(q, one_rank_mesh, [Replicate()])
    with pytest.raises(TypeError, match="not DTensors"):
        attn.decode_attention(q, ck, cv, torch.tensor([3]))


@pytest.mark.parametrize("change, match", [
    (dict(d=48), "head_dim"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(kv_h=3), "must divide"),
    (dict(h=2 * 33, kv_h=2), "groups of at most"),
    (dict(q_len=2), "one query position"),
    (dict(pos_dtype=torch.int32), "int64"),
    (dict(unaligned=True), "16-byte"),
])
def test_refused_inputs_raise_before_any_build(monkeypatch, change, match):
    def no_build(name):
        raise AssertionError(f"built {name} for refused inputs")

    monkeypatch.setattr(attn, "_decode_lib", None)
    monkeypatch.setattr(attn._build, "load", no_build)
    d, h = change.get("d", D), change.get("h", H)
    kv_h, dtype = change.get("kv_h", H), change.get("dtype", torch.bfloat16)
    q = torch.zeros(B, change.get("q_len", 1), h, d, dtype=dtype)
    cache = torch.zeros(B, L, kv_h, d, dtype=dtype)
    if change.get("unaligned"):
        # rows 2 bytes off a 16-byte boundary: the head stride is d + 1
        cache = torch.zeros(B, L, kv_h, d + 1, dtype=dtype)[..., :d]
    pos = torch.tensor([5], dtype=change.get("pos_dtype", torch.int64))
    with pytest.raises(ValueError, match=match):
        attn._launch_decode(q, cache, cache, pos)


def test_kernel_bookkeeping():
    """The wrapper counts its launches as the flash kernels do, by design
    (the cluster design and the three-pass one), and the tolerance is the
    bf16 and f32 rule of its docstring."""
    assert attn.decode_attention.launches_by_design.keys() == {"cluster",
                                                               "fma"}
    q, _, _, ck, cv = _inputs(H // 2, torch.bfloat16, seed=2)
    p = torch.tensor([40])
    ref = attn.decode_attention_reference(q, ck, cv, p)
    bound = attn.decode_tolerance(q, ck, cv, p, ref)
    assert bound.shape == ref.shape and (bound > 2.0 ** -7 * ref.float().abs()).all()
    qf, ckf, cvf = q.float(), ck.float(), cv.float()
    ref32 = attn.decode_attention_reference(qf, ckf, cvf, p)
    bound32 = attn.decode_tolerance(qf, ckf, cvf, p, ref32)
    assert (bound32 < bound).all()


def _assert_cluster_plan(plan, max_len, group, d, dtype):
    """A cluster plan's tiles fit a block and cover the cache."""
    assert plan["design"] == "cluster"
    assert plan["cluster"] == attn.DECODE_CLUSTER == 4
    assert plan["span"] == plan["slots"] * attn.DECODE_BOX
    assert plan["cluster"] * plan["span"] >= max_len
    assert (plan["cluster"] * (plan["slots"] - 1) * attn.DECODE_BOX
            < -(-max_len // attn.DECODE_BOX) * attn.DECODE_BOX)
    kv = plan["span"] * d * dtype.itemsize  # K's rows, then V's
    scores = group * plan["span"] * 4
    assert kv + scores < plan["smem"] <= attn.SMEM_LIMIT


@pytest.mark.parametrize("max_len, group, d, dtype", [
    (1024, 1, 64, torch.bfloat16),   # GPT-2 small's serving shape
    (1024, 2, 64, torch.bfloat16),   # GQA group 2
    (1024, 1, 32, torch.bfloat16),
    (1024, 1, 256, torch.bfloat16),
    (1000, 4, 128, torch.bfloat16),  # a max_len the boxes do not divide
    (300, 4, 256, torch.float32),
    (1024, 1, 64, torch.float32),
], ids=lambda v: str(v).replace("torch.", ""))
def test_plan_takes_the_cluster_design(max_len, group, d, dtype):
    plan = attn.decode_plan(max_len, group, d, dtype)
    _assert_cluster_plan(plan, max_len, group, d, dtype)


def test_serving_plan_is_256_rows_a_block_in_34_kb():
    """The serving shape: clusters of 4, 16 boxes of 16 rows a block, 256
    rows of K (then of V in the same 32 KB) and the rest a few KB: six
    blocks an SM, so the call's 384 blocks are resident at once."""
    plan = attn.decode_plan(1024, 1, 64, torch.bfloat16)
    assert (plan["cluster"], plan["slots"], plan["span"]) == (4, 16, 256)
    assert 6 * (plan["smem"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("max_len, group, d, dtype", [
    (2048, 2, 256, torch.float32),   # 256 rows of d 256 in f32: 256 KB
    (4096, 1, 128, torch.float32),
    (8192, 32, 64, torch.bfloat16),  # a long cache at the largest group
], ids=lambda v: str(v).replace("torch.", ""))
def test_plan_keeps_three_passes_beyond_the_shared_memory(max_len, group, d,
                                                          dtype):
    plan = attn.decode_plan(max_len, group, d, dtype)
    assert plan["design"] == "fma" and plan["smem"] > attn.SMEM_LIMIT


def test_plan_refuses_a_cluster_size_the_kernel_lacks():
    with pytest.raises(ValueError, match="decode clusters"):
        attn.decode_plan(1024, 1, 64, torch.bfloat16, cluster=3)
    assert attn.decode_plan(1024, 1, 64, torch.bfloat16,
                            cluster=8)["slots"] == 8


def test_an_unknown_design_is_refused_before_any_build(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a refused design")

    monkeypatch.setattr(attn, "_decode_lib", None)
    monkeypatch.setattr(attn._build, "load", no_build)
    q, _, _, ck, cv = _inputs(H, torch.bfloat16)
    with pytest.raises(ValueError, match="decode design"):
        attn._launch_decode(q, ck, cv, torch.tensor([3]), design="two_pass")
