"""The port's microbench (``cron_operator_tpu_torch/ops/microbench.py``)
against the JAX package's, on the CPU at a small size.

- :func:`timed_chain` keeps the JAX contract: a positive time or ``None``,
  and the chain applied k x iters times to the carry.
- The four chain bodies, one step each on numpy-seeded f32 inputs, equal
  the same composition computed from the JAX package's
  ``multi_head_attention`` (flash in interpret mode, as the JAX tests run
  it) and ``moe_ffn``, within 2e-5.
- ``main`` prints exactly the JAX microbench's keys (read from the
  ``json.dumps`` literal of the JAX module, so that its ``main`` is not
  run) and exits non-zero without a card unless ``platform=cpu`` is given.
- The module imports nothing of the port at module level, so that a
  script measuring another checkout can load it by path.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.ops.attention import multi_head_attention as jax_mha
from cron_operator_tpu.parallel.moe import moe_ffn as jax_moe_ffn
from cron_operator_tpu_torch.backends.gpu import (
    PEAK_HBM_BYTES_PER_S,
    peak_hbm_bytes_per_s,
)
from cron_operator_tpu_torch.ops import microbench

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5  # f32: the same products and reductions in another order
B, S, H, D = 1, 128, 2, 64
MOE_TOKENS, MOE_D, MOE_E = 64, 32, 4


def _attention_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D), dtype=np.float32)
            for _ in range(3)]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_timed_chain_time_and_output():
    carry = torch.zeros(4, dtype=torch.float64)
    t, out = microbench.timed_chain(lambda c: c + 1, carry, iters=3,
                                    span_s=0.005)
    assert t is None or t > 0
    # k x iters applications of +1, for some k >= 1, from the carry,
    # which stays as it was
    n = out[0].item()
    assert n >= 3 and n % 3 == 0
    assert torch.equal(out, torch.full_like(carry, n))
    assert torch.equal(carry, torch.zeros_like(carry))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_chain_matches_jax(causal):
    q, k, v = _attention_inputs()
    got = microbench.attention_chain(torch.tensor(k), torch.tensor(v), causal,
                                     "flash")(torch.tensor(q))
    want = jax.jit(lambda q, k, v: jax_mha(
        q, k, v, causal=causal, impl="flash", interpret=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(got, want)


def test_attention_grad_chain_matches_jax(causal=True):
    q, k, v = _attention_inputs(1)
    got = microbench.attention_grad_chain(torch.tensor(k), torch.tensor(v),
                                          causal, "flash")(torch.tensor(q))

    def loss(q, k, v):
        out = jax_mha(q, k, v, causal=causal, impl="flash", interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    dq, dk, dv = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))
    want = dq + ((dk.sum() + dv.sum()) * 1e-20).astype(dq.dtype)
    _close(got, want)


def _moe_inputs():
    """Parameters at ``init_moe_params``' scales and tokens, drawn with
    numpy; the torch copies through the flax converter, which keeps the
    expert weights' layout."""
    from cron_operator_tpu_torch.models.convert import _tensor

    rng = np.random.default_rng(2)
    f = 4 * MOE_D
    jp = {
        "router": rng.standard_normal((MOE_D, MOE_E), dtype=np.float32) * 0.02,
        "wi": rng.standard_normal((MOE_E, MOE_D, f), dtype=np.float32)
        / np.sqrt(MOE_D),
        "wo": rng.standard_normal((MOE_E, f, MOE_D), dtype=np.float32)
        / np.sqrt(f),
    }
    x = rng.standard_normal((MOE_TOKENS, MOE_D), dtype=np.float32)
    return ({k: jnp.asarray(v) for k, v in jp.items()},
            {k: _tensor(v) for k, v in jp.items()}, x)


def test_moe_chain_matches_jax():
    jp, tp, x = _moe_inputs()
    xt = torch.tensor(x)
    got = microbench.moe_chain(tp, xt)(xt)
    want, _ = jax.jit(lambda p, x: jax_moe_ffn(
        p, x, compute_dtype=jnp.float32))(jp, jnp.asarray(x))
    _close(got, want)


def test_moe_grad_chain_matches_jax():
    jp, tp, x = _moe_inputs()
    xt = torch.tensor(x)
    got = microbench.moe_grad_chain(tp, xt)(xt)

    def loss(p, x):
        y, aux = jax_moe_ffn(p, x, compute_dtype=jnp.float32)
        return jnp.sum(y.astype(jnp.float32) ** 2) + aux

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    live = jax.tree_util.tree_reduce(lambda a, g: a + g.sum(), gp, 0.0)
    _close(got, (gx + live * 1e-20).astype(jnp.float32))


def _reference_keys():
    """The keys of the JAX microbench's JSON line and of its ``moe`` dict,
    from the literals in its source."""
    tree = ast.parse((ROOT / "cron_operator_tpu" / "ops"
                      / "microbench.py").read_text())
    line = moe = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            line = {k.value for k in node.args[0].keys}
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", "") == "moe"
                and isinstance(node.value, ast.Dict)):
            moe = {k.value for k in node.value.keys}
    return line, moe


def test_main_prints_the_reference_keys(capsys):
    assert microbench.main([
        "platform=cpu", f"seq={S}", f"batch={B}", f"heads={H}",
        f"head_dim={D}", "iters=1", f"moe_tokens={MOE_TOKENS}",
        f"moe_d_model={MOE_D}", f"moe_experts={MOE_E}", "span_s=0.001",
    ]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    line, moe = _reference_keys()
    assert set(out) == line
    assert set(out["moe"]) == moe
    assert out["backend"] == "cpu" and out["flash_mode"] == "plain"
    assert out["shape"] == [B, S, H, D]
    for key in ("flash_ms", "xla_ms", "flash_grad_ms", "xla_grad_ms"):
        assert out[key] is None or out[key] > 0
    # bf16 inputs against the f32 reference: the bf16 rounding of O
    assert 0 <= out["flash_max_abs_err_vs_f32_ref"] < 2e-2


def test_main_without_a_card_exits_non_zero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert microbench.main([f"seq={S}", "moe=0"]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_module_imports_nothing_of_the_port_at_module_level():
    tree = ast.parse((ROOT / "cron_operator_tpu_torch" / "ops"
                      / "microbench.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and not [n for n in names
                          if n.startswith("cron_operator_tpu")]


@pytest.mark.parametrize("name, rate", [
    ("NVIDIA H100 80GB HBM3", 3.35e12), ("h100-sxm", 3.35e12),
    ("NVIDIA H100 PCIe", None), ("NVIDIA A100-SXM4-80GB", None), ("", None)])
def test_hbm_rate_by_device_name(name, rate):
    assert peak_hbm_bytes_per_s(name) == rate
    assert PEAK_HBM_BYTES_PER_S["h100-sxm"] == 3.35e12
