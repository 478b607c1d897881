"""The port's chunked cross-entropy against the JAX package's.

The same numpy hidden states, tied table and labels go through JAX
``chunked_cross_entropy`` and the port's; loss and both gradients agree
within f32 summation order (``rtol 1e-5`` on the loss, ``rtol 1e-4`` with
``atol 1e-6`` on the grads, the bounds ``tests/test_xent.py`` holds the JAX
op to against the naive path). The chunks cover a vocab the chunk divides,
ones it does not, and a chunk larger than the vocab.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.ops.xent import chunked_cross_entropy as jax_xent
from cron_operator_tpu_torch.ops.xent import chunked_cross_entropy

T, D, V = 24, 16, 100


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((2, T // 2, D), dtype=np.float32)
    table = 0.1 * rng.standard_normal((V, D), dtype=np.float32)
    labels = rng.integers(0, V, (2, T // 2)).astype(np.int32)
    return hidden, table, labels


def _port(hidden, table, labels, chunk):
    h = torch.tensor(hidden, requires_grad=True)
    w = torch.tensor(table, requires_grad=True)
    loss = chunked_cross_entropy(h, w, torch.tensor(labels), chunk)
    dh, dw = torch.autograd.grad(loss, (h, w))
    return loss.item(), dh.numpy(), dw.numpy()


def _jax(hidden, table, labels, chunk):
    loss, (dh, dw) = jax.value_and_grad(
        lambda h, w: jax_xent(h, w, jnp.asarray(labels), chunk),
        argnums=(0, 1),
    )(hidden, table)
    return float(loss), np.asarray(dh), np.asarray(dw)


# 100 divides; 32, 33, 7 and 64 leave a short final chunk (64's is 36 rows,
# padded to 64 and masked); 128 > V is clamped
@pytest.mark.parametrize("chunk", [V, 32, 33, 7, 128, 64])
def test_loss_and_grads_match_jax(data, chunk):
    got = _port(*data, chunk)
    ref = _jax(*data, chunk)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)


def test_padded_final_chunk_matches_jax():
    """A vocab whose final chunk is not a multiple of 64 rows (1361 = 2 x
    512 + 337, padded to 384), as GPT-2's 50257 leaves 1105 at chunk 8192:
    the padded columns stay out of the loss and of both gradients."""
    rng = np.random.default_rng(5)
    v = 1361
    hidden = rng.standard_normal((2, T // 2, D), dtype=np.float32)
    table = 0.1 * rng.standard_normal((v, D), dtype=np.float32)
    labels = rng.integers(0, v, (2, T // 2)).astype(np.int32)
    labels[0, 0] = v - 1  # a label in the last real row
    got = _port(hidden, table, labels, 512)
    ref = _jax(hidden, table, labels, 512)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)


def test_matches_the_full_logits_loss(data):
    """The chunked loss is the plain cross-entropy of the full logits."""
    hidden, table, labels = data
    logits = torch.tensor(hidden).reshape(-1, D) @ torch.tensor(table).T
    want = torch.nn.functional.cross_entropy(
        logits, torch.tensor(labels).reshape(-1).long())
    got = chunked_cross_entropy(torch.tensor(hidden), torch.tensor(table),
                                torch.tensor(labels), 32)
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)


def test_bf16_hidden_gives_bf16_grads(data):
    """bf16 hidden states are upcast per chunk (f32 products) and their
    gradient comes back in bf16, as in the JAX op."""
    hidden, table, labels = data
    h = torch.tensor(hidden).bfloat16().requires_grad_()
    w = torch.tensor(table, requires_grad=True)
    loss = chunked_cross_entropy(h, w, torch.tensor(labels), 32)
    dh, dw = torch.autograd.grad(loss, (h, w))
    assert loss.dtype == torch.float32
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32
    ref_loss, _, _ = _jax(np.asarray(jnp.asarray(hidden, jnp.bfloat16)
                                     .astype(jnp.float32)), table, labels, 32)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
