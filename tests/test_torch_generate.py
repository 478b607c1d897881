"""The port's KV-cache generation: greedy output token-identical to the JAX
package's ``generate`` from converted weights (with the cache position a
device tensor that decode advances on the device), equal to a full-forward
rerun (dense, GQA with RoPE, and Switch-MoE blocks), the same argument checks, and seeded sampling, whose draw is
``torch.multinomial``'s written out."""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cron_operator_tpu.models.gpt import GPT as JaxGPT
from cron_operator_tpu.models.gpt import GPTConfig as JaxGPTConfig
from cron_operator_tpu.workloads.generate import generate as jax_generate
from cron_operator_tpu_torch.models import GPT, GPTConfig
from cron_operator_tpu_torch.models.convert import params_from_flax
from cron_operator_tpu_torch.workloads.generate import generate


def _pair(**over):
    jcfg = JaxGPTConfig.tiny(dtype=jnp.float32, **over)
    tcfg = GPTConfig.tiny(dtype=torch.float32, **over)
    params = JaxGPT(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)
    )["params"]
    model = GPT(tcfg)
    model.load_state_dict(
        params_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    )
    return jcfg, params, tcfg, model.eval()


def _prompt(b=2, p=4, seed=1):
    return np.random.default_rng(seed).integers(0, 1024, (b, p)).astype(np.int32)


@pytest.mark.parametrize(
    "over", [dict(), dict(num_kv_heads=2, rope=True),
             dict(moe_every=2, num_experts=4)],
    ids=["mha", "gqa_rope", "moe"]
)
def test_greedy_matches_jax_generate(over):
    jcfg, params, tcfg, model = _pair(**over)
    prompt = _prompt()
    ref = np.asarray(jax_generate(jcfg, params, jnp.asarray(prompt), 6))
    out = generate(tcfg, model, torch.from_numpy(prompt).long(), 6)
    assert out.shape == (2, 10)
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize(
    "over", [dict(), dict(num_kv_heads=2, rope=True),
             # the JAX MoE oracle: a capacity factor of num_experts drops
             # no token in the full forward either, so no drop can hide a
             # routing divergence between the two paths
             dict(moe_every=1, num_experts=4, moe_capacity_factor=4.0)],
    ids=["mha", "gqa_rope", "moe"]
)
def test_greedy_matches_full_forward_rerun(over):
    cfg = GPTConfig.tiny(dtype=torch.float32, **over)
    model = GPT(cfg).init_weights(torch.Generator().manual_seed(0)).eval()
    prompt = torch.from_numpy(_prompt()).long()
    out = generate(cfg, model, prompt, 6)
    assert torch.equal(out[:, :4], prompt)
    seq = prompt
    with torch.no_grad():
        for _ in range(6):
            logits = model(seq)
            if model.has_moe:
                logits, _ = logits
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            seq = torch.cat([seq, nxt], dim=1)
    assert torch.equal(out, seq), "cached decode diverged from the full forward"


def test_single_token_prompt():
    _, _, cfg, model = _pair()
    out = generate(cfg, model, torch.from_numpy(_prompt(p=1)).long(), 3)
    assert out.shape == (2, 4)


def test_sampling_is_deterministic_per_seed():
    _, _, cfg, model = _pair()
    prompt = torch.from_numpy(_prompt()).long()

    def draw(seed):
        return generate(cfg, model, prompt, 8, temperature=5.0,
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(7), draw(7), draw(8)
    assert torch.equal(a, b)
    # temperature 5 over 1024 logits: 8 identical draws from two seeds is
    # vanishingly unlikely with an untrained model
    assert not torch.equal(a[:, 4:], c[:, 4:])


def test_rejects_the_same_bad_arguments():
    cfg = GPTConfig.tiny(dtype=torch.float32, max_len=32)
    model = GPT(cfg)
    prompt = torch.zeros(2, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds"):
        generate(cfg, model, prompt, max_new_tokens=29)
    with pytest.raises(ValueError, match="empty prompt"):
        generate(cfg, model, prompt[:, :0], 1)
    with pytest.raises(ValueError, match="needs an rng"):
        generate(cfg, model, prompt, 1, temperature=1.0)
    with pytest.raises(ValueError, match=">= 0"):
        generate(cfg, model, prompt, 1, temperature=-1.0)
    with pytest.raises(ValueError, match="must be >= 1"):
        generate(cfg, model, prompt, 0)
    with pytest.raises(ValueError, match="differs"):
        generate(GPTConfig.tiny(dtype=torch.float32), model, prompt, 1)


def test_cache_position_is_a_device_tensor_advanced_by_decode():
    """Prefill sets the position, each decode step adds one on the device;
    the K/V of step ``pos`` land at ``pos``."""
    _, _, cfg, model = _pair()
    cache = model.new_cache(2)
    assert cache.pos.dtype == torch.int64 and cache.pos.dim() == 0
    prompt = torch.from_numpy(_prompt()).long()
    with torch.no_grad():
        model.prefill(prompt, cache)
        assert int(cache.pos) == 4
        written = cache.k[0].abs().sum((0, 2, 3)) > 0
        assert written.tolist() == [True] * 4 + [False] * (cfg.max_len - 4)
        model.decode(prompt[:, -1:], cache)
        model.decode(prompt[:, -1:], cache)
    assert int(cache.pos) == 6
    written = cache.k[0].abs().sum((0, 2, 3)) > 0
    assert written[:6].all() and not written[6:].any()


def test_sampling_draw_is_multinomials():
    """The exponential race of ``_sample`` gives the token that
    ``torch.multinomial`` draws for one sample from the same generator
    state (it checks its input on the host, which a graph capture
    refuses)."""
    from cron_operator_tpu_torch.workloads.generate import _sample

    logits = torch.from_numpy(
        np.random.default_rng(5).standard_normal((4, 1024)).astype(np.float32)
    )
    temperature = torch.tensor(0.7)
    got = _sample(logits, temperature, torch.Generator().manual_seed(3))
    probs = torch.softmax(logits / temperature, dim=-1)
    want = torch.multinomial(probs, 1,
                             generator=torch.Generator().manual_seed(3))[:, 0]
    assert torch.equal(got, want)
    assert torch.equal(_sample(logits, None, None), logits.argmax(-1))
