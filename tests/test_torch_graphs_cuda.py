"""Multi-step dispatch on the card: the training step captured as a CUDA
graph and replayed against the eager step, the decode step's graph against
the eager decode loop, the captured prefill against the eager prefill
(logits and cache to the bit, its launches once a replay, the prefill
graphs of an entry sharing its decode graph's pool, evicted entries'
memory returned, weights restored in place served by the replays), and
fused data against the device stream.

Needs a CUDA card and nvcc (the flash kernels have no CPU mode, and a CUDA
graph needs a card); skips without one. It imports only torch and the
port, so it also runs where JAX is not installed: ``python -m pytest
--noconftest -m cuda tests/test_torch_graphs_cuda.py``.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import faulthandler
import importlib
import itertools

import pytest
import torch

from cron_operator_tpu_torch.models import MLP, Bert, BertConfig, GPT, GPTConfig
from cron_operator_tpu_torch.parallel.overlap import StepGraph
from cron_operator_tpu_torch.workloads import data
from cron_operator_tpu_torch.workloads.generate import generate

serving = importlib.import_module("cron_operator_tpu_torch.workloads.generate")
ln = importlib.import_module("cron_operator_tpu_torch.ops.layer_norm")
from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

CASE_TIMEOUT_S = 300  # as the kernel card tests: the first build included
STEPS = 6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no "
                    "CPU mode")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _gpt():
    # head dim 64 in bf16: the sm90 kernels; seq 128 takes the flash path
    cfg = GPTConfig.tiny(hidden_size=256, max_len=128)
    return GPT(cfg, device="cuda"), data.causal_token_sample(2, 128,
                                                             cfg.vocab_size)


def _bert():
    cfg = BertConfig.tiny(hidden_size=256, max_len=128)
    return Bert(cfg, device="cuda"), data.token_sample(2, 128, cfg.vocab_size)


def _mnist():
    return MLP(device="cuda"), data.mnist_sample(32)


MODELS = {"gpt": (_gpt, {}), "bert": (_bert, {}),
          "gpt_remat": (_gpt, {"remat": True}),
          "mnist": (_mnist, {"optimizer": "sgd", "learning_rate": 0.01})}


def _train(make, config, batches, graphed: bool):
    """STEPS steps from seed-0 weights: one call of STEPS steps (the graph:
    an eager warm-up step, the capture, STEPS - 1 replays) or STEPS calls
    of one eager step. Returns the last loss, the parameters and the flash
    launches counted."""
    model, _ = make()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    trainer = Trainer(model, TrainConfig(lr_schedule="cosine",
                                         schedule_steps=STEPS, **config))
    before = fa.flash_attention.launches, fa.flash_attention_dkv.launches
    if graphed:
        loss = trainer.step(list(batches)).loss
        assert trainer._graph is not None and trainer._graph.replays == STEPS - 1
    else:
        loss = [trainer.step(b).loss for b in batches][-1]
    torch.cuda.synchronize()
    launches = (fa.flash_attention.launches - before[0],
                fa.flash_attention_dkv.launches - before[1])
    return loss, dict(model.named_parameters()), launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODELS))
def test_graph_replay_matches_the_eager_step(cuda_device, name):
    """The same 6 steps (a cosine schedule, so every step has its own
    learning rate) as one replayed graph and as eager steps: the same loss
    and bit-identical parameters, and the kernels counted once per step
    through the replays."""
    make, config = MODELS[name]
    _, sample = make()
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [sample(gen) for _ in range(STEPS)]
    eager = _train(make, config, batches, graphed=False)
    graphed = _train(make, config, batches, graphed=True)
    assert eager[0] == graphed[0]
    for n, p in eager[1].items():
        assert torch.equal(p, graphed[1][n]), n
    if name != "mnist":
        layers = 2
        # remat runs the forward twice a step
        per_step = (2 if config.get("remat") else 1) * layers
        assert graphed[2] == eager[2] == (per_step * STEPS, layers * STEPS)


@pytest.mark.cuda
def test_fused_draws_in_the_graph_are_the_device_streams(cuda_device):
    """A draw captured with its generator registered gives, replay after
    replay, what the device stream draws from the same seed; and a fused
    run of 4 steps in one call trains on exactly those batches."""
    sample = data.causal_token_sample(2, 128, 1024)
    gen = torch.Generator(device="cuda").manual_seed(7)
    graph = StepGraph(lambda _: sample(gen)["x"].clone(), generators=(gen,))
    drawn = [graph({}).clone() for _ in range(4)]
    stream = data.device_batches(sample, device="cuda", seed=7)
    for got in drawn:
        assert torch.equal(got, next(stream)["x"])

    runs = []
    for fused in (False, True):
        model, sample = _gpt()
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        trainer = Trainer(model, TrainConfig(steps_per_call=4, data_seed=3),
                          sample_fn=sample if fused else None)
        batches = (itertools.repeat({}) if fused else
                   data.device_batches(sample, device="cuda", seed=3))
        stats = trainer.run(batches, 4)
        assert [s.chunk for s in stats] == [4]
        runs.append(dict(model.named_parameters()))
    for n, p in runs[0].items():
        assert torch.equal(p, runs[1][n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_decode_graph_matches_the_eager_loop(cuda_device, temperature):
    """Generation through the captured decode step (twice: capture, then
    replays only) gives the eager loop's tokens, greedy and seeded-sampled."""
    cfg = GPTConfig.tiny(hidden_size=256, max_len=192)
    model = GPT(cfg, device="cuda", param_dtype=cfg.dtype)
    model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
    prompt = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))

    def run(captured):
        gen = torch.Generator(device="cuda").manual_seed(5)
        return [generate(cfg, model, prompt, 16, temperature=temperature,
                         generator=gen, captured=captured) for _ in range(2)]

    eager = run(False)
    graphed = run(True)
    for a, b in zip(eager, graphed):
        assert a.shape == (2, 144)
        assert torch.equal(a, b)
    if temperature:
        assert not torch.equal(eager[0], eager[1])  # the stream moved on


@pytest.mark.cuda
def test_a_deleted_trainer_returns_its_graph_pool(cuda_device):
    """The step graph holds the trainer's step weakly, so a trainer goes
    with its last reference, its graph (the owner of the graph's private
    memory pool) with it: no reference cycle waits for the collector. The
    memory the run held is returned (the cuBLAS workspace of the capture's
    stream stays cached, so the count need not fall to the start's)."""
    import gc
    import weakref

    def train():
        model, sample = _gpt()
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        trainer = Trainer(model, TrainConfig())
        gen = torch.Generator(device="cuda").manual_seed(1)
        trainer.step([sample(gen) for _ in range(3)])
        assert trainer._graph is not None and trainer._graph.replays == 2
        torch.cuda.synchronize()
        held = sum(p.numel() * p.element_size() for p in model.parameters())
        return (weakref.ref(trainer), weakref.ref(trainer._graph),
                torch.cuda.memory_allocated(), held)

    gc.collect()
    gc.disable()
    try:
        trainer, graph, during, params_bytes = train()
        assert trainer() is None and graph() is None
        after = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    # the parameters, the AdamW state (2x) and the gradients at least
    assert during - after >= 4 * params_bytes, (during, after, params_bytes)


def _serving_gpt(seed=0, **over):
    cfg = GPTConfig.tiny(hidden_size=256, max_len=192, **over)
    model = GPT(cfg, device="cuda", param_dtype=cfg.dtype)
    return cfg, model.init_weights(
        torch.Generator(device="cuda").manual_seed(seed)).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, {"moe_every": 2, "num_experts": 4}],
                         ids=["dense", "moe"])
def test_a_replayed_prefill_is_the_eager_prefill(cuda_device, over):
    """The prefill captured by ``StepGraph`` (as ``generate`` captures it)
    and replayed on a new prompt gives the eager prefill's logits and KV
    cache to the bit, and counts K1 and the LayerNorm kernels once a
    replay."""
    cfg, model = _serving_gpt(**over)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                             generator=gen) for _ in range(2)]
    with torch.inference_mode():
        cache = model.new_cache(2)
        graph = StepGraph(lambda inputs: model.prefill(inputs["prompt"],
                                                       cache))
        graph({"prompt": prompts[0]})  # warm-up and capture
        k1, ln_fwd = fa.flash_attention.launches, (
            ln.layer_norm_forward.launches
            + ln.add_layer_norm_forward.launches)
        logits = graph({"prompt": prompts[1]}).clone()
        torch.cuda.synchronize()
        assert fa.flash_attention.launches - k1 == cfg.num_layers
        assert (ln.layer_norm_forward.launches
                + ln.add_layer_norm_forward.launches - ln_fwd
                == 2 * cfg.num_layers + 1)
        fresh = model.new_cache(2)
        want = model.prefill(prompts[1], fresh)
    assert torch.equal(logits, want)
    assert int(cache.pos) == int(fresh.pos) == 128
    for a, b in zip(cache.k + cache.v, fresh.k + fresh.v):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, {"num_kv_heads": 2, "rope": True},
                                  {"moe_every": 2, "num_experts": 4}],
                         ids=["mha", "gqa_rope", "moe"])
def test_captured_prefill_greedy_tokens_equal_the_eager_loop(cuda_device,
                                                             over):
    """Greedy generation with the prefill and decode step replayed, over
    two prompt lengths and a length seen again, gives the eager loop's
    tokens; the entry keeps one prefill graph a length, all on the decode
    graph's memory pool."""
    cfg, model = _serving_gpt(**over)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab_size, (2, p), device="cuda",
                             generator=gen) for p in (128, 64, 128)]
    for prompt in prompts:
        eager = generate(cfg, model, prompt, 16, captured=False)
        graphed = generate(cfg, model, prompt, 16)
        assert torch.equal(eager, graphed)
    decoder = serving._decoder(model, 2, True, None)
    assert list(decoder.prefills) == [64, 128]
    # 128 captured by its first generation, replayed by its second
    assert [g.replays for g in decoder.prefills.values()] == [0, 1]
    assert all(g._pool == decoder.pool for g in decoder.prefills.values())
    assert decoder.step._pool == decoder.pool


@pytest.mark.cuda
def test_evicted_entries_return_their_memory(cuda_device, monkeypatch):
    """With room for one entry, a second model's entry drops the first
    one: its graphs and cache go with it (the memory in use does not grow
    by the new entry's cache of the same size), and its graph pool goes
    back to the card (the memory reserved falls)."""
    import gc
    import weakref

    monkeypatch.setattr(serving, "_DECODERS_CAP", 1)
    monkeypatch.setattr(serving, "_DECODERS", serving.OrderedDict())
    cfg, first = _serving_gpt(seed=0)
    _, second = _serving_gpt(seed=1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    generate(cfg, first, prompt, 8)
    entry = serving._decoder(first, 2, True, None)
    graphs = [weakref.ref(g._graph) for g in (entry.step,
                                              *entry.prefills.values())]
    entry = weakref.ref(entry)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    allocated, reserved = (torch.cuda.memory_allocated(),
                           torch.cuda.memory_reserved())
    serving._decoder(second, 2, True, None)
    gc.collect()
    torch.cuda.empty_cache()
    assert entry() is None and all(g() is None for g in graphs)
    assert list(serving._DECODERS) == [(id(second), 2, True)]
    assert torch.cuda.memory_allocated() <= allocated
    assert torch.cuda.memory_reserved() < reserved


@pytest.mark.cuda
def test_weights_restored_in_place_are_served_by_the_replays(cuda_device):
    """A restore into the served model between generations
    (``load_state_dict`` writes the parameters in place) reaches the
    replayed prefill and decode steps: the padded vocab table they read is
    refilled before the replay, so the tokens are the eager loop's on the
    new weights."""
    cfg, model = _serving_gpt(seed=0)
    _, other = _serving_gpt(seed=1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4))
    for _ in range(2):  # the captures, then replays
        generate(cfg, model, prompt, 8)
    with torch.no_grad():
        model.load_state_dict(other.state_dict())
    graphed = generate(cfg, model, prompt, 8)
    eager = generate(cfg, other, prompt, 8, captured=False)
    assert torch.equal(graphed, eager)
