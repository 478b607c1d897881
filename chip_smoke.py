#!/usr/bin/env python3
"""Proof that the PyTorch port runs on an NVIDIA card, end to end.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. Device: the card's name and power limit; build every kernel of the port
   from ``cron_operator_tpu_torch/ops/csrc`` (nvcc, sm_90a).
2. Kernel against its plain version on the card: the flash-attention
   forward (K1) against ``flash_attention_reference`` over bf16/f32, causal
   or not, head_dim 64/128, GQA groups 1/2/4, seq 128/512/2048.
3. The serving slice at GPT-2 small width: ``generate_job`` through a job
   context, with every kernel count set to 0 just before and read just
   after; then prefill logits through the kernel against the plain-attention
   path on the same weights and prompt.
4. Times (CUDA events, medians): K1 per launch at the slice's shape beside
   its bound, the plain version and ``F.scaled_dot_product_attention`` (a
   yardstick only: the port never calls it); the slice's prefill, decode
   step and tokens/s.
5. A ``kernels`` JSON line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

HERE = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# The slice: GPT-2 small (vocab 50257, hidden 768, 12 layers, 12 heads,
# mlp 3072) serving 8 prompts of 512 tokens, 64 new tokens each.
SLICE_PARAMS = {
    "size": "base", "seq_len": "1024", "batch_size": "8", "prompt_len": "512",
    "max_new": "64", "rounds": "3", "temperature": "0", "seed": "0",
}
GPT2_SMALL_PARAMS = 124_439_808
K1_SHAPE = dict(b=8, s=512, h=12, d=64)  # the slice's prefill attention


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def median_ms(torch, fn, iters: int, reps: int = 5, warmup: int = 3) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def profile_window(torch, card: str, label: str, fn) -> None:
    """Where one window's device time goes: the top kernels by device time
    and the device's busy share of the window's wall time (torch.profiler;
    its own overhead lengthens the wall time, so the idle share is an upper
    bound)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[{card}] profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {100 * e.self_device_time_total / busy_us:5.1f}% "
              f"{e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
              f"{e.key[:90]}")


def phase_device(torch):
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)}", flush=True)
    from cron_operator_tpu_torch.ops import _build

    t0 = time.monotonic()
    logs = _build.build_all()
    print(f"build: {len(logs)} kernel source(s) in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    return card


def check_k1(torch, fa, name: str, q, k, v, causal: bool) -> float:
    """Runs K1 and its plain version on the same card tensors and fails
    unless they agree; returns max|dO|. In bf16 both sides round one f32
    result to bf16, so O may differ by one bf16 ulp (<= 2^-7 |O|); in f32
    only the summation order differs (1e-4). LSE is f32 on both sides:
    summation order only (1e-4)."""
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
    diff = (o.float() - o_ref.float()).abs()
    if q.dtype == torch.bfloat16:
        bound = 2.0 ** -7 * o_ref.float().abs() + 1e-4
    else:
        bound = torch.full_like(diff, 1e-4)
    err_o = diff.max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    print(f"  {name}: max|dO|={err_o:.3e} max|dLSE|={err_lse:.3e}")
    if not (bool(torch.isfinite(o.float()).all())
            and bool((diff <= bound).all()) and err_lse <= 1e-4):
        fail(f"{name} disagrees with the plain version")
    return err_o


def phase_kernel_vs_plain(torch, fa) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (False, True):
            for d in (64, 128):
                for group in (1, 2, 4):
                    for s in (128, 512, 2048):
                        b, h = 2, 8
                        q = torch.randn(b, s, h, d, generator=gen,
                                        device="cuda").to(dtype)
                        k, v = (torch.randn(b, s, h // group, d, generator=gen,
                                            device="cuda").to(dtype)
                                for _ in range(2))
                        check_k1(torch, fa,
                                 f"K1 {str(dtype)[6:]} causal={int(causal)} "
                                 f"d={d} group={group} s={s}",
                                 q, k, v, causal)
                        n += 1
    print(f"kernel vs plain: {n} cases agree", flush=True)


def phase_slice(torch, fa):
    from cron_operator_tpu_torch.backends.registry import JobContext
    from cron_operator_tpu_torch.workloads.entrypoints import generate_job

    ctx = JobContext("chip-smoke-generate", "default", {}, dict(SLICE_PARAMS))
    rounds = int(SLICE_PARAMS["rounds"])
    fa.flash_attention.launches = 0
    t0 = time.monotonic()
    generate_job(ctx)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = fa.flash_attention.launches
    print(f"slice: generate_job in {wall:.2f} s, progress {ctx.progress}")
    print(f"slice: flash_attention launches {launches} "
          f"(expected 12 x {rounds})", flush=True)
    if launches != 12 * rounds:
        fail(f"flash kernel launched {launches} times on the main path, "
             f"not {12 * rounds}")
    for key in ("n_params", "decode_read_bytes_per_step", "started_at",
                "first_step_at", "first_step_latency_s", "tokens_per_s",
                "steps_done", "tokens_generated"):
        if key not in ctx.progress:
            fail(f"progress key {key!r} was not published")
    if not ctx.progress["tokens_per_s"] > 0:
        fail("tokens_per_s is not positive")
    if ctx.progress["n_params"] != GPT2_SMALL_PARAMS:
        fail(f"n_params {ctx.progress['n_params']} is not GPT-2 small's")
    if ctx.progress["tokens_generated"] != rounds * 8 * 64:
        fail("tokens_generated does not count every round")
    return launches, ctx.progress


def slice_model(torch, cfg, weights_from=None):
    from cron_operator_tpu_torch.models import GPT

    model = GPT(cfg, device="cuda")
    if weights_from is None:
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    else:
        model.load_state_dict(weights_from.state_dict())
    return model.eval()


def phase_slice_correctness(torch):
    """Prefill logits through the kernel against the plain-attention path on
    the same bf16 weights and prompt, both measured against an f32 run."""
    from cron_operator_tpu_torch.models import GPTConfig

    cfg = GPTConfig(max_len=1024)
    flash = slice_model(torch, cfg)
    plain = slice_model(torch, replace(cfg, attention_impl="xla"), flash)
    exact = slice_model(
        torch, replace(cfg, attention_impl="xla", dtype=torch.float32), flash)
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        out = {name: m.prefill(prompt, m.new_cache(8))
               for name, m in (("flash", flash), ("plain", plain),
                               ("f32", exact))}
    if not all(t.shape == (8, cfg.vocab_size) and torch.isfinite(t).all()
               for t in out.values()):
        fail("prefill logits are not finite [8, vocab]")
    d_fp = (out["flash"] - out["plain"]).abs().max().item()
    d_p32 = (out["plain"] - out["f32"]).abs().max().item()
    d_f32 = (out["flash"] - out["f32"]).abs().max().item()
    print(f"prefill logits: max|flash-plain|={d_fp:.4f} "
          f"max|plain-f32|={d_p32:.4f} max|flash-f32|={d_f32:.4f} "
          f"(max|logit|={out['f32'].abs().max().item():.3f})")
    # Both bf16 paths carry bf16 rounding through 12 layers and differ only
    # in how attention rounds; the kernel path must stay within twice the
    # plain bf16 path's own distance from f32.
    if d_fp > 2 * d_p32 + 1e-3:
        fail("kernel prefill logits disagree with the plain path")
    tok_f, tok_p = out["flash"].argmax(-1), out["plain"].argmax(-1)
    for row in (tok_f != tok_p).nonzero().flatten().tolist():
        top2 = out["f32"][row].topk(2).values
        margin = (top2[0] - top2[1]).item()
        print(f"  row {row}: greedy tokens differ; f32 top-2 margin "
              f"{margin:.4f} vs max|flash-plain| {d_fp:.4f}")
        if margin > 2 * d_fp:
            fail(f"row {row}: greedy token differs beyond the logit gap")
    print(f"greedy first token: {int((tok_f == tok_p).sum())}/8 rows agree",
          flush=True)
    return flash


def phase_times(torch, fa, flash_model, card):
    import torch.nn.functional as F

    b, s, h, d = K1_SHAPE["b"], K1_SHAPE["s"], K1_SHAPE["h"], K1_SHAPE["d"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    # the main path's layout: strided views of one fused qkv projection
    qkv = torch.randn(b, s, 3, h, d, generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    k1_err = check_k1(torch, fa, f"K1 bfloat16 causal=1 b={b} s={s} h={h} "
                      f"d={d} (the slice's prefill)", q, k, v, True)
    k1_ms = median_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, causal=True), iters=50)
    plain_ms = median_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, causal=True), iters=20)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=50)
    moved = 4 * q.numel() * q.element_size() + b * h * s * 4  # + f32 LSE
    flops = 4 * d * b * h * (s * (s + 1) // 2)  # QK^T and PV, causal pairs
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[{card}] K1 b{b} s{s} h{h} d{d} causal bf16: {k1_ms:.4f} ms/launch"
          f" | plain {plain_ms:.4f} ms | sdpa {library_ms:.4f} ms | bound "
          f"{bound_ms * 1e3:.2f} us ({moved / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP)", flush=True)

    prompt = torch.randint(0, flash_model.config.vocab_size, (8, 512),
                           generator=gen, device="cuda")
    with torch.inference_mode():
        cache = flash_model.new_cache(8)
        prefill_ms = median_ms(
            torch, lambda: flash_model.prefill(prompt, cache), iters=3)
        token = prompt[:, -1:]

        def decode_step():
            # rewind so every timed step decodes at one cache position
            cache.pos = 512
            flash_model.decode(token, cache)

        decode_ms = median_ms(torch, decode_step, iters=20)
    print(f"[{card}] slice prefill (b8 p512): {prefill_ms:.3f} ms | decode "
          f"step (b8, cache 1024): {decode_ms:.3f} ms/token-step", flush=True)
    with torch.inference_mode():
        profile_window(torch, card, "prefill x1",
                       lambda: flash_model.prefill(prompt, cache))
        profile_window(torch, card, "decode x16",
                       lambda: [decode_step() for _ in range(16)])
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "cron_operator_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "cron_operator_tpu/ops/flash_attention.py:72",
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }, prefill_ms, decode_ms


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    if not (HERE / "cron_operator_tpu_torch" / "__init__.py").is_file():
        fail("cron_operator_tpu_torch/ is not beside this script: run it "
             "from the root of a checkout")
    import cron_operator_tpu_torch

    if Path(cron_operator_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail("imported cron_operator_tpu_torch from outside this checkout")
    import importlib

    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device(torch)
    phase_kernel_vs_plain(torch, fa)
    launches, progress = phase_slice(torch, fa)
    flash_model = phase_slice_correctness(torch)
    k1, prefill_ms, decode_ms = phase_times(torch, fa, flash_model, card)
    k1["launches"] = launches
    print(f"[{card}] slice tokens/s {progress['tokens_per_s']} (rounds 2-3 of "
          f"generate_job) | first round {progress['first_step_latency_s']} s")
    print("slice " + json.dumps({
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "tokens_per_s": progress["tokens_per_s"],
        "decode_read_bytes_per_step": progress["decode_read_bytes_per_step"],
    }))
    print(json.dumps({"kernels": [k1]}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
