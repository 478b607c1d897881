"""Attention and MoE micro-benchmark of the port, and its timing primitives,
as ``cron_operator_tpu/ops/microbench.py`` is the JAX package's.

Run as ``python -m cron_operator_tpu_torch.ops.microbench [key=value ...]``;
prints one JSON line with the JAX microbench's keys. Params: ``seq`` (512),
``batch`` (8), ``heads`` (8), ``head_dim`` (64), ``iters`` (20), ``causal``
(1), ``moe`` (1), ``moe_d_model`` (512), ``moe_tokens`` (4096),
``moe_experts`` (8), ``span_s`` (0.5, the span :func:`timed_chain` sizes
its repeat count for) and ``platform`` (unset: the CUDA card, and a
non-zero exit without one; ``cpu`` on request, where ``flash`` is the
kernels' plain version and the times say nothing of a card).

``flash`` is the Hopper kernels K1 (forward), K2 and K3 (backward) through
:func:`ops.attention.multi_head_attention`; ``xla`` is the port's plain
attention (``impl="xla"``: f32 products over a materialised s x s score
matrix, unfused). It is not XLA: the ratio of the two reads far higher than
the JAX microbench's on a TPU.

The timing primitives live here, one copy for every caller:

- :func:`timed_chain`, the chain timer of the JAX package's microbench, of
  ``hack/torch_mfu_probe.py``, ``hack/torch_mfu_attrib.py`` and
  ``hack/torch_step_bench.py``;
- :func:`event_ms`, :func:`median_ms` and :func:`device_ms`, the CUDA-event
  timers of ``chip_smoke.py`` and ``hack/torch_*_ab.py``.

Nothing of the port is imported at module level (:func:`timed_chain`
imports ``parallel.overlap`` when it captures, :func:`main` the models it
runs), so that a script that measures another checkout can load this file
by path and time every checkout with the same code.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


def _parse(argv):
    out = {}
    for a in argv:
        if "=" in a:
            k, v = a.split("=", 1)
            out[k] = v
    return out


def timed_chain(
    chain_fn: Callable[[torch.Tensor], torch.Tensor],
    carry: torch.Tensor,
    iters: int = 20,
    span_s: float = 0.5,
    *,
    capture: bool = True,
    generators: Sequence[torch.Generator] = (),
) -> Tuple[Optional[float], torch.Tensor]:
    """Seconds per application of ``chain_fn`` (carry -> carry of the same
    shape), with constant overhead subtracted out, or ``None`` when noise
    made the difference non-positive; and the chain's output.

    The JAX package's contract (``cron_operator_tpu/ops/microbench.py``
    ``timed_chain``): one block of ``iters`` applications is fed its own
    output k times a span, then 2k times; each span starts from ``carry``
    and is the best of 3; k is sized from a two-span difference so that a
    span lasts about ``span_s``; the result is (t_2k - t_k) / (k iters).
    The output is the chain applied k iters times to ``carry``.

    On the card the block is captured once as a CUDA graph
    (:class:`parallel.overlap.StepGraph`: an eager warm-up call on a side
    stream, then the capture; ``generators`` are registered with it) and a
    span replays it k times; each span is timed by CUDA events around the
    replays, so the constant costs of a span (the first launch, the event
    records) cancel in the difference. A chain that cannot be captured
    (one that replays a graph of its own, as a ``Trainer`` call of several
    steps does) is run eagerly only when the caller passes
    ``capture=False``; a capture that fails raises. On the CPU the block
    runs eagerly and each span is timed with ``time.perf_counter()``."""
    state = carry.clone()

    def block(_inputs=None):
        c = state
        for _ in range(iters):
            c = chain_fn(c)
        state.copy_(c)
        return state

    on_card = state.is_cuda
    run = block
    if on_card and capture:
        from cron_operator_tpu_torch.parallel.overlap import StepGraph

        graph = StepGraph(block, generators=generators)

        def run():
            return graph({})

    run()  # the build, the warm-up and (on the card) the capture

    def spanned(k: int) -> float:
        best = float("inf")
        for _ in range(3):
            state.copy_(carry)
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(k):
                    run()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                for _ in range(k):
                    run()
                best = min(best, time.perf_counter() - t0)
        return best

    # The calibration is a two-span difference too: a raw span / k carries
    # the constant costs and would size k too small.
    per_block = max(spanned(2) - spanned(1), 1e-6)
    k = max(1, min(256, int(span_s / per_block)))
    t_k = spanned(k)
    out = state.clone()
    t_2k = spanned(2 * k)
    diff = t_2k - t_k
    if diff <= 0:  # interference beat the differencing: no number
        return None, out
    return diff / (k * iters), out


def event_ms(torch, fn, iters: int, reps: int = 5, warmup: int = 3,
             held: bool = False) -> List[float]:
    """The mean CUDA-event time of ``iters`` back-to-back calls of ``fn``,
    ``reps`` times, after ``warmup`` calls. With ``held`` the calls are
    enqueued while the card is held busy (``torch.cuda._sleep``, twice the
    host's enqueue time of ``iters`` calls), so that the kernels run back
    to back and the events see the card's time alone; ``fn`` must then not
    synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    hold_cycles = 0
    if held:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        hold_cycles = int(2 * host_s * 2e9) + 1_000_000  # SM clock <= 2 GHz
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if held:
            torch.cuda._sleep(hold_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def median_ms(torch, fn, iters: int, reps: int = 5, warmup: int = 3) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    from CUDA events."""
    return statistics.median(event_ms(torch, fn, iters, reps, warmup))


def device_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn``: the median over ``reps`` of the CUDA-
    event time of ``iters`` back-to-back calls, enqueued while the card is
    held busy (``torch.cuda._sleep``, twice the host's enqueue time), so
    that the kernels run back to back and the host's time between launches
    is not counted. ``fn`` must not synchronise."""
    return statistics.median(event_ms(torch, fn, iters, reps, held=True))


def attention_inputs(b: int, s: int, h: int, d: int, device,
                     seed: int = 0) -> Tuple[torch.Tensor, ...]:
    """The microbench's q, k and v: bf16 ``[b, s, h, d]`` standard normals
    from a ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(b, s, h, d, generator=gen, device=device,
                             dtype=torch.bfloat16) for _ in range(3))


def attention_chain(k, v, causal: bool, impl: str):
    """c -> ``multi_head_attention(c, k, v)``: the output has q's shape, so
    it is the next q."""
    from cron_operator_tpu_torch.ops.attention import multi_head_attention

    def chain(c):
        return multi_head_attention(c, k, v, causal=causal, impl=impl)
    return chain


def attention_grad_chain(k, v, causal: bool, impl: str):
    """c -> dq + (sum dk + sum dv) 1e-20 in dq's dtype, the gradients of
    sum(f32(out)^2) with respect to (q, k, v) at q = c: the JAX
    microbench's ``chain_all_grads``. The dK/dV term keeps K3's work a
    part of the chain."""
    from cron_operator_tpu_torch.ops.attention import multi_head_attention

    def chain(c):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (c, k, v)]
            out = multi_head_attention(*leaves, causal=causal, impl=impl)
            dq, dk, dv = torch.autograd.grad(out.float().pow(2).sum(), leaves)
        return dq + ((dk.sum() + dv.sum()) * 1e-20).to(dq.dtype)
    return chain


def moe_chain(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """c -> the Switch-MoE FFN's output at c, its products in ``x``'s
    dtype (``moe_ffn(params, c, compute_dtype=x.dtype)[0]``)."""
    from cron_operator_tpu_torch.parallel.moe import moe_ffn

    def chain(c):
        return moe_ffn(params, c, compute_dtype=x.dtype)[0]
    return chain


def moe_grad_chain(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """c -> dL/dc + (the sum of every parameter gradient's sum) 1e-20, in
    ``x``'s dtype, with L = sum(f32(y)^2) + aux of the FFN at c: the JAX
    microbench's MoE chain. The parameter term keeps their gradients a
    part of the chain."""
    from cron_operator_tpu_torch.parallel.moe import moe_ffn

    def chain(c):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_() for p in params.values()]
            xc = c.detach().requires_grad_()
            y, aux = moe_ffn(dict(zip(params, leaves)), xc,
                             compute_dtype=x.dtype)
            *gp, gx = torch.autograd.grad(
                y.float().pow(2).sum() + aux, [*leaves, xc])
        live = sum(g.sum() for g in gp)
        return (gx + live * 1e-20).to(x.dtype)
    return chain


def release(device: torch.device) -> None:
    """Returns to the card the memory of a finished leg's graph and
    tensors (the collector first, for what a cycle holds)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    params = _parse(sys.argv[1:] if argv is None else argv)
    import importlib

    from cron_operator_tpu_torch.ops.attention import (
        multi_head_attention,
        reference_attention,
    )
    from cron_operator_tpu_torch.parallel.moe import init_moe_params
    from cron_operator_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(params.get("platform"))
    except RuntimeError as exc:
        print(f"microbench: {exc}", file=sys.stderr)
        return 1
    # the module, not the function of the same name that ops/__init__ exports
    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")

    b = int(params.get("batch", 8))
    s = int(params.get("seq", 512))
    h = int(params.get("heads", 8))
    d = int(params.get("head_dim", 64))
    iters = int(params.get("iters", 20))
    causal = params.get("causal", "1") in ("1", "true")
    span_s = float(params.get("span_s", 0.5))
    on_card = device.type == "cuda"

    q, k, v = attention_inputs(b, s, h, d, device)

    def chain(chain_fn, carry):
        t, _ = timed_chain(chain_fn, carry, iters=iters, span_s=span_s)
        release(device)
        return t

    designs = dict(fa.flash_attention.launches_by_design)
    flash_t = chain(attention_chain(k, v, causal, "flash"), q)
    ran = [x for x, n in fa.flash_attention.launches_by_design.items()
           if n > designs[x]]
    xla_t = chain(attention_chain(k, v, causal, "xla"), q)
    flash_out = multi_head_attention(q, k, v, causal=causal, impl="flash")
    flash_bwd_t = chain(attention_grad_chain(k, v, causal, "flash"), q)
    xla_bwd_t = chain(attention_grad_chain(k, v, causal, "xla"), q)
    ref = reference_attention(q.float(), k.float(), v.float(), causal=causal)
    max_err = float((flash_out.float() - ref).abs().max())
    del ref, flash_out
    release(device)

    # MoE dispatch throughput: the dense-dispatch products of one device's
    # share of a GPT-base MoE layer, forward and gradient.
    moe = None
    if params.get("moe", "1") in ("1", "true"):
        d_model = int(params.get("moe_d_model", 512))
        tokens = int(params.get("moe_tokens", 4096))
        n_exp = int(params.get("moe_experts", 8))
        mp = init_moe_params(
            torch.Generator(device=device).manual_seed(1), d_model=d_model,
            d_ff=4 * d_model, n_experts=n_exp,
        )
        x = torch.randn(tokens, d_model, device=device, dtype=torch.bfloat16,
                        generator=torch.Generator(device=device).manual_seed(2))
        moe = {
            "tokens": tokens, "d_model": d_model, "experts": n_exp,
            "fwd_ms": _ms(chain(moe_chain(mp, x), x)),
            "grad_ms": _ms(chain(moe_grad_chain(mp, x), x)),
        }

    print(json.dumps({
        "backend": "gpu" if on_card else "cpu",
        "flash_mode": "/".join(ran) if on_card else "plain",
        "timing": (
            ("one CUDA graph of an iters chain replayed k and 2k times a "
             "span, CUDA events" if on_card else
             "an eager iters chain run k and 2k times a span, "
             "perf_counter") +
            "; (t_2k - t_k)/(k*iters), best-of-3 spans, k sized for "
            f"~{span_s}s; null = noise beat the differencing"
        ),
        "shape": [b, s, h, d],
        "causal": causal,
        "flash_ms": _ms(flash_t),
        "xla_ms": _ms(xla_t),
        "speedup_flash_over_xla": _ratio(xla_t, flash_t),
        "flash_grad_ms": _ms(flash_bwd_t),
        "xla_grad_ms": _ms(xla_bwd_t),
        "speedup_flash_grad_over_xla": _ratio(xla_bwd_t, flash_bwd_t),
        "flash_max_abs_err_vs_f32_ref": round(max_err, 5),
        "moe": moe,
    }), flush=True)
    return 0


def _ms(t):
    return round(t * 1e3, 4) if t is not None else None


def _ratio(num, den):
    return round(num / den, 3) if num and den else None


if __name__ == "__main__":
    sys.exit(main())
