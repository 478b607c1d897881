#!/usr/bin/env python3
"""Step-speed benchmark of the PyTorch port's training executor, the
counterpart of ``hack/step_bench.py``.

It measures what the default mode buys on real ``Trainer`` runs, and gates
it:

- ``external_ab``, the gate: the same MLP(64) run on host MNIST batches two
  ways. **A** is the seed synchronous path (``steps_per_call=1``,
  ``stage_async=False``: one eager step a call, each batch staged inline);
  **B** is the default mode (``steps_per_call="auto"``: calls of 8 steps,
  on the card one captured step graph replayed, batches staged by a
  background thread). OK iff B's samples/s are at least ``--min-speedup``
  times A's and the final parameters of a fresh A/B pair trained on the
  same stream are equal to the bit.
- ``fused_vs_external``: fused data (each step draws its batch inside the
  step) against B's external staged batches.
- ``chain_floor``: the fused step through ``ops.microbench.timed_chain``
  (a ``Trainer`` call of 8 steps, span-differenced): the device's floor a
  step; ``overlap_headroom_ms`` is A's step less it.
- ``transformer``: BERT-tiny MLM (seq 128, batch 4, fused data) with
  ``attention=flash`` (K1-K3 on the card) against ``xla`` (the port's
  plain attention) through the whole train step. ``flash_mode`` says which
  kernel design ran, or ``plain`` on the CPU.

Writes ``BENCH_STEP_TORCH.json`` (``--out``). ``--check`` is the smoke:
small sizes, no transformer leg, and it fails unless the A/B parameters
are equal to the bit and staging hid host time (B's wait for a staged
chunk below the same chunked path's inline staging). ``--emit-matrix-seed
PATH`` also writes the measured rates as a fleet ``ThroughputMatrix`` seed
sidecar (``{"alpha": ..., "rates": {"<class>/<slice>": rate}}``), the
format ``hack/step_bench.py`` writes.

Run on a machine with a CUDA card: ``python3 hack/torch_step_bench.py
--stdout``. Without a card it exits non-zero unless ``--platform cpu`` is
given.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "hack"))


def _r(x, nd=3):
    return None if x is None else round(x, nd)


def write_matrix_seed(path, slice_type, rates_by_class):
    """Write measured rates as a fleet ``ThroughputMatrix`` seed sidecar:
    ``rates`` keyed ``"<workload-class>/<slice-type>"`` (``"*"`` is the
    scorer's any-class row), as ``hack/step_bench.py`` writes it; falsy
    rates are dropped. Returns the rates written."""
    rates = {
        f"{wclass}/{slice_type}": round(float(rate), 1)
        for wclass, rate in rates_by_class.items() if rate
    }
    doc = {"alpha": 0.3, "rates": rates, "source": "hack/torch_step_bench.py"}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return rates


def _measure_run(make_trainer, make_batches, warm, steps, batch):
    """Wall clock of a Trainer over ``steps`` steady-state steps (the
    build, the warm-up and the capture are left out by a first ``run`` of
    ``warm`` steps on the same trainer; ``run``'s target is cumulative).
    Returns (samples_per_s, per_step_ms, host_wait_ms), host_wait_ms the
    mean per-step ``data_s``: the inline staging on the synchronous path,
    the wait for the stager on the staged one."""
    tr = make_trainer()
    it = make_batches()
    waits = []
    tr.run(it, warm)
    t0 = time.perf_counter()
    tr.run(it, warm + steps, on_step=lambda s: waits.append(s.data_s))
    dt = time.perf_counter() - t0
    host_wait = sum(waits) / len(waits) if waits else 0.0
    return batch * steps / dt, dt / steps * 1e3, host_wait * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="JSON artifact path (default BENCH_STEP_TORCH.json; "
                         "never written in --check unless given)")
    ap.add_argument("--stdout", action="store_true",
                    help="print the JSON to stdout too")
    ap.add_argument("--check", action="store_true",
                    help="smoke: small sizes, no transformer leg; fails on a "
                         "parity break or zero overlap")
    ap.add_argument("--steps", type=int, default=None,
                    help="timed steady-state steps per side")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--min-speedup", type=float, default=1.3,
                    help="external_ab gate: B over A samples/s")
    ap.add_argument("--emit-matrix-seed", default=None, metavar="PATH",
                    help="write measured rates as a fleet ThroughputMatrix "
                         "seed sidecar")
    ap.add_argument("--skip-transformer", action="store_true")
    ap.add_argument("--platform", default=None,
                    help="cpu to run without a card (tests)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from cron_operator_tpu_torch.models import MLP, Bert, BertConfig
    from cron_operator_tpu_torch.ops.microbench import timed_chain
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import (
        AUTO_STEPS_PER_CALL,
        TrainConfig,
        Trainer,
    )
    from torch_mfu_probe import device_for, trainer_call

    device = device_for(args.platform)
    if device is None:
        return 1
    on_card = device.type == "cuda"
    backend = "gpu" if on_card else "cpu"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"

    # Warm-up and timed steps are multiples of the auto chunk: the warm run
    # must build and capture what the timed segment replays.
    chunk = AUTO_STEPS_PER_CALL
    steps = args.steps or (48 if args.check else 96)
    steps = max(chunk, (steps // chunk) * chunk)
    warm = 2 * chunk
    batch = args.batch

    init = MLP((64,), device=device).init_weights(
        torch.Generator(device=device).manual_seed(0))

    def trainer(**cfg_kw):
        # every trainer starts from the same weights: A and B must, for
        # their parity to mean anything
        return Trainer(copy.deepcopy(init),
                       TrainConfig(optimizer="sgd", **cfg_kw))

    cfg_a = dict(steps_per_call=1, stage_async=False)  # seed sync path
    cfg_b = dict(steps_per_call="auto", stage_async=True)  # default mode

    # --- external_ab: the gate -------------------------------------------
    a_rate, a_ms, a_wait = _measure_run(
        lambda: trainer(**cfg_a), lambda: data.mnist_batches(batch, seed=5),
        warm, steps, batch)
    b_rate, b_ms, b_wait = _measure_run(
        lambda: trainer(**cfg_b), lambda: data.mnist_batches(batch, seed=5),
        warm, steps, batch)
    speedup = b_rate / a_rate if a_rate else None
    # The same chunked path with inline staging pays the whole batch build
    # and placement on the step's path; the staged wait must sit below it.
    _, _, bs_wait = _measure_run(
        lambda: trainer(steps_per_call="auto", stage_async=False),
        lambda: data.mnist_batches(batch, seed=5), warm, steps, batch)
    overlap_ms = bs_wait - b_wait

    # Bit-exact parity: a fresh pair on one stream, a step count with a
    # tail that is not a whole chunk.
    psteps = 13
    tr_a, tr_b = trainer(**cfg_a), trainer(**cfg_b)
    tr_a.run(data.mnist_batches(batch, seed=9), psteps)
    tr_b.run(data.mnist_batches(batch, seed=9), psteps)
    parity = all(torch.equal(x, y) for x, y in zip(
        tr_a.model.state_dict().values(), tr_b.model.state_dict().values()))

    external_ab = {
        "model": "mlp(64) mnist", "batch": batch, "steps": steps,
        "a_samples_per_s": _r(a_rate, 1), "b_samples_per_s": _r(b_rate, 1),
        "a_step_ms": _r(a_ms), "b_step_ms": _r(b_ms),
        "a_host_wait_ms": _r(a_wait), "b_host_wait_ms": _r(b_wait),
        "b_sync_stage_wait_ms": _r(bs_wait),
        "overlap_hidden_ms_per_step": _r(overlap_ms),
        "auto_steps_per_call": tr_b.resolved_steps_per_call,
        "speedup_b_over_a": _r(speedup),
        "min_speedup": args.min_speedup,
        "params_bit_exact": parity,
        "ok": bool(parity and speedup and speedup >= args.min_speedup),
    }
    del tr_a, tr_b

    # --- fused_vs_external -----------------------------------------------
    def fused_trainer():
        return Trainer(copy.deepcopy(init),
                       TrainConfig(optimizer="sgd", steps_per_call=chunk),
                       sample_fn=data.mnist_sample(batch))

    f_rate, f_ms, _ = _measure_run(fused_trainer, lambda: itertools.repeat({}),
                                   warm, steps, batch)
    fused_vs_external = {
        "fused_samples_per_s": _r(f_rate, 1), "fused_step_ms": _r(f_ms),
        "external_b_samples_per_s": _r(b_rate, 1),
        "external_over_fused": _r(b_rate / f_rate) if f_rate else None,
    }

    # --- chain_floor: the fused step through timed_chain ------------------
    floor_t, _ = timed_chain(
        trainer_call(fused_trainer(), [{}] * chunk),
        torch.zeros((), device=device), iters=1,
        span_s=0.05 if args.check else 0.5, capture=False)
    floor_ms = floor_t / chunk * 1e3 if floor_t else None
    chain_floor = {
        "floor_step_ms": _r(floor_ms),
        "overlap_headroom_ms": _r(a_ms - floor_ms if floor_ms else None),
    }

    # --- transformer: flash against xla through the whole step ------------
    transformer = None
    if not (args.check or args.skip_transformer):
        import importlib

        fa = importlib.import_module(
            "cron_operator_tpu_torch.ops.flash_attention")
        # seq 128: the kernels' block; a shorter sequence takes no kernel
        tseq, tbatch, tsteps, twarm = 128, 4, 12, 4

        def bert_rate(impl):
            cfg = BertConfig.tiny(max_len=tseq, attention_impl=impl)
            model = Bert(cfg, device=device).init_weights(
                torch.Generator(device=device).manual_seed(0))
            tr = Trainer(
                model, TrainConfig(optimizer="sgd", seq_dim_in_batch=1,
                                   labels_follow_seq=True, steps_per_call=4),
                sample_fn=data.token_sample(tbatch, tseq, cfg.vocab_size))
            it = itertools.repeat({})
            tr.run(it, twarm)
            t0 = time.perf_counter()
            tr.run(it, twarm + tsteps)
            return tbatch * tseq * tsteps / (time.perf_counter() - t0)

        xla_tps = bert_rate("xla")
        before = dict(fa.flash_attention.launches_by_design)
        flash_tps = bert_rate("flash")
        ran = [x for x, n in fa.flash_attention.launches_by_design.items()
               if n > before[x]]
        transformer = {
            "model": "bert-tiny mlm", "seq": tseq, "batch": tbatch,
            "flash_mode": "/".join(ran) if on_card else "plain",
            "xla_tokens_per_s": _r(xla_tps, 1),
            "flash_tokens_per_s": _r(flash_tps, 1),
            "flash_over_xla": _r(flash_tps / xla_tps),
        }

    verdict = "OK" if external_ab["ok"] else "REGRESSION"
    report = {
        "backend": backend, "device_kind": kind, "slice_type": backend,
        "mode": "check" if args.check else "full",
        "timing": "steady-state Trainer wall clock, build, warm-up and "
                  "capture excluded; chain floor via "
                  "ops.microbench.timed_chain",
        "external_ab": external_ab,
        "fused_vs_external": fused_vs_external,
        "chain_floor": chain_floor,
        "transformer": transformer,
        "verdict": verdict,
    }
    if args.emit_matrix_seed:
        # train-small rides the measured MLP rate (and seeds the "*" row),
        # train-large the transformer's tokens/s when the run measured it
        by_class = {"train-small": b_rate, "*": b_rate}
        if transformer and transformer.get("xla_tokens_per_s"):
            by_class["train-large"] = transformer["xla_tokens_per_s"]
        report["matrix_seed_rates"] = write_matrix_seed(
            args.emit_matrix_seed, backend, by_class)
        report["matrix_seed"] = args.emit_matrix_seed

    out_path = args.out or (None if args.check else "BENCH_STEP_TORCH.json")
    if out_path and out_path != "/dev/null":
        tmp = out_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        os.replace(tmp, out_path)
    if args.stdout or not out_path:
        print(json.dumps(report), flush=True)

    if args.check:
        # The math must be identical and the overlap real; the speedup gate
        # stays a full-run claim, which a loaded host must not flake.
        if not parity:
            print("check failed: the chunked run's parameters differ from "
                  "the per-step run's", file=sys.stderr)
            return 1
        if overlap_ms <= 0:
            print(f"check failed: staging hid no host time (inline "
                  f"{bs_wait:.3f} ms <= staged {b_wait:.3f} ms)",
                  file=sys.stderr)
            return 1
        return 0
    return 0 if verdict == "OK" else 1


if __name__ == "__main__":
    sys.exit(main())
