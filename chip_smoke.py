#!/usr/bin/env python3
"""Proof that the PyTorch port runs on an NVIDIA card, end to end.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. Device: the card's name and power limit; build every kernel of the port
   from ``cron_operator_tpu_torch/ops/csrc`` (nvcc, sm_90a, one process per
   source, all started together).
2. Kernels against their plain versions on the card: the flash-attention
   forward (K1) against ``flash_attention_reference``, and the backward
   pair K2 (dQ) and K3 (dK, dV) against ``flash_attention_bwd_reference``,
   over bf16/f32, causal or not, head_dim 64/128 (plus 32 and 256 for the
   backward), GQA groups 1/2/4, seq 128/512/2048, and at b 1 the lengths
   no tile divides, ``RAGGED_SEQS`` (1 to 1000, ViT-B/16's 197 among
   them), so over both kernel designs (``sm90`` for bf16 at d 64/128,
   ``fma`` for the rest), within
   the bounds of ``forward_tolerance``, ``dq_tolerance`` and
   ``dkv_tolerance``; a second
   backward run must be bit-identical, and the backward's peak memory must
   grow about linearly from seq 2048 to 8192.
3. The serving slice at GPT-2 small width: ``generate_job`` through a job
   context (its prefill and decode steps replay captured CUDA graphs), with every
   kernel count set to 0 just before and read just after (every K1 launch
   must be of the sm90 design, and the decode kernel must launch 12 times
   in each of the 3 x 63 decode steps); then prefill logits through the
   kernel against the plain-attention path on the same weights and
   prompt.
4. Serving times: K1 per launch at the slice's shape (device time of
   back-to-back launches with the card held busy while the host enqueues
   them; plain CUDA-event time beside it), beside its bound, the plain
   version and
   ``F.scaled_dot_product_attention`` (a yardstick only: the port never
   calls it); the slice's prefill, eager decode step and tokens/s (CUDA
   events, medians); then generation through the prefill and decode
   graphs against the eager loop: greedy tokens identical; the replayed
   prefill against an eager one (KV cache, position and first token to
   the bit; K1 12 and the LayerNorm forward 25 launches, 24 folded, a
   replay) and its ms beside the eager prefill and the 6.870 ms before it
   was captured; decode ms a step (the graphed round less the graphed
   prefill; beside the 2.895 ms it took before the decode kernel and
   1.130 on its three-pass design), the first round's ms, device ms of a
   replayed step, busy share and tokens/s of each; the decode kernel
   launched 12 times a decode step in both; an eager decode step copies,
   casts or pads no tensor of a layer's cache size or more (neither the
   KV cache nor the vocab table); a replayed step profiled, with the
   decode kernel's one cluster launch once a layer (all launches on its
   cluster design), 25 LayerNorm launches and no residual add of its own.
5. The training slice at GPT-2 small width: ``gpt`` through a job context
   (b 8, s 1024, 10 steps in the default mode: ``steps_per_call`` 8, one
   captured step replayed), every kernel count set to 0 just before and
   read just after (K1, K2 and K3 all sm90, 120 each through the replay
   accounting; the loss kernels of ``ops/csrc/xent.cu`` once a step each,
   10 and 10); then three steps on the kernel path (flash attention and
   the loss kernels) against the plain path (plain attention, the former
   f32 loss) from the same f32 weights, both measured against an f32 run.
   The LayerNorm kernels (``ops/csrc/layer_norm.cu``) launch 25 times a
   step each way here (24 of them folded with the residual add before the
   norm), as on every GPT, BERT and ViT training path
   (phases 7, 8, 9 and 13), and 25 times a prefill and a decode step on
   the serving paths (phases 3, 11 and 14); phases 15, 16 and 18 record
   theirs as they come.
6. Training times: K1, K2 and K3 per launch at the slice's shape (device
   time, event time beside it) beside their bounds, their plain versions
   and the SDPA yardsticks (SDPA's backward alone for K2 and K3); then the
   step as one replayed graph of 8 steps (``step(..., chunk=8)``) against
   the eager step in this process: 8 eager steps and one graphed call
   from the same weights and data must leave the same loss and the same
   parameter bits; the step ms, tokens/s, MFU and device busy share of
   each (the graphed step beside the 41.805 ms before the vocab GEMMs
   were padded); profiles of an eager step and a graphed call, in which
   cuBLAS GEMMs for 1- or 2-element aligned rows may take under 1% of the
   device time (``UNALIGNED_GEMM``: the unpadded vocab GEMMs took 37%), and
   the graphed call's shares of the loss kernels, log-softmax, LayerNorm's
   kernels and copies and casts (``LM_SHARES``). The trainers of phases
   6, 7 and 13 are wired as the jobs wire them (``lm_wiring``).
7. BERT-base through ``bert`` (b 8, s 512, 10 steps): K1, K2 and K3 each
   launched 120 times, all sm90, non-causal, the loss kernels 10 each;
   three steps on the kernel
   path against the plain path and f32, as phase 5; K1-K3 at BERT's shape
   beside their bounds, plain versions and SDPA (``is_causal=False``); the
   graph against the eager step, as phase 6 (beside 15.496 ms).
8. ResNet-50 (``resnet50``: b 128, image 224, SGD), ViT-B/16 (``vit``:
   b 64, image 224) and the MLP (``mnist``) at their defaults, each with
   its parameter count; ViT's K1, K2 and K3 launched 12 times a step each
   at its 197 tokens, all sm90 (120 over its 10 steps), and its
   ``xla_flops_per_step`` within 1% of this script's count, the others no
   flash launch; ResNet-50's GroupNorm kernels
   launched 53 times a step each, forward and backward (530 over its 10
   steps, a replay counted once; ViT's 0), every forward launch on
   ``forward_plan``'s design and every backward on the cluster design, the
   forward's epilogues 33 relu, 16 residual then relu and 4 none a step
   and the backward's 33 relu masks (``RESNET50_EPILOGUES``), counts set
   to 0 just before the job and read just after; for ResNet-50 and ViT the
   graph against the eager step as phase 6, with model FLOPs per step from
   ``FlopCounterMode`` (plus ViT's attention, which runs inside the
   kernels, by formula), and for ResNet-50 the graphed call's device time
   in the relus' forward and backward and the adds (``RESNET50_SHARES``),
   for ViT that of the attention kernels, f32 GEMMs and copies
   (``VIT_SHARES``). Then K1-K3 at ViT's attention shape (b 64, s 197, h
   12, d 64, not causal) against their plain versions, timed beside their
   bounds (the work at s, not at the padded tiles), the plain versions and
   SDPA; and ViT's graphed step on the kernels, with the plain f32 body
   (the attention ViT ran before) and with a plain body of bf16 products
   swapped in, in turns, with each path's peak memory, beside
   ``VIT_PLAIN_BEFORE``.
9. The one-card job contract at GPT-2 small width (b 8, s 1024, bf16 over
   f32 parameters, AdamW, fused data): 12 steps in calls of 4 against 8
   steps saved every 4 and a fresh model and trainer that restore step 8
   and train to 12; steps 9-12's losses, every parameter and the
   optimizer state equal to the bit, K1, K2 and K3 launched 48 times each
   on the resumed run, all sm90, and the loss kernels 4 each (the model
   and loss wired as the job wires them), counts set to 0 just before it
   and read just after; the save stall, the restore time and the bytes a
   checkpoint takes.
10. The port runner as a subprocess on the card: ``gpt checkpoint=1
    save_every=4 steps=16 step_delay_s=0.2`` in a temporary
    ``checkpoint_dir``, SIGTERM once a progress frame shows 4 steps done
    (exit 0, a ``done`` frame with ``cancelled: true``), then the same
    command to its end (resumed from the last step saved, 16 steps, exit
    0, the JAX runner's frame types).
11. ``generate_job checkpoint_from=`` that lineage (b 8, prompt 512, 64
    new tokens, 2 rounds): ``restored_from_step`` reported, K1 launched 12
    times in each round's prefill (the second a replay, counted through
    its capture's tally) and the decode kernel 12 times in each
    decode step, greedy tokens equal to those of a GPT built in this
    process from the checkpoint's f32 parameters (eager decode).
12. ``gpt mfu=1 flops_accounting=1`` (24 steps): the published ``mfu``
    within 3% of this script's own MFU over the job's step time, and
    ``xla_flops_per_step`` within 1% of this script's FLOPs (6 N T plus
    the attention's 12 d per kept pair); ``gpt profile_dir=`` leaves a
    ``torch.profiler`` trace that names the sm90 K1 kernel.
13. Switch-MoE training: ``gpt moe_every=2 num_experts=8`` (the shipped
    GPT Cron's MoE params) at GPT-2 small width, b 8, s 1024, 10 steps in
    the default mode, 322,634,496 parameters: K1, K2 and K3 each launched
    120 times, all sm90, the loss kernels 10 each, counts set to 0 just
    before and read just after;
    three steps on the kernel path against the plain path and f32, as
    phase 5, with the tokens whose expert differs between the paths
    counted; the replayed graph against 8 eager steps (loss and parameter
    bits equal), step ms, device ms, busy share, tokens/s, MFU over the
    counted FLOPs (``Trainer.flops_per_step``) and over the active
    parameters' 6 N T, peak memory, and profiles; the graphed step beside
    69.017 ms, unaligned GEMMs under 1% of the graphed call's device time
    as in phase 6, and no cumsum over an outer axis (``OUTER_SCAN``). Then
    one MoE layer at the step's shape on the index path (dispatch and
    combine gathered by token index) against the dense one-hot
    formulation (``moe_ffn_reference``): output, dX through the dispatch
    and the experts' gradients the same bits, the router's gradient within
    ``MOE_ROUTER_GRAD_REL``, reruns identical; dispatch and combine timed
    on each path; and the graphed step with each path in turns (the dense
    one swapped in, ``dense_moe``), step ms and peak memory beside
    ``MOE_ONEHOT``.
14. Switch-MoE serving: ``generate_job`` with the same MoE params at the
    serving slice's shape (K1 36 launches over 3 rounds, all sm90, the
    decode kernel 12 a decode step); the prefill and decode graphs against
    the eager loop as phase 4 (beside 3.442 ms a decode step; the graphed
    prefill beside the eager 13.656-21.181 ms before it was captured),
    eager prefill ms on the index and the dense path in turns, greedy
    tokens equal on both, and
    tokens/s; then the cached greedy decode against
    a full-forward rerun for 8 tokens at full width with
    ``moe_capacity_factor=8`` (no token dropped on either path), in f32.
15. The device mesh on one card: the script starts itself twice
    (``--mesh-rank``) as two ranks of a gloo group on ``cuda:0`` (NCCL
    refuses two ranks on one device); each calls ``gpt`` at GPT-2 small
    widths (b 8 x 1024 global, AdamW, ``data=host``, 3 steps) under a
    strategy of ``MESH_STRATEGIES`` not in ``MESH_LEFT_OUT``: ``devices=2``
    (rows split, DDP), ``tensor=2`` (every rank the whole batch, its 6
    heads and its half of the FFN, the Megatron split; DDP over a batch
    group of one rank) and, with ``moe_every=2 num_experts=8``,
    ``expert=2`` (every rank the whole batch, the router and every dense
    weight whole, its 4 of the 8 experts' ``wi`` and ``wo`` in each MoE
    block, the experts' outputs gathered over the pair; DDP over a batch
    group of one rank), all the plain path (``MESH_PATHS``, checked),
    eager over gloo with plain ``torch.distributed`` calls (FSDP2 over
    gloo on CUDA tensors is untried). Each rank's K1, K2 and K3 must
    launch 36 times, all sm90, at the strategy's local (batch, heads): (4,
    12) under data, (8, 6) under tensor, (8, 12) under expert; the loss
    kernels 3 times each and the LayerNorm kernels 75 times each way (72
    folded), as one card's; counts set to 0 just before the job and read
    just after; both
    ranks report the same losses; against a one-rank run of the same
    batches and model (a process of its own) the per-step loss gap stays
    within ``MESH_LOSS_BOUND`` and the update distance (the parameters'
    change over the run, gathered whole) within ``MESH_UPDATE_BOUND``, and
    a one-rank run at lr 0 (dense, and with the MoE blocks) must fall
    outside both; K1-K3 are timed at the
    local shape; the step ms is printed as two ranks time-sharing the
    card, not as scaling. ``hack/torch_mesh_cards.py`` runs the same ranks
    and checks over NCCL, one rank a card.
16. Sequence and pipeline parallelism on one card, two ranks of a gloo
    group on ``cuda:0`` as in phase 15: ``gpt attention=ring seq=2``
    (GPT-2 small, b 8 x 1024 global, each rank ``[8, 512]``, causal) and
    ``bert attention=ulysses seq=2`` (BERT-base, b 8 x 512), AdamW,
    ``data=host``, 3 steps, each held by phase 15's checks
    (``MESH_LOSS_BOUND``, ``MESH_UPDATE_BOUND``, and a one-rank run at lr
    0 outside both) against a one-rank ``attention=flash`` run of the same
    batches (K1-K3 over the whole sequence: the arithmetic that the bodies
    run on their blocks, so the check isolates the split), with the gap to
    a one-rank ``attention=xla`` run (the plain f32 attention) printed
    beside; both ranks report the same losses. The bodies run K1, K2 and
    K3 (``flash_attention_block``), all sm90, once per computed block in
    each step and layer (``seq_launches``; counts set to 0 just before the
    job and read just after, by mask): the ring's rank 0 36 causal, rank 1
    36 causal and 36 full; Ulysses 36 full on each rank. The loss kernels
    (a ``seq`` mesh keeps the former f32 loss) launch 0 times. Printed for
    each: the step ms (time-shared), the device ms of one layer's attention
    body on each rank (forward and backward, ``profile_window`` at the
    rank's local shape; split into K1-K3, memory copies, NCCL's kernels and
    the rest) and the share of a profiled step's device time that the
    model's 12 bodies take, and peak memory a rank. On the ring's ranks, the GPT
    Cron's per-rank block (``CRON_RING_BLOCK``, ``[4, 2048, 12, 64]`` bf16,
    causal) over the ring of 2: forward and backward device ms and peak
    memory a rank through the kernels and through
    ``ring_attention_local_reference`` (the plain f32 body), the kernels'
    output and gradients within ``body_tolerances`` of K1-K3 over the
    whole sequence, finite, and a rerun's bits equal. K1-K3 are timed at
    the ring's diagonal block and Ulysses' local heads. Then
    ``spmd_pipeline`` over the two ranks
    as pipe 2: each stage one port ``DecoderLayer`` at GPT-2 small width
    (bf16 products over f32 parameters placed by
    ``pipeline_param_sharding``), x ``[8, 1024, 768]`` in 4 microbatches:
    the output and the gradients of x and of each rank's stage against
    the two layers run in sequence on the rank, within ``PIPE_REL_BOUND``
    (relative L2; the other layer's gradients must fall outside it), and
    K1-K3 launched ``pipe_ticks(2)`` times each a rank, all sm90. The ring's
    K/V hops and the pipeline's activation hops cross the gloo group
    through pinned host buffers (``parallel.ring._hop_through_host``:
    gloo's send and receive take host memory only).
17. The microbench (``ops/microbench.py``, the port's timing primitive)
    at ``bench.py``'s attention shape (b 4, s 2048, h 8, d 64, causal,
    bf16; the MoE leg at its defaults), its ``main`` called in this
    process with every kernel count set to 0 just before and read just
    after: K1, K2 and K3 must all launch, all sm90; its JSON line printed;
    no timing may read ``null``; K1 on the microbench's own inputs within
    ``forward_tolerance``, and the line's ``flash_max_abs_err_vs_f32_ref``
    within the largest bound; K1-K3 at that shape against their plain
    versions, timed (``attention_rows``); and ``flash_ms`` (a CUDA graph
    of 20 K1 calls, by ``timed_chain``) within ``MICROBENCH_AGREE`` of
    K1's ``device_ms``.
18. The meshed step captured over NCCL: the script starts itself once
    (``--mesh-rank``) as the one rank of an NCCL process group on
    ``cuda:0`` (asynchronous error handling off), which calls ``gpt`` at
    GPT-2 small widths (b 8 x 1024, AdamW, ``data=host``) over a one-rank
    mesh: the plain data-parallel path (``DistributedDataParallel``), 24
    steps in calls of 8, the first ``MESH_GRAPH_WARMUP`` eager and every
    later one a replay of the step captured with its collectives; K1, K2
    and K3 must launch 288 times each, all sm90, and the loss kernels 24
    each (counts set to 0 just
    before the job and read just after, a replay counted once); the same
    job in calls of one step (every step eager) must leave the same losses
    and the same parameter bits; a profiled replayed call must show an
    NCCL kernel; its step ms (a replayed call, CUDA events) is printed
    beside phase 6's unwrapped graphed step.
19. The decode kernel (``ops/csrc/decode_attn.cu``), its cluster design
    (the main path) and its three-pass design, against its plain version
    ``decode_attention_reference`` at GPT-2 small's decode shape (q ``[8,
    1, 12, 64]``, caches ``[8, 1024, 12, 64]`` bf16) at cache positions 0,
    511, 575 and 1023, a GQA case of group 2 and an f32 case, within
    ``decode_tolerance``; two runs bit-identical; NaN and inf past the
    position giving the output of a cache zeroed there; the plan and its
    cluster occupancy; both designs' device time at position 575 beside
    the bound (the K and V bytes up to the position over 3.35 TB/s), the
    plain version and SDPA with a boolean mask of the written positions (a
    yardstick: the port never calls it).
20. The GroupNorm kernels (``ops/csrc/group_norm.cu``) against their
    plain versions ``group_norm_reference`` and
    ``group_norm_backward_reference`` at each of ResNet-50's 12 norm
    shapes at b 128 (``RESNET50_NORMS``, bf16): y, mean and rstd, then
    dx, dgamma and dbeta, within ``group_norm_tolerance``, two runs
    bit-identical, and both kernels' two-pass designs on the same inputs;
    each shape's forward and backward plans and cluster occupancies; two
    f32 cases; mean-100, std-1 cases in f32, both forward designs, within
    the variance-gap bound of ``tests/test_torch_resnet.py``; an NCHW CUDA
    tensor raising; one GroupNorm forward and backward copying or casting
    no activation-sized tensor. The epilogues at every shape, in both
    designs of each direction: the forward's relu and residual-then-relu
    the same bits as the unfused kernel's y followed by torch's add and
    relu, the backward's relu mask the unfused kernel fed ``dy * (z >
    0)``, reruns identical. Each shape timed forward and backward (each
    direction's cluster and two-pass designs, with the shape's epilogues
    as ResNet-50 runs them and without; device time, the card held busy)
    beside its byte bound (a residual is one unit more), the plain
    version, ``F.group_norm`` and ``native_group_norm_backward`` (the
    yardsticks the port never calls on the card, without epilogue), and
    the sums over the 53 norms; then phase 8's ResNet-50 step (graph and
    eager ms, images/s, MFU) beside 26.181 and 43.327 ms before the fused
    epilogues, 69.747 and 72.098 before the kernels, 27.851 and 46.056 on
    the two-pass backward and 26.984 and 29.969 on the two-pass forward,
    with its GroupNorm launches (phase 8 fails unless every launch is on
    its plan's design and epilogue).
21. The loss kernels (``ops/csrc/xent.cu``, ``xent_fwd`` and
    ``xent_bwd``) against their plain versions
    (``softmax_xent_forward_reference``, ``softmax_xent_backward_reference``)
    at GPT-2 small's logits ``[8192, 50304]`` (vocab 50257) and BERT-base's
    ``[4096, 30528]`` (30522), bf16 and f32, labels 0 and V - 1 among them,
    NaN in the padded columns, and logits offset by +100: each row's loss
    and logsumexp, the mean and the gradient within ``xent_tolerance``,
    the padded columns exact zeros, reruns the same bits; each kernel
    timed at those shapes and at the data mesh's 4096 rows of GPT's vocab
    beside its byte bound, its plain version and ``F.cross_entropy`` on the
    cut bf16 logits (its backward alone for ``xent_bwd``; a yardstick the
    port never calls); the first graphed call of a GPT-2 small and of a
    BERT-base step making no f32 tensor of the logits' size and no cut copy
    of the logits (a dispatch mode over the warm-up, the capture and the
    replays); the gpt,
    bert and MoE gpt graphed steps on the loss kernels and with the former
    loss swapped in, in turns, with their peak memory, beside 30.212,
    14.389 and 35.980 ms (``LOSS_BEFORE_MS``); one LayerNorm forward and
    backward at GPT's and BERT's activations timed on its kernels and on
    the former arithmetic (the difference is what the kernels save), times
    25 a step, beside the step's device ms. The
    loss kernels' launches on the gpt, bert, MoE gpt, resumed, data-mesh
    and NCCL-graph paths (phases 5, 7, 9, 13, 15 and 18) go into the
    kernels line.
22. The LayerNorm kernels (``ops/csrc/layer_norm.cu``, ``layer_norm_fwd``
    and ``layer_norm_bwd``) against their plain versions
    (``layer_norm_reference``, ``layer_norm_backward_reference``) at the
    rows of the main paths (``LN_SHAPES``: GPT's ``[8192, 768]``, BERT's
    ``[4096, 768]``, ViT-B's ``[12608, 768]``, a decode step's ``[8,
    768]``, the pipeline's ``[2048, 768]``) and the tiny widths 128 and
    64, x in bf16 and f32, f32 and bf16 parameters, and rows offset by
    +100, within ``layer_norm_tolerance``, reruns the same bits; the
    folded pair (``layer_norm_add_fwd`` and ``layer_norm_bwd`` given the
    residual stream's gradient) against ``add_layer_norm_reference`` and
    ``add_layer_norm_backward_reference`` at ``LN_FOLD_SHAPES``, s the
    bits of torch's add; each kernel timed beside its byte bound, its
    plain version and the library calls (``F.layer_norm`` on the bf16 x
    with bf16-cast parameters, its backward alone; folded, torch's add and
    then ``F.layer_norm``, and the unfolded kernels after torch's add;
    yardsticks the port never calls); the graphed gpt and bert steps
    folded and with the blocks unfolded (``unfolded_layer_norm``: torch's
    adds, the norms alone), in turns, beside 19.738 and 10.585 ms
    (``LN_BEFORE_MS``); serving on each path in turns (the graphed decode
    step beside 0.662 ms, the graphed prefill, greedy tokens graph against
    eager and folded against unfolded, a replayed step's LayerNorm
    launches and bf16 adds, 24 fewer folded); LayerNorm's share of the
    gpt, bert and vit steps. Their launches on every path, each design
    apart, go into the kernels line.
23. A ``kernels`` JSON line, the card line, and last the result line
    ``{"ok": true, "device": {...}}``. Each phase prints its wall time.
    Every temporary directory is deleted and every subprocess ended.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import io
import itertools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

from cron_operator_tpu_torch.ops.microbench import device_ms, median_ms

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

# The training slice: the gpt entrypoint at its defaults, GPT-2 small,
# 8 sequences of 1024 tokens, bf16 compute over f32 parameters, AdamW.
TRAIN_PARAMS = {"size": "base", "batch_size": "8", "seq_len": "1024",
                "steps": "10"}
TRAIN_SHAPE = dict(b=8, s=1024, h=12, d=64)  # its attention
# BERT-base MLM at the bert entrypoint's defaults: 8 sequences of 512
# tokens, AdamW; its attention is non-causal.
BERT_PARAMS = {"size": "base", "batch_size": "8", "seq_len": "512",
               "steps": "10"}
BERT_SHAPE = dict(b=8, s=512, h=12, d=64)
# The image and MLP jobs at their entrypoints' defaults.
RESNET50_PARAMS = {"batch_size": "128", "image_size": "224", "steps": "10"}
VIT_PARAMS = {"size": "base", "batch_size": "64", "image_size": "224",
              "steps": "10", "flops_accounting": "1"}
# ViT-B/16's attention: b 64 x 197 tokens (196 patches and CLS), 12 heads of
# 64, non-causal, in each of its 12 layers: K1-K3 on the card at that length.
VIT_SHAPE = dict(b=64, s=197, h=12, d=64)
VIT_LAYERS = 12
# ViT's attention FLOPs a step, which FlopCounterMode cannot see inside the
# kernels: 4 d per (query, key) pair and head forward, 8 d backward, as
# ops.attention.count_attention_flops counts them (and as FlopCounterMode
# counted the plain body's four products).
VIT_ATTENTION_FLOPS = (12 * VIT_SHAPE["d"] * VIT_SHAPE["b"] * VIT_SHAPE["h"]
                       * VIT_SHAPE["s"] ** 2 * VIT_LAYERS)
# ViT's graphed step and rate on the plain f32 attention body, before K1-K3
# took its 197 tokens (PERF.md section 5; H100 80GB HBM3, 700 W), printed
# beside this run's.
VIT_PLAIN_BEFORE = {"step_ms": 40.452, "images_per_s": 1582.1}
# Shares of ViT's graphed call's device time: the flash kernels, f32 GEMMs
# (the plain body's products ran as sm80_xmma_gemm_f32f32), and copies and
# casts.
VIT_SHARES = {"attention kernels": r"flash_(fwd|bwd)",
              "f32 GEMMs": r"gemm_f32f32|sgemm",
              "copies and casts": r"direct_copy_kernel|bfloat16_copy_kernel"}
MNIST_PARAMS = {"batch_size": "256", "steps": "20"}
# Switch-MoE: the MoE params of the shipped GPT Cron
# (examples/v1alpha1/cron/cron-jax-gpt.yaml): every second block's FFN is 8
# experts, capacity factor 1.25, aux weight 0.01 (the GPTConfig defaults).
MOE_PARAMS = {"moe_every": "2", "num_experts": "8"}
MOE_TRAIN_PARAMS = {**TRAIN_PARAMS, **MOE_PARAMS}
MOE_SLICE_PARAMS = {**SLICE_PARAMS, **MOE_PARAMS}
GPT2_SMALL_MOE_PARAMS = 322_634_496
GRAPH_CHUNK = 8  # steps per call of the default mode (steps_per_call=auto)
# The graphed step and decode ms before the padded vocab table, the decode
# kernel and the inner-axis router scan (PERF.md section 5; H100 80GB
# HBM3, 700 W), printed beside this run's.
BEFORE_MS = {"gpt": 41.805, "bert": 15.496, "moe": 69.017,
             "decode": 2.895, "moe decode": 3.442}
# The graphed decode ms a step on the three-pass decode kernel, before its
# cluster redesign (PERF.md section 5: PR 13 run 3, H100 80GB HBM3, 700 W).
DECODE_THREE_PASS_MS = {"generate": 1.130, "moe": 1.586}
# The eager prefill (b 8, prompt 512) before it was captured beside the
# decode step (PERF.md section 5, H100 80GB HBM3, 700 W; MoE
# host-bound across 13.656-21.181), printed beside the graphed prefill.
PREFILL_BEFORE_MS = {"generate": "6.870", "moe": "13.656-21.181"}
# Kernels the graphed steps must no longer spend time in, each regex with
# the largest share of a graphed call's device time its kernels may take:
# cuBLAS's GEMMs for rows of 1- or 2-element alignment, which the vocab
# widths 50257 and 30522 ran at 15.6-37% of a step before they were padded
# (a small f32 GEMM of the MoE router, [T, 768] x [768, 8], runs one at
# about 0.2%), and the cumsum that scans an outer axis, which the MoE
# router ran before its scan moved to the inner axis.
UNALIGNED_GEMM = {r"align[12](?!\d)": 0.01}
OUTER_SCAN = {r"scan_outer_dim": 0.0}
# The MoE GPT on the dense one-hot dispatch and combine, before they became
# gathers by token index (PERF.md section 5; H100 80GB HBM3, 700 W): the
# graphed step, the first graphed call's peak memory, the counted and
# active TFLOP a step, eager prefill and the graphed decode step, printed
# beside this run's.
MOE_ONEHOT = {"step_ms": 48.449, "peak_gib": 16.89, "counted_tflop": 10.7513,
              "active_tflop": 6.5815, "prefill_ms": 17.593,
              "decode_ms": 1.591}
# The router's gradient, index path against dense, in bf16: the dense path
# rounds each gate's gradient to bf16 (unit roundoff 2^-8), the index path
# sums it in f32; the bound is on the largest entry's scale.
MOE_ROUTER_GRAD_REL = 2 ** -7
# Phase 19: the decode kernel at GPT-2 small's decode shape, at the first,
# the middle, the slice's last (prompt 512 + 64 new tokens) and the final
# cache position, and a GQA case of group 2.
DECODE_SHAPE = dict(b=8, max_len=1024, h=12, d=64)
DECODE_POSITIONS = (0, 511, 575, 1023)
DECODE_TIMED_POS = 575
# Phase 21: the loss kernels at the logits the gpt and bert jobs make,
# (T, Vp, V): GPT-2 small's b 8 x 1024 and BERT-base's b 8 x 512.
XENT_SHAPES = {"gpt": (8192, 50304, 50257), "bert": (4096, 30528, 30522)}
# The graphed steps on the former loss (f32 log-softmax over the cut f32
# logits), PERF.md section 5's readings before the loss kernels; H100
# 80GB HBM3, 700 W.
LOSS_BEFORE_MS = {"gpt": 30.212, "bert": 14.389, "moe": 35.980}
# The loss kernels' launches (forward, backward) on each main path, filled
# by the phases that run it, for the kernels line.
XENT_LAUNCHES = {}
# LayerNorms a step (or a prefill, or a decode step) of GPT-2 small,
# BERT-base and ViT-B/16: two a block and the final one.
LM_NORMS = 2 * 12 + 1
# The LayerNorm kernels' launches (forward, backward) on each path, filled
# by the phases that run it, for the kernels line.
LN_LAUNCHES = {}
# Shares of a graphed LM call's device time read from its profile: the
# loss kernels, log-softmax (the former loss), LayerNorm's kernels and
# copies and casts (PyTorch's direct_copy_kernel: copy_ and the casts to
# f32; bfloat16_copy_kernel: the casts to bf16).
LM_SHARES = {"loss kernels": r"xent_(fwd|bwd)_kernel",
             "log_softmax": r"softmax",
             "layer_norm": r"layer_norm|GammaBeta",
             "copies and casts": r"direct_copy_kernel|bfloat16_copy_kernel"}
N_PARAMS = {"gpt": GPT2_SMALL_PARAMS, "bert": 108_890_112,
            "resnet50": 25_557_032, "vit": 86_567_656, "mnist": 535_818}
TRAIN_PROGRESS_KEYS = (
    "started_at", "steps_per_call", "data_mode", "first_step_at",
    "first_step_latency_s", "compile_time_s", "steps_done", "step_timeline",
    "last_loss", "last_step_time_s", "tokens_per_s", "avg_step_time_s",
    "steps_per_s", "data_stall_ms_p50", "n_params",
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def release(torch) -> None:
    """Returns the card memory of deleted trainers and models: the collector
    runs before the allocator's cache is emptied, so that nothing a
    reference cycle holds keeps its blocks (a trainer and its step graph
    no longer make one: the graph holds the trainer's step weakly)."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


# Traces a profile_window takes before it gives up on one that holds no
# kernel.
PROFILE_ATTEMPTS = 3


def profile_window(torch, card: str, label: str, fn, kernels_out=None):
    """Where one window's device time goes: the top kernels by device time
    and the device's busy share of the window's wall time (torch.profiler;
    its own overhead lengthens the wall time, so the idle share is an upper
    bound). Returns the window's wall and device-busy ms; every kernel's
    (name, device us, launches) goes into ``kernels_out`` when given. The
    profiler traces one call of ``fn`` first and discards it: a trace
    that starts with the window can miss the window's first kernels (a
    replayed decode step once showed 11 of its 12 decode launches and
    fewer of its first layer's other kernels)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # a trace with no kernel at all is the profiler's loss, not the
    # window's (a replayed decode step once came back empty): trace again
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # a record_function range (the optimizer's step) also carries
        # device time, that of the kernels inside it: leave it out of the
        # sum
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)]
        if kernels:
            break
        print(f"[{card}] profile {label}: the trace holds no kernel "
              f"(attempt {attempt + 1} of {PROFILE_ATTEMPTS})", flush=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    if kernels_out is not None:
        kernels_out.extend((e.key, e.self_device_time_total, e.count)
                           for e in kernels)
    print(f"[{card}] profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {100 * e.self_device_time_total / busy_us:5.1f}% "
              f"{e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
              f"{e.key[:90]}")
    return wall_us / 1e3, busy_us / 1e3


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


def whole_block_fwd(fa, q, k, v, causal: bool):
    """K1 through its public entry with one block of the whole sequence,
    which meets the JAX block rule at any length (a ragged ``seq`` too);
    the kernel's own tiles do not follow the blocks."""
    s = q.shape[1]
    return fa.flash_attention_fwd(q, k, v, causal=causal, block_q=s,
                                  block_k=s)


def check_k1(torch, fa, name: str, q, k, v, causal: bool) -> float:
    """Runs K1 and its plain version on the same card tensors and fails
    unless they agree; returns max|dO|. O within ``forward_tolerance`` for
    the design that runs: in bf16 the sm90 design rounds P to bf16 before
    P V, as the TPU kernel does (2^-7 |O| + 2^-8 (P |V|) / l + 1e-4 max|O|),
    the fma design rounds O once (one bf16 ulp, 2^-7 |O| + 1e-4); in f32
    only the summation order differs (1e-4). LSE is f32 on both sides:
    summation order only (1e-4)."""
    o, lse = whole_block_fwd(fa, q, k, v, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
    diff = (o.float() - o_ref.float()).abs()
    bound = fa.forward_tolerance(q, k, v, o_ref, lse_ref, causal=causal)
    err_o = diff.max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    print(f"  {name}: max|dO|={err_o:.3e} max|dLSE|={err_lse:.3e}")
    if not (bool(torch.isfinite(o.float()).all())
            and bool((diff <= bound).all()) and err_lse <= 1e-4):
        fail(f"{name} disagrees with the plain version")
    return err_o


# Phase 2's sequence lengths that no kernel tile divides (one row, a tile
# and one short or over, ViT-B/16's 197, ...), at b 1 and 4 heads.
RAGGED_SEQS = (1, 63, 65, 197, 200, 255, 1000)
RAGGED_B, RAGGED_H = 1, 4


def phase_kernel_vs_plain(torch, fa) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(dtype, causal, d, group, s, 2, 8)
             for dtype in (torch.bfloat16, torch.float32)
             for causal in (False, True) for d in (64, 128)
             for group in (1, 2, 4) for s in (128, 512, 2048)]
    cases += [(dtype, causal, d, group, s, RAGGED_B, RAGGED_H)
              for dtype in (torch.bfloat16, torch.float32)
              for causal in (False, True) for d in (64, 128)
              for group in (1, 2) for s in RAGGED_SEQS]
    for dtype, causal, d, group, s, b, h in cases:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(b, s, h // group, d, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        check_k1(torch, fa, f"K1 {str(dtype)[6:]} causal={int(causal)} d={d} "
                 f"group={group} b={b} s={s}", q, k, v, causal)
    print(f"kernel vs plain: {len(cases)} cases agree (ragged seq "
          f"{RAGGED_SEQS} among them), launches by design "
          f"{fa.flash_attention.launches_by_design}", flush=True)


def bwd_bound(q, k, causal):
    """(bytes_ms, ops_ms, bytes, flops) of K2 and of K3 for these inputs:
    each input read once and each output written once, and the products
    over the (query, key) pairs the mask keeps, at the data-sheet rates."""
    b, s, h, d = q.shape
    kv_h = k.shape[2]
    es = q.element_size()
    q_bytes, kv_bytes = b * s * h * d * es, b * s * kv_h * d * es
    rows = 2 * b * h * s * 4  # f32 LSE and Delta
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    out = {}
    for name, moved, per_pair in (
            ("K2", 3 * q_bytes + 2 * kv_bytes + rows, 6 * d),  # Q dO dQ, K V
            ("K3", 2 * q_bytes + 4 * kv_bytes + rows, 8 * d)):  # Q dO, K V dK dV
        flops = per_pair * pairs
        out[name] = (moved / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3,
                     moved, flops)
    return out


def check_bwd(torch, fa, name: str, q, k, v, do, causal: bool):
    """Runs K2 and K3 twice and their plain versions once on the same card
    tensors; fails unless the two runs are bit-identical and agree with the
    plain versions: in f32 within 1e-4 max|ref| (summation order); in bf16
    dQ within ``dq_tolerance`` and dK and dV within ``dkv_tolerance`` for
    the design that runs (the sm90 designs round dS, and in K3 P, to bf16,
    as the TPU kernels do; the fma design keeps them in f32 and rounds each
    grad once: 2^-7 |ref| + 1e-4 max|ref|); at seq 1, where dQ and dK
    vanish in exact arithmetic, plus ``vanishing_grad_floor``. Returns
    (max|d dQ|, max|d dK, d dV|)."""
    o, lse = whole_block_fwd(fa, q, k, v, causal)
    delta = fa._delta(o, do)
    runs = []
    for _ in range(2):
        dq = fa.flash_attention_dq(q, k, v, do, lse, delta, causal=causal)
        dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, causal=causal)
        runs.append((dq, dk, dv))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail(f"{name}: a second backward run is not bit-identical")
    refs = (fa.flash_attention_dq_reference(q, k, v, do, lse, delta,
                                            causal=causal),
            *fa.flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                              causal=causal))
    errs = []
    bounds = (fa.dq_tolerance(q, k, v, do, lse, delta, refs[0],
                              causal=causal),
              *fa.dkv_tolerance(q, k, v, do, lse, delta, *refs[1:],
                                causal=causal))
    if q.shape[1] == 1:  # dQ and dK vanish: one key takes all the mass
        floors = fa.vanishing_grad_floor(q, k, v, do, lse, causal=causal)
        bounds = (bounds[0] + floors[0], bounds[1] + floors[1], bounds[2])
    for grad, got, ref, bound in zip(("dQ", "dK", "dV"), runs[0], refs,
                                     bounds):
        ref = ref.float()
        diff = (got.float() - ref).abs()
        floor = 1e-4 * ref.abs().max().item()
        if not (bool(torch.isfinite(got.float()).all())
                and bool((diff <= bound).all())):
            fail(f"{name}: {grad} disagrees with the plain version "
                 f"(max|d|={diff.max().item():.3e}, floor {floor:.3e})")
        errs.append(diff.max().item())
    print(f"  {name}: max|d dQ|={errs[0]:.3e} max|d dK|={errs[1]:.3e} "
          f"max|d dV|={errs[2]:.3e}")
    return errs[0], max(errs[1:])


def phase_bwd_vs_plain(torch, fa) -> None:
    gen = torch.Generator(device="cuda").manual_seed(3)

    def inputs(b, s, h, kv_h, d, dtype):
        def draw(heads):
            return torch.randn(b, s, heads, d, generator=gen,
                               device="cuda").to(dtype)
        return draw(h), draw(kv_h), draw(kv_h), draw(h)

    cases = [(dtype, causal, d, group, s, 2, 8)
             for dtype in (torch.bfloat16, torch.float32)
             for causal in (False, True) for d in (64, 128)
             for group in (1, 2, 4) for s in (128, 512, 2048)]
    cases += [(dtype, causal, d, 2, s, 2, 8) for dtype in (torch.bfloat16,
                                                           torch.float32)
              for causal in (False, True) for d in (32, 256)
              for s in (512, 197)]
    cases += [(dtype, causal, d, group, s, RAGGED_B, RAGGED_H)
              for dtype in (torch.bfloat16, torch.float32)
              for causal in (False, True) for d in (64, 128)
              for group in (1, 2) for s in RAGGED_SEQS]
    for dtype, causal, d, group, s, b, h in cases:
        check_bwd(torch, fa, f"K2/K3 {str(dtype)[6:]} causal={int(causal)} "
                  f"d={d} group={group} b={b} s={s}",
                  *inputs(b, s, h, h // group, d, dtype), causal)
    print(f"backward kernels vs plain: {len(cases)} cases agree (ragged seq "
          f"{RAGGED_SEQS} among them), each "
          "bit-identical on a second run; launches by design: K2 "
          f"{fa.flash_attention_dq.launches_by_design}, K3 "
          f"{fa.flash_attention_dkv.launches_by_design}", flush=True)

    # Peak memory of the backward at b*h fixed: O(s) (the outputs and
    # Delta), where a materialised s x s score matrix would grow 16x.
    peaks = {}
    for s in (2048, 8192):
        q, k, v, do = inputs(1, s, 8, 8, 64, torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        peaks[s] = torch.cuda.max_memory_allocated() - base
        del q, k, v, do, o, lse, grads
    ratio = peaks[8192] / peaks[2048]
    print(f"backward peak memory above its inputs: s 2048 {peaks[2048]} B, "
          f"s 8192 {peaks[8192]} B, ratio {ratio:.2f} (linear: 4, "
          "quadratic: 16)", flush=True)
    if ratio > 5:
        fail(f"backward memory grows {ratio:.2f}x for 4x the sequence")


def zero_counts(fa) -> None:
    for fn in (fa.flash_attention, fa.flash_attention_dq,
               fa.flash_attention_dkv):
        fn.launches = 0
        fn.launches_by_design = dict.fromkeys(fa.DESIGNS, 0)
    decode = decode_wrapper()
    decode.launches = 0
    decode.launches_by_design = dict.fromkeys(decode.launches_by_design, 0)
    for fn in norm_wrappers():
        fn.launches = 0
        fn.launches_by_design = dict.fromkeys(fn.launches_by_design, 0)
        fn.launches_by_epilogue = dict.fromkeys(fn.launches_by_epilogue, 0)
    for fn in (*xent_wrappers(), *ln_wrappers()):
        fn.launches = 0
        fn.launches_by_design = dict.fromkeys(fn.launches_by_design, 0)


# Launches of the designs that no main path should run now, summed over
# the main paths' runs for the kernels line (the checks fail on any)
OLD_DESIGN_LAUNCHES = {"decode": 0, "group_norm": 0, "group_norm_bwd": 0}


def check_decode_design(label: str, launches: int) -> None:
    """Every decode launch of a main path went to the cluster design."""
    by_design = dict(decode_wrapper().launches_by_design)
    OLD_DESIGN_LAUNCHES["decode"] += by_design.get("fma", 0)
    print(f"{label}: decode_attention launches by design {by_design}",
          flush=True)
    if by_design.get("cluster") != launches:
        fail(f"{label}: decode launches by design {by_design}, not all "
             f"{launches} on the cluster design")


def decode_wrapper():
    """``ops.attention.decode_attention``, whose ``launches`` count the
    decode kernel's."""
    return importlib.import_module(
        "cron_operator_tpu_torch.ops.attention").decode_attention


def norm_wrappers():
    """``ops.group_norm``'s forward and backward wrappers, whose
    ``launches`` count the GroupNorm kernels'."""
    gn = importlib.import_module("cron_operator_tpu_torch.ops.group_norm")
    return gn.group_norm_forward, gn.group_norm_backward


def read_norm_counts():
    return tuple(fn.launches for fn in norm_wrappers())


def xent_wrappers():
    """``ops.xent``'s forward and backward wrappers, whose ``launches``
    count the loss kernels'."""
    xent = importlib.import_module("cron_operator_tpu_torch.ops.xent")
    return xent.softmax_xent_forward, xent.softmax_xent_backward


def read_xent_counts():
    return [fn.launches for fn in xent_wrappers()]


def check_xent(label: str, path: str, counts, steps: int) -> None:
    """The loss kernels launched once a step each on the path ``path``
    (``steps`` steps; 0 for a path that keeps the former loss), kept for
    the kernels line."""
    print(f"{label}: loss kernel launches (forward, backward) {counts} "
          f"(expected {steps} each)", flush=True)
    if list(counts) != [steps, steps]:
        fail(f"{label}: the loss kernels launched {counts} times, not "
             f"{steps} each")
    if steps:
        XENT_LAUNCHES[path] = [XENT_LAUNCHES.get(path, [0, 0])[i] + counts[i]
                               for i in range(2)]


def ln_wrappers():
    """``ops.layer_norm``'s forward and backward wrappers, unfolded and
    folded (the residual add before the norm), whose ``launches`` count the
    LayerNorm kernels'."""
    ln = importlib.import_module("cron_operator_tpu_torch.ops.layer_norm")
    return (ln.layer_norm_forward, ln.layer_norm_backward,
            ln.add_layer_norm_forward, ln.add_layer_norm_backward)


def read_ln_counts():
    """The LayerNorm kernels' launches: (forward, backward) of both
    designs, then those of the folded design alone."""
    fwd, bwd, add_fwd, add_bwd = (fn.launches for fn in ln_wrappers())
    return [fwd + add_fwd, bwd + add_bwd, add_fwd, add_bwd]


def check_ln(label: str, path: str, counts, expected,
             folded: bool = True) -> None:
    """The LayerNorm kernels' launches (forward, backward; each a norm,
    folded or not, then the folded alone) on the path ``path``, kept for
    the kernels line: ``expected`` (forward, backward), or None for a path
    whose counts are recorded as they come. With ``folded`` every norm but
    the first of :data:`LM_NORMS` takes its residual add (24 of 25), else
    none does (a DTensor mesh keeps torch's adds)."""
    print(f"{label}: LayerNorm kernel launches (forward, backward) "
          f"{counts[:2]}, folded {counts[2:]}" + (
              "" if expected is None else f" (expected {list(expected)}, "
              f"folded {'24 in 25' if folded else 'none'})"), flush=True)
    if expected is not None:
        fold = [e * (LM_NORMS - 1) // LM_NORMS if folded else 0
                for e in expected]
        if list(counts) != [*expected, *fold]:
            fail(f"{label}: the LayerNorm kernels launched {counts} times, "
                 f"not {[*expected, *fold]}")
    if path:
        LN_LAUNCHES[path] = [LN_LAUNCHES.get(path, [0] * 4)[i] + counts[i]
                             for i in range(4)]


@contextlib.contextmanager
def unfolded_layer_norm():
    """``models.layers.LayerNorm.add_norm`` unfolded while the context is
    open: torch's residual add, then the norm alone (``LayerNorm.forward``:
    the unfolded LayerNorm kernels), as the blocks ran before the fold."""
    layers = importlib.import_module("cron_operator_tpu_torch.models.layers")
    real = layers.LayerNorm.add_norm

    def unfolded(self, x, r):
        if r is not None:
            x = x + r
        return x, self(x)

    layers.LayerNorm.add_norm = unfolded
    try:
        yield
    finally:
        layers.LayerNorm.add_norm = real


def lm_wiring(cfg, former: bool = False):
    """``(cfg, loss_fn)`` of a GPT or BERT config as the gpt and bert jobs
    wire them on one card (``entrypoints.lm_loss``: the padded product
    through the loss kernels), or with ``former`` the wiring before them
    (the model's f32 logits and ``cross_entropy_loss``)."""
    from cron_operator_tpu_torch.workloads.entrypoints import lm_loss
    from cron_operator_tpu_torch.workloads.train import cross_entropy_loss

    return_hidden, loss_fn = ((False, cross_entropy_loss) if former
                              else lm_loss())
    return replace(cfg, return_hidden=return_hidden), loss_fn


def read_counts(fa):
    return (fa.flash_attention.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches)


def read_designs(fa):
    return tuple(dict(fn.launches_by_design) for fn in (
        fa.flash_attention, fa.flash_attention_dq, fa.flash_attention_dkv))


def phase_slice(torch, fa, params=SLICE_PARAMS, n_params=GPT2_SMALL_PARAMS,
                label="slice", ln_path="generate"):
    from cron_operator_tpu_torch.backends.registry import JobContext
    from cron_operator_tpu_torch.workloads.entrypoints import generate_job

    ctx = JobContext("chip-smoke-generate", "default", {}, dict(params))
    rounds = int(params["rounds"])
    zero_counts(fa)
    t0 = time.monotonic()
    generate_job(ctx)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, dq_launches, dkv_launches = read_counts(fa)
    k1_designs = read_designs(fa)[0]
    decode_launches = decode_wrapper().launches
    steps = rounds * (int(params["max_new"]) - 1)
    # the LayerNorm forward 25 times in each round's prefill and each decode
    # step (a replay counted once)
    check_ln(label, ln_path, read_ln_counts(),
             (LM_NORMS * (rounds + steps), 0))
    print(f"{label}: generate_job in {wall:.2f} s, progress {ctx.progress}")
    print(f"{label}: decode_attention launches {decode_launches} (expected "
          f"12 a decode step x {steps} steps)", flush=True)
    if decode_launches != 12 * steps:
        fail(f"{label}: the decode kernel launched {decode_launches} times, "
             f"not 12 in each of {steps} decode steps")
    check_decode_design(label, decode_launches)
    print(f"{label}: flash_attention launches {launches} "
          f"(expected 12 x {rounds}, all sm90: {k1_designs}), backward "
          f"{dq_launches}/{dkv_launches} (expected 0)", flush=True)
    if launches != 12 * rounds or dq_launches or dkv_launches:
        fail(f"flash kernels launched {launches}/{dq_launches}/"
             f"{dkv_launches} times on the serving path, not "
             f"{12 * rounds}/0/0")
    if k1_designs["sm90"] != launches:
        fail(f"K1 launches on the serving path by design {k1_designs}: not "
             "all sm90")
    for key in ("n_params", "decode_read_bytes_per_step", "started_at",
                "first_step_at", "first_step_latency_s", "tokens_per_s",
                "steps_done", "tokens_generated"):
        if key not in ctx.progress:
            fail(f"progress key {key!r} was not published")
    if not ctx.progress["tokens_per_s"] > 0:
        fail("tokens_per_s is not positive")
    if ctx.progress["n_params"] != n_params:
        fail(f"{label}: n_params {ctx.progress['n_params']} is not "
             f"{n_params}")
    if ctx.progress["tokens_generated"] != rounds * 8 * 64:
        fail("tokens_generated does not count every round")
    return launches, decode_launches, ctx.progress


def slice_model(torch, cfg, weights_from=None):
    """A serving model as ``generate_job`` builds it: parameters kept in
    ``cfg.dtype``."""
    from cron_operator_tpu_torch.models import GPT

    model = GPT(cfg, device="cuda", param_dtype=cfg.dtype)
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


def timed_rows(torch, card, name, fns, iters=(20, 5, 20)):
    """(device ms, CUDA-event ms) per call of a kernel's wrapper, its plain
    version and its library yardstick. The device ms (:func:`device_ms`) is
    what the kernels line reports: at the slices' shapes a call of the
    wrappers costs the host about as long as the kernel runs, so
    back-to-back calls timed by events alone measure the host as much as
    the card. The event times are printed beside them."""
    device = [device_ms(torch, fn, n) for fn, n in zip(fns, iters)]
    events = [median_ms(torch, fn, iters=n) for fn, n in zip(fns, iters)]
    print(f"[{card}] {name} (kernel, plain, library): device ms {device} | "
          f"event ms {events}", flush=True)
    return device, events


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
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    (k1_ms, plain_ms, library_ms), _ = timed_rows(torch, card, "K1", (
        lambda: fa.flash_attention_fwd(q, k, v, causal=True),
        lambda: fa.flash_attention_reference(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)))
    moved = 4 * q.numel() * q.element_size() + b * h * s * 4  # + f32 LSE
    flops = 4 * d * b * h * (s * (s + 1) // 2)  # QK^T and PV, causal pairs
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[{card}] K1 b{b} s{s} h{h} d{d} causal bf16: {k1_ms:.4f} ms/"
          f"launch (device) | plain {plain_ms:.4f} ms | sdpa "
          f"{library_ms:.4f} ms | bound {bound_ms * 1e3:.2f} us "
          f"({moved / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)", flush=True)

    prompt = torch.randint(0, flash_model.config.vocab_size, (8, 512),
                           generator=gen, device="cuda")
    with torch.inference_mode():
        cache = flash_model.new_cache(8)
        prefill_ms = median_ms(
            torch, lambda: flash_model.prefill(prompt, cache), iters=3)
        token = prompt[:, -1:]

        def decode_step():
            # rewind so every timed step decodes at one cache position
            cache.pos.fill_(512)
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
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }, prefill_ms, decode_ms


def phase_job(torch, fa, job: str, params: dict, sm90_per_step: int,
              n_params=None, xent_path: str = None, ln_path: str = None):
    """A training job through the entrypoint a user's Cron calls, with every
    kernel count set to 0 just before and read just after: each of K1, K2
    and K3 must have launched ``sm90_per_step`` times a step, all of the
    sm90 design (0 for a job whose attention never reaches the kernels),
    and the loss kernels once a step each on an LM path (``xent_path``,
    its name in the kernels line), else never; the LayerNorm kernels
    :data:`LM_NORMS` times a step each way on the path ``ln_path`` (the LM
    path's by default), else never. ``n_params`` is the parameter count
    expected (the job's default model's by default)."""
    from cron_operator_tpu_torch.backends.registry import JobContext
    from cron_operator_tpu_torch.workloads import entrypoints

    ctx = JobContext(f"chip-smoke-{job}", "default", {}, dict(params))
    steps = int(params["steps"])
    zero_counts(fa)
    t0 = time.monotonic()
    getattr(entrypoints, job)(ctx)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts(fa)
    designs = read_designs(fa)
    check_xent(job, xent_path, read_xent_counts(), steps if xent_path else 0)
    ln_path = ln_path or xent_path
    check_ln(job, ln_path, read_ln_counts(),
             (LM_NORMS * steps if ln_path else 0,) * 2)
    progress = {k: v for k, v in ctx.progress.items() if k != "step_timeline"}
    expected = sm90_per_step * steps
    print(f"{job}: in {wall:.2f} s, progress {progress}")
    print(f"{job}: launches K1/K2/K3 {counts} (expected {expected} each), "
          f"by design {designs} (all sm90)", flush=True)
    if counts != (expected,) * 3:
        fail(f"flash kernels launched {counts} times on the {job} path, "
             f"not {expected} each")
    for name, n, by_design in zip(("K1", "K2", "K3"), counts, designs):
        if by_design["sm90"] != n:
            fail(f"{name} launches on the {job} path by design {by_design}: "
                 "not all sm90")
    tokens = "tokens_per_s" in ctx.progress
    for key in TRAIN_PROGRESS_KEYS:
        if key not in ctx.progress and (tokens or key != "tokens_per_s"):
            fail(f"{job}: progress key {key!r} was not published")
    n_params = n_params or N_PARAMS[job]
    if ctx.progress["n_params"] != n_params:
        fail(f"{job}: n_params {ctx.progress['n_params']} is not {n_params}")
    if ctx.progress["steps_done"] != steps:
        fail(f"{job}: steps_done {ctx.progress['steps_done']} is not {steps}")
    if ctx.progress["steps_per_call"] != GRAPH_CHUNK:
        fail(f"{job}: steps_per_call {ctx.progress['steps_per_call']} is "
             f"not the default mode's {GRAPH_CHUNK}")
    if len(ctx.progress["step_timeline"]) != steps:
        fail(f"{job}: step_timeline does not hold every step")
    if not math.isfinite(ctx.progress["last_loss"]):
        fail(f"{job}: the last loss is not finite")
    rate = "tokens_per_s" if tokens else "steps_per_s"
    if not ctx.progress[rate] > 0:
        fail(f"{job}: {rate} is not positive")
    return counts, ctx.progress


@contextlib.contextmanager
def recorded_routes(routes: list):
    """Appends each router call's expert choice (the argmax of its logits,
    ``[tokens]`` on the card) to ``routes`` while the context is open: it
    wraps ``router_top1_indices``, which the index path calls and the
    dense ``router_top1`` builds its one-hots from."""
    moe = importlib.import_module("cron_operator_tpu_torch.parallel.moe")
    real = moe.router_top1_indices

    def spy(logits, capacity):
        routes.append(logits.detach().argmax(dim=-1))
        return real(logits, capacity)

    moe.router_top1_indices = spy
    try:
        yield routes
    finally:
        moe.router_top1_indices = real


def phase_train_correctness(torch, model_cls, cfg, stream, label):
    """Three AdamW steps on the kernel path (flash attention and the loss
    kernels, wired as the job wires them) and on the plain path (plain
    attention, the former f32 loss) from the same f32 weights and batches;
    each is measured against an f32 run (plain, former loss). Both bf16
    paths carry bf16 rounding through 12 layers and differ
    only in how attention rounds, so the kernel path must stay within twice
    the plain bf16 path's own distance from f32: per-step losses (plus
    1e-3, as the prefill check allows), and the first step's gradients as
    one vector (L2 norm of the difference). An MoE model's aux loss is in
    the loss; the tokens its routers send to another expert than the other
    path's in the first step (its roundings differ, so a near-tie may go
    either way) are counted and printed."""
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    init = model_cls(cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(0))
    state = {k: v.clone() for k, v in init.state_dict().items()}
    moe = getattr(init, "has_moe", False)
    del init
    batches = [next(stream) for _ in range(3)]
    losses, grads, routes = {}, {}, {}
    for name, over in (("flash", dict(attention_impl="flash")),
                       ("plain", dict(attention_impl="xla")),
                       ("f32", dict(attention_impl="xla",
                                    dtype=torch.float32))):
        wired, loss_fn = lm_wiring(replace(cfg, **over),
                                   former=name != "flash")
        model = model_cls(wired, device="cuda")
        model.load_state_dict(state)
        trainer = Trainer(model, TrainConfig(aux_loss_in_output=moe),
                          loss_fn=loss_fn)
        losses[name] = []
        routes[name] = []
        for i, batch in enumerate(batches):
            with recorded_routes(routes[name] if i == 0 else []):
                losses[name].append(trainer.step(batch).loss)
            if i == 0:
                grads[name] = torch.cat([p.grad.flatten()
                                         for p in model.parameters()])
        del model, trainer
        release(torch)
    print(f"{label} losses: flash {losses['flash']} plain {losses['plain']} "
          f"f32 {losses['f32']}")
    if moe:
        def flips(a, b):
            return sum(int((x != y).sum()) for x, y in zip(routes[a],
                                                           routes[b]))
        tokens = sum(r.numel() for r in routes["f32"])
        print(f"{label} route flips in step 1 ({len(routes['f32'])} MoE "
              f"layers, {tokens} token routes): flash vs plain "
              f"{flips('flash', 'plain')}, plain vs f32 "
              f"{flips('plain', 'f32')}, flash vs f32 "
              f"{flips('flash', 'f32')}", flush=True)
    for i in range(len(batches)):
        d_fp = abs(losses["flash"][i] - losses["plain"][i])
        d_p32 = abs(losses["plain"][i] - losses["f32"][i])
        print(f"  step {i + 1}: |flash-plain|={d_fp:.6f} "
              f"|plain-f32|={d_p32:.6f}")
        if d_fp > 2 * d_p32 + 1e-3:
            fail(f"{label} step {i + 1}: the kernel path's loss is off the "
                 "plain path's by more than bf16 noise")
    g_fp = (grads["flash"] - grads["plain"]).norm().item()
    g_p32 = (grads["plain"] - grads["f32"]).norm().item()
    print(f"{label} first-step grads: |flash-plain|={g_fp:.6f} |plain-f32|="
          f"{g_p32:.6f} (|g f32|={grads['f32'].norm().item():.4f})",
          flush=True)
    if not (torch.isfinite(grads["flash"]).all() and g_fp <= 2 * g_p32):
        fail(f"{label}: the kernel path's first-step grads are off the plain "
             "path's by more than bf16 noise")


def phase_gpt_correctness(torch):
    from cron_operator_tpu_torch.models import GPT, GPTConfig
    from cron_operator_tpu_torch.workloads import data

    cfg = GPTConfig(max_len=1024)
    phase_train_correctness(
        torch, GPT, cfg, data.device_causal_token_batches(
            8, 1024, cfg.vocab_size, device="cuda", seed=5), "train")


def attention_rows(torch, fa, card, shape: dict, causal: bool, label: str):
    """K1, K2 and K3 at one training shape: each checked against its plain
    version, then timed (device time, event time beside it) beside its
    bound, its plain version and the SDPA yardstick (SDPA's backward alone
    for K2 and K3)."""
    import torch.nn.functional as F

    b, s, h, d = (shape[x] for x in "bshd")
    gen = torch.Generator(device="cuda").manual_seed(4)
    # the main path's layout: strided views of one fused qkv projection and
    # a contiguous dO
    qkv = torch.randn(b, s, 3, h, d, generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    rows = {}
    mask = f"causal={int(causal)}"

    # K1: Q, K, V read and O written in bf16, the f32 LSE written; QK^T and
    # PV over the (query, key) pairs the mask keeps
    k1_err = check_k1(torch, fa, f"K1 bfloat16 {mask} b={b} s={s} h={h} "
                      f"d={d} ({label})", q, k, v, causal)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    moved = 4 * q.numel() * q.element_size() + b * h * s * 4
    flops = 4 * d * pairs
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    (ms, plain_ms, library_ms), _ = timed_rows(torch, card, f"K1 ({label})", (
        lambda: whole_block_fwd(fa, q, k, v, causal),
        lambda: fa.flash_attention_reference(q, k, v, causal=causal),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)))
    rows["K1"] = dict(
        max_abs_err=k1_err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms,
    )
    bounds = {"K1": (bytes_ms, ops_ms, moved, flops)}

    # K2 and K3
    dq_err, dkv_err = check_bwd(
        torch, fa, f"K2/K3 bfloat16 {mask} b={b} s={s} h={h} d={d} "
        f"({label})", q, k, v, do, causal)
    o, lse = whole_block_fwd(fa, q, k, v, causal)
    delta = fa._delta(o, do)
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal)

    def sdpa_bwd():
        return torch.autograd.grad(out, leaves, dot, retain_graph=True)

    bounds.update(bwd_bound(q, k, causal))
    for name, err, kernel, plain in (
            ("K2", dq_err, fa.flash_attention_dq,
             fa.flash_attention_dq_reference),
            ("K3", dkv_err, fa.flash_attention_dkv,
             fa.flash_attention_dkv_reference)):
        bytes_ms, ops_ms, _, _ = bounds[name]
        (ms, plain_ms, library_ms), _ = timed_rows(
            torch, card, f"{name} ({label})", (
                lambda: kernel(q, k, v, do, lse, delta, causal=causal),
                lambda: plain(q, k, v, do, lse, delta, causal=causal),
                sdpa_bwd))
        rows[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms,
        )
    for name, row in rows.items():
        _, _, moved, flops = bounds[name]
        print(f"[{card}] {name} b{b} s{s} h{h} d{d} {mask} bf16 ({label}): "
              f"{row['ms']:.4f} ms/launch (device) | plain "
              f"{row['plain_ms']:.4f} ms | "
              f"sdpa {row['library_ms']:.4f} ms | bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}) "
              f"({moved / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)", flush=True)
    return rows


def check_graph_step(torch, label: str, make_trainer):
    """GRAPH_CHUNK eager steps against one call of as many steps replayed
    from the captured step graph, each on a fresh trainer from
    ``make_trainer`` (the same seed-0 weights and the same fused data
    seed): the last loss and every parameter must be the same bits. Where
    they are not, a second eager run measures the eager path's own
    run-to-run spread (nondeterministic library kernels): the graph must
    then differ from eager by no more than twice that, and the script
    says so."""
    k = GRAPH_CHUNK

    def run(chunk):
        trainer = make_trainer()
        if chunk == 1:
            for _ in range(k - 1):
                trainer.step({}, sync=False)
            loss = trainer.step({}).loss
        else:
            loss = trainer.step({}, chunk=k).loss
        params = [p.detach().clone() for p in trainer.model.parameters()]
        del trainer
        release(torch)
        return loss, params

    def dist(a, b):
        return max((x.float() - y.float()).abs().max().item()
                   for x, y in zip(a[1], b[1]))

    eager, graph = run(1), run(k)
    if not all(math.isfinite(run_[0]) for run_ in (eager, graph)):
        fail(f"{label}: the loss is not finite")
    same = eager[0] == graph[0] and all(
        torch.equal(a, b) for a, b in zip(eager[1], graph[1]))
    if same:
        print(f"{label}: {k} replayed steps == {k} eager steps (loss "
              f"{graph[0]!r}, every parameter bit-identical)", flush=True)
        return
    spread = dist(eager, run(1))
    d_graph = dist(eager, graph)
    print(f"{label}: FINDING: graph differs from eager: loss {graph[0]!r} vs "
          f"{eager[0]!r}, max|param diff| {d_graph:.3e}; eager against "
          f"itself {spread:.3e}", flush=True)
    if spread == 0 or d_graph > 2 * spread:
        fail(f"{label}: the replayed steps differ from the eager steps "
             "beyond the eager path's own spread")


def graph_vs_eager(torch, card, label: str, make_trainer, model_flops: float,
                   items: int, unit: str, before_ms: float = None,
                   forbid: str = None, shares: dict = None):
    """The step of a fused-data trainer (each step draws its batch) eagerly
    and as one replayed graph of GRAPH_CHUNK steps (``step(..., chunk=8)``),
    in this process: the wall ms a step (CUDA events over back-to-back
    calls, median of 3: what the host's enqueue leaves of the card's time
    is in it), the device ms a step (a graphed call enqueued while the card
    is held busy: the kernels back to back, the same kernels as the eager
    step's), the busy share (device ms over wall ms), ``items`` a step in
    ``unit``/s and MFU against the bf16 peak from ``model_flops`` a step;
    then profiles of an eager step and a graphed call. The graphed step ms
    is printed beside ``before_ms`` where given; ``forbid`` maps regexes to
    the largest share of the graphed call's device time that the kernels
    each matches may take; ``shares`` maps labels to regexes whose kernels'
    share of that time goes into ``rows["shares"]``."""
    k = GRAPH_CHUNK
    check_graph_step(torch, label, make_trainer)
    trainer = make_trainer()

    def eager():
        trainer.step({}, sync=False)

    def graph():
        trainer.step({}, sync=False, chunk=k)

    graph()  # the warm-up step and the capture
    device = device_ms(torch, graph, iters=1, reps=3) / k
    rows = {"device_ms": device, "model_flops_per_step": model_flops}
    for mode, fn, iters, per_call in (("eager", eager, k, 1),
                                      ("graph", graph, 1, k)):
        step_ms = median_ms(torch, fn, iters=iters, reps=3, warmup=1) / per_call
        rows[mode] = {
            "step_ms": step_ms, f"{unit}_per_s": items / step_ms * 1e3,
            "steps_per_s": 1e3 / step_ms,
            "mfu": model_flops / (step_ms / 1e3 * BF16_FLOPS),
            "busy": device / step_ms,
        }
        print(f"[{card}] {label} {mode}: {step_ms:.3f} ms/step | "
              f"{items / step_ms * 1e3:.1f} {unit}/s | mfu "
              f"{rows[mode]['mfu']:.4f} of {BF16_FLOPS / 1e12:.0f} TFLOP/s | "
              f"device {device:.3f} ms/step, busy {100 * device / step_ms:.1f}%"
              f" | model FLOPs/step {model_flops / 1e12:.4f} T", flush=True)
    profile_window(torch, card, f"{label} eager x1",
                   lambda: trainer.step({}))
    kernels = []
    profile_window(torch, card, f"{label} graph x{k}",
                   lambda: trainer.step({}, chunk=k), kernels)
    del trainer
    release(torch)
    if before_ms is not None:
        print(f"[{card}] {label}: graphed {rows['graph']['step_ms']:.3f} ms a "
              f"step, beside {before_ms} before the padded vocab GEMMs and "
              "the inner-axis router scan (PERF.md section 5)", flush=True)
    busy_us = sum(us for _, us, _ in kernels)
    if shares:
        rows["shares"] = {}
        for name, pattern in shares.items():
            hits = [(k[:90], us / 1e3, n) for k, us, n in kernels
                    if re.search(pattern, k)]
            rows["shares"][name] = sum(ms for _, ms, _ in hits) * 1e3 / busy_us
            print(f"[{card}] {label}: {name} ({pattern!r}) "
                  f"{100 * rows['shares'][name]:.2f}% of the graphed call's "
                  f"device time: {hits or 'none'}", flush=True)
    for pattern, most in (forbid or {}).items():
        hits = [(name[:120], us / 1e3, n) for name, us, n in kernels
                if re.search(pattern, name)]
        share = sum(ms for _, ms, _ in hits) * 1e3 / busy_us
        print(f"{label}: kernels matching {pattern!r} in the graphed call: "
              f"{hits or 'none'} ({100 * share:.2f}% of its device time, at "
              f"most {100 * most:.0f}%)", flush=True)
        if hits and share >= most:
            fail(f"{label}: the graphed step still spends {100 * share:.2f}% "
                 f"of its device time in {hits}")
    return rows


def lm_step_times(torch, card, label, model_cls, cfg, sample, shape, causal,
                  before_ms=None, forbid=None):
    """The step of a language model at ``shape``, wired as its job wires it
    (the loss kernels), graph against eager, with :data:`LM_SHARES` of the
    graphed call: model FLOPs are 6 N T plus the attention's 3 * 4 d b h per
    (query, key) pair the mask keeps, per layer (forward and backward)."""
    from cron_operator_tpu_torch.workloads.train import Trainer

    b, s, h, d = (shape[x] for x in "bshd")
    wired, loss_fn = lm_wiring(cfg)

    def make_trainer():
        model = model_cls(wired, device="cuda").init_weights(
            torch.Generator(device="cuda").manual_seed(0))
        return Trainer(model, loss_fn=loss_fn, sample_fn=sample)

    n_params = sum(p.numel() for p in model_cls(cfg, device="meta")
                   .parameters())
    tokens = b * s
    pairs = s * (s + 1) // 2 if causal else s * s
    attn_flops = cfg.num_layers * 3 * 4 * d * b * h * pairs
    dense_flops = 6 * n_params * tokens
    print(f"[{card}] {label}: model FLOPs/step {dense_flops / 1e12:.4f} T "
          f"(6*N*T) + {attn_flops / 1e12:.4f} T (attention fwd+bwd, "
          f"causal={int(causal)})")
    return graph_vs_eager(torch, card, label, make_trainer,
                          dense_flops + attn_flops, tokens, "tokens",
                          before_ms, forbid, LM_SHARES)


def phase_train_times(torch, fa, card):
    from cron_operator_tpu_torch.models import GPT, GPTConfig
    from cron_operator_tpu_torch.workloads import data

    rows = attention_rows(torch, fa, card, TRAIN_SHAPE, True,
                          "the training slice")
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    cfg = GPTConfig(max_len=s)
    step = lm_step_times(
        torch, card, f"train step (GPT-2 small, b{b} s{s}, bf16/f32 "
        "masters, AdamW)", GPT, cfg,
        data.causal_token_sample(b, s, cfg.vocab_size), TRAIN_SHAPE, True,
        BEFORE_MS["gpt"], UNALIGNED_GEMM)
    return rows, step


def phase_bert(torch, fa, card):
    """BERT-base: the job, the kernel path against the plain path, the
    kernels at its shape and the step. Returns the job's K1-K3 launches,
    the kernels' rows and the step's rows."""
    from cron_operator_tpu_torch.models import Bert, BertConfig
    from cron_operator_tpu_torch.workloads import data

    counts, progress = phase_job(torch, fa, "bert", BERT_PARAMS, 12,
                                 xent_path="bert")
    b, s = BERT_SHAPE["b"], BERT_SHAPE["s"]
    cfg = BertConfig.base(max_len=s)
    phase_train_correctness(
        torch, Bert, cfg, data.device_token_batches(
            b, s, cfg.vocab_size, device="cuda", seed=5), "bert")
    rows = attention_rows(torch, fa, card, BERT_SHAPE, False, "bert")
    step = lm_step_times(
        torch, card, f"bert step (BERT-base, b{b} s{s}, bf16/f32 masters, "
        "AdamW)", Bert, cfg, data.token_sample(b, s, cfg.vocab_size),
        BERT_SHAPE, False, BEFORE_MS["bert"], UNALIGNED_GEMM)
    print(f"[{card}] bert job: {progress['tokens_per_s']} tokens/s, "
          f"{progress['avg_step_time_s']} s/step (the calls after the first),"
          f" first call {progress['compile_time_s']} s")
    print("bert " + json.dumps({
        **step, "job_tokens_per_s": progress["tokens_per_s"],
        "job_avg_step_time_s": progress["avg_step_time_s"],
        "job_first_step_s": progress["compile_time_s"],
    }))
    return counts, rows, step


def phase_image_job(torch, fa, card, job: str, params: dict, make_model,
                    train_config, norms_per_step: int = 0,
                    shares: dict = None, ln_path: str = None,
                    flash_per_step: int = 0, attention_flops: float = 0):
    """An image job at its defaults (K1, K2 and K3 launch
    ``flash_per_step`` times a step each, all sm90: ViT's 12 layers at 197
    tokens, none for the others; the GroupNorm kernels launch
    ``norms_per_step`` times a step each, forward and backward, counted
    from 0 over the job, each on its plan's design and ResNet-50's
    epilogue), then its step on the card, graph against eager
    (``make_model()``'s model with seed-0 weights, the job's optimizer,
    fused data): model FLOPs a step counted by ``FlopCounterMode`` over one
    forward and backward plus ``attention_flops``, the attention that the
    kernels run out of its sight, held within 1% of the job's
    ``xla_flops_per_step`` where the job publishes it; ``shares`` as
    :func:`graph_vs_eager`'s; ``ln_path`` names a job whose LayerNorms
    launch the kernels (``phase_job``'s). Returns the GroupNorm launches
    (forward, backward and the two directions' launches by epilogue), the
    step's rows and the K1-K3 launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import (
        Trainer,
        cross_entropy_loss,
    )

    flash_counts, progress = phase_job(torch, fa, job, params,
                                       flash_per_step, ln_path=ln_path)
    norm_counts = read_norm_counts()  # counted from 0 over the job
    steps = int(params["steps"])
    expected = (norms_per_step * steps,) * 2
    print(f"{job}: GroupNorm kernel launches (forward, backward) "
          f"{norm_counts} (expected {expected}: {norms_per_step} a step, a "
          f"replay counted once)", flush=True)
    if norm_counts != expected:
        fail(f"the GroupNorm kernels launched {norm_counts} times on the "
             f"{job} path, not {expected}")
    if norms_per_step:
        forward, backward = (dict(fn.launches_by_design)
                             for fn in norm_wrappers())
        OLD_DESIGN_LAUNCHES["group_norm"] += forward.get("two_pass", 0)
        OLD_DESIGN_LAUNCHES["group_norm_bwd"] += backward.get("two_pass", 0)
        planned = resnet50_forward_designs(steps)
        print(f"{job}: GroupNorm forward launches by design {forward} "
              f"(forward_plan's {planned}), backward {backward}", flush=True)
        if forward != planned:
            fail(f"{job}: GroupNorm forward launches by design {forward}, "
                 f"not forward_plan's {planned}")
        if backward.get("cluster") != norm_counts[1]:
            fail(f"{job}: GroupNorm backward launches by design {backward}, "
                 f"not all {norm_counts[1]} on the cluster design")
        epilogues = tuple(dict(fn.launches_by_epilogue)
                          for fn in norm_wrappers())
        planned = resnet50_epilogues(steps)
        print(f"{job}: GroupNorm launches by epilogue, forward "
              f"{epilogues[0]}, backward {epilogues[1]} (expected "
              f"{planned[0]} and {planned[1]}: 33 relu, 16 residual then "
              "relu and 4 none a step; 33 masked backward)", flush=True)
        if epilogues != planned:
            fail(f"{job}: GroupNorm launches by epilogue {epilogues}, not "
                 f"{planned}")
        norm_counts = (*norm_counts, *epilogues)
    b, size = int(params["batch_size"]), int(params["image_size"])

    def seeded():
        return make_model().init_weights(
            torch.Generator(device="cuda").manual_seed(0))

    model = seeded()
    sample = data.imagenet_sample(b, size, model.head.out_features)
    batch = sample(torch.Generator(device="cuda").manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        cross_entropy_loss(model(batch["x"]), batch["y"]).backward()
    del model, batch
    release(torch)
    model_flops = counter.get_total_flops() + attention_flops
    if "xla_flops_per_step" in progress:
        job_flops = progress["xla_flops_per_step"]
        print(f"{job}: xla_flops_per_step {job_flops} vs script "
              f"{model_flops:.6e} ({job_flops / model_flops - 1:+.4%}; the "
              f"attention {attention_flops:.6e} of it)", flush=True)
        if abs(job_flops / model_flops - 1) > 0.01:
            fail(f"{job}: xla_flops_per_step {job_flops} is not within 1% "
                 f"of this script's {model_flops}")
    step = graph_vs_eager(
        torch, card, f"{job} step (b{b}, image {size})",
        lambda: Trainer(seeded(), train_config, sample_fn=sample),
        model_flops, b, "images", shares=shares)
    print(f"[{card}] {job} job: {progress['steps_per_s']} steps/s, "
          f"{progress['avg_step_time_s']} s/step (the calls after the "
          f"first), first call {progress['compile_time_s']} s")
    print(f"{job} " + json.dumps({
        **step, "job_steps_per_s": progress["steps_per_s"],
        "job_avg_step_time_s": progress["avg_step_time_s"],
        "job_first_step_s": progress["compile_time_s"],
    }))
    return norm_counts, step, flash_counts


def plain_bf16_attention(q, k, v, *, causal: bool):
    """The plain attention body with its two products in bf16 on the tensor
    cores (cuBLAS, f32 accumulation, bf16 out), the softmax in f32 and P
    rounded to bf16: the yardstick that a plain repair of the f32 body
    would give. K/V at full head count, as the plain body takes them."""
    import torch

    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / d ** 0.5
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@contextlib.contextmanager
def vit_attention_body(path: str):
    """``auto`` attention on the card as ``path`` runs it: ``kernels`` (K1-K3,
    the main path), ``plain_f32`` (the plain f32 body that ViT ran before:
    ``parallel.ring._single_device_attention``) or ``plain_bf16``
    (:func:`plain_bf16_attention`), swapped in for the kernels' entry."""
    attention = importlib.import_module("cron_operator_tpu_torch.ops.attention")
    if path == "kernels":
        yield
        return
    body = (attention._single_device_attention if path == "plain_f32"
            else plain_bf16_attention)
    entry = attention._flash_attention_any_length
    attention._flash_attention_any_length = (
        lambda q, k, v, *, causal=False: body(q, k, v, causal=causal))
    try:
        yield
    finally:
        attention._flash_attention_any_length = entry


def phase_vit_attention(torch, fa, card, vit_step: dict) -> dict:
    """ViT-B/16's attention at its shape (b 64, s 197, h 12, d 64, not
    causal): K1-K3 against their plain versions, timed beside their bounds
    (the work at s, not at the tiles), the plain versions and SDPA
    (``attention_rows``); then the graphed ViT step on the kernels and with
    each plain body swapped in (:func:`vit_attention_body`), in turns
    kernels, plain_f32, plain_bf16, kernels (:func:`graphed_runs`; the
    kernels bracket the plain bodies, and phase 8 timed them too), with each
    path's peak memory, beside
    :data:`VIT_PLAIN_BEFORE`. Returns the kernels' rows and the runs."""
    from cron_operator_tpu_torch.models import ViT, ViTConfig
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    rows = attention_rows(torch, fa, card, VIT_SHAPE, False, "vit")
    b, size = int(VIT_PARAMS["batch_size"]), int(VIT_PARAMS["image_size"])
    sample = data.imagenet_sample(b, size, ViTConfig.base().num_classes)

    def make_trainer(path):
        model = ViT(ViTConfig.base(), device="cuda").init_weights(
            torch.Generator(device="cuda").manual_seed(0))
        return Trainer(model, TrainConfig(), sample_fn=sample)

    runs, best = graphed_runs(
        torch, ("kernels", "plain_f32", "plain_bf16", "kernels"),
        make_trainer, vit_attention_body)
    print(f"[{card}] vit step A/B (graphed, kernels/plain_f32/plain_bf16/"
          "kernels): " + " | ".join(
              f"{p} " + ", ".join(
                  f"{r['step_ms']:.3f} ms, {b / r['step_ms'] * 1e3:.1f} "
                  f"images/s ({r['device_ms']:.3f} device, peak "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB)" for r in rs)
              for p, rs in runs.items())
          + " | kernels/plain_f32 "
          f"{best['kernels']['step_ms'] / best['plain_f32']['step_ms']:.4f}, "
          "kernels/plain_bf16 "
          f"{best['kernels']['step_ms'] / best['plain_bf16']['step_ms']:.4f}"
          f" | beside {VIT_PLAIN_BEFORE['step_ms']} ms and "
          f"{VIT_PLAIN_BEFORE['images_per_s']} images/s on the plain f32 "
          "body (PERF.md section 5)", flush=True)
    share = vit_step.get("shares", {}).get("attention kernels")
    per_step = VIT_LAYERS * sum(rows[k]["ms"] for k in ("K1", "K2", "K3"))
    print(f"[{card}] vit: K1-K3 x{VIT_LAYERS} a step {per_step:.3f} ms = "
          f"{100 * per_step / vit_step['device_ms']:.1f}% of the step's "
          f"{vit_step['device_ms']:.3f} device ms; the graphed call's "
          f"profile puts the kernels at {100 * (share or 0):.2f}%", flush=True)
    return {"rows": rows, "runs": runs, "best": best}


COPYING_OPS = ("_to_copy", "copy_", "clone", "contiguous", "_reshape_copy",
               "constant_pad_nd", "cat")


def copying_ops(torch, fn, min_numel: int) -> list:
    """The copies, casts, pads and concatenations that one eager call of
    ``fn`` makes with a tensor of at least ``min_numel`` elements among its
    operands or results, as (op, shape) pairs: a dispatch mode sees every
    aten op of the call (a kernel called through ctypes runs none). Call it
    under ``no_grad``, not ``inference_mode``, where composite ops (``to``,
    ``einsum``) would reach the mode whole, their copies unseen."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    found = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in COPYING_OPS:
                big = [tuple(t.shape) for t in tree_leaves((args, kwargs, out))
                       if isinstance(t, torch.Tensor) and t.numel() >= min_numel]
                if big:
                    found.append((str(func), big[0]))
            return out

    with Watch():
        fn()
    return found


def phase_serving_graph(torch, card, prefill_ms: float, cfg=None,
                        label: str = "generate", before_ms: float = None):
    """Generation at the slice's shape (b 8, prompt 512, 64 new tokens,
    greedy) through the prefill and decode graphs against the eager loop,
    on the same weights and prompt: the tokens must be identical. Then the
    entry's replayed prefill against an eager prefill on a cache of its
    own: the KV cache, its position and the first token to the bit, K1 12
    and the LayerNorm forward 25 launches (24 folded) a replay, and the
    graphed prefill's ms (CUDA events; device ms with the card held busy)
    beside ``prefill_ms`` (eager) and :data:`PREFILL_BEFORE_MS`. Wall ms of
    a whole generation (host clock, synchronised, median of the 3 after a
    first one, the first round, that holds the graphs' warm-ups and
    captures) gives the decode ms a step, ``(wall - prefill) / 63`` with
    each mode's prefill (graphed or eager), and tokens/s, printed beside
    ``before_ms``, the decode ms a step before the decode kernel; the
    device ms of one replayed decode step (the card held busy) over the
    decode ms a step is the busy share of each. An eager decode step may
    copy, cast or pad no tensor of a layer's cache size or larger (the KV
    cache, the vocab table: ``copying_ops``); the graph must launch the
    decode kernel 12 times a step; a replayed step is profiled, and holds
    :data:`LM_NORMS` LayerNorm launches and no residual add of its own.
    ``cfg`` is GPT-2 small's unless given."""
    from cron_operator_tpu_torch.models import GPTConfig

    serving = importlib.import_module("cron_operator_tpu_torch.workloads.generate")
    cfg = cfg or GPTConfig(max_len=1024)
    model = slice_model(torch, cfg)
    b, p, n = 8, 512, 64
    prompt = torch.randint(0, cfg.vocab_size, (b, p), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    with torch.no_grad():
        cache = model.new_cache(b)
        model.prefill(prompt, cache)
        big = min(cache.k[0].numel(), model.tok_emb.weight.numel())
        copies = copying_ops(
            torch, lambda: model.decode(prompt[:, -1:], cache), big)
        del cache
    print(f"{label}: copies of {big}+ elements in an eager decode step: "
          f"{copies or 'none'}", flush=True)
    if copies:
        fail(f"{label}: a decode step copies a cache- or table-sized tensor: "
             f"{copies}")
    decode = decode_wrapper()
    outs, rows, walls = {}, {}, {}
    with torch.inference_mode():
        for mode, captured in (("eager", False), ("graph", True)):
            walls[mode] = []
            launches_before = decode.launches
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[mode] = serving.generate(cfg, model, prompt, n,
                                              captured=captured)
                torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t0) * 1e3)
            launched = decode.launches - launches_before
            if launched != 12 * 4 * (n - 1):
                fail(f"{label} {mode}: the decode kernel launched {launched} "
                     f"times in 4 x {n - 1} decode steps, not 12 a step")
        if not torch.equal(outs["eager"], outs["graph"]):
            fail("greedy tokens through the prefill and decode graphs differ "
                 "from the eager loop's")
        decoder = serving._decoder(model, b, True, None)
        graphed_prefill = check_prefill_replay(torch, label, model, decoder,
                                               prompt)
        prefill = {"eager": prefill_ms, "graph": graphed_prefill["ms"]}
        for mode in ("eager", "graph"):
            gen_ms = statistics.median(walls[mode][1:])
            rows[mode] = {
                "generate_ms": gen_ms, "first_ms": walls[mode][0],
                "prefill_ms": prefill[mode],
                "decode_ms_per_step": (gen_ms - prefill[mode]) / (n - 1),
                "tokens_per_s": b * n / gen_ms * 1e3,
                "decode_launches_per_step": 12}
        rows["prefill_replay"] = graphed_prefill
        token = prompt[:, -1:]

        def replay():
            decoder.cache.pos.fill_(p)  # every step decodes at one position
            decoder.step({"token": token})

        device = device_ms(torch, replay, iters=20, reps=5)
        profile_window(torch, card, f"{label} graph x1",
                       lambda: serving.generate(cfg, model, prompt, n))
        kernels = []
        profile_window(torch, card, f"{label} replayed decode step x1", replay,
                       kernels)
    decode_kernels = {name: count for name, _, count in kernels
                      if "decode_attn" in name or any(
                          k in name for k in ("scores_kernel", "pv_kernel",
                                              "combine_kernel",
                                              "decode_cluster_kernel"))}
    copy_us = sum(us for name, us, _ in kernels if "copy" in name.lower())
    norms, adds = norm_and_add_launches(kernels)
    print(f"{label}: a replayed decode step runs the decode kernel "
          f"{decode_kernels}; copy kernels {copy_us / 1e3:.4f} ms of it; "
          f"LayerNorm kernels {norms}, bf16 adds {adds} (the position "
          "add; each residual add is folded into a norm)", flush=True)
    if (list(decode_kernels.values()) != [12]
            or "decode_cluster_kernel" not in next(iter(decode_kernels))):
        fail(f"{label}: a replayed decode step does not run the decode "
             f"kernel's cluster design once a layer: {decode_kernels}")
    if norms != LM_NORMS or adds > 1:
        fail(f"{label}: a replayed decode step runs {norms} LayerNorm "
             f"kernels and {adds} bf16 adds, not {LM_NORMS} and at most the "
             "position add")
    rows["decode_step_adds"] = adds
    rows["device_ms_per_step"] = device
    for mode in ("eager", "graph"):
        r = rows[mode]
        r["busy"] = device / r["decode_ms_per_step"]
        print(f"[{card}] {label} {mode} (b{b} p{p} +{n}): "
              f"{r['generate_ms']:.3f} ms (first round {r['first_ms']:.1f}) "
              f"| prefill {r['prefill_ms']:.3f} ms | decode "
              f"{r['decode_ms_per_step']:.3f} ms/step, device {device:.3f} ms,"
              f" busy {100 * r['busy']:.1f}% | {r['tokens_per_s']:.1f} "
              "tokens/s", flush=True)
    print(f"[{card}] {label}: graphed prefill {graphed_prefill['ms']:.3f} ms "
          f"({graphed_prefill['device_ms']:.3f} device), eager "
          f"{prefill_ms:.3f}, beside {PREFILL_BEFORE_MS[label_key(label)]} "
          "eager before the capture (PERF.md section 5)", flush=True)
    if before_ms is not None:
        print(f"[{card}] {label}: decode {rows['graph']['decode_ms_per_step']:.3f}"
              f" ms a step graphed, beside {before_ms} before the decode "
              f"kernel and {DECODE_THREE_PASS_MS[label_key(label)]} on its "
              "three-pass design (PERF.md section 5)", flush=True)
    print(f"{label} greedy tokens: graph == eager ({b} x {n})", flush=True)
    del model, decoder
    release(torch)
    return rows


def check_prefill_replay(torch, label: str, model, decoder, prompt) -> dict:
    """The serving entry's prefill graph for ``prompt``'s length, replayed
    on ``prompt``, against an eager prefill on a cache of its own: every
    layer's K and V over the prompt, the position and the greedy first
    token to the bit; K1 launched 12 times and the LayerNorm forward
    :data:`LM_NORMS` times (24 folded) by the replay, counted through the
    capture's tally, the decode kernel never. Returns the graphed
    prefill's ms (CUDA events, median of 20) and device ms (the card held
    busy)."""
    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
    p = prompt.shape[1]
    graph = decoder.prefills[p]
    eager = model.new_cache(prompt.shape[0])
    want = model.prefill(prompt, eager).argmax(-1)
    zero_counts(fa)
    token = graph({"prompt": prompt}).clone()
    torch.cuda.synchronize()
    k1, ln = fa.flash_attention.launches, read_ln_counts()
    replays = decode_wrapper().launches
    same = (torch.equal(token, want) and int(decoder.cache.pos) == p
            and all(torch.equal(a[:, :p], w[:, :p]) for a, w in zip(
                decoder.cache.k + decoder.cache.v, eager.k + eager.v)))
    print(f"{label}: a replayed prefill against an eager one: cache, "
          f"position and first token the same bits {same}; launches K1 "
          f"{k1}, LayerNorm {ln[0]} ({ln[2]} folded), decode {replays}",
          flush=True)
    if not same:
        fail(f"{label}: the replayed prefill differs from the eager prefill")
    if (k1, ln[0], ln[2], replays) != (12, LM_NORMS, LM_NORMS - 1, 0):
        fail(f"{label}: a prefill replay launched K1 {k1}, LayerNorm "
             f"{ln[0]} ({ln[2]} folded), decode {replays} times, not 12, "
             f"{LM_NORMS} ({LM_NORMS - 1}) and 0")
    del eager
    replay = lambda: graph({"prompt": prompt})  # noqa: E731
    return {"ms": median_ms(torch, replay, iters=20),
            "device_ms": device_ms(torch, replay, iters=10, reps=5),
            "k1_launches": k1, "layer_norm_launches": ln[0],
            "folded_launches": ln[2], "bits_equal": same}


def norm_and_add_launches(kernels) -> tuple:
    """The LayerNorm kernels' launches and the bf16 elementwise adds'
    (torch's residual adds were ``CUDAFunctor_add<c10::BFloat16>``) in a
    profile's (name, us, launches) rows."""
    norms = sum(n for name, _, n in kernels
                if re.search(r"layer_norm_fwd_kernel", name))
    adds = sum(n for name, _, n in kernels
               if "CUDAFunctor_add<c10::BFloat16>" in name)
    return norms, adds


def label_key(label: str) -> str:
    """The serving label's key in ``DECODE_THREE_PASS_MS``."""
    return "moe" if "moe" in label.lower() else "generate"


def lm_model_flops(n_params: int, shape: dict, causal: bool,
                   num_layers: int) -> float:
    """Model FLOPs of a language model's training step at ``shape``: 6 N T
    plus the attention's 3 * 4 d b h per (query, key) pair the mask keeps,
    per layer (forward and backward), as :func:`lm_step_times` counts."""
    b, s, h, d = (shape[x] for x in "bshd")
    pairs = s * (s + 1) // 2 if causal else s * s
    return 6 * n_params * b * s + num_layers * 3 * 4 * d * b * h * pairs


def phase_resume(torch, fa, card, root: str):
    """Resume is exact: 12 steps in calls of 4 against 8 steps saved every 4
    and a fresh model and trainer that restore step 8 and train to 12, all
    from the seed-0 weights and the fused data seed. Each step's loss is
    written into a device buffer inside the step (so the captured step
    logs it too); the resumed run's K1-K3 and loss kernel launches are
    counted from 0. The model and loss are wired as the gpt job wires
    them."""
    from cron_operator_tpu_torch.models import GPT, GPTConfig
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    cfg, job_loss = lm_wiring(GPTConfig(max_len=1024))
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    sample = data.causal_token_sample(b, s, cfg.vocab_size)
    config = TrainConfig(save_every=4, steps_per_call=4)

    def make(store=None):
        model = GPT(cfg, device="cuda").init_weights(
            torch.Generator(device="cuda").manual_seed(0))
        log = torch.zeros(16, device="cuda")
        pos = torch.zeros((), dtype=torch.long, device="cuda")

        def loss_fn(out, y):
            loss = job_loss(out, y)
            log.index_put_((pos,), loss.detach())
            pos.add_(1)
            return loss

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = Trainer(model, config, loss_fn=loss_fn, sample_fn=sample,
                          checkpoint=store)
        torch.cuda.synchronize()
        return trainer, log, time.perf_counter() - t0

    def run(trainer, steps):
        ckpt = {}
        trainer.run(itertools.repeat({}), steps,
                    on_step=lambda st: ckpt.__setitem__(st.step, st.ckpt_s))
        torch.cuda.synchronize()
        return ckpt

    whole, whole_log, _ = make()
    run(whole, 12)
    store = CheckpointStore("default", "chip-smoke-resume", root=root)
    first, first_log, _ = make(store)
    t0 = time.perf_counter()
    ckpt = run(first, 8)
    first_wall = time.perf_counter() - t0
    store.close()
    if store.all_steps() != [4, 8]:
        fail(f"resume: saved steps {store.all_steps()}, not [4, 8]")
    if not torch.equal(first_log[:8], whole_log[:8]):
        fail("resume: the checkpointing run's losses differ from the "
             "uninterrupted run's")
    payload = Path(store.directory) / "8" / "state.pt"
    ckpt_bytes = payload.stat().st_size
    del first
    release(torch)

    store = CheckpointStore("default", "chip-smoke-resume", root=root)
    resumed, resumed_log, restore_s = make(store)
    if resumed.steps_done != 8:
        fail(f"resume: restored {resumed.steps_done} steps, not 8")
    zero_counts(fa)
    run(resumed, 12)
    counts, designs = read_counts(fa), read_designs(fa)
    check_xent("resume", "resume", read_xent_counts(), 4)
    check_ln("resume", "resume", read_ln_counts(), (4 * LM_NORMS,) * 2)
    store.close()
    print(f"resume: K1/K2/K3 launches on the resumed run {counts} (expected "
          f"48 each), by design {designs}", flush=True)
    if counts != (48,) * 3 or any(d["sm90"] != 48 for d in designs):
        fail(f"resume: flash launches {counts} by design {designs}, not 48 "
             "each, all sm90")
    same_losses = torch.equal(resumed_log[:4], whole_log[8:12])
    same_params = all(torch.equal(a, b_) for a, b_ in zip(
        whole.model.state_dict().values(), resumed.model.state_dict().values()))
    sw, sr = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    same_opt = sw["state"].keys() == sr["state"].keys() and all(
        torch.equal(v, sr["state"][i][k])
        for i, st in sw["state"].items() for k, v in st.items())
    steps_on_card = all(st["step"].is_cuda for st in sr["state"].values())
    same_gen = torch.equal(whole._data_gen.get_state(),
                           resumed._data_gen.get_state())
    print(f"resume: steps 9-12 losses {resumed_log[:4].tolist()} vs "
          f"{whole_log[8:12].tolist()}; losses equal {same_losses}, "
          f"parameters equal {same_params}, optimizer state equal "
          f"{same_opt} (step tensors on the card {steps_on_card}), data "
          f"generator state equal {same_gen}", flush=True)
    if not (same_losses and same_params and same_opt and steps_on_card
            and same_gen):
        fail("resume: the resumed run is not the uninterrupted run to the bit")
    row = {"save_ms_step4": ckpt[4] * 1e3, "save_ms_step8": ckpt[8] * 1e3,
           "restore_ms": restore_s * 1e3, "checkpoint_bytes": ckpt_bytes,
           "run8_with_saves_s": first_wall}
    print(f"[{card}] checkpoint of GPT-2 small + AdamW: {ckpt_bytes} bytes a "
          f"step | save stall (copy to pinned host memory, ckpt_s) step 4 "
          f"{row['save_ms_step4']:.1f} ms, step 8 {row['save_ms_step8']:.1f} "
          f"ms | restore (load from disk, copy into the trainer) "
          f"{row['restore_ms']:.1f} ms | 8 steps with 2 saves, the writes "
          f"drained: {first_wall:.2f} s", flush=True)
    del whole, resumed
    release(torch)
    return counts, row


RUNNER_JOB = "chip-smoke-gpt"
RUNNER_ARGS = ["gpt", "checkpoint=1", "save_every=4", "steps=16",
               "step_delay_s=0.2"]
FRAME_TYPES = {"progress", "spans", "error", "done"}  # the JAX runner's


def runner_frames(proc, on_frame=None):
    """The runner's ``@@CRON_TPU@@`` frames, read as they come;
    ``on_frame`` sees each one."""
    frames = []
    for line in proc.stdout:
        if line.startswith("@@CRON_TPU@@ "):
            frames.append(json.loads(line[len("@@CRON_TPU@@ "):]))
            if on_frame is not None:
                on_frame(frames[-1])
    return frames


def start_runner(root: str):
    """The runner in a subprocess, its stderr into a file under ``root``."""
    path = os.pathsep.join(p for p in (str(HERE), os.environ.get("PYTHONPATH"))
                           if p)
    env = dict(os.environ, PYTHONPATH=path, TPU_JOB_NAME=RUNNER_JOB,
               TPU_JOB_NAMESPACE="default", TPU_TRACE_ID="0c1a2b3c4d5e6f70")
    stderr_path = os.path.join(root, "runner.stderr")
    with open(stderr_path, "w") as stderr:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cron_operator_tpu_torch.workloads.runner",
             *RUNNER_ARGS, f"checkpoint_dir={root}"],
            cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=stderr,
            text=True)
    proc.stderr_path = stderr_path
    return proc


def finish(proc, timeout: float = 300):
    """Waits for the runner (killing it past ``timeout``): its exit code and
    the end of its stderr."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, Path(proc.stderr_path).read_text()[-3000:]


def phase_runner(root: str):
    """The port runner on the card, stopped by SIGTERM once 4 steps are
    done, then run again to its end: it must resume from the last save.
    Returns the step it stopped at, the lineage's last step (16) and the
    seconds from the signal to the stopped runner's exit."""
    proc = start_runner(root)
    signalled = []
    try:
        def stop_at_4(frame):
            if (frame["type"] == "progress" and not signalled
                    and frame["progress"].get("steps_done", 0) >= 4):
                proc.send_signal(signal.SIGTERM)
                signalled.append(time.monotonic())

        frames = runner_frames(proc, stop_at_4)
    finally:
        code, err = finish(proc)
    stop_s = time.monotonic() - signalled[0] if signalled else math.nan
    done = frames[-1] if frames else {}
    print(f"runner: SIGTERM run exit {code} {stop_s:.2f} s after the signal, "
          f"frames {[f['type'] for f in frames]}, done steps "
          f"{done.get('progress', {}).get('steps_done')}, cancelled "
          f"{done.get('cancelled')}", flush=True)
    if code != 0 or done.get("type") != "done" or done.get("cancelled") is not True:
        fail(f"runner: the SIGTERM run did not stop gracefully (exit {code}):"
             f" {err}")
    steps = sorted(int(p.name) for p in Path(root, "default", RUNNER_JOB)
                   .iterdir() if p.name.isdigit())
    stopped = done["progress"]["steps_done"]
    if not steps or steps[-1] != stopped or stopped >= 16:
        fail(f"runner: stopped at {stopped} with saved steps {steps}")

    proc = start_runner(root)
    try:
        frames = runner_frames(proc)
    finally:
        code, err = finish(proc)
    types = [f["type"] for f in frames]
    progress = frames[-1]["progress"] if frames else {}
    print(f"runner: rerun exit {code}, frames {types}, resumed_from_step "
          f"{progress.get('resumed_from_step')}, steps_done "
          f"{progress.get('steps_done')}, last_loss "
          f"{progress.get('last_loss')}, tokens/s "
          f"{progress.get('tokens_per_s')}", flush=True)
    if code != 0 or not types or types[-1] != "done" or "error" in types \
            or not set(types) <= FRAME_TYPES or "spans" not in types:
        fail(f"runner: the rerun failed (exit {code}, frames {types}): "
             f"{err}")
    if (progress.get("resumed_from_step") != stopped
            or progress.get("steps_done") != 16
            or frames[-1]["cancelled"] is not False
            or not math.isfinite(progress.get("last_loss", math.nan))):
        fail(f"runner: the rerun did not resume from step {stopped} to 16: "
             f"{progress}")
    return stopped, 16, stop_s


def phase_serve_checkpoint(torch, fa, root: str, step: int):
    """``generate_job checkpoint_from`` the runner's lineage, whose newest
    step is ``step``, with K1's count set to 0 just before and read just
    after; its greedy tokens
    against a GPT built here from the checkpoint's f32 parameters (eager
    decode) on the prompts the job drew."""
    from cron_operator_tpu_torch.backends.registry import JobContext
    from cron_operator_tpu_torch.models import GPT, GPTConfig
    from cron_operator_tpu_torch.workloads import entrypoints
    from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore
    from cron_operator_tpu_torch.workloads.generate import generate

    served = []

    def spy(cfg, model, prompt, max_new, **kw):
        out = generate(cfg, model, prompt, max_new, **kw)
        served.append((prompt.clone(), out.clone()))
        return out

    params = {"seq_len": "1024", "prompt_len": "512", "max_new": "64",
              "batch_size": "8", "rounds": "2", "checkpoint_from": RUNNER_JOB,
              "checkpoint_dir": root}
    ctx = JobContext("chip-smoke-serve", "default", {}, params)
    entrypoints.generate, real = spy, entrypoints.generate
    try:
        zero_counts(fa)
        entrypoints.generate_job(ctx)
        torch.cuda.synchronize()
        counts, designs = read_counts(fa), read_designs(fa)
        decode_launches = decode_wrapper().launches
        check_ln("serve", "serve_checkpoint", read_ln_counts(),
                 (LM_NORMS * 2 * 64, 0))
    finally:
        entrypoints.generate = real
    progress = ctx.progress
    print(f"serve: {progress}; K1/K2/K3 launches {counts} (expected 24/0/0, "
          f"all sm90: {designs[0]}); decode_attention {decode_launches} "
          "(expected 12 x 63 x 2)", flush=True)
    if decode_launches != 12 * 63 * 2:
        fail(f"serve: the decode kernel launched {decode_launches} times, "
             "not 12 in each of 2 x 63 decode steps")
    check_decode_design("serve", decode_launches)
    if progress.get("restored_from_step") != step:
        fail(f"serve: restored_from_step {progress.get('restored_from_step')}"
             f", not {step}")
    if counts != (24, 0, 0) or designs[0]["sm90"] != 24:
        fail(f"serve: flash launches {counts}, not 12 in each round's prefill")
    cfg = GPTConfig(max_len=1024)
    model = GPT(cfg, device="cuda")  # f32 masters, cast at use
    store = CheckpointStore("default", RUNNER_JOB, root=root, create=False)
    model.load_state_dict(store.restore_params(step))
    store.close()
    model.eval()
    with torch.inference_mode():
        for i, (prompt, out) in enumerate(served):
            want = generate(cfg, model, prompt, 64, captured=False)
            if not (out.shape == (8, 576) and torch.equal(out, want)):
                fail(f"serve: round {i}'s greedy tokens differ from the "
                     "checkpoint's in-process model")
    print(f"serve: {len(served)} rounds x 8 x 64 greedy tokens equal the "
          "in-process model's", flush=True)
    del model
    release(torch)
    return counts, decode_launches


MFU_PARAMS = {**TRAIN_PARAMS, "steps": "24", "mfu": "1",
              "flops_accounting": "1"}


def phase_mfu(torch, card, root: str):
    """``gpt mfu=1 flops_accounting=1`` against this script's FLOPs, over
    the job's own steady-state step time; then a profiled run."""
    from cron_operator_tpu_torch.backends.registry import JobContext
    from cron_operator_tpu_torch.workloads import entrypoints

    ctx = JobContext("chip-smoke-mfu", "default", {}, dict(MFU_PARAMS))
    entrypoints.gpt(ctx)
    p = ctx.progress
    flops = lm_model_flops(GPT2_SMALL_PARAMS, TRAIN_SHAPE, True, 12)
    mfu = flops / (p["avg_step_time_s"] * BF16_FLOPS)
    print(f"[{card}] mfu: job {p.get('mfu')} vs script {mfu:.4f} over "
          f"{p['avg_step_time_s']} s/step | xla_flops_per_step "
          f"{p.get('xla_flops_per_step')} vs script {flops:.6e} "
          f"({p.get('xla_flops_per_step', 0) / flops - 1:+.4%})", flush=True)
    if not (p.get("mfu") and abs(p["mfu"] / mfu - 1) <= 0.03):
        fail(f"mfu: the job's {p.get('mfu')} is not within 3% of {mfu:.4f}")
    if abs(p.get("xla_flops_per_step", 0) / flops - 1) > 0.01:
        fail(f"mfu: xla_flops_per_step {p.get('xla_flops_per_step')} is not "
             f"within 1% of {flops:.6e}")

    prof_dir = os.path.join(root, "profile")
    ctx = JobContext("chip-smoke-profile", "default", {},
                     {**TRAIN_PARAMS, "steps": "3", "profile_dir": prof_dir})
    entrypoints.gpt(ctx)
    trace = ctx.progress.get("profile_trace")
    print(f"profile: steps_per_call {ctx.progress['steps_per_call']}, trace "
          f"{trace}, error {ctx.progress.get('profile_error')}", flush=True)
    if not trace or "flash_fwd_sm90_kernel" not in Path(trace).read_text():
        fail("profile: no trace naming the sm90 K1 kernel")
    return {"mfu_job": p["mfu"], "mfu_script": mfu,
            "flops_job": p["xla_flops_per_step"], "flops_script": flops,
            "avg_step_time_s": p["avg_step_time_s"]}


def moe_cfg(**over):
    """GPT-2 small with the Switch-MoE params of ``MOE_PARAMS``."""
    from cron_operator_tpu_torch.models import GPTConfig

    return GPTConfig(max_len=1024, moe_every=int(MOE_PARAMS["moe_every"]),
                     num_experts=int(MOE_PARAMS["num_experts"]), **over)


@contextlib.contextmanager
def dense_moe():
    """The MoE GPT's FFN on the dense one-hot formulation
    (``moe_ffn_reference``, the plain version of the index path) while the
    context is open, swapped in as ``recorded_routes`` swaps the router."""
    gpt = importlib.import_module("cron_operator_tpu_torch.models.gpt")
    moe = importlib.import_module("cron_operator_tpu_torch.parallel.moe")
    gpt.moe_ffn = moe.moe_ffn_reference
    try:
        yield
    finally:
        gpt.moe_ffn = moe.moe_ffn


def same_bits(torch, a, b) -> bool:
    """Whether ``a`` and ``b`` hold the same bits."""
    kind = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(kind), b.view(kind))


def check_moe_index_path(torch, card, cfg, shape: dict) -> dict:
    """``moe_ffn`` (dispatch and combine gathered by token index) against
    ``moe_ffn_reference`` (the dense ``[T, E, C]`` one-hot products) on the
    card at one MoE layer of the training step: T = b s tokens, GPT-2
    small's widths, the config's experts and capacity factor, bf16 over
    f32 parameters, real routes from seeded weights. The output, dX
    through the dispatch (both paths given detached logits) and the
    experts' gradients must be the same bits, the router's gradient within
    ``MOE_ROUTER_GRAD_REL`` of its largest entry (the dense path rounds
    each gate's gradient to bf16), and a rerun of the index path
    bit-identical. Then the device ms of dispatch and combine with their
    routing, forward and backward, on each path, and of the whole layer
    on each."""
    moe = importlib.import_module("cron_operator_tpu_torch.parallel.moe")
    t, d, e = shape["b"] * shape["s"], cfg.hidden_size, cfg.num_experts
    factor = cfg.moe_capacity_factor
    c = moe._capacity(t, e, factor)
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = moe.init_moe_params(gen, d_model=d, d_ff=cfg.mlp_dim,
                                 n_experts=e)
    x = torch.randn(t, d, generator=gen, device="cuda").bfloat16()

    def run(fn, detached=False):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        xl = x.clone().requires_grad_()
        real = moe.router_top1_indices
        if detached:
            moe.router_top1_indices = lambda lg, cap: real(lg.detach(), cap)
        try:
            y, aux = fn(leaves, xl, capacity_factor=factor,
                        compute_dtype=torch.bfloat16)
            ((y.float() ** 2).mean() + 0.01 * aux).backward()
        finally:
            moe.router_top1_indices = real
        return y.detach(), xl.grad, {k: v.grad for k, v in leaves.items()}

    index, dense = run(moe.moe_ffn), run(moe.moe_ffn_reference)
    again = run(moe.moe_ffn)
    dx_index = run(moe.moe_ffn, True)[1]
    dx_dense = run(moe.moe_ffn_reference, True)[1]
    _, slot, _, _ = moe.router_top1_indices(x.float() @ params["router"], c)
    kept = int((slot < c).sum())
    router_err = ((index[2]["router"] - dense[2]["router"]).abs().max()
                  / dense[2]["router"].abs().max()).item()
    checks = {
        "y": same_bits(torch, index[0], dense[0]),
        "dX through the dispatch": same_bits(torch, dx_index, dx_dense),
        "wi grad": same_bits(torch, index[2]["wi"], dense[2]["wi"]),
        "wo grad": same_bits(torch, index[2]["wo"], dense[2]["wo"]),
        "rerun": same_bits(torch, again[0], index[0]) and same_bits(
            torch, again[1], index[1]) and all(
                same_bits(torch, again[2][k], index[2][k]) for k in params),
        "router grad": router_err <= MOE_ROUTER_GRAD_REL,
    }
    print(f"moe index path vs dense (T {t}, E {e}, C {c}, d {d}, bf16; "
          f"{kept} tokens kept): " + ", ".join(
              f"{k} {'ok' if v else 'DIFFERS'}" for k, v in checks.items())
          + f" (router grad max err {router_err:.3e} of its largest entry, "
          f"at most {MOE_ROUTER_GRAD_REL:.3e})", flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"moe: the index path differs from the dense one in {bad}")
    del index, dense, again, dx_index, dx_dense
    release(torch)

    # dispatch and combine with their routing, forward and backward, from
    # the f32 logits, bf16 x and a bf16 expert output (the expert products
    # between them are the same on both paths)
    logits = (x.float() @ params["router"]).requires_grad_()
    xg = x.clone().requires_grad_()
    expert_out = torch.randn(e, c, d, generator=gen, device="cuda",
                             dtype=torch.bfloat16).requires_grad_()
    d_in = torch.randn(e, c, d, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    d_y = torch.randn(t, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    leaves = [xg, expert_out, logits]

    def index_pass():
        experts, slot, gate, _ = moe.router_top1_indices(logits, c)
        dest, src = moe.slot_indices(experts, slot, c, e)
        expert_in = moe._Dispatch.apply(xg, src, dest, e)
        y = moe._Combine.apply(expert_out, gate, src, dest)
        torch.autograd.grad([expert_in, y], leaves, [d_in, d_y])

    def dense_pass():
        combine, dispatch, _ = moe.router_top1(logits, c)
        dispatch, combine = dispatch.bfloat16(), combine.bfloat16()
        expert_in = torch.matmul(dispatch.permute(1, 2, 0), xg)
        y = torch.matmul(combine.reshape(t, e * c), expert_out.reshape(e * c, d))
        torch.autograd.grad([expert_in, y], leaves, [d_in, d_y])

    def layer(fn):
        def go():
            leaves_ = {k: v.detach().requires_grad_() for k, v in
                       params.items()}
            xl = x.detach().requires_grad_()
            y, aux = fn(leaves_, xl, capacity_factor=factor,
                        compute_dtype=torch.bfloat16)
            torch.autograd.grad((y.float() ** 2).mean() + 0.01 * aux,
                                [*leaves_.values(), xl])
        return go

    ms = {}
    for name, fn in (("index", index_pass), ("dense", dense_pass),
                     ("dense", dense_pass), ("index", index_pass)):
        ms.setdefault(name, []).append(device_ms(torch, fn, iters=10, reps=3))
    ms = {k: min(v) for k, v in ms.items()}
    layer_ms = {"index": device_ms(torch, layer(moe.moe_ffn), iters=10,
                                   reps=3),
                "dense": device_ms(torch, layer(moe.moe_ffn_reference),
                                   iters=10, reps=3)}
    print(f"[{card}] moe dispatch + combine with routing, forward and "
          f"backward, one layer (device ms): index {ms['index']:.4f}, dense "
          f"{ms['dense']:.4f} ({5 * 2 * t * e * c * d / 1e9:.1f} GFLOP of "
          f"one-hot products) | the whole layer, forward and backward: index "
          f"{layer_ms['index']:.4f}, dense {layer_ms['dense']:.4f}",
          flush=True)
    return {"dispatch_combine_ms": ms, "layer_ms": layer_ms, "kept": kept,
            "capacity": c, "router_grad_err": router_err}


def graphed_runs(torch, paths, make_trainer, context=None):
    """The graphed step of ``make_trainer(path)`` for each of ``paths`` in
    turn (for instance A, B, B, A), each on a fresh trainer (inside
    ``context(path)`` where given): the peak memory of its first graphed
    call (the warm-up step, the capture and 7 replays), then the ms a step
    of a graphed call (CUDA events, median of 3) and its device ms (the
    card held busy). Returns every reading by path and each path's faster
    one."""
    k = GRAPH_CHUNK
    rows = {}
    for path in paths:
        with context(path) if context else contextlib.nullcontext():
            release(torch)
            torch.cuda.reset_peak_memory_stats()
            trainer = make_trainer(path)
            trainer.step({}, chunk=k)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()

            def graph():
                trainer.step({}, sync=False, chunk=k)

            step = median_ms(torch, graph, iters=1, reps=3, warmup=1) / k
            device = device_ms(torch, graph, iters=1, reps=3) / k
            del trainer
            release(torch)
        rows.setdefault(path, []).append(
            {"step_ms": step, "device_ms": device, "peak_bytes": peak})
    return rows, {p: min(r, key=lambda row: row["step_ms"])
                  for p, r in rows.items()}


def moe_step_ab(torch, card, make_trainer) -> dict:
    """The graphed MoE step on the index path and with the dense one-hot
    formulation swapped in (``dense_moe``), in turns index, dense, dense,
    index (:func:`graphed_runs`). Each path keeps its faster reading."""
    rows, best = graphed_runs(
        torch, ("index", "dense", "dense", "index"),
        lambda path: make_trainer(),
        lambda path: dense_moe() if path == "dense" else
        contextlib.nullcontext())
    print(f"[{card}] moe step A/B (graphed, index/dense/dense/index): "
          + " | ".join(f"{p} " + ", ".join(
              f"{r['step_ms']:.3f} ms ({r['device_ms']:.3f} device, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB)" for r in rs)
              for p, rs in rows.items())
          + f" | index/dense {best['index']['step_ms'] / best['dense']['step_ms']:.4f}"
          f" | beside {MOE_ONEHOT['step_ms']} ms and "
          f"{MOE_ONEHOT['peak_gib']} GiB on the one-hot products (PERF.md "
          "section 5)", flush=True)
    return {"runs": rows, "best": best}


def phase_moe_train(torch, fa, card):
    """Switch-MoE training at GPT-2 small width: the job (K1-K3 120 each,
    all sm90), the kernel path against the plain path and f32 with route
    flips counted, peak memory, the graph against the eager step, MFU over
    the counted and over the active FLOPs; the index dispatch and combine
    against the dense one-hot formulation at one layer (bits, device ms)
    and the graphed step on each path in one process."""
    from cron_operator_tpu_torch.models import GPT
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    counts, progress = phase_job(torch, fa, "gpt", MOE_TRAIN_PARAMS, 12,
                                 n_params=GPT2_SMALL_MOE_PARAMS,
                                 xent_path="moe")
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    cfg = moe_cfg()
    phase_train_correctness(
        torch, GPT, cfg, data.device_causal_token_batches(
            b, s, cfg.vocab_size, device="cuda", seed=5), "moe train")
    sample = data.causal_token_sample(b, s, cfg.vocab_size)
    wired, loss_fn = lm_wiring(cfg)

    def make_trainer():
        model = GPT(wired, device="cuda").init_weights(
            torch.Generator(device="cuda").manual_seed(0))
        return Trainer(model, TrainConfig(aux_loss_in_output=True),
                       loss_fn=loss_fn, sample_fn=sample)

    # Peak memory (everything allocated: parameters, grads, AdamW state,
    # activations): an eager step after a first one, and a fresh trainer's
    # first graphed call (the warm-up step, the capture and 7 replays).
    trainer = make_trainer()
    trainer.step({})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.step({})
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()
    counted = trainer.flops_per_step()
    del trainer
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    trainer = make_trainer()
    trainer.step({}, chunk=GRAPH_CHUNK)
    torch.cuda.synchronize()
    graph_peak = torch.cuda.max_memory_allocated()
    del trainer
    release(torch)
    if not counted:
        fail("moe train: Trainer.flops_per_step counted nothing")
    n_moe = cfg.num_layers // cfg.moe_every
    n_active = GPT2_SMALL_MOE_PARAMS - n_moe * (cfg.num_experts - 1) * (
        2 * cfg.hidden_size * cfg.mlp_dim)
    active = lm_model_flops(n_active, TRAIN_SHAPE, True, cfg.num_layers)
    print(f"[{card}] moe train: peak memory {eager_peak / 2**30:.2f} GiB "
          f"(eager step), {graph_peak / 2**30:.2f} GiB (first graphed call; "
          f"{MOE_ONEHOT['peak_gib']} on the one-hot products) | counted "
          f"FLOPs/step {counted / 1e12:.4f} T (FlopCounterMode; "
          f"{MOE_ONEHOT['counted_tflop']} with the one-hot products) | active "
          f"{active / 1e12:.4f} T (6 N T over {n_active} active parameters + "
          f"attention; {MOE_ONEHOT['active_tflop']} before) | counted/active "
          f"{counted / active:.4f}", flush=True)
    step = graph_vs_eager(
        torch, card, f"moe train step (GPT-2 small, moe_every 2, 8 experts, "
        f"b{b} s{s}, bf16/f32 masters, AdamW)", make_trainer, counted,
        b * s, "tokens", BEFORE_MS["moe"], {**UNALIGNED_GEMM, **OUTER_SCAN},
        LM_SHARES)
    layer = check_moe_index_path(torch, card, cfg, TRAIN_SHAPE)
    ab = moe_step_ab(torch, card, make_trainer)
    per_step = {k: n_moe * v for k, v in layer["dispatch_combine_ms"].items()}
    share = per_step["index"] / step["device_ms"]
    active_mfu = active / (step["graph"]["step_ms"] / 1e3 * BF16_FLOPS)
    print(f"[{card}] moe dispatch + combine x{n_moe} layers: index "
          f"{per_step['index']:.3f} ms of {step['device_ms']:.3f} ms device a "
          f"step ({100 * share:.1f}%), dense {per_step['dense']:.3f} | graphed "
          f"step {step['graph']['step_ms']:.3f} ms beside "
          f"{MOE_ONEHOT['step_ms']} | MFU over active FLOPs (graph) "
          f"{active_mfu:.4f}", flush=True)
    return counts, {
        **step, "eager_peak_bytes": eager_peak, "graph_peak_bytes": graph_peak,
        "counted_flops_per_step": counted, "active_flops_per_step": active,
        "active_mfu_graph": active_mfu, "index_vs_dense": layer,
        "dispatch_combine_ms_per_step": per_step,
        "dispatch_combine_share": share, "step_ab": ab,
        "job_tokens_per_s": progress["tokens_per_s"],
        "job_avg_step_time_s": progress["avg_step_time_s"],
        "job_first_step_s": progress["compile_time_s"],
    }


def phase_moe_serving(torch, fa, card):
    """Switch-MoE serving: ``generate_job`` at the slice's shape; eager
    prefill on the index and the dense path in turns, and the greedy tokens
    of each (equal: the forward is the same bits); the decode graph against
    the eager loop; then the cached greedy decode against a
    full-forward rerun (the oracle of the JAX package's MoE decode test) at
    full width with capacity factor 8: no token is dropped on either path,
    and in f32 neither rounding nor a route flips a greedy token."""
    from cron_operator_tpu_torch.models import GPT

    serving = importlib.import_module("cron_operator_tpu_torch.workloads.generate")
    launches, decode_launches, progress = phase_slice(
        torch, fa, MOE_SLICE_PARAMS, GPT2_SMALL_MOE_PARAMS, "moe serving",
        "moe_serve")
    cfg = moe_cfg()
    model = slice_model(torch, cfg)
    prompt = torch.randint(0, cfg.vocab_size, (8, 512), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))
    # eager prefill is host-bound: its wall ms follows the host's load
    # (8-23 ms on either path in one call), and so does a device time taken
    # with the card held busy, whose hold the enqueue can outlast. Each
    # path's kernel time from a profile (the sum of its kernels' device
    # time) is read beside it.
    prefill, prefill_kernels = {}, {}
    with torch.inference_mode():
        cache = model.new_cache(8)

        def prefill_call():
            model.prefill(prompt, cache)

        for path in ("index", "dense", "dense", "index"):
            with dense_moe() if path == "dense" else contextlib.nullcontext():
                prefill.setdefault(path, []).append(
                    median_ms(torch, prefill_call, iters=3))
                prefill_kernels.setdefault(path, []).append(profile_window(
                    torch, card, f"moe prefill ({path})", prefill_call)[1])
        del cache
    prefill_ms = min(prefill["index"])
    # greedy tokens on each path, eager (a captured decode step is kept per
    # model and would replay the first path's kernels)
    tokens = {}
    for path in ("index", "dense"):
        with dense_moe() if path == "dense" else contextlib.nullcontext():
            tokens[path] = serving.generate(cfg, model, prompt[:, :128], 16,
                                            captured=False)
    same = torch.equal(tokens["index"], tokens["dense"])
    print(f"[{card}] moe prefill (b8 p512, eager; index/dense/dense/index): "
          + " | ".join(f"{p} " + ", ".join(
              f"{v:.3f} ({d:.3f} in kernels)" for v, d in zip(
                  vs, prefill_kernels[p])) for p, vs in prefill.items())
          + f" ms, beside {MOE_ONEHOT['prefill_ms']} on the one-hot products"
          f" | greedy tokens (b8 p128 +16, eager) index "
          f"{'==' if same else '!='} dense", flush=True)
    if not same:
        fail("moe serving: the index path's greedy tokens differ from the "
             "dense path's")
    del model
    release(torch)
    rows = phase_serving_graph(torch, card, prefill_ms, cfg, "moe generate",
                               BEFORE_MS["moe decode"])

    ocfg = moe_cfg(moe_capacity_factor=8.0, dtype=torch.float32)
    model = GPT(ocfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(0)).eval()
    prompt = torch.randint(0, ocfg.vocab_size, (8, 128), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4))
    margin = math.inf
    with torch.inference_mode():
        out = serving.generate(ocfg, model, prompt, 8)
        seq = prompt
        for _ in range(8):
            logits, _ = model(seq)
            top2 = logits[:, -1].topk(2).values
            margin = min(margin, (top2[:, 0] - top2[:, 1]).min().item())
            seq = torch.cat([seq, logits[:, -1].argmax(-1, keepdim=True)], 1)
    same = torch.equal(out, seq)
    print(f"moe oracle (f32, capacity factor 8, b8 p128 +8): cached decode "
          f"{'==' if same else '!='} full-forward rerun; smallest greedy "
          f"top-2 logit margin {margin:.5f}", flush=True)
    if not same:
        fail("moe serving: cached greedy decode differs from the full "
             "forward at no-drop capacity")
    del model
    release(torch)
    print(f"[{card}] moe serving: prefill {prefill_ms:.3f} ms (b8 p512) | "
          f"decode {rows['graph']['decode_ms_per_step']:.3f} ms/step graph "
          f"(beside {MOE_ONEHOT['decode_ms']} on the one-hot products), "
          f"{rows['eager']['decode_ms_per_step']:.3f} eager | "
          f"{rows['graph']['tokens_per_s']:.1f} tokens/s graph | job "
          f"{progress['tokens_per_s']} tokens/s", flush=True)
    return launches, decode_launches, {
        "prefill_ms": prefill_ms, "prefill_ms_by_path": prefill,
        "prefill_kernel_ms_by_path": prefill_kernels,
        "job_tokens_per_s": progress["tokens_per_s"],
        "oracle_margin": margin, **rows}


# Phase 15: the device mesh on one card. Two ranks share cuda:0 in a gloo
# process group (NCCL refuses two ranks on one device), each calls the gpt
# entrypoint at GPT-2 small width, b 8 x 1024, AdamW, data=host, 3 steps.
MESH_PARAMS = {"size": "base", "batch_size": "8", "seq_len": "1024",
               "steps": "3", "data": "host", "steps_per_call": "1"}
MESH_STRATEGIES = {
    # name: (strategy params, K1-K3's local (batch, heads) on each rank)
    "data": ({"devices": "2"}, (4, 12)),
    "fsdp": ({"fsdp": "2"}, (4, 12)),
    "tensor": ({"tensor": "2"}, (8, 6)),
    "expert": ({**MOE_PARAMS, "expert": "2"}, (8, 12)),
}
# Strategies this phase leaves out, and why: under torch 2.11 (the
# card's), gloo's functional all-gather of CUDA tensors
# (_c10d_functional.all_gather_into_tensor, then wait_tensor, which
# DTensor's redistributions call) ends the process with SIGSEGV, and the plain
# dist.all_gather_into_tensor of the same tensors works. data trains under
# DDP, which needs only all-reduce; tensor and expert train on the plain
# path too (DDP over a batch group of one rank): tensor's blocks sum their
# partial products and their inputs' gradients by in-place all-reduces,
# expert's MoE blocks gather their experts' outputs by the plain
# all-gather, and the pieces are gathered for the update distance the
# same way. fsdp trains under FSDP2, whose all-gathers and reduce-scatters
# of CUDA tensors over gloo no run has tried (hack/torch_mesh_cards.py
# runs it over NCCL). The CPU tests train all four in gloo worlds.
MESH_LEFT_OUT = {"fsdp": "FSDP2's collectives of CUDA tensors over gloo "
                         "(untried; over NCCL on several cards)"}
# The path each strategy's trainer takes (``trainer_path``)
MESH_PATHS = {"data": "ddp", "fsdp": "fsdp", "tensor": "ddp",
              "expert": "ddp"}
# Every check of a mesh run holds it against a one-rank run of the same
# global batches (the reference), on two readings:
# - the per-step loss gap. Sound runs differ by bf16 products whose row
#   blocks and partial sums round in another order (and, under expert, by
#   top-1 routes that a near tie flips); a run whose parameters never move
#   differs by the training's own descent. MESH_FROZEN_PARAMS runs the
#   reference at lr 0, and the check fails unless that reading lies above
#   the bound, so the bound is shown to catch it in every run.
# - the update distance |d_mesh - d_ref| / |d_ref|, where d is the change
#   of every parameter over the run, gathered whole on rank 0: 1 exactly
#   for parameters that never move, and far from 0 when a rank applies
#   gradients of its own rows alone.
MESH_LOSS_BOUND = 2e-3
MESH_UPDATE_BOUND = 0.25
GPT2_VOCAB = 50257
MESH_FROZEN_PARAMS = {"lr": "0"}
MESH_STEPS = int(MESH_PARAMS["steps"])
MESH_LAYERS = 12  # GPT-2 small: one K1, K2 and K3 launch a layer and step


class LossLog(dict):
    """A job's progress that keeps every ``last_loss`` published."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def __setitem__(self, key, value):
        if key == "last_loss":
            self.losses.append(value)
        super().__setitem__(key, value)


def run_gpt(torch, params: dict, delta_out: str, profile: bool = False,
            job: str = "gpt", readings=None):
    """The ``job`` entrypoint (``gpt`` or ``bert``) on ``params`` in this
    process (a rank of the process group when there is one), with every
    kernel count set to 0 just before and read just after, and the (batch,
    heads) of each launch. Writes to ``delta_out`` (on rank 0; every rank
    gathers) the change of every parameter over the run, whole, f32.
    ``profile`` runs one more step of the same batch size under
    ``profile_window`` (every rank) and keeps what it printed;
    ``readings(trainer, batch)`` adds its dict to the result. Returns the
    counts (and the loss kernels' under ``xent``, the LayerNorm kernels'
    under ``layer_norm``), designs, shapes, the loss forward kernel's
    ``[rows, columns, real columns, first column]`` (``xent_shapes``),
    K1-K3's launches ``[full, causal]`` by mask (``by_mask``), per-step
    losses, step s, tokens/s, the peak memory in GiB, the trainer's path
    (:func:`trainer_path`), the attention impl and mask, and the ``seq``
    axis's size and this rank's coordinate on it (and the profile)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
    from cron_operator_tpu_torch.backends.registry import JobContext
    from cron_operator_tpu_torch.parallel.mesh import tensor_parallel
    from cron_operator_tpu_torch.workloads import data, entrypoints

    def whole(t, split=None, name=None):
        """``t`` whole, f32 on the host: a DTensor's full tensor, and a
        piece of a parameter split over ``tensor`` or ``expert`` gathered
        over its group (a collective: every rank calls it; on the host over
        gloo)."""
        t = t.detach()
        t = t.full_tensor() if isinstance(t, DTensor) else t
        if split is not None and name in split.splits:
            on_host = dist.get_backend(split.group_of(name)) == "gloo"
            t = split.gather(name, t.cpu() if on_host else t)
        return t.to("cpu", torch.float32, copy=True)

    shapes, made, xent_shapes = set(), [], set()
    xent = importlib.import_module("cron_operator_tpu_torch.ops.xent")
    xent_launch = xent._launch_forward

    def xent_traced(logits, labels, vocab, *slice_of):
        xent_shapes.add((*logits.shape, vocab, *(slice_of[:1] or (0,))))
        return xent_launch(logits, labels, vocab, *slice_of)

    launchers = {a: getattr(fa, a) for a in ("_launch", "_launch_dq",
                                             "_launch_dkv")}
    by_mask = {a: [0, 0] for a in launchers}  # [full, causal] launches
    real_trainer = entrypoints.Trainer

    def trainer(model, *args, **kw):
        start = {n: whole(p) for n, p in model.named_parameters()}
        made.append((real_trainer(model, *args, **kw), start))
        return made[-1][0]

    for attr, inner in launchers.items():
        def traced(q, *args, _inner=inner, _name=attr):
            shapes.add((_name, q.shape[0], q.shape[2]))
            by_mask[_name][int(bool(args[-1]))] += 1  # causal: the last
            return _inner(q, *args)
        setattr(fa, attr, traced)
    entrypoints.Trainer = trainer
    xent._launch_forward = xent_traced
    try:
        ctx = JobContext("chip-smoke-mesh", "default", {}, params,
                         progress=LossLog())
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fa)
        getattr(entrypoints, job)(ctx)
        torch.cuda.synchronize()
        result = {"counts": read_counts(fa), "designs": read_designs(fa),
                  "xent": read_xent_counts(),
                  "layer_norm": read_ln_counts(),
                  "shapes": sorted(shapes),
                  "xent_shapes": sorted(map(list, xent_shapes)),
                  "losses": ctx.progress.losses,
                  "by_mask": [by_mask[a] for a in launchers],
                  "step_s": ctx.progress["avg_step_time_s"],
                  "tokens_per_s": ctx.progress["tokens_per_s"],
                  "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    finally:
        entrypoints.Trainer = real_trainer
        xent._launch_forward = xent_launch
        for attr, inner in launchers.items():
            setattr(fa, attr, inner)
    tr, start = made[0]
    sizes = dict(zip(tr.mesh.mesh_dim_names, tr.mesh.shape)) if (
        tr.mesh is not None) else {}
    result.update(path=trainer_path(tr), impl=tr.model.config.attention_impl,
                  causal=job == "gpt", seq_size=sizes.get("seq", 1),
                  seq_coord=(tr.mesh.get_local_rank("seq")
                             if sizes.get("seq", 1) > 1 else 0))
    split = tensor_parallel(tr.model)
    delta = {n: whole(p, split, n) - start[n]
             for n, p in tr.model.named_parameters()}
    if not dist.is_initialized() or dist.get_rank() == 0:
        torch.save(delta, delta_out)
    del delta, start
    stream = data.token_batches if job == "bert" else data.causal_token_batches
    batch = next(stream(int(params["batch_size"]), int(params["seq_len"]),
                        tr.model.config.vocab_size))
    if readings is not None:
        result.update(readings(tr, batch))
    if profile:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            profile_window(torch, card_line(), "one mesh step",
                           lambda: tr.step(batch))
        result["profile"] = text.getvalue()
    return result


def tensor_xent_shape(rows: int, t: int, index: int) -> list:
    """The loss forward kernel's ``[rows, columns, real columns, first
    column]`` on the rank of ``tensor`` index ``index`` among ``t``: its
    block of GPT-2 small's vocab rows, the vocab rounded up to a multiple
    of 64 t and cut in t equal blocks (25152 a rank at t 2, rank 1's 25105
    of them real), counted here apart from the port's rule
    (``models.layers.vocab_split``)."""
    per = -(-GPT2_VOCAB // (64 * t)) * 64
    lo = index * per
    return [rows, per, max(0, min(per, GPT2_VOCAB - lo)), lo]


def trainer_path(tr) -> str:
    """How a Trainer holds its model: ``one`` (no mesh), ``fsdp`` (FSDP2),
    ``dtensor`` (placed parameters) or ``ddp`` (plain parameters under
    DDP)."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    if tr.mesh is None:
        return "one"
    if isinstance(tr.model, FSDPModule):
        return "fsdp"
    if any(isinstance(p, DTensor) for p in tr.model.parameters()):
        return "dtensor"
    return "ddp"


def mesh_rank(rank: int, world: int, local_rank: int, backend: str,
              port: int, task: str, params: dict, out: str,
              profile: bool) -> None:
    """One rank of a mesh run (``chip_smoke.py --mesh-rank``): joins a
    process group of ``world`` ranks over ``backend`` on
    ``cuda:local_rank`` (none for a gloo world of one; NCCL's asynchronous
    error handling off, which a captured step needs), runs ``task``
    (``gpt`` or ``bert``: :func:`run_gpt` of that job, with the sequence
    readings under ``seq``; ``pipeline``: :func:`run_pipeline` over
    ``world`` stages; ``graph``: :func:`run_mesh_graph`) and writes its
    result to ``out`` (the parameter change to ``out.delta.pt``)."""
    import faulthandler

    faulthandler.enable()  # a crashed rank leaves its stack in its stderr
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_rank))
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(local_rank)
    grouped = world > 1 or backend == "nccl"
    if backend == "nccl":
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    if grouped:
        dist.init_process_group(backend, rank=rank, world_size=world,
                                init_method=f"tcp://127.0.0.1:{port}")
    try:
        if task == "pipeline":
            result = run_pipeline(torch, world)
        elif task == "graph":
            result = run_mesh_graph(torch, params, out)
        else:
            seq = int(params.get("seq", 1)) > 1
            result = run_gpt(torch, params, out + ".delta.pt", profile,
                             job=task, readings=seq_readings if seq else None)
        Path(out).write_text(json.dumps(result))
    finally:
        if grouped:
            dist.destroy_process_group()


def spawn_ranks(world: int, params: dict, root: str, name: str, *,
                backend: str = "gloo", cards: int = 1,
                profile: bool = False, task: str = "gpt",
                timeout: float = 600) -> list:
    """``world`` rank processes of one mesh run of ``task`` (rank r on card
    r % ``cards``), waited for up to ``timeout`` s each; their results. A
    rank that fails fails the script, with the end of its stderr."""
    port = free_port()
    outs = [os.path.join(root, f"{name}.{r}.json") for r in range(world)]
    procs = []
    for r in range(world):
        with open(outs[r] + ".stderr", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "chip_smoke.py"), "--mesh-rank",
                 str(r), str(world), str(r % cards), backend, str(port),
                 task, json.dumps(params), outs[r]]
                + (["--profile"] * profile),
                cwd=HERE, stdout=subprocess.DEVNULL, stderr=err))
    try:
        for r, proc in enumerate(procs):
            proc.wait(timeout=timeout)
            if proc.returncode:
                err = Path(outs[r] + ".stderr").read_text()[-3000:]
                fail(f"mesh {name}: rank {r} exited {proc.returncode}:\n{err}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = [json.loads(Path(o).read_text()) for o in outs]
    if task != "pipeline":
        ranks[0]["delta"] = outs[0] + ".delta.pt"
    return ranks


def update_distance(torch, delta: str, ref_delta: str) -> float:
    """|d - d_ref| / |d_ref| over every parameter, from two saved changes."""
    a = torch.load(delta, weights_only=True)
    b = torch.load(ref_delta, weights_only=True)
    num = sum(float((a[n].double() - b[n].double()).square().sum()) for n in b)
    den = sum(float(b[n].double().square().sum()) for n in b)
    return math.sqrt(num / den)


def mesh_readings(torch, run: list, ref: dict):
    """A mesh run (its ranks' results) against the reference's: the largest
    per-step loss gap and the update distance."""
    if len(ref["losses"]) != MESH_STEPS or len(run[0]["losses"]) != MESH_STEPS:
        fail(f"a mesh run published {len(run[0]['losses'])} losses and its "
             f"reference {len(ref['losses'])}, not {MESH_STEPS}")
    gap = max(abs(a - b) for a, b in zip(run[0]["losses"], ref["losses"]))
    return gap, update_distance(torch, run[0]["delta"], ref["delta"])


def mesh_problems(torch, ranks: list, ref: dict, local: tuple,
                  path=None):
    """Every check of one strategy's run: each rank's K1, K2 and K3
    launched MESH_STEPS x MESH_LAYERS times, all sm90, at the strategy's
    local (batch, heads); every rank on ``path`` (when given: the
    trainer's, ``trainer_path``); every rank's losses equal; the loss gap
    and the update distance against the reference within their bounds.
    Returns the problems (empty when it passed) and the two readings."""
    want = MESH_STEPS * MESH_LAYERS
    problems = []
    for r, got in enumerate(ranks):
        if path is not None and got["path"] != path:
            problems.append(f"rank {r} trained on the {got['path']} path, "
                            f"not {path}")
        if got["counts"] != [want] * 3:
            problems.append(f"rank {r} launched K1/K2/K3 {got['counts']} "
                            f"times, not {want} each")
        if any(d["sm90"] != n for d, n in zip(got["designs"], got["counts"])):
            problems.append(f"rank {r} launches by design {got['designs']}: "
                            "not all sm90")
        if {tuple(x[1:]) for x in got["shapes"]} != {tuple(local)}:
            problems.append(f"rank {r} launched at (batch, heads) "
                            f"{got['shapes']}, not {tuple(local)}")
        if got["losses"] != ranks[0]["losses"]:
            problems.append(f"ranks report different losses "
                            f"{[x['losses'] for x in ranks]}")
    gap, dist = mesh_readings(torch, ranks, ref)
    if not gap <= MESH_LOSS_BOUND:
        problems.append(f"losses {ranks[0]['losses']} not within "
                        f"{MESH_LOSS_BOUND} of the reference's {ref['losses']}")
    if not dist <= MESH_UPDATE_BOUND:
        problems.append(f"update distance {dist} above {MESH_UPDATE_BOUND}")
    return problems, {"loss_gap": gap, "update_distance": dist}


def frozen_reading(torch, refs: dict, root: str, params: dict = MESH_PARAMS,
                   kind: str = "dense", task: str = "gpt") -> dict:
    """The reference at lr 0 (parameters that never move) against the
    reference: its readings must fail both bounds."""
    (frozen,) = spawn_ranks(1, {**params, **MESH_FROZEN_PARAMS}, root,
                            f"frozen_{task}_{kind}", task=task)
    gap, dist = mesh_readings(torch, [frozen], refs[kind])
    if not (gap > MESH_LOSS_BOUND and dist > MESH_UPDATE_BOUND):
        fail(f"a run whose parameters never move reads a loss gap {gap} and "
             f"an update distance {dist}: within the bounds "
             f"{MESH_LOSS_BOUND}, {MESH_UPDATE_BOUND}")
    return {"loss_gap": gap, "update_distance": dist}


def frozen_readings(torch, refs: dict, root: str) -> dict:
    """:func:`frozen_reading` of each reference of :func:`mesh_references`
    (dense, and with the MoE params), by kind."""
    return {kind: frozen_reading(
        torch, refs, root,
        {**MESH_PARAMS, **(MOE_PARAMS if kind == "moe" else {})}, kind)
        for kind in refs}


def mesh_references(strategies: dict, root: str) -> dict:
    """One-rank runs of MESH_PARAMS, dense and with the MoE params, as each
    strategy in ``strategies`` needs them."""
    refs = {}
    for extra in [v[0] for v in strategies.values()]:
        kind = "moe" if "moe_every" in extra else "dense"
        if kind not in refs:
            model = MOE_PARAMS if kind == "moe" else {}
            (refs[kind],) = spawn_ranks(1, {**MESH_PARAMS, **model}, root,
                                        f"ref_{kind}")
    return refs


def phase_mesh(torch, fa, card):
    """Every strategy of MESH_STRATEGIES not in MESH_LEFT_OUT, as two ranks
    on the one card, through :func:`mesh_problems` against one-rank runs of
    the same batches, with the frozen reading beside. Returns each
    strategy's launches summed over the ranks, the rows of the kernels at
    each local shape, its step ms and its readings."""
    from cron_operator_tpu_torch.utils.device import world_size

    if world_size() != 1:
        fail("the smoke's own process must not be in a process group")
    strategies = {k: v for k, v in MESH_STRATEGIES.items()
                  if k not in MESH_LEFT_OUT}
    for name in MESH_LEFT_OUT:
        print(f"mesh {name}: left out: {MESH_LEFT_OUT[name]}", flush=True)
    if "data" not in strategies:
        fail("the mesh phase must run the data strategy")
    root = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    results, rows = {}, {}
    try:
        refs = mesh_references(strategies, root)
        frozen = frozen_readings(torch, refs, root)
        for kind, reading in frozen.items():
            print(f"mesh: parameters that never move (lr 0, {kind}) read a "
                  f"loss gap {reading['loss_gap']:.6f} and an update "
                  f"distance {reading['update_distance']:.6f} (bounds "
                  f"{MESH_LOSS_BOUND}, {MESH_UPDATE_BOUND})", flush=True)
        for name, (extra, local) in strategies.items():
            ranks = spawn_ranks(2, {**MESH_PARAMS, **extra}, root, name)
            kind = "moe" if "moe_every" in extra else "dense"
            ref = refs[kind]
            problems, readings = mesh_problems(torch, ranks, ref, local,
                                               MESH_PATHS[name])
            for r, got in enumerate(ranks):  # a plain mesh: the kernels
                check_xent(f"mesh {name} rank {r}", f"mesh_{name}",
                           got["xent"], MESH_STEPS)
                print(f"mesh {name} rank {r}: the loss forward kernel at "
                      "[rows, columns, real columns, first column] "
                      f"{got['xent_shapes']}", flush=True)
                if name == "tensor" and got["xent_shapes"] != [
                        tensor_xent_shape(TRAIN_SHAPE["b"] * TRAIN_SHAPE["s"],
                                          2, r)]:
                    fail(f"mesh tensor rank {r}: the loss kernels ran at "
                         f"{got['xent_shapes']}, not the rank's block of "
                         "the vocab")
                check_ln(f"mesh {name} rank {r}", f"mesh_{name}",
                         got["layer_norm"], (LM_NORMS * MESH_STEPS,) * 2)
            print(f"mesh {name}: the {ranks[0]['path']} path; losses "
                  f"{ranks[0]['losses']} against one "
                  f"rank {ref['losses']}: max gap {readings['loss_gap']:.6f}"
                  f", update distance {readings['update_distance']:.6f}; "
                  f"K1/K2/K3 {ranks[0]['counts']} a rank, all sm90, at "
                  f"(batch, heads) {local}", flush=True)
            if problems:
                fail(f"mesh {name}: " + "; ".join(problems))
            print(f"[{card}] mesh {name}: {ranks[0]['step_s'] * 1e3:.1f} ms "
                  "a step (steps 2-3; two ranks time-sharing one card "
                  "through host gloo collectives: not a scaling number)",
                  flush=True)
            shape = dict(TRAIN_SHAPE, b=local[0], h=local[1])
            key = (local[0], local[1])
            if key not in rows:
                rows[key] = attention_rows(torch, fa, card, shape, True,
                                           f"mesh {name}")
            results[name] = {
                "launches": [sum(x["counts"][i] for x in ranks)
                             for i in range(3)],
                "rows": rows[key], "step_ms": ranks[0]["step_s"] * 1e3,
                **readings, "frozen": frozen[kind]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return results


# Phase 16: sequence and pipeline parallelism on one card, two ranks of a
# gloo group on cuda:0 as in phase 15.
SEQ_RUNS = {
    # name: (job, params of the two-rank run; the reference runs them with
    # attention=flash at one rank: K1-K3 over the whole sequence, the
    # arithmetic the bodies run on their blocks, so the check isolates the
    # split; a one-rank attention=xla run is read beside it)
    "ring": ("gpt", {**MESH_PARAMS, "attention": "ring", "seq": "2"}),
    "ulysses": ("bert", {**MESH_PARAMS, "seq_len": "512",
                         "attention": "ulysses", "seq": "2"}),
}
SEQ_LAYERS = 12  # GPT-2 small and BERT-base: one attention body a layer
# K1-K3's shapes on the seq runs: ring gpt's block of a rank, b 8 x 512 of
# 12 heads (the diagonal causal, the block below it in full: BERT_SHAPE),
# and Ulysses bert's whole 512 tokens on 6 heads
SEQ_RING_BLOCK = dict(TRAIN_SHAPE, s=TRAIN_SHAPE["s"] // 2)
SEQ_ULYSSES_HEADS = dict(BERT_SHAPE, h=BERT_SHAPE["h"] // 2)
# The GPT Cron's ring block (examples/v1alpha1/cron/cron-jax-gpt.yaml:
# seq_len 16384 over seq 8 and fsdp 8 at b 32, GPT-2 small's 12 heads of
# 64): each rank's [4, 2048, 12, 64], read here over the phase's ring of 2
CRON_RING_BLOCK = dict(b=4, s=2048, h=12, d=64)
CRON_TOL_HEADS = 2  # heads a time in the bounds' f32 [b, h, s, s] terms
PIPE_SHAPE = dict(b=8, s=1024, hidden=768, microbatches=4)


def pipe_ticks(stages: int) -> int:
    """stage_fn calls a rank of a pipe of ``stages``."""
    return PIPE_SHAPE["microbatches"] + stages - 1

# The pipeline against the same two layers in sequence, relative L2 of each
# compared tensor: bf16 products over microbatches of 2 rows against the
# whole batch round in other cuBLAS tiles (a few bf16 ulps, about 0.4%
# each); a stage's gradients held against the other layer's must read
# above it.
PIPE_REL_BOUND = 2e-2


def seq_readings(tr, batch) -> dict:
    """On each rank of a sequence-parallel run: one profiled step's device
    ms, and the device ms of one layer's attention
    body (its forward and backward on this rank's block, causal for gpt)
    under ``profile_window``, at the run's local shape, split into K1-K3,
    memory copies, NCCL's kernels and the rest (``body_split_ms``); for
    the ring, the
    Cron-shape reading (:func:`cron_ring_reading`)."""
    import torch

    from cron_operator_tpu_torch.parallel.ring import ring_attention_local
    from cron_operator_tpu_torch.parallel.ulysses import (
        ulysses_attention_local,
    )

    card = card_line()
    _, step_ms = profile_window(torch, card, "one sequence-parallel step",
                                lambda: tr.step(batch))
    cfg = tr.model.config
    mesh = tr.mesh
    b, s = batch["x"].shape
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    par = dict(zip(mesh.mesh_dim_names, mesh.shape))["seq"]
    t = s // par
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(b, t, h, d, device="cuda", dtype=cfg.dtype,
                           generator=gen).requires_grad_() for _ in range(3))
    causal = cfg.attention_impl == "ring"  # gpt: ring; bert: ulysses
    body = ring_attention_local if causal else ulysses_attention_local

    def fwd_bwd():
        out = body(q, k, v, mesh=mesh, causal=causal)
        out.backward(torch.ones_like(out))

    traced = []
    _, body_ms = profile_window(torch, card, "one attention body, fwd+bwd",
                                fwd_bwd, traced)
    split = {"flash": 0.0, "copies": 0.0, "nccl": 0.0, "other": 0.0}
    for key, us, _ in traced:  # K1-K3, memory copies (gloo's staging),
        # NCCL's kernels (their time waiting on the peer included)
        name = key.lower()
        part = next((p for p, word in (("flash", "flash"),
                                       ("copies", "memcpy"),
                                       ("nccl", "nccl")) if word in name),
                    "other")
        split[part] += us / 1e3
    out = {"step_device_ms": step_ms, "body_device_ms": body_ms,
           "body_split_ms": split,
           "body_share": SEQ_LAYERS * body_ms / step_ms}
    if causal:
        del q, k, v
        out["cron"] = cron_ring_reading(torch, mesh, card)
    return out


def cron_ring_reading(torch, mesh, card) -> dict:
    """The GPT Cron's per-rank ring block (CRON_RING_BLOCK, bf16, causal)
    on this rank of the ``seq`` ring, from one seeded whole q, k, v and dO:
    forward and backward through ``ring_attention_local`` (K1-K3) and
    ``ring_attention_local_reference`` (the plain f32 body), each's device
    ms (``profile_window``) and peak memory above what the rank held
    before; the kernels' output and gradients on this rank's rows against
    K1-K3 over the whole sequence (``flash_attention_block``) as the worst
    ratio of error to ``body_tolerances`` (bounds taken CRON_TOL_HEADS
    heads at a time), whether a rerun gave the same bits, and the plain
    body's largest gap to the kernels' output."""
    from cron_operator_tpu_torch.parallel.ring import (
        body_tolerances,
        ring_attention_local,
        ring_attention_local_reference,
    )

    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
    ring = dict(zip(mesh.mesh_dim_names, mesh.shape))["seq"]
    mine = mesh.get_local_rank("seq")
    b, t, h, d = (CRON_RING_BLOCK[x] for x in "bshd")
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, do = (torch.randn(b, ring * t, h, d, device="cuda",
                               generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    rows = slice(mine * t, (mine + 1) * t)

    def run(body):
        leaves = [x[:, rows].clone().requires_grad_() for x in (q, k, v)]
        out = body(*leaves, mesh=mesh, causal=True)
        out.backward(do[:, rows])
        return [out.detach()] + [x.grad for x in leaves]

    result, got = {}, {}
    for name, body in (("kernels", ring_attention_local),
                       ("plain", ring_attention_local_reference)):
        release(torch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got[name] = run(body)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        _, ms = profile_window(
            torch, card, f"GPT Cron ring block {[b, t, h, d]}, {name} body, "
            "fwd+bwd", lambda: run(body))
        result[name] = {"device_ms": ms, "peak_gib": peak}
    again = run(ring_attention_local)
    result["rerun_equal"] = all(torch.equal(x, y)
                                for x, y in zip(got["kernels"], again))
    result["plain_max_abs_err"] = float(
        (got["plain"][0].float() - got["kernels"][0].float()).abs().max())
    del again, got["plain"]
    release(torch)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, _ = fa.flash_attention_block(*leaves, causal=True)
    o.backward(do)
    want = [o.detach()] + [x.grad for x in leaves]
    del o, leaves
    worst = {}
    for h0 in range(0, h, CRON_TOL_HEADS):
        heads = slice(h0, h0 + CRON_TOL_HEADS)
        bounds = body_tolerances(*(x[:, :, heads] for x in (q, k, v, do)),
                                 causal=True, blocks=ring)
        for key, g, w in zip(("o", "dq", "dk", "dv"), got["kernels"], want):
            err = (g[:, :, heads].float() - w[:, rows, heads].float()).abs()
            ratio = float((err / bounds[key][:, rows]).max())
            worst[key] = max(worst.get(key, 0.0), ratio)
        del bounds
    result["worst_ratio"] = worst
    result["finite"] = all(bool(torch.isfinite(x).all())
                           for x in got["kernels"])
    return result


def rel_l2(torch, a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def run_pipeline(torch, stages: int = 2) -> dict:
    """On each of ``stages`` ranks: ``spmd_pipeline`` over a pipe mesh of
    ``stages`` port ``DecoderLayer``s at GPT-2 small width (weights from
    seed 0, f32
    parameters placed by ``pipeline_param_sharding``, bf16 products) on x
    ``[8, 1024, 768]`` bf16 in 4 microbatches, K1-K3 counted over its
    forward and backward (the loss ``mean(y ** 2)`` in f32); then the
    layers in sequence on this rank from the same weights and x. Returns
    the counts and designs, and the relative L2 of the output, x's
    gradient and this rank's stage gradients against the sequence's (and
    the least of the stage's against the other layers')."""
    from torch.distributed.tensor import distribute_tensor
    from torch.func import functional_call

    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
    from cron_operator_tpu_torch.models.gpt import DecoderLayer, GPTConfig
    from cron_operator_tpu_torch.models.layers import init_flax_layers_
    from cron_operator_tpu_torch.parallel.mesh import mesh_for_devices
    from cron_operator_tpu_torch.parallel.pipeline import (
        pipeline_param_sharding,
        spmd_pipeline,
        stack_pipeline_stages,
    )

    cfg = GPTConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    layers = [DecoderLayer(cfg, device="cuda") for _ in range(stages)]
    for layer in layers:
        init_flax_layers_(layer, gen)
    x = torch.randn(PIPE_SHAPE["b"], PIPE_SHAPE["s"], PIPE_SHAPE["hidden"],
                    device="cuda", generator=gen).to(cfg.dtype)
    mesh = mesh_for_devices(device_type="cuda", pipe=stages)
    stage = mesh.get_local_rank("pipe")
    stacked = stack_pipeline_stages([
        {n: p.detach() for n, p in layer.named_parameters()}
        for layer in layers])
    place = pipeline_param_sharding(stacked, mesh)
    placed = {n: distribute_tensor(t, mesh, place[n], src_data_rank=None)
              .requires_grad_() for n, t in stacked.items()}

    def stage_fn(params, x):
        return functional_call(layers[0], params, (x,))[0]

    xp = x.clone().requires_grad_()
    zero_counts(fa)
    y = spmd_pipeline(stage_fn, placed, xp, mesh=mesh,
                      n_microbatches=PIPE_SHAPE["microbatches"])
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    counts, designs = read_counts(fa), read_designs(fa)
    layer_norm = read_ln_counts()

    xs = x.clone().requires_grad_()
    ys = xs
    for layer in layers:
        ys, _ = layer(ys)
    ys.float().square().mean().backward()
    grads = {n: placed[n].grad.to_local()[0] for n in placed}
    mine = dict(layers[stage].named_parameters())
    others = [dict(layer.named_parameters())
              for i, layer in enumerate(layers) if i != stage]
    return {
        "counts": counts, "designs": designs, "layer_norm": layer_norm,
        "y": rel_l2(torch, y, ys), "x_grad": rel_l2(torch, xp.grad, xs.grad),
        "stage_grads": max(rel_l2(torch, grads[n], mine[n].grad)
                           for n in grads if mine[n].grad.norm() > 0),
        "other_layer": min(rel_l2(torch, grads[n], other[n].grad)
                           for other in others for n in grads
                           if other[n].grad.norm() > 0),
    }


def seq_launches(got: dict, steps: int = MESH_STEPS) -> list:
    """The ``[full, causal]`` launches each of K1, K2 and K3 must make on a
    rank of a run of ``steps`` steps (:func:`run_gpt`'s result), by the
    body's rule, per step and layer: once per computed block, so ``coord +
    1`` blocks on coordinate ``coord`` of a causal ring (its own causal, the
    earlier ones in full; the later ones add nothing), every block in full
    on a non-causal ring, and one block over the whole sequence for Ulysses
    or without a ``seq`` axis."""
    per = steps * SEQ_LAYERS
    if got["impl"] == "ulysses" or got["seq_size"] == 1:
        return [0, per] if got["causal"] else [per, 0]
    if got["causal"]:
        return [per * got["seq_coord"], per]
    return [per * got["seq_size"], 0]


# The trainer's paths a seq mesh may take: plain modules (DDP, or FSDP2
# under fsdp x seq), never DTensor parameters.
SEQ_PATHS = ("ddp", "fsdp")


def seq_problems(torch, ranks: list, ref: dict):
    """Every check of a sequence-parallel run against its one-rank
    ``attention=flash`` reference: every rank on a path of
    :data:`SEQ_PATHS`; on every rank K1, K2 and K3 launched as
    :func:`seq_launches` says, by mask, all sm90; every rank's losses
    equal; the loss gap and the update distance within their bounds; the
    ring's Cron-shape reading (where taken) within ``body_tolerances``,
    finite and bit-identical on a rerun. Returns the problems and the two
    readings."""
    gap, dist = mesh_readings(torch, ranks, ref)
    problems = []
    for r, got in enumerate(ranks):
        if got["path"] not in SEQ_PATHS:
            problems.append(f"rank {r} trained on the {got['path']} path, "
                            f"not the plain one ({' or '.join(SEQ_PATHS)})")
        want = seq_launches(got)
        if got["by_mask"] != [want] * 3 or got["counts"] != [sum(want)] * 3:
            problems.append(f"rank {r} (coordinate {got['seq_coord']}) "
                            f"launched K1/K2/K3 {got['by_mask']} times by "
                            f"[full, causal] mask, not {want} each")
        if any(x["sm90"] != n for x, n in zip(got["designs"], got["counts"])):
            problems.append(f"rank {r} launches by design {got['designs']}: "
                            "not all sm90")
        cron = got.get("cron")
        if cron is not None and not (
                cron["finite"] and cron["rerun_equal"]
                and max(cron["worst_ratio"].values()) <= 1.0):
            problems.append(f"rank {r}: the Cron-shape ring block reads "
                            f"{cron}: not finite, not bit-identical on a "
                            "rerun, or past body_tolerances")
    if any(got["losses"] != ranks[0]["losses"] for got in ranks):
        problems.append("ranks report different losses "
                        f"{[got['losses'] for got in ranks]}")
    if not gap <= MESH_LOSS_BOUND:
        problems.append(f"losses {ranks[0]['losses']} not within "
                        f"{MESH_LOSS_BOUND} of {ref['losses']}")
    if not dist <= MESH_UPDATE_BOUND:
        problems.append(f"update distance {dist} above {MESH_UPDATE_BOUND}")
    return problems, (gap, dist)


def pipeline_problems(ranks: list, stages: int) -> list:
    """Every check of a pipeline run over ``stages`` ranks: K1-K3 launched
    ``pipe_ticks(stages)`` times each a rank, all sm90; the output, x's
    gradient and each stage's gradients within PIPE_REL_BOUND of the
    layers in sequence, and the other layers' gradients outside it."""
    problems = []
    for r, got in enumerate(ranks):
        if got["counts"] != [pipe_ticks(stages)] * 3:
            problems.append(f"rank {r} launched K1/K2/K3 {got['counts']} "
                            f"times, not {pipe_ticks(stages)} each")
        if any(d["sm90"] != n for d, n in zip(got["designs"], got["counts"])):
            problems.append(f"rank {r} launches by design {got['designs']}: "
                            "not all sm90")
        worst = max(got["y"], got["x_grad"], got["stage_grads"])
        if not (worst <= PIPE_REL_BOUND < got["other_layer"]):
            problems.append(f"rank {r}: relative L2 {worst} (bound "
                            f"{PIPE_REL_BOUND}) or the other layers' "
                            f"{got['other_layer']} within it")
    return problems


def phase_seq(torch, fa, card):
    """Ring ``gpt`` and Ulysses ``bert`` over two ranks against one-rank
    ``attention=flash`` runs (phase 15's checks; K1-K3 by the bodies' rule,
    :func:`seq_launches`; the plain path, DDP: the loss kernels once a step
    each and the LayerNorm kernels 24 of 25 folded, eager over gloo, which
    cannot capture), with the gap to a one-rank ``attention=xla`` run
    beside, and the ring's Cron-shape reading; then the pipe-2 pipeline
    against the layers in sequence. Returns each run's readings, its
    launches by mask summed over the ranks, the rows of K1-K3 at the bodies'
    shapes and the pipeline's launches."""
    root = tempfile.mkdtemp(prefix="chip-smoke-seq-")
    results = {}
    try:
        for name, (job, params) in SEQ_RUNS.items():
            plain = {k: v for k, v in params.items() if k != "seq"}
            flash = {**plain, "attention": "flash"}
            (ref,) = spawn_ranks(1, flash, root, f"ref_{name}", task=job)
            frozen = frozen_reading(torch, {"ref": ref}, root, flash, "ref",
                                    job)
            (xla,) = spawn_ranks(1, {**plain, "attention": "xla"}, root,
                                 f"xla_{name}", task=job)
            ranks = spawn_ranks(2, params, root, name, task=job)
            problems, (gap, dist) = seq_problems(torch, ranks, ref)
            xla_gap, xla_dist = mesh_readings(torch, ranks, xla)
            for r, got in enumerate(ranks):  # a seq mesh trains plain
                # modules: the loss kernels, the folded LayerNorm kernels
                check_xent(f"seq {name} rank {r}", f"seq_{name}",
                           got["xent"], MESH_STEPS)
                check_ln(f"seq {name} rank {r}", f"seq_{name}",
                         got["layer_norm"], (LM_NORMS * MESH_STEPS,) * 2)
            print(f"seq {name} ({job}): trained on the "
                  f"{[got['path'] for got in ranks]} path (by rank)",
                  flush=True)
            print(f"seq {name} ({job}): losses {ranks[0]['losses']} against "
                  f"one rank's attention=flash {ref['losses']}: max gap "
                  f"{gap:.6f}, update distance {dist:.6f}; lr 0 reads "
                  f"{frozen['loss_gap']:.6f} and "
                  f"{frozen['update_distance']:.6f}; against one rank's "
                  f"attention=xla {xla['losses']}: max gap {xla_gap:.6f}, "
                  f"update distance {xla_dist:.6f}; K1/K2/K3 [full, causal] "
                  f"launches by rank {[got['by_mask'] for got in ranks]} "
                  f"(designs {[got['designs'] for got in ranks]})",
                  flush=True)
            cron = [got["cron"] for got in ranks if "cron" in got]
            for r, reading in enumerate(cron):
                print(f"[{card}] seq {name} rank {r}: the GPT Cron's ring "
                      f"block {[CRON_RING_BLOCK[x] for x in 'bshd']} bf16 "
                      "causal, ring of 2, fwd+bwd: kernels "
                      f"{reading['kernels']['device_ms']:.3f} device ms, "
                      f"peak {reading['kernels']['peak_gib']:.3f} GiB; plain "
                      f"f32 body {reading['plain']['device_ms']:.3f} device "
                      f"ms, peak {reading['plain']['peak_gib']:.3f} GiB; "
                      "error / body_tolerances against K1-K3 over the whole "
                      f"sequence {reading['worst_ratio']}; rerun equal "
                      f"{reading['rerun_equal']}; plain body's output within "
                      f"{reading['plain_max_abs_err']:.5f}", flush=True)
            if problems:
                fail(f"seq {name}: " + "; ".join(problems))
            got = ranks[0]
            bodies = "; ".join(
                f"rank {r}: one attention body {x['body_device_ms']:.3f} "
                f"device ms (fwd+bwd; K1-K3, copies, NCCL, the rest "
                f"{[round(v, 3) for v in x['body_split_ms'].values()]}), "
                f"{SEQ_LAYERS} of them "
                f"{100 * x['body_share']:.1f}% of a profiled step's "
                f"{x['step_device_ms']:.3f} device ms"
                for r, x in enumerate(ranks))
            print(f"[{card}] seq {name}: {got['step_s'] * 1e3:.1f} ms a step "
                  "(steps 2-3, two ranks time-sharing one card: not a scaling "
                  f"number); {bodies}; peak "
                  f"{max(r['peak_gib'] for r in ranks):.2f} GiB a rank",
                  flush=True)
            results[name] = {
                "step_ms": got["step_s"] * 1e3, "loss_gap": gap,
                "update_distance": dist, "frozen": frozen,
                "xla_loss_gap": xla_gap, "xla_update_distance": xla_dist,
                "body_device_ms": [x["body_device_ms"] for x in ranks],
                "step_device_ms": [x["step_device_ms"] for x in ranks],
                "body_share": [x["body_share"] for x in ranks],
                "body_split_ms": [x["body_split_ms"] for x in ranks],
                "peak_gib": max(r["peak_gib"] for r in ranks),
                "cron": cron,
                "launches": [sum(r["counts"][i] for r in ranks)
                             for i in range(3)],
                "by_mask": [[sum(r["by_mask"][i][m] for r in ranks)
                             for m in (0, 1)] for i in range(3)]}
        ranks = spawn_ranks(2, {}, root, "pipeline", task="pipeline")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r, got in enumerate(ranks):
        check_ln(f"pipeline rank {r}", "pipeline", got["layer_norm"], None)
        print(f"pipeline rank {r}: K1/K2/K3 {got['counts']} {got['designs']}; "
              f"relative L2 against the layers in sequence: y {got['y']:.5f}, "
              f"x grad {got['x_grad']:.5f}, stage grads "
              f"{got['stage_grads']:.5f} (the other layer's "
              f"{got['other_layer']:.3f}); bound {PIPE_REL_BOUND}", flush=True)
    problems = pipeline_problems(ranks, 2)
    if problems:
        fail("pipeline: " + "; ".join(problems))
    results["pipeline"] = {
        "launches": [sum(g["counts"][i] for g in ranks) for i in range(3)],
        **{k: max(g[k] for g in ranks) for k in ("y", "x_grad",
                                                 "stage_grads")},
        "other_layer": min(g["other_layer"] for g in ranks),
        # K1-K3 at the stages' shape: a microbatch of 2 rows
        "rows": attention_rows(torch, fa, card, dict(
            TRAIN_SHAPE, b=PIPE_SHAPE["b"] // PIPE_SHAPE["microbatches"]),
            True, "pipeline")}
    # K1-K3 at the bodies' shapes: the ring's diagonal block (causal; the
    # blocks below it are BERT_SHAPE in full, phase 7's rows) and Ulysses'
    # local heads over the whole sequence
    results["ring"]["rows"] = attention_rows(torch, fa, card, SEQ_RING_BLOCK,
                                             True, "seq ring diagonal")
    results["ulysses"]["rows"] = attention_rows(
        torch, fa, card, SEQ_ULYSSES_HEADS, False, "seq ulysses")
    return results


# bench.py's attention_bench shape (bench.py:293-294), the microbench's
# defaults otherwise; flash_ms and K1's device ms must agree within this
MICROBENCH_ARGS = ["seq=2048", "batch=4", "heads=8", "head_dim=64",
                   "iters=20", "causal=1"]
MICROBENCH_SHAPE = dict(b=4, s=2048, h=8, d=64)
MICROBENCH_AGREE = 0.25


def phase_microbench(torch, fa, card):
    """The port's microbench through its ``main``, as ``python -m
    cron_operator_tpu_torch.ops.microbench`` runs it, on its main path
    (counts set to 0 just before, read just after), then its checks (see
    the module docstring, phase 17). Returns the counts, K1-K3's rows at
    the shape and the JSON line."""
    from cron_operator_tpu_torch.ops import microbench

    zero_counts(fa)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = microbench.main(MICROBENCH_ARGS)
    counts, designs = read_counts(fa), read_designs(fa)
    if rc != 0:
        fail(f"microbench main exited {rc}")
    line = out.getvalue().strip().splitlines()[-1]
    print("microbench " + line, flush=True)
    bench = json.loads(line)
    release(torch)
    print(f"microbench launches {counts}, by design {designs}", flush=True)
    for name, by_design in zip(("K1", "K2", "K3"), designs):
        if not by_design["sm90"] or by_design["fma"]:
            fail(f"microbench: {name} launched {by_design}, not sm90 alone")
    times = {key: bench[key] for key in (
        "flash_ms", "xla_ms", "flash_grad_ms", "xla_grad_ms")}
    times.update({f"moe_{key}": bench["moe"][key]
                  for key in ("fwd_ms", "grad_ms")})
    missing = [key for key, t in times.items() if t is None]
    if missing:
        fail(f"microbench timings read null: {missing}")

    b, s, h, d = (MICROBENCH_SHAPE[x] for x in "bshd")
    q, k, v = microbench.attention_inputs(b, s, h, d, "cuda")
    check_k1(torch, fa, f"K1 bfloat16 causal=1 b={b} s={s} h={h} d={d} "
             "(the microbench's inputs)", q, k, v, True)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=True)
    bound = fa.forward_tolerance(q, k, v, o_ref, lse_ref,
                                 causal=True).max().item()
    err = bench["flash_max_abs_err_vs_f32_ref"]
    print(f"microbench max|O - O_f32| {err} within the largest bound "
          f"{bound:.5f}", flush=True)
    if not 0 <= err <= bound:
        fail(f"microbench max error {err} beyond forward_tolerance {bound}")
    del q, k, v, o_ref, lse_ref
    release(torch)

    rows = attention_rows(torch, fa, card, MICROBENCH_SHAPE, True,
                          "microbench")
    k1 = rows["K1"]
    apart = abs(bench["flash_ms"] - k1["ms"]) / k1["ms"]
    print(f"[{card}] microbench flash_ms {bench['flash_ms']} (timed_chain: a "
          f"captured chain of 20) vs K1 device_ms {k1['ms']:.4f} "
          f"({100 * apart:.1f}% apart) | xla_ms {bench['xla_ms']} (the plain "
          f"f32 body) | sdpa {k1['library_ms']:.4f} ms | flash_grad_ms "
          f"{bench['flash_grad_ms']} vs xla_grad_ms {bench['xla_grad_ms']}",
          flush=True)
    if apart > MICROBENCH_AGREE:
        fail(f"microbench flash_ms and K1's device ms are {100 * apart:.1f}% "
             "apart")
    release(torch)
    return counts, rows, bench


# Phase 18: the meshed step captured over NCCL on one card. One rank of a
# one-rank NCCL process group (NCCL refuses two ranks on one card) trains
# gpt over a one-rank mesh: the plain data-parallel path (DDP), whose calls
# of GRAPH_CHUNK steps replay one captured step with the collectives inside
# it, after MESH_GRAPH_WARMUP eager steps.
GRAPH_MESH_PARAMS = {**TRAIN_PARAMS, "steps": "24", "data": "host",
                     "steps_per_call": str(GRAPH_CHUNK)}
GRAPH_MESH_STEPS = int(GRAPH_MESH_PARAMS["steps"])
# its step ms against phase 6's unwrapped graphed step: printed, not a gate
GRAPH_MESH_AGREE = 0.10
# NCCL's kernels by name: its collectives' (ncclDevKernel_...) and, in a
# one-rank group, the reduce of a scaled all-reduce (onerank.cu's
# oneRankReduce). At one rank NCCL launches nothing for an in-place sum,
# which DDP's gradient buckets are; the loss's average is a scaled one.
NCCL_KERNELS = ("nccl", "onerank")


def replay_kernels(torch, fn) -> dict:
    """``{kernel name: (device ms, launches)}`` of one call of ``fn`` under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)}


def run_mesh_graph(torch, params: dict, out: str) -> dict:
    """On the rank of a one-rank NCCL group: :func:`run_gpt` of ``params``
    (calls of GRAPH_CHUNK steps, replayed after the warm-up), then one more
    call timed (CUDA events, median of 3) and one profiled (the NCCL
    kernels inside the replay); then :func:`run_gpt` of the same job with
    ``steps_per_call`` 1 (every step eager). Returns the graphed run's
    result with the eager run's losses and whether every parameter after
    the two runs is the same bits."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    finals = {}

    def snapshot(tr):  # this rank's values (its shards under FSDP2)
        return [(p.to_local() if isinstance(p, DTensor) else p).detach()
                .clone() for p in tr.model.parameters()]

    def graph_readings(tr, batch):
        finals["graph"] = snapshot(tr)
        replayed = tr.replayed_steps
        batches = [batch] * GRAPH_CHUNK

        def call():
            tr.step(batches, sync=False)

        step_ms = median_ms(torch, call, iters=1, reps=3,
                            warmup=1) / GRAPH_CHUNK
        kernels = replay_kernels(torch, call)
        return {"replayed": replayed, "step_ms": step_ms,
                "nccl": {k: v for k, v in kernels.items()
                         if any(m in k.lower() for m in NCCL_KERNELS)},
                "busy_ms": sum(ms for ms, _ in kernels.values())
                / GRAPH_CHUNK,
                "backend": dist.get_backend(),
                "plain": not any(isinstance(p, DTensor)
                                 for p in tr.model.parameters())}

    def eager_readings(tr, batch):
        finals["eager"] = snapshot(tr)
        return {}

    graph = run_gpt(torch, params, out + ".graph.pt",
                    readings=graph_readings)
    release(torch)
    eager = run_gpt(torch, {**params, "steps_per_call": "1"},
                    out + ".eager.pt", readings=eager_readings)
    graph["eager_losses"] = eager["losses"]
    graph["same_bits"] = all(torch.equal(a, b) for a, b in
                             zip(finals["graph"], finals["eager"]))
    return graph


def phase_mesh_graph(torch, card, unwrapped_ms: float) -> dict:
    """The rank of :func:`run_mesh_graph` (a process of its own, NCCL on
    ``cuda:0``), held to: K1, K2 and K3 launched GRAPH_MESH_STEPS x
    MESH_LAYERS times each, all sm90, at the training slice's shape (the
    replays counted once each); the plain path on NCCL; every step after
    MESH_GRAPH_WARMUP replayed; the losses and every parameter equal to the
    eager run's to the bit; an NCCL kernel inside the profiled replay. Its
    step ms is printed beside ``unwrapped_ms`` (phase 6's graphed step of
    one card, unwrapped). Returns the launches and the readings."""
    from cron_operator_tpu_torch.workloads.train import MESH_GRAPH_WARMUP

    root = tempfile.mkdtemp(prefix="chip-smoke-graph-")
    try:
        (got,) = spawn_ranks(1, GRAPH_MESH_PARAMS, root, "graph",
                             backend="nccl", task="graph")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = GRAPH_MESH_STEPS * MESH_LAYERS
    ends = got["eager_losses"][GRAPH_CHUNK - 1::GRAPH_CHUNK]
    problems = []
    if got["counts"] != [want] * 3:
        problems.append(f"K1/K2/K3 launched {got['counts']} times, not "
                        f"{want} each")
    if any(d["sm90"] != n for d, n in zip(got["designs"], got["counts"])):
        problems.append(f"launches by design {got['designs']}: not all sm90")
    if {tuple(x[1:]) for x in got["shapes"]} != {
            (TRAIN_SHAPE["b"], TRAIN_SHAPE["h"])}:
        problems.append(f"launched at (batch, heads) {got['shapes']}")
    check_xent("mesh graph", "mesh_graph", got["xent"], GRAPH_MESH_STEPS)
    check_ln("mesh graph", "mesh_graph", got["layer_norm"], None)
    if got["backend"] != "nccl" or not got["plain"]:
        problems.append(f"trained over {got['backend']} with plain "
                        f"parameters {got['plain']}")
    if got["replayed"] != GRAPH_MESH_STEPS - MESH_GRAPH_WARMUP:
        problems.append(f"{got['replayed']} steps replayed, not "
                        f"{GRAPH_MESH_STEPS - MESH_GRAPH_WARMUP}")
    if not all(math.isfinite(x) for x in got["losses"]):
        problems.append(f"losses {got['losses']} not finite")
    if got["losses"] != ends or not got["same_bits"]:
        problems.append(f"graphed losses {got['losses']} against eager "
                        f"{ends}, parameters the same bits: "
                        f"{got['same_bits']}")
    if not got["nccl"]:
        problems.append("no NCCL kernel in the profiled replay")
    print(f"mesh graph: {GRAPH_MESH_STEPS} steps in calls of {GRAPH_CHUNK} "
          f"over a one-rank NCCL group, {MESH_GRAPH_WARMUP} eager then "
          f"{got['replayed']} replayed; losses {got['losses']} == eager "
          f"{ends}: {got['losses'] == ends}, parameters the same bits: "
          f"{got['same_bits']}; K1/K2/K3 {got['counts']}; NCCL kernels in "
          f"a replayed call of {GRAPH_CHUNK}: {got['nccl']}", flush=True)
    if problems:
        fail("mesh graph: " + "; ".join(problems))
    ratio = got["step_ms"] / unwrapped_ms
    print(f"[{card}] mesh graph: {got['step_ms']:.3f} ms a step (a replayed "
          f"call of {GRAPH_CHUNK}, CUDA events, median of 3), against the "
          f"unwrapped graphed step's {unwrapped_ms:.3f} ms: x{ratio:.4f} "
          f"({'within' if abs(ratio - 1) <= GRAPH_MESH_AGREE else 'outside'}"
          f" {GRAPH_MESH_AGREE:.0%}); kernels {got['busy_ms']:.3f} device ms "
          f"a step; peak {got['peak_gib']:.2f} GiB", flush=True)
    return {"launches": got["counts"], "step_ms": got["step_ms"],
            "unwrapped_ms": unwrapped_ms, "ratio": ratio,
            "nccl": got["nccl"], "replayed": got["replayed"],
            "losses": got["losses"]}


def phase_decode_kernel(torch, card) -> dict:
    """The decode kernel against its plain version at GPT-2 small's decode
    shape (q ``[8, 1, 12, 64]``, caches ``[8, 1024, 12, 64]`` bf16) at
    every position of ``DECODE_POSITIONS``, a GQA case of group 2 and an
    f32 case, each in the design ``decode_plan`` picks (the cluster design
    at all of them, which the launches by design confirm) and in the
    three-pass design on the same inputs: ``out`` within
    ``decode_tolerance`` (bf16: 2^-7 |ref| + 2^-7 (P |V|) + 1e-4 max|ref|,
    a rounding flip of a probability and of the output; f32: summation
    order), two runs bit-identical, and NaN/inf past ``pos`` giving the
    output of a cache zeroed there. Then the plan, the cluster occupancy,
    and both designs' device ms at ``DECODE_TIMED_POS`` beside the plain
    version's, SDPA's with a boolean mask of the written positions (a
    yardstick) and the bound: the K and V bytes up to ``pos`` (plus q and
    out) over 3.35 TB/s against 4 b h (pos + 1) d operations over the bf16
    peak. Returns a row for each design."""
    import torch.nn.functional as F

    attn = importlib.import_module("cron_operator_tpu_torch.ops.attention")
    b, max_len, h, d = (DECODE_SHAPE[x] for x in ("b", "max_len", "h", "d"))
    gen = torch.Generator(device="cuda").manual_seed(19)

    def inputs(kv_h, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((b, 1, h, d), (b, max_len, kv_h, d),
                              (b, max_len, kv_h, d))]

    cases = ([(h, torch.bfloat16, pos) for pos in DECODE_POSITIONS]
             + [(h // 2, torch.bfloat16, pos) for pos in (0, 575, 1023)]
             + [(h, torch.float32, DECODE_TIMED_POS)])
    worst = {"cluster": {}, "fma": {}}
    by_design = attn.decode_attention.launches_by_design
    for kv_h, dtype, pos in cases:
        q, k, v = inputs(kv_h, dtype)
        p = torch.tensor([pos], device="cuda")
        plan = attn.decode_plan(max_len, h // kv_h, d, dtype)
        name = f"{str(dtype)[6:]} kv_h {kv_h} pos {pos}"
        if plan["design"] != "cluster":
            fail(f"decode_attn {name}: the plan keeps {plan['design']}")
        before = by_design["cluster"]
        outs = {"cluster": attn.decode_attention(q, k, v, p),
                "fma": attn._launch_decode(q, k, v, p, design="fma")}
        if by_design["cluster"] != before + 1:
            fail(f"decode_attn {name}: the wrapper did not launch the "
                 "cluster design")
        ref = attn.decode_attention_reference(q, k, v, p)
        bound = attn.decode_tolerance(q, k, v, p, ref)
        kz, vz, kg, vg = k.clone(), v.clone(), k.clone(), v.clone()
        kz[:, pos + 1:], vz[:, pos + 1:] = 0, 0
        kg[:, pos + 1:], vg[:, pos + 1:] = float("nan"), float("inf")
        for design, out in outs.items():
            again = attn._launch_decode(q, k, v, p, design=design)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            same_past = torch.equal(
                attn._launch_decode(q, kz, vz, p, design=design),
                attn._launch_decode(q, kg, vg, p, design=design))
            exact = (out == ref).float().mean().item()
            print(f"  decode_attn {design} {name}: max|d out|="
                  f"{err.max().item():.3e}, max err/bound "
                  f"{(err / bound).max().item():.3f}, {100 * exact:.2f}% of "
                  "elements equal to the bit, reruns "
                  f"{'identical' if torch.equal(out, again) else 'DIFFER'}, "
                  f"garbage past pos {'ignored' if same_past else 'READ'}",
                  flush=True)
            if not (bool(torch.isfinite(out.float()).all())
                    and bool((err <= bound).all())):
                fail(f"decode_attn {design} {name} disagrees with the plain "
                     "version")
            if not torch.equal(out, again):
                fail(f"decode_attn {design} {name}: two runs differ")
            if not same_past:
                fail(f"decode_attn {design} {name}: positions past pos "
                     "change the output")
            if dtype == torch.bfloat16 and kv_h == h:
                worst[design][pos] = err.max().item()

    pos = DECODE_TIMED_POS
    q, k, v = inputs(h, torch.bfloat16)
    p = torch.tensor([pos], device="cuda")
    plan = attn.decode_plan(max_len, 1, d, torch.bfloat16)
    clusters = attn.decode_occupancy(q, k)
    print(f"[{card}] decode_attn plan at b{b} cache {max_len} h{h} d{d} "
          f"bf16: {plan}; {b * h} clusters of {plan['cluster']}, "
          f"{clusters} resident at once (cudaOccupancyMaxActiveClusters)",
          flush=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(max_len, device="cuda") <= pos)[None, None, None]
    (ms, plain_ms, library_ms), _ = timed_rows(torch, card, "decode_attn", (
        lambda: attn.decode_attention(q, k, v, p),
        lambda: attn.decode_attention_reference(q, k, v, p),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)))
    three_pass_ms = device_ms(torch, lambda: attn._launch_decode(
        q, k, v, p, design="fma"), 20)
    n = pos + 1
    moved = (2 * b * n * h * d + 2 * b * h * d) * q.element_size()
    flops = 4 * b * h * n * d
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[{card}] decode_attn b{b} cache {max_len} h{h} d{d} bf16 at pos "
          f"{pos}: cluster {ms * 1e3:.2f} us/call (device, "
          f"{bound_ms / ms:.1%} of the bound) | three-pass "
          f"{three_pass_ms * 1e3:.2f} us (19.04 in PR 14's run 6) | plain "
          f"{plain_ms * 1e3:.2f} us | sdpa with a boolean mask "
          f"{library_ms * 1e3:.2f} us | bound {bound_ms * 1e3:.2f} us "
          f"({moved / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)", flush=True)
    common = {"plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "library_ms": library_ms}
    return {"cluster": {"max_abs_err": worst["cluster"][pos], "ms": ms,
                        **common},
            "fma": {"max_abs_err": worst["fma"][pos], "ms": three_pass_ms,
                    **common}}


# ResNet-50's GroupNorms at b 128 x 224^2: (channels, map side, norms a
# step), 53 in all (models/resnet.py: the stem, then each block's convs and
# its projection shortcut)
RESNET50_NORMS = ((64, 112, 1), (64, 56, 6), (128, 56, 1), (256, 56, 4),
                  (128, 28, 7), (256, 28, 1), (512, 28, 5), (256, 14, 11),
                  (512, 14, 1), (1024, 14, 7), (512, 7, 5), (2048, 7, 4))
# the forward epilogues of each shape's norms (models/resnet.py: the stem
# and each block's inner norms take a relu, each block's last norm its
# residual then a relu, the projection shortcuts none): 33, 16 and 4 a step
RESNET50_EPILOGUES = {
    (64, 112): {"relu": 1}, (64, 56): {"relu": 6}, (128, 56): {"relu": 1},
    (256, 56): {"residual_relu": 3, "none": 1}, (128, 28): {"relu": 7},
    (256, 28): {"relu": 1}, (512, 28): {"residual_relu": 4, "none": 1},
    (256, 14): {"relu": 11}, (512, 14): {"relu": 1},
    (1024, 14): {"residual_relu": 6, "none": 1}, (512, 7): {"relu": 5},
    (2048, 7): {"residual_relu": 3, "none": 1}}
assert all(sum(RESNET50_EPILOGUES[c, side].values()) == n
           for c, side, n in RESNET50_NORMS)
# the backward's epilogue of a forward's: a relu's mask runs in the kernel,
# a residual's before it
BACKWARD_EPILOGUE = {"none": "none", "relu": "relu", "residual_relu": "none"}
# the profile's buckets of the separate elementwise passes around the norms
# (torch's relu is clamp_min, its backward threshold_backward)
RESNET50_SHARES = {"relu forward": r"clamp", "relu backward": r"threshold",
                   "adds": r"CUDAFunctor_add|AddFunctor"}
NORM_BATCH = int(RESNET50_PARAMS["batch_size"])
NORM_GROUPS, NORM_EPS = 32, 1e-6
# f32 operations an element (statistics and normalisation; the backward's
# two sums and dx) over the f32 rate outside the tensor cores (H100 SXM)
NORM_OPS = {"forward": 5, "backward": 10}
F32_FLOPS = 67e12
# ResNet-50's graphed and eager step before the GroupNorm kernels, and on
# the two-pass backward before its cluster redesign (PERF.md section 5,
# H100 80GB HBM3 at 700 W: PR 14 run 6)
NORM_BEFORE_MS = {"graph": 69.747, "eager": 72.098}
NORM_TWO_PASS_MS = {"graph": 27.851, "eager": 46.056}
# the same on the two-pass forward before its cluster redesign (PERF.md
# section 5, H100 80GB HBM3 at 700 W)
NORM_TWO_PASS_FWD_MS = {"graph": 26.984, "eager": 29.969}
# the same before the relus and residual adds ran in the norms' epilogues
# (PERF.md section 5, H100 80GB HBM3 at 700 W)
NORM_UNFUSED_MS = {"graph": 26.181, "eager": 43.327}


def resnet50_epilogues(steps: int) -> tuple:
    """The GroupNorm forward's and backward's launches by epilogue over
    ``steps`` ResNet-50 steps."""
    forward = {"none": 0, "relu": 0, "residual_relu": 0}
    backward = {"none": 0, "relu": 0}
    for mix in RESNET50_EPILOGUES.values():
        for epilogue, n in mix.items():
            forward[epilogue] += n * steps
            backward[BACKWARD_EPILOGUE[epilogue]] += n * steps
    return forward, backward


def resnet50_forward_designs(steps: int) -> dict:
    """The GroupNorm forward's launches by design over ``steps`` ResNet-50
    steps, by ``forward_plan`` at each of its 53 norms (bf16)."""
    import torch

    gn = importlib.import_module("cron_operator_tpu_torch.ops.group_norm")
    designs = dict.fromkeys(gn.FORWARD_DESIGNS, 0)
    for c, side, count in RESNET50_NORMS:
        plan = gn.forward_plan(NORM_BATCH, c, side * side, NORM_GROUPS,
                               torch.bfloat16)
        designs[plan["design"]] += count * steps
    return designs


def norm_bound(b: int, c: int, hw: int, esize: int, direction: str,
               epilogue: str = "none"):
    """(bound ms, bound_by) of one norm with ``epilogue``: each input read
    once and each output written once (forward x, gamma, beta and a
    residual -> z, mean, rstd; backward x, dy, mean, rstd, gamma and for a
    relu's mask beta -> dx, dgamma, dbeta) over 3.35 TB/s, against
    ``NORM_OPS`` f32 operations an element over the f32 rate."""
    n, stats = b * c * hw, 2 * b * NORM_GROUPS * 4
    if direction == "forward":
        moved = 2 * n * esize + 2 * c * 4 + stats
        if epilogue == "residual_relu":
            moved += n * esize
    else:
        moved = 3 * n * esize + 3 * c * 4 + stats
        if epilogue == "relu":
            moved += c * 4
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = NORM_OPS[direction] * n / F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def check_norm(torch, gn, label: str, x, dy, gamma, beta, out_dtype):
    """Both GroupNorm kernels against their plain versions on one input:
    y, mean and rstd, then dx, dgamma and dbeta (the plain backward from
    the kernel's statistics, so both take the same inputs), each within
    ``group_norm_tolerance``; a second run of each bit-identical; then
    each kernel's two-pass design on the same inputs within the same
    bounds. Returns the largest |y - plain|, |dx - plain|, and the two-pass
    designs' |y - plain| and |dx - plain|."""
    g, eps = NORM_GROUPS, NORM_EPS
    y, mean, rstd = gn.group_norm_forward(x, gamma, beta, g, eps, out_dtype)
    dx, dgamma, dbeta = gn.group_norm_backward(dy, x, mean, rstd, gamma, g)
    again = gn.group_norm_forward(x, gamma, beta, g, eps, out_dtype)
    again += gn.group_norm_backward(dy, x, *again[1:], gamma, g)
    same = all(torch.equal(a, b) for a, b in zip(
        (y, mean, rstd, dx, dgamma, dbeta), again))
    del again
    ry, rmean, rrstd = gn.group_norm_reference(x, gamma, beta, g, eps,
                                               out_dtype)
    rdx, rdgamma, rdbeta = gn.group_norm_backward_reference(dy, x, mean, rstd,
                                                            gamma, g)
    bounds = gn.group_norm_tolerance(x, gamma, beta, g, rmean, rrstd, ry, dy,
                                     rdx)
    pairs = {"y": (y, ry), "mean": (mean, rmean), "rstd": (rstd, rrstd),
             "dx": (dx, rdx), "dgamma": (dgamma, rdgamma),
             "dbeta": (dbeta, rdbeta)}
    ratios, errs = {}, {}
    for key, (got, want) in pairs.items():
        err = (got.float() - want.float()).abs()
        if not bool(torch.isfinite(got.float()).all()):
            fail(f"GroupNorm {label}: {key} is not finite")
        ratios[key] = (err / bounds[key]).max().item()
        errs[key] = err.max().item()
        if not bool((err <= bounds[key]).all()):
            fail(f"GroupNorm {label}: {key} outside group_norm_tolerance "
                 f"(max err/bound {ratios[key]:.3f})")
    if not same:
        fail(f"GroupNorm {label}: two runs differ")
    # each kernel's other design on the same inputs and bounds
    two_pass = {"design": "two_pass"}
    others = {
        "forward": (("y", "mean", "rstd"), gn._launch_forward(
            x, gamma, beta, g, eps, out_dtype, two_pass)),
        "backward": (("dx", "dgamma", "dbeta"), gn._launch_backward(
            dy, x, mean, rstd, gamma, g, two_pass))}
    for direction, (keys, outs) in others.items():
        for key, got in zip(keys, outs):
            err = (got.float() - pairs[key][1].float()).abs()
            ratios[f"two_pass {key}"] = (err / bounds[key]).max().item()
            if not (bool(torch.isfinite(got.float()).all())
                    and bool((err <= bounds[key]).all())):
                fail(f"GroupNorm {label}: the two-pass {direction}'s {key} "
                     "outside group_norm_tolerance")
            if key in ("y", "dx"):
                errs[f"two_pass {key}"] = err.max().item()
    torch.cuda.synchronize()
    print(f"  group_norm {label}: max err/bound "
          + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items())
          + f"; max|d y| {errs['y']:.3e} (two-pass "
          f"{errs['two_pass y']:.3e}), max|d dx| {errs['dx']:.3e} (two-pass "
          f"{errs['two_pass dx']:.3e}); reruns identical", flush=True)
    return (errs["y"], errs["dx"], errs["two_pass y"],
            errs["two_pass dx"])


def check_epilogues(torch, gn, label: str, x, dy, gamma, beta, residual):
    """The epilogues against the unfused kernels and torch's ops on one
    input, in each direction's main and two-pass designs: the forward's
    relu and residual-then-relu the same bits as the unfused kernel's y
    followed by ``residual + y`` and ``torch.relu``; the backward's relu
    mask the unfused kernel fed ``threshold_backward(dy, z, 0)``; every
    fused launch twice, bit-identical. Returns the plans checked."""
    g, eps, dtype = NORM_GROUPS, NORM_EPS, x.dtype
    b, c, h, w = x.shape
    plans = {"forward": (gn.forward_plan(b, c, h * w, g, dtype),
                         {"design": "two_pass"}),
             "backward": (gn.backward_plan(b, c, h * w, g, dtype, dtype),
                          {"design": "two_pass"})}
    for plan in plans["forward"]:
        y, mean, rstd = gn._launch_forward(x, gamma, beta, g, eps, dtype,
                                           plan)
        for res in (None, residual):
            want = torch.relu(y if res is None else res + y)
            for _ in range(2):
                z, m, r = gn._launch_forward(x, gamma, beta, g, eps, dtype,
                                             plan, relu=True, residual=res)
                if not (torch.equal(z, want) and torch.equal(m, mean)
                        and torch.equal(r, rstd)):
                    fail(f"GroupNorm {label}: the {plan['design']} forward "
                         f"with {'a residual and ' * (res is not None)}relu "
                         "differs from the unfused kernel and torch")
        del y, want, z
    z, mean, rstd = gn.group_norm_forward(x, gamma, beta, g, eps, dtype,
                                          relu=True)
    masked = torch.ops.aten.threshold_backward(dy, z, 0)
    for plan in plans["backward"]:
        want = gn._launch_backward(masked, x, mean, rstd, gamma, g, plan)
        for _ in range(2):
            got = gn._launch_backward(dy, x, mean, rstd, gamma, g, plan,
                                      relu=True, bias=beta)
            if not all(torch.equal(a, b_) for a, b_ in zip(got, want)):
                fail(f"GroupNorm {label}: the {plan['design']} backward with "
                     "the relu's mask differs from the unfused kernel fed "
                     "dy * (z > 0)")
    torch.cuda.synchronize()
    print(f"  group_norm {label}: relu and residual-then-relu forward, relu "
          "backward equal to the unfused kernels and torch's ops to the bit "
          f"in the {plans['forward'][0]['design']} and two-pass designs; "
          "reruns identical", flush=True)
    return plans


def variance_gap_bound(torch, x, gamma, beta):
    """The exact f64 GroupNorm of ``x`` and the bound of
    ``tests/test_torch_resnet.py::test_group_norm_variance_gap_is_bounded``
    on an f32 result: a sum of n f32 terms of size E[x^2] is off by up to
    n 2^-24 E[x^2], which moves the variance by that much relative to
    itself, and the output by half that times max |x - mean| / std and
    max |gamma|."""
    b, c = x.shape[:2]
    g = x.double().reshape(b, NORM_GROUPS, -1)
    mean = g.mean(-1, keepdim=True)
    var = g.var(-1, unbiased=False, keepdim=True)
    z = ((g - mean) / torch.sqrt(var + NORM_EPS)).reshape(x.shape)
    exact = z * gamma.double()[:, None, None] + beta.double()[:, None, None]
    n = g.shape[-1]
    rel_var = n * 2.0 ** -24 * ((g ** 2).mean(-1, keepdim=True) / var).max()
    bound = rel_var / 2 * z.abs().max() * gamma.abs().max()
    return exact, bound.item()


def phase_group_norm(torch, card, norm_counts, resnet_step) -> dict:
    """The GroupNorm kernels (``ops/csrc/group_norm.cu``) against their
    plain versions at each of ResNet-50's 12 norm shapes at b 128 in bf16
    (``check_norm``), an f32 case and a mean-100 case held to the
    variance-gap bound of ``tests/test_torch_resnet.py``; a CUDA input that
    is not channels-last raises; one model GroupNorm's forward and backward
    copies and casts no activation-sized tensor. Each shape's plans and
    cluster occupancies; each shape timed forward and backward, both
    designs of each (device ms with the card held busy) beside its bound,
    the plain version and the library call (``F.group_norm``, and
    ``native_group_norm_backward``), and the sums over the 53 norms; then
    phase 8's ResNet-50 step beside PERF.md section 5's. Returns the
    kernels' rows for the kernels line (each direction's main design and
    its two-pass design), each time summed over the 53 norms."""
    import torch.nn.functional as F

    from cron_operator_tpu_torch.models.layers import GroupNorm

    gn = importlib.import_module("cron_operator_tpu_torch.ops.group_norm")
    gen = torch.Generator(device="cuda").manual_seed(20)
    g, eps, bf16 = NORM_GROUPS, NORM_EPS, torch.bfloat16

    def inputs(b, c, side, dtype, mean=0.0):
        def nhwc():
            return torch.randn(b, side, side, c, generator=gen,
                               device="cuda").permute(0, 3, 1, 2)
        x, dy = (mean + nhwc()).to(dtype), nhwc().to(dtype)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
        return x, dy, gamma, beta

    for label, dtype, shape in (("f32 b4 C256 14x14", torch.float32,
                                 (4, 256, 14)),
                                ("f32 b4 C64 112x112", torch.float32,
                                 (4, 64, 112))):
        b, c, hw = shape[0], shape[1], shape[2] ** 2
        plans = {"forward": gn.forward_plan(b, c, hw, g, dtype),
                 "backward": gn.backward_plan(b, c, hw, g, dtype, dtype)}
        print(f"  group_norm {label}: plans {plans}", flush=True)
        for direction, plan in plans.items():
            if plan["design"] != "cluster":
                fail(f"GroupNorm {label}: the {direction} plan keeps "
                     f"{plan['design']}")
        check_norm(torch, gn, label, *inputs(*shape, dtype), dtype)
    for b, c, side in ((2, 64, 6), (8, 512, 14)):
        x, _, gamma, beta = inputs(b, c, side, torch.float32, mean=100.0)
        exact, bound = variance_gap_bound(torch, x, gamma, beta)
        for plan in (gn.forward_plan(b, c, side * side, g, torch.float32),
                     {"design": "two_pass"}):
            y, _, _ = gn._launch_forward(x, gamma, beta, g, eps,
                                         torch.float32, plan)
            err = (y.double() - exact).abs().max().item()
            print(f"  group_norm mean 100, std 1, f32 b{b} C{c} "
                  f"{side}x{side}, {plan['design']} forward: max|y - exact "
                  f"f64| {err:.3e}, variance-gap bound {bound:.3e}",
                  flush=True)
            if not err <= bound:
                fail(f"GroupNorm mean-100 case b{b} C{c} ({plan['design']}): "
                     f"{err} beyond the variance-gap bound {bound}")
    x, dy, gamma, beta = inputs(2, 64, 8, bf16)
    for name, call in (
            ("forward", lambda: gn.group_norm_forward(
                x.contiguous(), gamma, beta, g, eps, bf16)),
            ("backward", lambda: gn.group_norm_backward(
                dy.contiguous(), x, *gn.group_norm_forward(
                    x, gamma, beta, g, eps, bf16)[1:], gamma, g))):
        try:
            call()
        except ValueError as err:
            print(f"  group_norm {name} of an NCHW-contiguous CUDA tensor "
                  f"raises: {err}", flush=True)
        else:
            fail(f"the GroupNorm {name} kernel took a tensor that is not "
                 "channels-last")

    # unfused (no epilogue) and fused (each norm's epilogue as ResNet-50
    # runs it) sums over the 53 norms
    totals = {d: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                                "two_pass_ms", "fused_ms", "fused_plain_ms",
                                "fused_bound_ms", "fused_two_pass_ms"), 0.0)
              for d in ("forward", "backward")}
    worst = dict.fromkeys(("forward", "backward", "forward_two_pass",
                           "backward_two_pass"), 0.0)
    lib_note = "channels-last inputs"
    bound_by = set()
    for c, side, count in RESNET50_NORMS:
        b, hw = NORM_BATCH, side * side
        x, dy, gamma, beta = inputs(b, c, side, bf16)
        plans = {"forward": gn.forward_plan(b, c, hw, g, bf16),
                 "backward": gn.backward_plan(b, c, hw, g, bf16, bf16)}
        if plans["backward"]["design"] != "cluster":
            fail(f"GroupNorm b{b} C{c} {side}x{side}: the backward plan keeps "
                 "two_pass")
        for direction, plan in plans.items():
            occupancy = (gn.forward_occupancy if direction == "forward"
                         else gn.backward_occupancy)(x, g)
            clusters = (f"{b * c // plan['slab']} clusters, {occupancy} "
                        "resident at once (cudaOccupancyMaxActiveClusters)"
                        if plan["design"] == "cluster" else "two passes")
            print(f"[{card}] group_norm {direction} plan b{b} C{c} "
                  f"{side}x{side}: {plan}; {clusters}", flush=True)
        errs = check_norm(torch, gn, f"bf16 b{b} C{c} {side}x{side}", x, dy,
                          gamma, beta, bf16)
        for key, err in zip(worst, errs):
            worst[key] = max(worst[key], err)
        res = inputs(b, c, side, bf16)[0]
        check_epilogues(torch, gn, f"bf16 b{b} C{c} {side}x{side}", x, dy,
                        gamma, beta, res)
        _, mean, rstd = gn.group_norm_forward(x, gamma, beta, g, eps, bf16)
        gamma_lp, beta_lp = gamma.to(bf16), beta.to(bf16)
        args = (x, gamma_lp, beta_lp, b, c, hw, g, eps)
        # the backward's library call on the channels-last tensors where it
        # takes them and gives F.group_norm's statistics, else on NCHW copies
        want = F.group_norm(x, g, gamma_lp, beta_lp, eps).float()
        try:
            out, lmean, lrstd = torch.ops.aten.native_group_norm(*args)
            took = torch.allclose(out.float(), want, atol=0.05)
            lib_note = "its output on them disagreed with F.group_norm's"
        except RuntimeError as err:
            took, lib_note = False, str(err)[:80]
        lib_x, lib_dy = x, dy
        if not took:
            lib_note = f"NCHW-contiguous copies ({lib_note})"
            lib_x, lib_dy = x.contiguous(), dy.contiguous()
            _, lmean, lrstd = torch.ops.aten.native_group_norm(
                lib_x, gamma_lp, beta_lp, b, c, hw, g, eps)
        del want
        fns = {
            "forward": (
                lambda: gn.group_norm_forward(x, gamma, beta, g, eps, bf16),
                lambda: gn.group_norm_reference(x, gamma, beta, g, eps, bf16),
                lambda: F.group_norm(x, g, gamma_lp, beta_lp, eps)),
            "backward": (
                lambda: gn.group_norm_backward(dy, x, mean, rstd, gamma, g),
                lambda: gn.group_norm_backward_reference(dy, x, mean, rstd,
                                                         gamma, g),
                lambda: torch.ops.aten.native_group_norm_backward(
                    lib_dy, lib_x, lmean, lrstd, gamma_lp, b, c, hw, g,
                    [True] * 3)),
        }
        two_pass = {"design": "two_pass"}
        others = {
            "forward": lambda: gn._launch_forward(x, gamma, beta, g, eps,
                                                  bf16, two_pass),
            "backward": lambda: gn._launch_backward(dy, x, mean, rstd, gamma,
                                                    g, two_pass)}

        def fused(direction, epilogue):
            """(main design, two-pass design, plain version) of one norm
            with ``epilogue``."""
            relu = epilogue != "none"
            if direction == "forward":
                r = res if epilogue == "residual_relu" else None
                return (lambda: gn.group_norm_forward(
                            x, gamma, beta, g, eps, bf16, relu, r),
                        lambda: gn._launch_forward(
                            x, gamma, beta, g, eps, bf16, two_pass,
                            relu=relu, residual=r),
                        lambda: gn.group_norm_reference(
                            x, gamma, beta, g, eps, bf16, relu, r))
            return (lambda: gn.group_norm_backward(
                        dy, x, mean, rstd, gamma, g, relu, beta, eps),
                    lambda: gn._launch_backward(
                        dy, x, mean, rstd, gamma, g, two_pass, relu=relu,
                        bias=beta),
                    lambda: gn.group_norm_backward_reference(
                        dy, x, mean, rstd, gamma, g, relu, beta, eps))
        for direction, (kernel, plain, library) in fns.items():
            # the two designs in turns: main, two-pass, two-pass, main
            ms, two_ms, two_again, ms_again = (
                device_ms(torch, fn, 20) for fn in (
                    kernel, others[direction], others[direction], kernel))
            ms, two_ms = (ms + ms_again) / 2, (two_ms + two_again) / 2
            plain_ms, library_ms = (device_ms(torch, fn, n) for fn, n in (
                (plain, 3), (library, 10)))
            bound_ms, by = norm_bound(b, c, hw, 2, direction)
            bound_by.add(by)
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", library_ms), ("bound_ms", bound_ms),
                           ("two_pass_ms", two_ms)):
                totals[direction][key] += count * v
            print(f"[{card}] group_norm {direction} b{b} C{c} {side}x{side} "
                  f"bf16 (x{count} a step): {plans[direction]['design']} "
                  f"{ms * 1e3:.2f} us (device) | bound {bound_ms * 1e3:.2f} "
                  f"us ({bound_ms / ms:.1%}) | two-pass {two_ms * 1e3:.2f} us "
                  f"({bound_ms / two_ms:.1%}) | plain {plain_ms * 1e3:.2f} us "
                  f"| library {library_ms * 1e3:.2f} us", flush=True)
            mix = {}
            for epilogue, n in RESNET50_EPILOGUES[c, side].items():
                if direction == "backward":
                    epilogue = BACKWARD_EPILOGUE[epilogue]
                mix[epilogue] = mix.get(epilogue, 0) + n
            for epilogue, n in mix.items():
                row = (ms, two_ms, plain_ms, bound_ms)
                if epilogue != "none":
                    main, two, plain_e = fused(direction, epilogue)
                    f_ms, f_two, f_two2, f_ms2 = (
                        device_ms(torch, fn, 20) for fn in (main, two, two,
                                                            main))
                    row = ((f_ms + f_ms2) / 2, (f_two + f_two2) / 2,
                           device_ms(torch, plain_e, 3),
                           norm_bound(b, c, hw, 2, direction, epilogue)[0])
                    print(f"[{card}] group_norm {direction} with {epilogue} "
                          f"b{b} C{c} {side}x{side} bf16 (x{n} a step): "
                          f"{plans[direction]['design']} {row[0] * 1e3:.2f} "
                          f"us (device; {ms * 1e3:.2f} unfused) | bound "
                          f"{row[3] * 1e3:.2f} us ({row[3] / row[0]:.1%}; "
                          f"{bound_ms * 1e3:.2f} unfused) | two-pass "
                          f"{row[1] * 1e3:.2f} us | plain {row[2] * 1e3:.2f} "
                          "us", flush=True)
                for key, v in zip(("fused_ms", "fused_two_pass_ms",
                                   "fused_plain_ms", "fused_bound_ms"), row):
                    totals[direction][key] += n * v
        if (c, side) == RESNET50_NORMS[0][:2]:
            norm = GroupNorm(c, compute_dtype=bf16, device="cuda")
            xr = x.detach().requires_grad_()
            found = copying_ops(torch, lambda: norm(xr).backward(dy),
                                x.numel())
            print(f"  one GroupNorm forward and backward at b{b} C{c} "
                  f"{side}x{side}: copies or casts of {x.numel()}+ elements "
                  f"{found or 'none'}", flush=True)
            if found:
                fail(f"a GroupNorm forward and backward copies or casts "
                     f"activation-sized tensors: {found}")
            del norm, xr
        del x, dy, res, mean, rstd, lmean, lrstd, lib_x, lib_dy, fns, others
        release(torch)
    print(f"[{card}] group_norm over ResNet-50's 53 norms a step (library "
          f"backward on {lib_note}; each direction's two-pass design beside, "
          "3.706 and 5.446 ms before the cluster designs in PERF.md section "
          "6; fused: each norm's epilogue as ResNet-50 runs it, unfused 2.819 "
          "and 4.213 ms before the epilogues): " + json.dumps(totals),
          flush=True)

    if resnet_step is not None:
        steps = int(RESNET50_PARAMS["steps"])
        print(f"[{card}] resnet50: GroupNorm launches {norm_counts[:2]} over "
              f"{steps} steps ({norm_counts[0] // steps} forward and "
              f"{norm_counts[1] // steps} backward a step), by epilogue "
              f"forward {norm_counts[2]}, backward {norm_counts[3]}",
              flush=True)
        for mode in ("graph", "eager"):
            row = resnet_step[mode]
            print(f"[{card}] resnet50 {mode} step with the GroupNorm kernels"
                  f" and their epilogues: {row['step_ms']:.3f} ms, "
                  f"{row['images_per_s']:.1f} images/s, MFU "
                  f"{row['mfu']:.4f}, beside {NORM_UNFUSED_MS[mode]} ms "
                  f"before the epilogues, {NORM_BEFORE_MS[mode]} before the "
                  f"kernels, {NORM_TWO_PASS_MS[mode]} on the two-pass "
                  f"backward and {NORM_TWO_PASS_FWD_MS[mode]} on the "
                  "two-pass forward (PERF.md section 5)", flush=True)
        print(f"[{card}] resnet50 graphed call's device time in the "
              "elementwise passes around the norms: " + ", ".join(
                  f"{k} {100 * v:.2f}%" for k, v in
                  resnet_step["shares"].items())
              + " (10.5% adds and gradient sums, 8.9% relu backward, 6.1% "
              "relu forward before the epilogues: PERF.md section 5)",
              flush=True)
    # each row times the 53 norms with ResNet-50's epilogues (the main
    # path's work), its unfused times beside; the library call has none
    rows = {}
    for d in ("forward", "backward"):
        rows[d] = {"max_abs_err": worst[d], "ms": totals[d]["fused_ms"],
                   "plain_ms": totals[d]["fused_plain_ms"],
                   "bound_ms": totals[d]["fused_bound_ms"],
                   "bound_by": ("bytes" if bound_by == {"bytes"}
                                else "operations"),
                   "library_ms": totals[d]["library_ms"],
                   "unfused_ms": totals[d]["ms"],
                   "unfused_bound_ms": totals[d]["bound_ms"],
                   "unfused_plain_ms": totals[d]["plain_ms"]}
        rows[f"{d}_two_pass"] = {**rows[d],
                                 "max_abs_err": worst[f"{d}_two_pass"],
                                 "ms": totals[d]["fused_two_pass_ms"],
                                 "unfused_ms": totals[d]["two_pass_ms"]}
    return rows


# Phase 21: the loss kernels (ops/csrc/xent.cu). Their bound's f32
# operations an element (forward: subtract, scale, exp2, add; backward:
# subtract, scale, exp2, subtract, scale) over the f32 rate outside the
# tensor cores, beside the bytes.
XENT_OPS = {"fwd": 4, "bwd": 5}


def xent_inputs(torch, shape, dtype, seed=0, offset=0.0):
    """Seeded logits ``[T, Vp]`` (3 x standard normal plus ``offset``, NaN
    in the padded columns, which the kernels must not read) and int64
    labels ``[T]`` with 0 and V - 1 among them."""
    t, vp, v = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(t, vp, generator=gen, device="cuda").mul_(3).add_(offset)
    x[:, v:] = float("nan")
    y = torch.randint(0, v, (t,), generator=gen, device="cuda")
    y[0], y[1] = 0, v - 1
    return x.to(dtype), y


def check_xent_pair(torch, xent, label, x, y, v, g) -> dict:
    """The loss kernels against their plain versions on ``x``, ``y``: each
    row's loss and logsumexp, the mean and the gradient within
    ``xent_tolerance``, the padded columns exact zeros, a rerun the same
    bits. Returns the largest errors (the loss rows', the gradient's)."""
    loss, lse = xent.softmax_xent_forward(x, y, v)
    dx = xent.softmax_xent_backward(x, y, lse, g, v)
    torch.cuda.synchronize()
    ref_loss, ref_lse = xent.softmax_xent_forward_reference(x, y, v)
    ref_dx = xent.softmax_xent_backward_reference(x, y, g, v)
    bounds = xent.xent_tolerance(x, y, v, ref_loss, ref_lse, g, ref_dx)
    errs = {}
    for name, got, want in (("lse", lse, ref_lse), ("loss", loss, ref_loss),
                            ("dlogits", dx[:, :v], ref_dx[:, :v])):
        err = (got.float() - want.float()).abs()
        ratio = float((err / bounds[name]).max())
        errs[name] = float(err.max())
        if not (bool(torch.isfinite(got).all()) and ratio <= 1):
            fail(f"xent {label}: {name} off its plain version: max err "
                 f"{errs[name]:.3e}, err/bound {ratio:.3f}")
        errs[name + "_ratio"] = ratio
    mean_err = float((loss.mean() - ref_loss.mean()).abs())
    pad_zero = bool((dx[:, v:] == 0).all())
    again_loss, again_lse = xent.softmax_xent_forward(x, y, v)
    again = xent.softmax_xent_backward(x, y, again_lse, g, v)
    rerun = all(same_bits(torch, a, b) for a, b in (
        (loss, again_loss), (lse, again_lse), (dx, again)))
    print(f"xent {label}: loss rows max err {errs['loss']:.3e} (err/bound "
          f"{errs['loss_ratio']:.3f}), lse {errs['lse']:.3e} "
          f"({errs['lse_ratio']:.3f}), mean {mean_err:.3e} (bound "
          f"{float(bounds['mean']):.3e}), dlogits {errs['dlogits']:.3e} "
          f"({errs['dlogits_ratio']:.3f}); padded columns zero {pad_zero}; "
          f"rerun the same bits {rerun}", flush=True)
    if not (mean_err <= float(bounds["mean"]) and pad_zero and rerun):
        fail(f"xent {label}: mean off its bound, a padded column not zero "
             "or a rerun not the same bits")
    return errs


def xent_rows(torch, xent, card, label, shape, total=None) -> dict:
    """The loss kernels at ``shape`` in bf16, each timed (device time, the
    card held busy; event time beside it) beside its byte bound, its plain
    version and the library yardstick: ``F.cross_entropy`` on the cut
    logits (a contiguous copy made beforehand), forward, and its backward
    alone (``torch.autograd.grad``). With ``total`` (the whole vocab) the
    logits are a ``tensor`` rank's first block of the vocab (its ``v``
    real columns from column 0; the labels fall in it), the kernels and the
    plain versions in their slice forms, the library call on the block's
    real columns."""
    import torch.nn.functional as F

    t, vp, v = shape
    x, y = xent_inputs(torch, shape, torch.bfloat16, seed=7)
    g = torch.ones((), device="cuda")
    _, lse = xent.softmax_xent_forward(x, y, v, 0, total)
    cut = x[:, :v].contiguous().requires_grad_()
    out = F.cross_entropy(cut, y)
    element = x.element_size()
    moved = {"fwd": t * vp * element + t * (8 + 2 * 4),
             "bwd": 2 * t * vp * element + t * (8 + 4)}
    rows = {}
    merged = None if total is None else lse  # the slice form's backward
    for name, fns in (
            ("fwd", (lambda: xent.softmax_xent_forward(x, y, v, 0, total),
                     lambda: xent.softmax_xent_forward_reference(
                         x, y, v, 0, total),
                     lambda: F.cross_entropy(cut, y))),
            ("bwd", (lambda: xent.softmax_xent_backward(x, y, lse, g, v, 0,
                                                        total),
                     lambda: xent.softmax_xent_backward_reference(
                         x, y, g, v, 0, merged),
                     lambda: torch.autograd.grad(out, cut,
                                                 retain_graph=True)))):
        (ms, plain_ms, library_ms), _ = timed_rows(
            torch, card, f"xent_{name} ({label})", fns)
        bytes_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = XENT_OPS[name] * t * v / F32_FLOPS * 1e3
        rows[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms, shape=[t, vp])
        print(f"[{card}] xent_{name} T {t} Vp {vp} bf16 ({label}): "
              f"{ms:.4f} ms (device) | plain {plain_ms:.4f} ms | "
              f"F.cross_entropy {library_ms:.4f} ms | bound "
              f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']}, "
              f"{moved[name] / 1e6:.1f} MB) | "
              f"{100 * rows[name]['bound_ms'] / ms:.1f}% of the bound",
              flush=True)
    del x, y, cut, out
    release(torch)
    return rows


# The slices of GPT-2 small's vocab that phase 21 holds against the plain
# versions: (rows, tensor ranks t, the rank's index) at a data 2 x tensor 2
# or tensor 4 rank's T of 4096 (b 4 x 1024): rank 0 of 2 (25152 columns,
# all real), rank 1 of 2 (25105 of 25152 real) and rank 3 of 4 (12433 of
# 12608 real)
XENT_SLICES = {"gpt2 rank 0 of 2": (4096, 2, 0),
               "gpt2 rank 1 of 2": (4096, 2, 1),
               "gpt2 rank 3 of 4": (4096, 4, 3)}
# The slices timed for the kernels line, rank 0's block of GPT-2 small's
# vocab under tensor 2: phase 15's T (b 8 x 1024) and a data 2 x tensor 2
# rank's (b 4 x 1024): (T, columns, real columns)
XENT_TENSOR_SHAPES = {"tensor": (8192, 25152, 25152),
                      "tensor_data2": (4096, 25152, 25152)}


def check_xent_slices(torch, xent) -> dict:
    """The loss kernels in their slice forms at :data:`XENT_SLICES`, bf16
    and f32 +100: each slice's logsumexp within ``xent_tolerance`` of its
    plain version and its label logit the same bits; the t slices' forward
    results merged (``merge_slices``) within ``merge_tolerance`` of the
    whole row's kernel; each slice's gradient from the merged logsumexp
    within ``xent_tolerance`` of its plain version, zeros past its real
    columns, a rerun the same bits. Returns the largest errors by
    slice and dtype."""
    from cron_operator_tpu_torch.models.layers import vocab_split

    split = vocab_split(GPT2_VOCAB)
    errs = {}
    for t in sorted({t for _, t, _ in XENT_SLICES.values()}):
        rows = XENT_SLICES[next(k for k, v in XENT_SLICES.items()
                                if v[1] == t)][0]
        per = split.padded(t) // t
        for dtype, offset in ((torch.bfloat16, 0.0), (torch.float32, 100.0)):
            x, y = xent_inputs(torch, (rows, split.padded(t), GPT2_VOCAB),
                               dtype, seed=10 + t, offset=offset)
            g = torch.full((), 0.37, device="cuda")
            parts = []
            for r in range(t):
                lo, real = split.offset(r, t)
                piece = x[:, lo:lo + per].contiguous()
                parts.append((piece, lo, real) + xent.softmax_xent_forward(
                    piece, y, real, lo, GPT2_VOCAB))
            loss, lse = xent.softmax_xent_forward(x, y, GPT2_VOCAB)
            ref_loss, ref_lse = xent.softmax_xent_forward_reference(
                x, y, GPT2_VOCAB)
            lses = torch.stack([p[4] for p in parts])
            got_loss, got_lse = xent.merge_slices(
                lses, torch.stack([p[3] for p in parts]))
            bounds = xent.merge_tolerance(xent.xent_tolerance(
                x, y, GPT2_VOCAB, ref_loss, ref_lse), lses, lse)
            tag = f"{str(dtype)[6:]} offset {offset:g}"
            merge = {}
            for key, got, want in (("lse", got_lse, lse),
                                   ("loss", got_loss, loss)):
                err = (got - want).abs()
                merge[key] = float((err / bounds[key]).max())
                if not merge[key] <= 1:
                    fail(f"xent: {t} slices merged off the whole row's "
                         f"kernel ({key}, {tag}): max err "
                         f"{float(err.max()):.3e}, err/bound {merge[key]:.3f}")
            print(f"xent: GPT-2 small's {t} slices merged against the whole "
                  f"row's kernel ({tag}): err/bound lse {merge['lse']:.3f}, "
                  f"loss {merge['loss']:.3f}", flush=True)
            for name, (_, tt, r) in XENT_SLICES.items():
                if tt != t:
                    continue
                piece, lo, real, picked, slse = parts[r]
                ref_picked, ref_slse = xent.softmax_xent_forward_reference(
                    piece, y, real, lo, GPT2_VOCAB)
                dx = xent.softmax_xent_backward(piece, y, got_lse, g, real,
                                                lo, GPT2_VOCAB)
                again = xent.softmax_xent_backward(piece, y, got_lse, g, real,
                                                   lo, GPT2_VOCAB)
                ref_dx = xent.softmax_xent_backward_reference(
                    piece, y, g, real, lo, got_lse)
                fwd = xent.xent_tolerance(piece, y, real, ref_picked,
                                          ref_slse, lo=lo)
                bwd = xent.xent_tolerance(piece, y, real, ref_picked,
                                          got_lse, g, ref_dx, lo=lo)
                lse_ratio = float(((slse - ref_slse).abs()
                                   / fwd["lse"]).max())
                dx_err = (dx[:, :real].float() - ref_dx[:, :real].float()).abs()
                dx_ratio = float((dx_err / bwd["dlogits"]).max())
                picked_same = same_bits(torch, picked, ref_picked)
                pad_zero = bool((dx[:, real:] == 0).all())
                rerun = same_bits(torch, dx, again)
                label = f"{name} {tag}"
                errs[label] = {"lse": float((slse - ref_slse).abs().max()),
                               "dlogits": float(dx_err.max()),
                               "lse_ratio": lse_ratio,
                               "dlogits_ratio": dx_ratio}
                print(f"xent {label}: [{rows}, {per}], {real} real columns "
                      f"from {lo}: lse err/bound {lse_ratio:.3f}, label "
                      f"logits the same bits {picked_same}, dlogits max err "
                      f"{errs[label]['dlogits']:.3e} (err/bound "
                      f"{dx_ratio:.3f}); padding zero {pad_zero}; rerun the "
                      f"same bits {rerun}", flush=True)
                if not (lse_ratio <= 1 and dx_ratio <= 1 and picked_same
                        and pad_zero and rerun
                        and bool(torch.isfinite(dx).all())):
                    fail(f"xent {label}: the slice kernels off their plain "
                         "versions")
            del x, y, parts
            release(torch)
    return errs


def logits_made(torch, fn, t: int, v: int, vp: int) -> list:
    """(op, shape, dtype) of every aten op result of one call of ``fn``
    that is shaped like the logits (last dim V or Vp, at least T V
    elements): a dispatch mode sees every op, the autograd engine's
    included, and those of a CUDA graph's capture (a kernel called
    through ctypes runs none)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    made = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for r in tree_leaves(out):
                if (isinstance(r, torch.Tensor) and r.dim() >= 2
                        and r.shape[-1] in (v, vp) and r.numel() >= t * v):
                    made.append((str(func), tuple(r.shape), str(r.dtype)))
            return out

    with Watch():
        fn()
    return made


def phase_xent(torch, card) -> dict:
    """The loss kernels (``ops/csrc/xent.cu``) against their plain versions
    at GPT-2 small's and BERT-base's logits, bf16 and f32, and offset by
    +100; their times beside the bounds, the plain versions and
    ``F.cross_entropy`` (also at the data mesh's local T of 4096 rows);
    the first graphed call of a GPT-2 small and a BERT-base step making no
    f32 tensor of the logits' size and no cut copy of them; the gpt, bert and MoE gpt
    graphed steps on the loss kernels and with the former loss swapped in
    (the model's f32 logits and ``cross_entropy_loss``), in turns, beside
    :data:`LOSS_BEFORE_MS`, with the peak memory of each (LayerNorm's
    part of the steps is phase 22's). Returns the kernels line's rows and
    the readings."""
    from cron_operator_tpu_torch.models import GPT, Bert, BertConfig, GPTConfig
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import TrainConfig, Trainer

    xent = importlib.import_module("cron_operator_tpu_torch.ops.xent")
    errs = {}
    for name, shape in XENT_SHAPES.items():
        for dtype, offset, g in ((torch.bfloat16, 0.0, 1.0),
                                 (torch.float32, 0.0, 1.0),
                                 (torch.bfloat16, 100.0, 0.37),
                                 (torch.float32, 100.0, 0.37)):
            x, y = xent_inputs(torch, shape, dtype, seed=len(errs),
                               offset=offset)
            label = f"{name} {str(dtype)[6:]} offset {offset:g}"
            errs[label] = check_xent_pair(
                torch, xent, label, x, y, shape[2],
                torch.full((), g, device="cuda"))
            del x, y
            release(torch)
    # the local logits of a rank: the data mesh's and ring gpt's (b 4 x
    # 1024 or 8 x 512 rows), Ulysses bert's (b 8 x 256)
    local = {"mesh": ((4096,) + XENT_SHAPES["gpt"][1:], "gpt"),
             "seq_bert": ((2048,) + XENT_SHAPES["bert"][1:], "bert")}
    rows = {name: xent_rows(torch, xent, card, name, shape)
            for name, shape in (*XENT_SHAPES.items(),
                                *((n, shape) for n, (shape, _)
                                  in local.items()))}
    for name in XENT_SHAPES:
        for d in ("fwd", "bwd"):
            key = "loss" if d == "fwd" else "dlogits"
            rows[name][d]["max_abs_err"] = errs[
                f"{name} bfloat16 offset 0"][key]
    for name, (_, like) in local.items():
        for d in ("fwd", "bwd"):
            rows[name][d]["max_abs_err"] = rows[like][d]["max_abs_err"]
    slice_errs = check_xent_slices(torch, xent)
    for name, shape in XENT_TENSOR_SHAPES.items():
        rows[name] = xent_rows(torch, xent, card, name, shape,
                               total=GPT2_VOCAB)
        for d in ("fwd", "bwd"):
            rows[name][d]["max_abs_err"] = slice_errs[
                "gpt2 rank 0 of 2 bfloat16 offset 0"][
                    "lse" if d == "fwd" else "dlogits"]

    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    models = {
        "gpt": (GPT, GPTConfig(max_len=s),
                data.causal_token_sample(b, s, 50257), False),
        "bert": (Bert, BertConfig.base(max_len=BERT_SHAPE["s"]),
                 data.token_sample(BERT_SHAPE["b"], BERT_SHAPE["s"], 30522),
                 False),
        "moe": (GPT, moe_cfg(), data.causal_token_sample(b, s, 50257), True),
    }

    def trainer_of(name, former=False):
        cls, cfg, sample, moe = models[name]
        wired, loss_fn = lm_wiring(cfg, former)
        model = cls(wired, device="cuda").init_weights(
            torch.Generator(device="cuda").manual_seed(0))
        return Trainer(model, TrainConfig(aux_loss_in_output=moe),
                       loss_fn=loss_fn, sample_fn=sample)

    kinds = {}
    for name in XENT_SHAPES:
        t, vp, v = XENT_SHAPES[name]
        trainer = trainer_of(name)
        made = logits_made(
            torch, lambda: trainer.step({}, chunk=GRAPH_CHUNK), t, v, vp)
        del trainer
        release(torch)
        kinds[name] = sorted(set(made))
        print(f"xent: the first graphed call of a {name} step (warm-up, "
              f"capture, {GRAPH_CHUNK - 1} replays) made {len(made)} "
              f"logits-shaped tensors: {kinds[name]}", flush=True)
        if not made or any(dtype != "torch.bfloat16" or shape[-1] != vp
                           for _, shape, dtype in made):
            fail(f"xent: a graphed {name} step made an f32 tensor of the "
                 "logits' size or a cut copy of the logits (or the watch "
                 "saw none)")

    ab = {}
    for name in models:
        runs, best = graphed_runs(
            torch, ("kernels", "former", "former", "kernels"),
            lambda path: trainer_of(name, former=path == "former"))
        ab[name] = {"runs": runs, "best": best}
        print(f"[{card}] {name} step A/B (graphed, kernels/former/former/"
              f"kernels): " + " | ".join(f"{p} " + ", ".join(
                  f"{r['step_ms']:.3f} ms ({r['device_ms']:.3f} device, peak "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB)" for r in rs)
                  for p, rs in runs.items())
              + " | kernels/former "
              f"{best['kernels']['step_ms'] / best['former']['step_ms']:.4f}"
              f" | beside {LOSS_BEFORE_MS[name]} ms on the former loss "
              "(PERF.md section 5)", flush=True)
    return {"rows": rows, "errors": errs, "slice_errors": slice_errs,
            "logits_made": kinds, "step_ab": ab}


# Phase 22: the LayerNorm kernels (ops/csrc/layer_norm.cu) at the rows
# (T, H) of the main paths: GPT-2 small's b 8 x 1024, BERT-base's b 8 x
# 512 (and the data mesh's rank), ViT-B/16's b 64 x 197, a decode step's
# b 8, the pipeline's microbatch of 2 x 1024 and the tiny configs' widths.
LN_SHAPES = {"gpt": (8192, 768), "bert": (4096, 768), "vit": (12608, 768),
             "decode": (8, 768), "pipeline": (2048, 768),
             "tiny_gpt": (2048, 128), "tiny_vit": (2048, 64)}
LN_TIMED = ("gpt", "bert", "vit", "decode", "pipeline")
# the shapes also checked with rows offset by +100
LN_OFFSET_SHAPES = ("gpt", "tiny_gpt", "tiny_vit")
LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon, the models' LN_EPS
# The graphed gpt and bert steps and the graphed decode step before the
# residual adds were folded into the norms, PERF.md section 5's readings
# (H100 80GB HBM3, 700 W).
LN_BEFORE_MS = {"gpt": 19.738, "bert": 10.585, "decode": 0.662}
# f32 operations an element in the bound's count beside the bytes: the
# forward's sum, centred square (2), and y (3); the backward's x̂ (2), γ dy,
# two row sums (2), two parameter partials (2) and dx (4); the fold adds
# one (the residual add, the gradient's add).
LN_OPS = {"fwd": 6, "bwd": 12, "add_fwd": 7, "add_bwd": 13}
# The folded pair checked at these shapes (bf16 and f32), with the
# residual stream's gradient and without.
LN_FOLD_SHAPES = ("decode", "gpt", "bert", "vit", "pipeline", "tiny_gpt")


def ln_inputs(torch, shape, dtype, param_dtype=None, seed=0, offset=0.0):
    """Seeded x (standard normal plus ``offset``) and dy in ``dtype``, gamma
    (1 + 0.1 normal) and beta (0.1 normal) in ``param_dtype`` (f32 by
    default)."""
    t, h = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(t, h, generator=gen, device="cuda").add_(offset)
    dy = torch.randn(t, h, generator=gen, device="cuda")
    gamma = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(h, generator=gen, device="cuda")
    pdt = param_dtype or torch.float32
    return x.to(dtype), dy.to(dtype), gamma.to(pdt), beta.to(pdt)


def check_ln_pair(torch, ln, label, x, dy, gamma, beta, out_dtype) -> dict:
    """The LayerNorm kernels against their plain versions on the same
    inputs: y, mean, rstd, dx, dgamma and dbeta within
    ``layer_norm_tolerance``, a rerun the same bits. Returns the largest
    errors (y's and dx's) and err/bound ratios."""
    y, mean, rstd = ln.layer_norm_forward(x, gamma, beta, LN_EPS, out_dtype)
    grads = ln.layer_norm_backward(dy, x, mean, rstd, gamma, beta)
    torch.cuda.synchronize()
    ref = ln.layer_norm_reference(x, gamma, beta, LN_EPS, out_dtype)
    ref_grads = ln.layer_norm_backward_reference(dy, x, ref[1], ref[2],
                                                 gamma, beta)
    bounds = ln.layer_norm_tolerance(x, gamma, beta, ref[1], ref[2], ref[0],
                                     dy, ref_grads[0], ref_grads[1])
    errs = {}
    h = x.shape[-1]
    for name, got, want in zip(("y", "mean", "rstd", "dx", "dgamma",
                                "dbeta"), (y, mean, rstd, *grads),
                               (*ref, *ref_grads)):
        err = (got.float() - want.float()).abs()
        if name in ("y", "dx"):
            err = err.reshape(-1, h)
        ratio = float((err / bounds[name]).max())
        errs[name] = float(err.max())
        errs[name + "_ratio"] = ratio
        if not (got.dtype == want.dtype and got.shape == want.shape
                and bool(torch.isfinite(got).all()) and ratio <= 1):
            fail(f"layer_norm {label}: {name} off its plain version: max "
                 f"err {errs[name]:.3e}, err/bound {ratio:.3f}")
    again = ln.layer_norm_forward(x, gamma, beta, LN_EPS, out_dtype)
    again_grads = ln.layer_norm_backward(dy, x, again[1], again[2], gamma,
                                         beta)
    rerun = all(same_bits(torch, a, b) for a, b in zip(
        (y, mean, rstd, *grads), (*again, *again_grads)))
    print(f"layer_norm {label}: " + ", ".join(
        f"{k} {errs[k]:.3e} ({errs[k + '_ratio']:.3f})"
        for k in ("y", "mean", "rstd", "dx", "dgamma", "dbeta"))
        + f" (max err, err/bound); rerun the same bits {rerun}", flush=True)
    if not rerun:
        fail(f"layer_norm {label}: a rerun is not the same bits")
    return errs


def ln_rows(torch, ln, card, label, shape) -> dict:
    """The LayerNorm kernels at ``shape`` in bf16 (f32 parameters), each
    timed (device time, the card held busy; event time beside it) beside
    its byte bound, its plain version and the library yardstick:
    ``F.layer_norm`` on the bf16 x with bf16-cast parameters, forward, and
    its backward alone (``torch.autograd.grad``)."""
    import torch.nn.functional as F

    t, h = shape
    x, dy, gamma, beta = ln_inputs(torch, shape, torch.bfloat16, seed=7)
    _, mean, rstd = ln.layer_norm_forward(x, gamma, beta, LN_EPS,
                                          torch.bfloat16)
    lx = x.clone().requires_grad_()
    lp = [p.to(torch.bfloat16).requires_grad_() for p in (gamma, beta)]
    out = F.layer_norm(lx, (h,), *lp, LN_EPS)
    element = x.element_size()
    # each input read once, each output written once: x, gamma, beta in;
    # y, mean, rstd out; backward dy, x, mean, rstd, gamma in and dx,
    # dgamma, dbeta out
    moved = {"fwd": 2 * t * h * element + 2 * h * 4 + 2 * t * 4,
             "bwd": 3 * t * h * element + 2 * t * 4 + 3 * h * 4}
    rows = {}
    for name, fns in (
            ("fwd", (lambda: ln.layer_norm_forward(x, gamma, beta, LN_EPS,
                                                   torch.bfloat16),
                     lambda: ln.layer_norm_reference(x, gamma, beta, LN_EPS,
                                                     torch.bfloat16),
                     lambda: F.layer_norm(lx, (h,), *lp, LN_EPS))),
            ("bwd", (lambda: ln.layer_norm_backward(dy, x, mean, rstd, gamma,
                                                    beta),
                     lambda: ln.layer_norm_backward_reference(
                         dy, x, mean, rstd, gamma, beta),
                     lambda: torch.autograd.grad(out, (lx, *lp), dy,
                                                 retain_graph=True)))):
        (ms, plain_ms, library_ms), _ = timed_rows(
            torch, card, f"layer_norm_{name} ({label})", fns)
        bytes_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = LN_OPS[name] * t * h / F32_FLOPS * 1e3
        rows[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms)
        print(f"[{card}] layer_norm_{name} [{t}, {h}] bf16 ({label}): "
              f"{ms:.4f} ms (device) | plain {plain_ms:.4f} ms | "
              f"F.layer_norm bf16 {library_ms:.4f} ms | bound "
              f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']}, "
              f"{moved[name] / 1e6:.2f} MB) | "
              f"{100 * rows[name]['bound_ms'] / ms:.1f}% of the bound",
              flush=True)
    del x, dy, lx, lp, out
    release(torch)
    return rows


def check_fold_pair(torch, ln, label, x, r, dy, ds, gamma, beta,
                    out_dtype) -> dict:
    """The folded LayerNorm kernels against their plain versions on the
    same inputs: s the bits of torch's add, then y, mean, rstd, dx, dgamma
    and dbeta within ``layer_norm_tolerance`` (dx's bound with the plain
    version's second rounding, ``dx_norm``), a rerun the same bits.
    Returns the largest errors and err/bound ratios."""
    s, y, mean, rstd = ln.add_layer_norm_forward(x, r, gamma, beta, LN_EPS,
                                                 out_dtype)
    grads = ln.add_layer_norm_backward(dy, ds, s, mean, rstd, gamma, beta)
    torch.cuda.synchronize()
    ref = ln.add_layer_norm_reference(x, r, gamma, beta, LN_EPS, out_dtype)
    ref_grads = ln.add_layer_norm_backward_reference(dy, ds, ref[0], ref[2],
                                                     ref[3], gamma, beta)
    dx_norm = ln.layer_norm_backward_reference(dy, ref[0], ref[2], ref[3],
                                               gamma, beta)[0]
    bounds = ln.layer_norm_tolerance(ref[0], gamma, beta, ref[2], ref[3],
                                     ref[1], dy, ref_grads[0], ref_grads[1],
                                     dx_norm=None if ds is None else dx_norm)
    if not same_bits(torch, s, ref[0]):
        fail(f"layer_norm_add {label}: s is not the bits of torch's add")
    errs = {}
    h = x.shape[-1]
    for name, got, want in zip(("y", "mean", "rstd", "dx", "dgamma",
                                "dbeta"), (y, mean, rstd, *grads),
                               (*ref[1:], *ref_grads)):
        err = (got.float() - want.float()).abs()
        if name in ("y", "dx"):
            err = err.reshape(-1, h)
        ratio = float((err / bounds[name]).max())
        errs[name] = float(err.max())
        errs[name + "_ratio"] = ratio
        if not (got.dtype == want.dtype and got.shape == want.shape
                and bool(torch.isfinite(got).all()) and ratio <= 1):
            fail(f"layer_norm_add {label}: {name} off its plain version: "
                 f"max err {errs[name]:.3e}, err/bound {ratio:.3f}")
    again = ln.add_layer_norm_forward(x, r, gamma, beta, LN_EPS, out_dtype)
    again_grads = ln.add_layer_norm_backward(dy, ds, again[0], again[2],
                                             again[3], gamma, beta)
    rerun = all(same_bits(torch, a, b) for a, b in zip(
        (s, y, mean, rstd, *grads), (*again, *again_grads)))
    print(f"layer_norm_add {label}: s the bits of torch's add, " + ", ".join(
        f"{k} {errs[k]:.3e} ({errs[k + '_ratio']:.3f})"
        for k in ("y", "mean", "rstd", "dx", "dgamma", "dbeta"))
        + f" (max err, err/bound); rerun the same bits {rerun}", flush=True)
    if not rerun:
        fail(f"layer_norm_add {label}: a rerun is not the same bits")
    return errs


def fold_rows(torch, ln, card, label, shape) -> dict:
    """The folded LayerNorm kernels at ``shape`` in bf16 (f32 parameters),
    each timed (device time, the card held busy) beside its byte bound, its
    plain version (torch's add, then the norm's plain version), the two
    library calls it replaces (torch's add, then ``F.layer_norm`` on the
    bf16 sum with bf16-cast parameters; backward, autograd's through both
    with the residual stream's gradient) and the unfolded kernels after
    torch's add (``unfolded_ms``)."""
    import torch.nn.functional as F

    t, h = shape
    x, dy, gamma, beta = ln_inputs(torch, shape, torch.bfloat16, seed=8)
    r, ds, _, _ = ln_inputs(torch, shape, torch.bfloat16, seed=9)
    s, _, mean, rstd = ln.add_layer_norm_forward(x, r, gamma, beta, LN_EPS,
                                                 torch.bfloat16)
    lx, lr = (v.clone().requires_grad_() for v in (x, r))
    lp = [p.to(torch.bfloat16).requires_grad_() for p in (gamma, beta)]
    ls = lx + lr
    out = F.layer_norm(ls, (h,), *lp, LN_EPS)
    element = x.element_size()
    # each input read once, each output written once: x, r, gamma, beta in;
    # s, y, mean, rstd out; backward s, dy, ds, mean, rstd, gamma in and
    # dx, dgamma, dbeta out
    moved = {"fwd": 4 * t * h * element + 2 * h * 4 + 2 * t * 4,
             "bwd": 4 * t * h * element + 2 * t * 4 + 3 * h * 4}
    rows = {}
    for name, fns in (
            ("fwd", (lambda: ln.add_layer_norm_forward(
                        x, r, gamma, beta, LN_EPS, torch.bfloat16),
                     lambda: ln.add_layer_norm_reference(
                         x, r, gamma, beta, LN_EPS, torch.bfloat16),
                     lambda: F.layer_norm(x + r, (h,), *lp, LN_EPS),
                     lambda: ln.layer_norm_forward(x + r, gamma, beta, LN_EPS,
                                                   torch.bfloat16))),
            ("bwd", (lambda: ln.add_layer_norm_backward(
                        dy, ds, s, mean, rstd, gamma, beta),
                     lambda: ln.add_layer_norm_backward_reference(
                         dy, ds, s, mean, rstd, gamma, beta),
                     lambda: torch.autograd.grad((ls, out), (lx, lr, *lp),
                                                 (ds, dy), retain_graph=True),
                     lambda: ln.layer_norm_backward(dy, s, mean, rstd, gamma,
                                                    beta)[0] + ds))):
        (ms, plain_ms, library_ms, unfolded_ms), _ = timed_rows(
            torch, card, f"layer_norm_add_{name} ({label})", fns,
            iters=(20, 5, 20, 20))
        bytes_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = LN_OPS["add_" + name] * t * h / F32_FLOPS * 1e3
        rows[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms, unfolded_ms=unfolded_ms)
        print(f"[{card}] layer_norm_add_{name} [{t}, {h}] bf16 ({label}): "
              f"{ms:.5f} ms (device) | unfolded kernels after torch's add "
              f"{unfolded_ms:.5f} ms | plain {plain_ms:.4f} ms | torch add "
              f"and F.layer_norm bf16 {library_ms:.5f} ms | bound "
              f"{rows[name]['bound_ms']:.5f} ms ({rows[name]['bound_by']}, "
              f"{moved[name] / 1e6:.2f} MB) | "
              f"{100 * rows[name]['bound_ms'] / ms:.1f}% of the bound",
              flush=True)
    del x, r, dy, ds, lx, lr, lp, ls, out
    release(torch)
    return rows


def path_context(path: str):
    """The phase 22 A/B's swap for ``path``: the blocks unfolded (torch's
    residual adds, the norms alone) for ``"unfolded"``, else none."""
    return (unfolded_layer_norm() if path == "unfolded"
            else contextlib.nullcontext())


def first_flip_ok(torch, models: dict, prompt, tokens: dict) -> list:
    """Where the greedy tokens of the folded and the unfolded models first
    part in a row: each path's logits at that shared prefix (an eager
    prefill of the row), and whether the unfolded path's top-2 margin
    there lies within twice the paths' largest logit gap (a near tie that
    either rounding may break), as phase 3 allows. Returns (row, position,
    margin, gap, ok) for each row that parts."""
    found = []
    a, b = tokens["folded"], tokens["unfolded"]
    p = prompt.shape[1]
    for row in (a != b).any(dim=1).nonzero().flatten().tolist():
        pos = int((a[row] != b[row]).nonzero()[0])
        prefix = a[row:row + 1, :pos]
        logits = {}
        for path, model in models.items():
            with path_context(path):
                logits[path] = model.prefill(prefix, model.new_cache(1))[0]
        gap = float((logits["folded"] - logits["unfolded"]).abs().max())
        top2 = logits["unfolded"].float().topk(2).values
        margin = float(top2[0] - top2[1])
        found.append((row, pos - p, margin, gap, margin <= 2 * gap))
    return found


def ln_decode_ab(torch, card) -> dict:
    """GPT-2 small serving (bf16 parameters, b 8, prompt 512, 64 new
    tokens, greedy) with the residual adds folded into the LayerNorm
    kernels and unfolded (torch's adds, the norms alone), each on a model
    of its own (the captured prefill and decode step are kept per model)
    from the same weights, in turns folded/unfolded/unfolded/folded: the
    graphed generation's wall ms (median of 3 after the captures'), the
    graphed prefill's ms and the decode ms a step ``(wall - prefill) /
    63``, and the device ms of a replayed decode step and prefill; greedy
    tokens graph against eager on each path, and folded against unfolded
    (through ``first_flip_ok``); the bf16 adds of a replayed decode step
    on each path, 24 fewer folded."""
    from cron_operator_tpu_torch.models import GPTConfig

    serving = importlib.import_module("cron_operator_tpu_torch.workloads.generate")
    cfg = GPTConfig(max_len=1024)
    b, p, n = 8, 512, 64
    models = {"folded": slice_model(torch, cfg)}
    models["unfolded"] = slice_model(torch, cfg, models["folded"])
    prompt = torch.randint(0, cfg.vocab_size, (b, p), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(5))
    runs, tokens, adds = {}, {}, {}
    with torch.inference_mode():
        for path in ("folded", "unfolded", "unfolded", "folded"):
            model = models[path]
            with path_context(path):
                walls = []
                for _ in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    graphed = serving.generate(cfg, model, prompt, n)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                eager = serving.generate(cfg, model, prompt, n,
                                         captured=False)
                if not torch.equal(graphed, eager):
                    fail(f"layer_norm decode ({path}): greedy tokens through "
                         "the graphs differ from the eager loop's")
                tokens[path] = graphed
                decoder = serving._decoder(model, b, True, None)
                token = prompt[:, -1:]

                def replay():
                    decoder.cache.pos.fill_(p)
                    decoder.step({"token": token})

                def prefill():
                    decoder.prefills[p]({"prompt": prompt})

                device = device_ms(torch, replay, iters=20, reps=5)
                prefill_ms = median_ms(torch, prefill, iters=10)
                prefill_device = device_ms(torch, prefill, iters=5, reps=5)
                if path not in adds:
                    kernels = []
                    profile_window(torch, card, f"decode step ({path})",
                                   replay, kernels)
                    adds[path] = norm_and_add_launches(kernels)
            gen_ms = statistics.median(walls[1:])
            runs.setdefault(path, []).append({
                "generate_ms": gen_ms, "first_round_ms": walls[0],
                "prefill_ms": prefill_ms,
                "prefill_device_ms": prefill_device,
                "decode_ms_per_step": (gen_ms - prefill_ms) / (n - 1),
                "device_ms_per_step": device})
        flips = first_flip_ok(torch, models, prompt, tokens)
    best = {k: min(v, key=lambda r: r["decode_ms_per_step"])
            for k, v in runs.items()}
    same = torch.equal(tokens["folded"], tokens["unfolded"])
    print(f"[{card}] decode A/B (graphed, folded/unfolded/unfolded/folded): "
          + " | ".join(f"{k} " + ", ".join(
              f"{r['decode_ms_per_step']:.4f} ms a step "
              f"({r['device_ms_per_step']:.4f} device, graphed prefill "
              f"{r['prefill_ms']:.3f}, {r['prefill_device_ms']:.3f} device)"
              for r in v) for k, v in runs.items())
          + f" | beside {LN_BEFORE_MS['decode']} ms unfolded (PERF.md "
          f"section 5); greedy tokens graph == eager on each, folded == "
          f"unfolded {same}; a replayed step's (LayerNorm, bf16 add) "
          f"launches {adds}", flush=True)
    for row, pos, margin, gap, ok in flips:
        print(f"  row {row}: greedy tokens part at new token {pos}; the "
              f"unfolded top-2 margin {margin:.4f} vs the paths' logit gap "
              f"{gap:.4f}", flush=True)
        if not ok:
            fail(f"layer_norm decode: row {row}'s greedy token {pos} differs "
                 "between the folded and the unfolded path beyond the "
                 "logit gap")
    if (adds["folded"][0] != LM_NORMS or adds["unfolded"][0] != LM_NORMS
            or adds["unfolded"][1] - adds["folded"][1] != LM_NORMS - 1):
        fail(f"layer_norm decode: a replayed step's (LayerNorm, bf16 add) "
             f"launches {adds}: not {LM_NORMS} norms on each path and "
             f"{LM_NORMS - 1} adds fewer folded")
    del models
    release(torch)
    return {"runs": runs, "best": best, "tokens_equal": same,
            "flips": flips, "adds": adds}


def phase_layer_norm(torch, card, steps: dict, serving: dict) -> dict:
    """The LayerNorm kernels (``ops/csrc/layer_norm.cu``) against their
    plain versions at :data:`LN_SHAPES`, x in bf16 and f32, f32 and bf16
    parameters, and rows offset by +100 (bf16, f32, and f32 x with a bf16
    y) within ``layer_norm_tolerance``, reruns the same bits; the folded
    pair (the residual add before the norm) at :data:`LN_FOLD_SHAPES` in
    bf16 and f32, with the residual stream's gradient and without, and at
    GPT's rows offset by +100 (``check_fold_pair``); the times of both at
    the main paths' rows beside the bound, the plain versions and the
    library calls;
    the graphed gpt and bert steps folded and unfolded (torch's adds, the
    norms alone: ``unfolded_layer_norm``), in turns, beside
    :data:`LN_BEFORE_MS` (each path's graph equals its eager steps to the
    bit folded: phases 6 and 7 check that before this one runs);
    serving on each path (``ln_decode_ab``); LayerNorm's share of
    the gpt, bert and vit steps (``steps``: phases 6, 7 and 8's graphed
    steps) and of a decode step (``serving``: phase 4's). Returns the
    kernels line's rows and the readings."""
    from cron_operator_tpu_torch.models import Bert, BertConfig, GPT, GPTConfig
    from cron_operator_tpu_torch.workloads import data
    from cron_operator_tpu_torch.workloads.train import Trainer

    ln = importlib.import_module("cron_operator_tpu_torch.ops.layer_norm")
    errs = {}

    def label_of(name, dtype, pdt):
        plan = ln.forward_plan(*LN_SHAPES[name])
        return (f"{name} {list(LN_SHAPES[name])} x {str(dtype)[6:]} params "
                f"{str(pdt)[6:]} ({plan['design']}, {plan['chunks']} "
                "chunks)")

    for name, shape in LN_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            for pdt in (torch.float32, torch.bfloat16):
                label = label_of(name, dtype, pdt)
                errs[label] = check_ln_pair(
                    torch, ln, label, *ln_inputs(torch, shape, dtype, pdt,
                                                 seed=len(errs)), dtype)
        for dtype, out_dtype in ((torch.bfloat16, torch.bfloat16),
                                 (torch.float32, torch.float32),
                                 (torch.float32, torch.bfloat16)):
            if name in LN_OFFSET_SHAPES:
                x, dy, gamma, beta = ln_inputs(torch, shape, dtype,
                                               seed=len(errs), offset=100.0)
                label = (f"{name} x {str(dtype)[6:]} y {str(out_dtype)[6:]}"
                         " offset 100")
                errs[label] = check_ln_pair(torch, ln, label, x,
                                            dy.to(out_dtype), gamma, beta,
                                            out_dtype)
        release(torch)
    for name in LN_FOLD_SHAPES:
        # the serving paths hold bf16 parameters, the training ones f32
        pdt = torch.bfloat16 if name == "decode" else torch.float32
        for dtype in (torch.bfloat16, torch.float32):
            for with_ds in (True, False):
                x, dy, gamma, beta = ln_inputs(torch, LN_SHAPES[name], dtype,
                                               pdt, seed=len(errs))
                r, ds, _, _ = ln_inputs(torch, LN_SHAPES[name], dtype,
                                        seed=len(errs) + 1)
                label = (f"fold {name} {list(LN_SHAPES[name])} x "
                         f"{str(dtype)[6:]} params {str(pdt)[6:]}"
                         + ("" if with_ds else " no ds"))
                errs[label] = check_fold_pair(
                    torch, ln, label, x, r, dy, ds if with_ds else None,
                    gamma, beta, dtype)
    x, dy, gamma, beta = ln_inputs(torch, LN_SHAPES["gpt"], torch.bfloat16,
                                   seed=len(errs), offset=100.0)
    r, ds, _, _ = ln_inputs(torch, LN_SHAPES["gpt"], torch.bfloat16,
                            seed=len(errs) + 1)
    errs["fold gpt offset 100"] = check_fold_pair(
        torch, ln, "fold gpt x bfloat16 offset 100", x, r, dy, ds, gamma,
        beta, torch.bfloat16)
    del x, dy, gamma, beta, r, ds
    release(torch)
    rows = {name: ln_rows(torch, ln, card, name, LN_SHAPES[name])
            for name in LN_TIMED}
    folded = {name: fold_rows(torch, ln, card, name, LN_SHAPES[name])
              for name in LN_TIMED}
    for name in LN_TIMED:
        # the serving paths hold bf16 parameters, the training ones f32
        pdt = torch.bfloat16 if name == "decode" else torch.float32
        e = errs[label_of(name, torch.bfloat16, pdt)]
        rows[name]["fwd"]["max_abs_err"] = e["y"]
        rows[name]["bwd"]["max_abs_err"] = e["dx"]
        e = errs[f"fold {name} {list(LN_SHAPES[name])} x bfloat16 params "
                 f"{str(pdt)[6:]}"]
        folded[name]["fwd"]["max_abs_err"] = e["y"]
        folded[name]["bwd"]["max_abs_err"] = e["dx"]

    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    models = {
        "gpt": (GPT, GPTConfig(max_len=s),
                data.causal_token_sample(b, s, 50257)),
        "bert": (Bert, BertConfig.base(max_len=BERT_SHAPE["s"]),
                 data.token_sample(BERT_SHAPE["b"], BERT_SHAPE["s"], 30522)),
    }

    def trainer_of(name):
        cls, cfg, sample = models[name]
        wired, loss_fn = lm_wiring(cfg)
        model = cls(wired, device="cuda").init_weights(
            torch.Generator(device="cuda").manual_seed(0))
        return Trainer(model, loss_fn=loss_fn, sample_fn=sample)

    ab = {}
    for name in models:
        runs, best = graphed_runs(
            torch, ("folded", "unfolded", "unfolded", "folded"),
            lambda path: trainer_of(name), path_context)
        ab[name] = {"runs": runs, "best": best}
        print(f"[{card}] {name} step A/B (graphed, folded/unfolded/unfolded/"
              f"folded): " + " | ".join(f"{p} " + ", ".join(
                  f"{r['step_ms']:.3f} ms ({r['device_ms']:.3f} device, peak "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB)" for r in rs)
                  for p, rs in runs.items())
              + " | folded/unfolded "
              f"{best['folded']['step_ms'] / best['unfolded']['step_ms']:.4f}"
              f" | beside {LN_BEFORE_MS[name]} ms before the fold (PERF.md "
              "section 5)", flush=True)
    decode = ln_decode_ab(torch, card)
    print(f"[{card}] decode: phase 4's graphed decode step folded "
          f"{serving['graph']['decode_ms_per_step']:.4f} ms, "
          f"{serving['device_ms_per_step']:.4f} device ms, beside "
          f"{LN_BEFORE_MS['decode']} before the fold", flush=True)
    shares = {}
    for name, shape in (("gpt", "gpt"), ("bert", "bert"), ("vit", "vit")):
        # a step: one unfolded pair and 24 folded ones
        r, f = rows[shape], folded[shape]
        per_step = {k: (r["fwd"][k] + r["bwd"][k]
                        + (LM_NORMS - 1) * (f["fwd"][k] + f["bwd"][k]))
                    for k in ("ms", "plain_ms", "bound_ms")}
        device = steps[name]["device_ms"]
        copies = steps[name].get("shares", {}).get("copies and casts")
        shares[name] = {**per_step, "step_device_ms": device,
                        "share": per_step["ms"] / device,
                        "step_copies_share": copies}
        print(f"[{card}] layer_norm in the {name} step: {LM_NORMS} kernel "
              f"pairs (24 folded) {per_step['ms']:.3f} ms = {100 * shares[name]['share']:.1f}"
              f"% of its {device:.3f} device ms (plain versions "
              f"{per_step['plain_ms']:.3f} ms, bound "
              f"{per_step['bound_ms']:.3f} ms; the graphed call's copies "
              f"and casts {100 * (copies or 0):.1f}%)", flush=True)
    return {"rows": rows, "folded": folded, "errors": errs, "step_ab": ab,
            "decode": decode, "shares": shares}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


CSRC = "cron_operator_tpu_torch/ops/csrc/"
# the design the main path runs (bf16, head dim 64), its source, and the
# TPU kernel it replaces
KERNEL_ROWS = {
    "K1": ("flash_attention_fwd", "sm90", CSRC + "flash_fwd_sm90.cu",
           "cron_operator_tpu/ops/flash_attention.py:72"),
    "K2": ("flash_attention_dq", "sm90", CSRC + "flash_bwd_dq_sm90.cu",
           "cron_operator_tpu/ops/flash_attention.py:138"),
    "K3": ("flash_attention_dkv", "sm90", CSRC + "flash_bwd_dkv_sm90.cu",
           "cron_operator_tpu/ops/flash_attention.py:192"),
}


DECODE_ROW = ("decode_attention", CSRC + "decode_attn.cu",
              # no Pallas kernel: XLA compiles the JAX decode's attention
              "cron_operator_tpu/models/gpt.py:215")


def decode_entry(name_suffix: str, design: str, launches: int,
                 row: dict) -> dict:
    name, source, replaces = DECODE_ROW
    return {"name": name + name_suffix, "route": "cuda", "design": design,
            "source": source, "replaces": replaces, "launches": launches,
            **row}


def kernel_entry(key: str, name_suffix: str, launches: int, row: dict) -> dict:
    name, design, source, replaces = KERNEL_ROWS[key]
    return {"name": name + name_suffix, "route": "cuda", "design": design,
            "source": source, "replaces": replaces, "launches": launches,
            **row}


NORM_ROW = (CSRC + "group_norm.cu",
            # no Pallas kernel: XLA fuses flax's nn.GroupNorm
            "cron_operator_tpu/models/resnet.py:38")


def norm_entry(name: str, design: str, launches: int, row: dict) -> dict:
    source, replaces = NORM_ROW
    return {"name": name, "route": "cuda", "design": design,
            "source": source, "replaces": replaces, "launches": launches,
            **row}


XENT_ROW = (CSRC + "xent.cu",
            # no Pallas kernel: XLA fuses the JAX loss's f32 log-softmax
            "cron_operator_tpu/workloads/train.py:44")
# each main path of the loss kernels, its suffix in the kernels line and
# the shape of phase 21 whose times stand for it
XENT_PATHS = (("gpt", "", "gpt"), ("bert", "@bert", "bert"),
              ("moe", "@moe", "gpt"), ("resume", "@resume", "gpt"),
              ("mesh_data", "@mesh_data", "mesh"),
              # a tensor rank holds every row (b 8 x 1024) and its block
              # of the vocab, an expert rank every row and the table whole
              ("mesh_tensor", "@mesh_tensor", "tensor"),
              ("mesh_expert", "@mesh_expert", "gpt"),
              # ring gpt's rank holds b 8 x 512 rows (the data mesh's
              # 4096), Ulysses bert's b 8 x 256
              ("seq_ring", "@seq_ring", "mesh"),
              ("seq_ulysses", "@seq_ulysses", "seq_bert"),
              ("mesh_graph", "@mesh_graph", "gpt"))


def xent_entries(rows: dict) -> list:
    source, replaces = XENT_ROW
    return [{"name": f"softmax_xent_{d}{suffix}", "route": "cuda",
             "design": "row", "source": source, "replaces": replaces,
             "launches": XENT_LAUNCHES.get(path, [0, 0])[i],
             **rows[shape][d]}
            for path, suffix, shape in XENT_PATHS
            for i, d in enumerate(("fwd", "bwd"))]


LN_ROW = (CSRC + "layer_norm.cu",
          # no Pallas kernel: XLA fuses flax's nn.LayerNorm
          "cron_operator_tpu/models/gpt.py:139")
# each path of the LayerNorm kernels, its suffix in the kernels line, the
# shape of phase 22 whose times stand for it, and whether it runs the
# backward (the serving paths run the forward alone)
LN_PATHS = (("gpt", "", "gpt", True), ("bert", "@bert", "bert", True),
            ("vit", "@vit", "vit", True), ("moe", "@moe", "gpt", True),
            ("resume", "@resume", "gpt", True),
            ("generate", "@generate", "decode", False),
            ("serve_checkpoint", "@serve_checkpoint", "decode", False),
            ("moe_serve", "@moe_serve", "decode", False),
            ("mesh_data", "@mesh_data", "bert", True),
            ("mesh_tensor", "@mesh_tensor", "gpt", True),  # every row
            ("mesh_expert", "@mesh_expert", "gpt", True),  # every row
            # ring gpt's rank holds b 8 x 512 rows, Ulysses bert's 8 x 256
            ("seq_ring", "@seq_ring", "bert", True),
            ("seq_ulysses", "@seq_ulysses", "pipeline", True),
            ("pipeline", "@pipeline", "pipeline", True),
            ("mesh_graph", "@mesh_graph", "gpt", True))


# the folded pair: the residual add that XLA fuses into the norm's fusion
LN_ADD_REPLACES = "cron_operator_tpu/models/gpt.py:164"


def ln_entries(rows: dict, folded: dict) -> list:
    """Each path's unfolded and folded rows; ``LN_LAUNCHES[path]`` holds
    (forward, backward) of both designs, then the folded design's."""
    source, replaces = LN_ROW
    names = {"fwd": "layer_norm", "bwd": "layer_norm_bwd"}
    entries = []
    for path, suffix, shape, backward in LN_PATHS:
        if path not in LN_LAUNCHES:
            continue
        counts = LN_LAUNCHES[path]
        for i, d in enumerate(("fwd", "bwd")):
            if d == "bwd" and not backward:
                continue
            common = {"route": "cuda", "source": source,
                      "shape": list(LN_SHAPES[shape])}
            entries.append({"name": names[d] + suffix, "design": "warp",
                            "replaces": replaces, **common,
                            "launches": counts[i] - counts[2 + i],
                            **rows[shape][d]})
            entries.append({"name": names[d].replace(
                                "layer_norm", "layer_norm_add") + suffix,
                            "design": "warp_add",
                            "replaces": LN_ADD_REPLACES, **common,
                            "launches": counts[2 + i], **folded[shape][d]})
    return entries


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
    fa = importlib.import_module("cron_operator_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False

    walls = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        walls[name] = time.monotonic() - t0
        print(f"phase {name}: {walls[name]:.1f} s", flush=True)
        return out

    card = timed("device and build", phase_device, torch)
    timed("K1 vs plain", phase_kernel_vs_plain, torch, fa)
    timed("K2/K3 vs plain", phase_bwd_vs_plain, torch, fa)
    launches, decode_launches, progress = timed("generate_job", phase_slice,
                                                torch, fa)
    flash_model = timed("prefill correctness", phase_slice_correctness, torch)
    k1, prefill_ms, decode_ms = timed("serving times", phase_times, torch, fa,
                                      flash_model, card)
    print(f"[{card}] slice tokens/s {progress['tokens_per_s']} (rounds 2-3 of "
          f"generate_job) | first round {progress['first_step_latency_s']} s")
    del flash_model
    release(torch)
    serving = timed("serving graph", phase_serving_graph, torch, card,
                    prefill_ms, None, "generate", BEFORE_MS["decode"])
    print("slice " + json.dumps({
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "tokens_per_s": progress["tokens_per_s"],
        "decode_read_bytes_per_step": progress["decode_read_bytes_per_step"],
        **serving,
    }))

    train_counts, train_progress = timed("gpt", phase_job, torch, fa, "gpt",
                                         TRAIN_PARAMS, 12, None, "gpt")
    timed("gpt correctness", phase_gpt_correctness, torch)
    train_rows, step = timed("gpt times", phase_train_times, torch, fa, card)
    print(f"[{card}] train job: {train_progress['tokens_per_s']} tokens/s, "
          f"{train_progress['avg_step_time_s']} s/step, "
          f"{train_progress['steps_per_s']} steps/s (the calls after the "
          f"first), first call {train_progress['compile_time_s']} s")
    print("train " + json.dumps({
        **step, "job_tokens_per_s": train_progress["tokens_per_s"],
        "job_avg_step_time_s": train_progress["avg_step_time_s"],
        "job_first_step_s": train_progress["compile_time_s"],
    }))

    bert_counts, bert_rows, bert_step = timed("bert", phase_bert, torch, fa,
                                              card)

    from cron_operator_tpu_torch.models import ResNet50, ViT, ViTConfig
    from cron_operator_tpu_torch.workloads.train import TrainConfig

    # each job's model and optimizer, as its entrypoint builds them
    norm_counts, resnet_step, _ = timed(
        "resnet50", phase_image_job, torch, fa, card, "resnet50",
        RESNET50_PARAMS, lambda: ResNet50(device="cuda"),
        TrainConfig(optimizer="sgd", learning_rate=0.1),
        sum(n for _, _, n in RESNET50_NORMS), RESNET50_SHARES)
    _, vit_step, vit_counts = timed(
        "vit", phase_image_job, torch, fa, card, "vit", VIT_PARAMS,
        lambda: ViT(ViTConfig.base(), device="cuda"), TrainConfig(), 0,
        VIT_SHARES, "vit", VIT_LAYERS, VIT_ATTENTION_FLOPS)
    vit_attention = timed("vit attention", phase_vit_attention, torch, fa,
                          card, vit_step)
    print("vit_attention " + json.dumps({
        "best": vit_attention["best"], "runs": vit_attention["runs"],
        "launches": vit_counts}))
    timed("mnist", phase_job, torch, fa, "mnist", MNIST_PARAMS, 0)

    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        resume_counts, resume = timed("resume", phase_resume, torch, fa,
                                      card, root)
        stopped, last, stop_s = timed("runner", phase_runner, root)
        serve_counts, serve_decode = timed(
            "serve checkpoint", phase_serve_checkpoint, torch, fa, root, last)
        mfu = timed("mfu and profile", phase_mfu, torch, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("contract " + json.dumps({**resume, "runner_stopped_at": stopped,
                                    "runner_exit_s_after_sigterm": stop_s,
                                    **mfu}))
    moe_counts, moe_train = timed("moe training", phase_moe_train, torch, fa,
                                  card)
    print("moe_train " + json.dumps(moe_train))
    moe_launches, moe_decode, moe_serving = timed(
        "moe serving", phase_moe_serving, torch, fa, card)
    print("moe_serving " + json.dumps(moe_serving))
    mesh = timed("mesh on one card", phase_mesh, torch, fa, card)
    print("mesh " + json.dumps({k: {x: v[x] for x in (
        "step_ms", "loss_gap", "update_distance", "frozen")}
        for k, v in mesh.items()}))
    seq = timed("sequence and pipeline", phase_seq, torch, fa, card)
    print("seq " + json.dumps({k: {x: y for x, y in v.items() if x != "rows"}
                               for k, v in seq.items()}))
    micro_counts, micro_rows, _ = timed("microbench", phase_microbench, torch,
                                        fa, card)
    graph = timed("mesh graph", phase_mesh_graph, torch, card,
                  step["graph"]["step_ms"])
    print("mesh_graph " + json.dumps(graph))
    decode_row = timed("decode kernel vs plain", phase_decode_kernel, torch,
                       card)
    norm_rows = timed("GroupNorm kernel vs plain", phase_group_norm, torch,
                      card, norm_counts, resnet_step)
    loss = timed("softmax xent kernel vs plain", phase_xent, torch, card)
    print("xent " + json.dumps({
        "launches": XENT_LAUNCHES, "errors": loss["errors"],
        "logits_made": loss["logits_made"],
        "step_ab": {k: v["best"] for k, v in loss["step_ab"].items()}}))
    norm = timed("LayerNorm kernel vs plain", phase_layer_norm, torch, card,
                 {"gpt": step, "bert": bert_step, "vit": vit_step}, serving)
    print("layer_norm " + json.dumps({
        "launches": LN_LAUNCHES, "errors": norm["errors"],
        "step_ab": {k: v["best"] for k, v in norm["step_ab"].items()},
        "decode": {k: v for k, v in norm["decode"].items() if k != "runs"},
        "shares": norm["shares"]}))
    step_epilogues = resnet50_epilogues(1)
    print(f"phases: {sum(walls.values()):.1f} s in all, "
          + json.dumps({k: round(v, 1) for k, v in walls.items()}))

    print(json.dumps({"kernels": [
        kernel_entry("K1", "", launches, k1),
        # the decode kernel on the serving paths: generate_job, serving the
        # checkpoint, MoE serving; every row at GPT-2 small's decode shape.
        # The three-pass design, which no main path runs now (the plan keeps
        # it for shapes whose tiles pass a block's shared memory), beside
        decode_entry("", "cluster", decode_launches, decode_row["cluster"]),
        decode_entry("@serve_checkpoint", "cluster", serve_decode,
                     decode_row["cluster"]),
        decode_entry("@moe_serve", "cluster", moe_decode,
                     decode_row["cluster"]),
        decode_entry("[three_pass]", "fma", OLD_DESIGN_LAUNCHES["decode"],
                     decode_row["fma"]),
        kernel_entry("K1", "@train", train_counts[0], train_rows["K1"]),
        kernel_entry("K2", "", train_counts[1], train_rows["K2"]),
        kernel_entry("K3", "", train_counts[2], train_rows["K3"]),
        kernel_entry("K1", "@bert", bert_counts[0], bert_rows["K1"]),
        kernel_entry("K2", "@bert", bert_counts[1], bert_rows["K2"]),
        kernel_entry("K3", "@bert", bert_counts[2], bert_rows["K3"]),
        # ViT-B/16's 12 layers at b 64 x 197 tokens (phase 8)
        *(kernel_entry(key, "@vit", vit_counts[i], vit_attention["rows"][key])
          for i, key in enumerate(("K1", "K2", "K3"))),
        # this slice's paths: the resumed training run (the training
        # slice's shape) and serving from the checkpoint (the prefill's)
        kernel_entry("K1", "@resume", resume_counts[0], train_rows["K1"]),
        kernel_entry("K2", "@resume", resume_counts[1], train_rows["K2"]),
        kernel_entry("K3", "@resume", resume_counts[2], train_rows["K3"]),
        kernel_entry("K1", "@serve_checkpoint", serve_counts[0], k1),
        # the Switch-MoE paths: training at the training slice's shape and
        # serving's prefill at the serving slice's
        kernel_entry("K1", "@moe", moe_counts[0], train_rows["K1"]),
        kernel_entry("K2", "@moe", moe_counts[1], train_rows["K2"]),
        kernel_entry("K3", "@moe", moe_counts[2], train_rows["K3"]),
        kernel_entry("K1", "@moe_serve", moe_launches, k1),
        # the mesh paths: each strategy's launches summed over its two
        # ranks, each row at the strategy's local shape
        *(kernel_entry(key, f"@mesh_{name}", run["launches"][i],
                       run["rows"][key])
          for name, run in mesh.items()
          for i, key in enumerate(("K1", "K2", "K3"))),
        # the seq bodies of phase 16, launches summed over the two ranks:
        # the ring's diagonal blocks (causal) at a rank's b 8 x 512, the
        # blocks below them (in full) at the same shape (phase 7's rows),
        # Ulysses' 6 local heads over 512 tokens
        *(kernel_entry(key, "@seq_ring", seq["ring"]["by_mask"][i][1],
                       seq["ring"]["rows"][key])
          for i, key in enumerate(("K1", "K2", "K3"))),
        *(kernel_entry(key, "@seq_ring[full]", seq["ring"]["by_mask"][i][0],
                       bert_rows[key])
          for i, key in enumerate(("K1", "K2", "K3"))),
        *(kernel_entry(key, "@seq_ulysses", seq["ulysses"]["launches"][i],
                       seq["ulysses"]["rows"][key])
          for i, key in enumerate(("K1", "K2", "K3"))),
        # the pipeline of phase 16: its launches summed over the two ranks,
        # at the training slice's shape in microbatches of 2 rows
        *(kernel_entry(key, "@pipeline", seq["pipeline"]["launches"][i],
                       seq["pipeline"]["rows"][key])
          for i, key in enumerate(("K1", "K2", "K3"))),
        # the microbench of phase 17 at bench.py's attention shape
        *(kernel_entry(key, "@microbench", micro_counts[i], micro_rows[key])
          for i, key in enumerate(("K1", "K2", "K3"))),
        # the meshed step captured over NCCL of phase 18, at the training
        # slice's shape
        *(kernel_entry(key, "@mesh_graph", graph["launches"][i],
                       train_rows[key])
          for i, key in enumerate(("K1", "K2", "K3"))),
        # the GroupNorm pair on the resnet50 path of phase 8; each time is
        # one step's 53 norms at b 128 x 224^2 with the epilogue mix that
        # "epilogues" states (a step's; "launches_by_epilogue" the run's),
        # summed over their shapes, the unfused sums beside; each
        # direction's two-pass design, which no main path runs now, beside
        norm_entry("group_norm", "cluster", norm_counts[0],
                   {**norm_rows["forward"], "epilogues": step_epilogues[0],
                    "launches_by_epilogue": norm_counts[2]}),
        norm_entry("group_norm[two_pass]", "two_pass",
                   OLD_DESIGN_LAUNCHES["group_norm"],
                   {**norm_rows["forward_two_pass"],
                    "epilogues": step_epilogues[0]}),
        norm_entry("group_norm_bwd", "cluster", norm_counts[1],
                   {**norm_rows["backward"], "epilogues": step_epilogues[1],
                    "launches_by_epilogue": norm_counts[3]}),
        norm_entry("group_norm_bwd[two_pass]", "two_pass",
                   OLD_DESIGN_LAUNCHES["group_norm_bwd"],
                   {**norm_rows["backward_two_pass"],
                    "epilogues": step_epilogues[1]}),
        # the loss kernels on the gpt and bert paths of phases 5, 7, 9, 13,
        # 15 and 18, each row at its path's logits (phase 21)
        *xent_entries(loss["rows"]),
        # the LayerNorm pair on every path that launched it (phases 3, 5, 7,
        # 8, 9, 11, 13-16 and 18), each row at its path's rows (phase 22)
        *ln_entries(norm["rows"], norm["folded"]),
    ]}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5], int(sys.argv[6]), sys.argv[7],
                  json.loads(sys.argv[8]), sys.argv[9],
                  sys.argv[10:11] == ["--profile"])
    else:
        main()
