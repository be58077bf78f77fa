#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout.  It imports nothing of JAX and fails
(non-zero exit, no result line) when CUDA is unavailable.  Phases; any
failure raises and the script exits non-zero:

0. the card (``nvidia-smi`` name and power limit) and the toolchain;
1. build the CUDA kernels from ``semi_supervised_asr_tpu_torch/csrc``,
   with ptxas's registers and spills of the bf16 instances of K5 and of
   the LSTM cluster route (and its exchange-floor probe), and
   ``cudaOccupancyMaxActiveClusters`` of each K2/K3 cluster plan at B=32,
   H=256/384/512 (timit's must all be resident at once);
2. K1 (fused post-FFT frontend) against its plain version at B=32, T=400,
   800 and 1600 (F=257, M=80, a zero-length row each), and at B=5, T=37
   (the last tile ends off 16 bytes) and B=1, T=1 under every launch plan
   of the phase-5 sweep, each without SpecAugment bands, with random bands
   and with bands at the edges (fs + fw = 80, a time band past the row's
   length): max abs error <= 1e-5; a view 4-12 bytes off 16-byte
   alignment must raise;
3. K2 (LSTM forward scan) against its plain version at the listener's
   shapes (T=800 / input 80 and T=100 / input 1024, B=32, H=256, both
   directions, variable lengths with a zero-length row, residuals):
   <= 1e-5 in float32 (the CUDA-core route), <= BF16_TOL in bfloat16 (the
   cluster route); then the cluster route at H=256, 384 and 512, B=32
   and 5, T=1 and 37, D=2 and D=1 reverse, each with a zero-length row;
   every call's route is checked by its launch count;
4. the serving slice at ``configs/timit.yaml`` full width (random weights
   from seed 0, synthetic WAVs in two buckets) through the port's
   ``transcribe`` entry, beam 5 and greedy, with each kernel's launch
   count from that run (K2 on the cluster route); then the same bucket-400
   batch with
   ``backend="reference"``: encoder outputs within the phase-3 tolerance
   and, in a float32-compute run, identical tokens;
5. K1 at B=32, T=400 and 1600: device time L2-cold (rotating inputs that
   hold twice the L2) and L2-warm, call time, its plain version, and
   ``torch.matmul(pspec, fb)`` alone as a partial yardstick; the sweep of
   K1's launch plans (rows per tile, row groups, ring stages, blocks per
   SM), L2-cold at both shapes; then median times per batch of 32 at
   bucket 400: K2 against its plain version, and the whole serving path
   (features -> encoder -> beam 5) on kernels against the plain versions;
6. K3 (LSTM backward scan) against its plain version at the listener's
   shapes (T=800 / input 80 and T=100 / input 1024, B=32, H=256, both
   directions, ragged lengths with a zero-length row, random dh_out):
   dgates <= 1e-5 in float32, <= BF16_TOL in bfloat16; then the
   gradients of one whole BiLSTM layer (dx, dW_ih, dW_hh, db) through the
   autograd Function, kernel against plain, in float32; then K3's
   cluster route at phase 3's shapes;
7. the training slice at ``configs/timit.yaml`` full width through
   the Solver (the train CLI's short form; synthetic corpus, bucket 400,
   B=32, bf16, weights from seed 0): 3 steps, the loss of each, finite
   losses, and
   each kernel's launch count from that run (all three > 0, K1 once a
   step, K2 and K3 on the cluster route); then one bf16 step from the trained weights and
   one float32 step from fresh ones, each with one batch and fixed
   SpecAugment bands on kernels and on ``backend="reference"``: loss and
   every gradient leaf within BF16_STEP_LOSS_TOL / BF16_STEP_GRAD_TOL
   (bf16) and 1e-5 / GRAD_TOL (float32);
8. at bucket 400, B=32, bf16: the library yardsticks, like with like:
   cuDNN's whole LSTM layer forward (input projection + recurrence)
   beside the port's (projection + K2), and cuDNN's layer backward
   (training forward + backward minus training forward) beside the
   port's by the same difference (K3 + the dW_hh product + the
   projection's autograd backward); K3 against its plain version; K2
   and K3 with tiles of 8 rows (the plan's) against 16; the serial
   chain's floor of timit's K2 and K3 cluster plans (T=400 steps of the
   exchange and the waits for it alone); and the median host time of a
   train step on kernels against the plain versions.  K2 and K3's own
   times, the tiles and the floor are CUDA events over back-to-back
   calls (the profiler has misread single-kernel calls late in a run);
9. K5 (flash attention, forward and backward) against its plain version
   at the conformer's shapes (B=32, 8 heads of 64, T'=100 and 400) and at
   four odd shapes (head dims 24, 128 and 8, and T'=129: ragged tiles),
   each in f32 (the CUDA-core route) and bf16 (the tensor-core route),
   with a full row, an empty row, a row of length 1 and rows whose masks
   have holes before their last valid key: O, and dq, dk, dv through the
   autograd Function against autograd of ``mhsa_reference``, within
   K5_TOL / GRAD_TOL in float32 and the K5_BF16 bounds in bf16; the empty
   row's dq must be exactly 0;
10. the serving slice at ``configs/ls960_conformer.yaml`` full width with
    ``model.attn_backend=flash`` (random weights from seed 0, synthetic
    WAVs in the 400- and 800-frame buckets) through ``transcribe``, beam 5
    and greedy, with the launch counts (16 K5 forward launches per
    encode); then one bucket-800 batch on ``backend="reference"``:
    encoder outputs within the K5 bounds and, in float32, identical
    tokens;
11. the training slice at the same width through the Solver
    (synthetic corpus, bucket 1600 so that T'=400, B=32, bf16,
    ``train.async_ckpt=false``): 3 steps, finite
    losses, K1 once a step, both K5 launch counts > 0; then one float32 step on
    kernels against the plain versions, as in phase 7;
12. K5 forward and backward (bf16, B=32, 8 heads of 64) against
    ``scaled_dot_product_attention`` with the boolean key mask (the
    library yardstick, never on the port's path) at the T' of all four
    ls960_conformer buckets (100-400), with the card's clocks, power and
    temperature before and after each K5 timing, each ratio and each
    share of the bound; at T'=400 (bucket 1600) also against the plain
    version; every one of these times is a CUDA graph of back-to-back
    calls between CUDA events (a backward: forward + backward minus
    forward), so no host gap and no profiler enters it, and each log line
    names the method that took it; then the conformer's beam-5 serve
    batch and train step on kernels against the plain versions;
13. the semi-supervised step (C4) at ``configs/ls100_semi.yaml`` full
    width (enc 384 x (1 + 3) BiLSTM, dec 768, batch 64, bf16; synthetic
    data, the pseudo-label gate open from step 1) through the Solver: 3
    steps with a checkpoint at step 2, each with its metrics (loss, ce,
    text_ae, pseudo, pseudo_gate, grad_norm), wall time and kernel
    launches by route (K1 3, K2 12 and K3 8 a step, K2 and K3 on the
    cluster route), the final validation on the EMA buffer
    (``decode.use_ema``; K1 1 and K2 4 a dev batch); step 2's checkpoint
    resumed in a fresh workdir must give step 3's state (parameters, EMA
    buffer, Adam moments and count, generator) bitwise;
    a float32 step from fresh weights and a bf16 step from the trained
    ones with the gate open and every row kept, kernels against plain:
    the clean view, the teacher's hypotheses, then the loss and every
    gradient on the same hypotheses (1e-5 / GRAD_TOL in float32, the
    phase-7 bounds in bf16) and the EMA buffer after the update (1e-6);
    K2 and K3 at the step's first-layer shapes (B=64, H=384, T=400 and
    1600) with their launch plans and resident clusters, and K2 at B=56
    (a launch that fits the card in one wave) beside B=64;
14. the Solver path at ``configs/timit.yaml`` full width (synthetic
    corpus of 128 utterances in one 400-frame bucket, B=32, bf16):
    ``Solver.train`` for 4 steps with validation and a checkpoint every 2
    (K1 1, K2 4, K3 4 a step and K1 1, K2 4 a dev batch, K2 and K3 on the
    cluster route); a bf16 step from the trained weights on the run's
    first batch and the dev batch's encoder (bf16 and float32) and
    decodes (float32, identical tokens), kernels against plain; the host
    time of a step's input copies (pinned, side stream) against a plain
    ``.to(device)``; the same run stopped at step 2 and resumed by
    ``main --train --resume`` in a fresh process: step 4's state, data
    position and step-3/4 records bitwise equal to the straight run's;
    retention after a worse dev error (the newest two and the best
    survive); ``main --test`` with beam 5 and greedy (PER, length-cap hit
    rate, ``--hyp-out`` and its analysis); ``eval_params``'s weights
    against a Recognizer given the same weights in float32 (identical
    tokens); ``transcribe --load-dir`` on the workdir; the card's
    checkpoint, restore, evaluation, start-up and first-step times and
    the run's frames per second.

The line before the last is the kernel table as JSON (with each kernel's
bound, library time and what that library call computes, how each time
was taken, and its design; launches from the timit Solver run (phase 14)
for K1-K3, from the conformer training run for K5, and per path in
``launches_by_path``; K2 and K3 also at the C4 shapes in ``at_c4``); the
last line is ``{"ok": true, "device": {...}}``.  ``--profile DIR`` also
writes ``torch.profiler`` tables of one beam-5 batch and of one train step
of each path (the C4 step included) there.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import functools
import io
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "timit.yaml"
K1_TOL = 1e-5
# K1's launch plans, (rows per tile, row groups, ring stages, blocks per
# SM), checked in phase 2 and timed in phase 5
K1_PLANS = tuple((r, g, st, k) for r in (8, 16, 32) for g in (2, 4)
                 for st in (2, 3, 4) for k in (1, 2) if r // g <= 8)
K2_TOL = 1e-5
# bf16: kernel and plain version round h to bf16 identically but sum the
# f32 products in different orders; when that flips one bf16 rounding of
# an h unit (ulp ~4e-3 at |h| ~ 1), each gate of the next step moves by
# |w_hh| * ulp ~ 2.5e-4 at H=256 (weights U(+-1/16)).  A few such flips
# over a sequence stay under 2e-3.
BF16_TOL = 2e-3
K3_TOL = 1e-5
# A bf16 train step, kernels against plain (phase 7): each LSTM layer's
# kernels sum their f32 products in another order than the plain version,
# which can flip a bf16 rounding of an h or dgates entry (ulp ~4e-3 near
# 1) and so move the gradients that flow through it.  Measured on the
# H100: loss 1.1e-7 relative, the worst leaf 3.4e-5 of the model's largest
# gradient entry (5e-3 of its own, a deep BiLSTM layer's w_ih).  The bounds
# leave a margin of ~30x for other seeds and flips.
BF16_STEP_LOSS_TOL = 1e-5
BF16_STEP_GRAD_TOL = 1e-3
# A gradient entry of a layer or of the model sums up to T*B products, added
# in another order by the kernels than by the plain versions, so the float32
# difference scales with the size of those products, not with their sum:
# where the sum cancels (the attention bias's gradient sums a softmax
# gradient over frames, which is zero but for the tanh weights), a bound
# relative to the leaf's own largest entry fails (1.1e-4 observed on the
# H100).  So each leaf's largest difference is bounded relative to the
# largest gradient entry of the whole set compared (one layer, or the
# model).
GRAD_TOL = 1e-5
# K5 in float32: the kernels sum the same f32 products as the plain version
# in another order (and normalise by the row sum at the end).
K5_TOL = 1e-5
# K5 in bf16: the plain version rounds each score to bf16 before scaling
# (as XLA's bf16 einsum does) and the kernels keep it in f32, so a score of
# magnitude ~3 moves by up to 2^-8 * 3 ~ 0.01 and each weight by about that
# fraction; O (|v| ~ 1, bf16 ulp 2^-8 near 1) then differs by ~1e-2 and
# the gradients by ~1e-2 of their largest entry (1.6e-2 and 1.1e-2 measured
# on the H100 at T=100 and 400).  Twice that is the bound.
K5_BF16_TOL = 3e-2
K5_BF16_GRAD_TOL = 3e-2
DEVICE = "cuda"
# the training slice on the synthetic corpus: two batches of 32 per epoch,
# all in the 400-frame bucket
TRAIN_OVERRIDES = ["data.dataset=synthetic", "data.num_synthetic_utts=64",
                   "data.frame_buckets=[400]"]
# the kernels of the LAS path (timit): K1, K2, K3
LSTM_PATH = ("fused_post_fft", "lstm_scan_fwd", "lstm_scan_bwd")
# the conformer path: configs/ls960_conformer.yaml at full width with the
# flash attention route (no shipped config sets it), synthetic data,
# batches of 32
CONFORMER_CONFIG = ROOT / "configs" / "ls960_conformer.yaml"
CONFORMER_OVERRIDES = ["model.attn_backend=flash", "data.dataset=synthetic",
                       "train.batch_size=32"]
# training: two batches of 32 per epoch in the recipe's largest bucket
# (T' = 400 after the 4x stem); dropout, SortaGrad and the recipe's
# background checkpoint saves (train.async_ckpt) are not ported
CONFORMER_TRAIN = ["model.enc_dropout=0", "data.sortagrad_epochs=0",
                   "train.async_ckpt=false", "data.num_synthetic_utts=64",
                   "data.frame_buckets=[1600]"]
# K5's timing shape: bucket 1600 -> T' = 400, B=32, 8 heads of 64
K5_TIMING = (32, 400, 8, 64)
# T' of ls960_conformer's four buckets (400-1600 frames, 4x stem), each
# timed in phase 12
K5_BUCKETS = (100, 200, 300, 400)
# the conformer's encoder, kernels vs plain on one batch: float32 within
# K5's own bound; bf16 relative to the largest output, within K5's bf16
# bound (16 blocks carry the scores' bf16 rounding, each renormalised by
# its LayerNorm)
CONF_ENC_TOL = K5_TOL
CONF_ENC_BF16_TOL = K5_BF16_TOL
# the semi-supervised path (C4): configs/ls100_semi.yaml at full width and
# its own batch of 64; cut: synthetic data (the LibriSpeech splits are not
# on the machine), 64 utterances, and the pseudo-label gate opened after
# one step (closed at step 0, open from step 1).  The labeled stream lands
# in the 400-frame / 128-token bucket, the unlabeled streams in 1600 / 256
SEMI_CONFIG = ROOT / "configs" / "ls100_semi.yaml"
SEMI_OVERRIDES = ["data.dataset=synthetic", "data.num_synthetic_utts=64",
                  "objective.pseudo_warmup_steps=1"]
# the kernels-against-plain steps of the C4 path: the gate open at step 0
# and every row kept (random weights put every hypothesis below the
# recipe's 0.6 confidence, which would leave the term no gradient)
SEMI_CHECK = {"pseudo_warmup_steps": 0, "pseudo_confidence": 0.0}
# a C4 step's launches: K1 for the labeled, the clean and the augmented
# view; K2 for the 4 layers of the labeled, the augmented and the
# teacher's clean encode; K3 for the student's two
C4_LAUNCHES = {"fused_post_fft": 3, "lstm_scan_fwd": 12, "lstm_scan_bwd": 8}
# K2 and K3 timed at the C4 step's first-layer shapes (B=64, H=384, 80
# inputs): the labeled view (T=400) and the unlabeled views (T=1600)
C4_LSTM_T = (400, 1600)
# phase 13's run of the C4 path through the Solver: 3 steps, a checkpoint
# at step 2, the final validation (and checkpoint) at step 3 on the EMA
# buffer; the 64 labeled utterances fill one batch of 64 in the 400-frame,
# 128-token bucket, so the default data.drop_remainder keeps it
SEMI_SOLVER = ["train.total_steps=3", "train.ckpt_every=2",
               "train.eval_every=0", "train.log_every=1",
               "decode.use_ema=true"]
# the Solver path (phase 14: main --train / --resume / --test, transcribe
# from a checkpoint) at configs/timit.yaml full width; cuts: the synthetic
# corpus of 128 utterances, all in one 400-frame bucket (4 full batches of
# 32 an epoch under the default data.drop_remainder, and a dev set of 32,
# one full batch), so that every kernel runs at the shapes phases 2, 4 and
# 7 hold against the plain versions (K1 at B=32 T=400, K2 and K3 at T'
# 400-50) and phase 14 holds again on its own batches; 4 steps, validation
# and a checkpoint every 2, a train record every step
SOLVER_OVERRIDES = ["data.dataset=synthetic", "data.num_synthetic_utts=128",
                    "data.frame_buckets=[400]", "train.total_steps=4",
                    "train.eval_every=2", "train.ckpt_every=2",
                    "train.log_every=1"]
# timit's launches: a train step runs K1 once and K2 and K3 once a layer
# (1 + 3 BiLSTM layers, both directions in one launch); a validation batch
# K1 once and K2 once a layer
SOLVER_STEP_LAUNCHES = {"fused_post_fft": 1, "lstm_scan_fwd": 4,
                        "lstm_scan_bwd": 4}
SOLVER_EVAL_LAUNCHES = {"fused_post_fft": 1, "lstm_scan_fwd": 4}


def c4_tag(t: int) -> str:
    return f"_h384_b64_t{t}"


# every shipped LSTM-listener width of the LAS and semi-supervised recipes
# (timit 256; ls100, ls100_semi 384; ls960_dp 512): the cluster route's
# checks (phases 1, 3, 6)
CLUSTER_WIDTHS = (256, 384, 512)
# published peaks of one H100 SXM (NVIDIA H100 datasheet)
HBM_BYTES_S = 3.35e12
L2_BYTES = 50e6
BF16_FLOPS = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn`` (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# The profiler loses kernel events at the end of a trace (the last 2 of a
# cuDNN layer's 5 x 1,676 in every trace, the last launch of a
# single-kernel call, a thousand of a long plain loop): every trace of
# device_ms_by_kernel ends in TRACE_TAIL spin kernels, which take the loss
# and are not counted.
TRACE_TAIL = 4096
# device_ms_by_kernel's one entry when no trace held a kernel
EVENTS_KEY = "all kernels (CUDA events, back to back)"


@functools.lru_cache(maxsize=None)
def tail_kernel() -> str:
    """The device-side name of ``torch.cuda._sleep``'s kernel: the most
    frequent kernel of a trace of spin kernels alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_TAIL):
            torch.cuda._sleep(16)
        torch.cuda.synchronize()
    names = collections.Counter(e.name for e in prof.events()
                                if e.device_type == DeviceType.CUDA)
    require(bool(names), "the profiler saw no spin kernel")
    return names.most_common(1)[0][0]


def device_ms_by_kernel(fn, reps: int, warmup: int = 2) -> dict:
    """Mean device milliseconds per call of ``fn`` for each kernel it
    launches (torch.profiler), by kernel name.  Each trace ends in a tail
    of spin kernels (see TRACE_TAIL), and each measurement takes two traces
    and keeps them when they hold the same number of kernel events (their
    mean).  After a trace of tens of thousands of kernels the profiler can
    record nothing for several sessions, so a failed attempt waits a
    second; after five, the fuller trace, or, if no trace held a kernel,
    CUDA events over back-to-back calls under the name ``EVENTS_KEY``,
    each with a log line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    tail = tail_kernel()

    def trace() -> tuple[dict, int]:
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            for _ in range(TRACE_TAIL):
                torch.cuda._sleep(16)
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        n = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and e.name != tail:
                out[e.name] = out.get(e.name, 0.0) + e.device_time_total
                n += 1
        return {k: us / reps / 1e3 for k, us in out.items()}, n

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = ({}, 0)
    for _ in range(5):
        (a, na), (b, nb) = trace(), trace()
        if na == nb > 0:
            return {k: (a[k] + b.get(k, 0.0)) / 2 for k in a}
        best = max(best, (a, na), (b, nb), key=lambda x: x[1])
        log(f"[profiler] two traces disagree ({na} and {nb} kernel events "
            f"over {reps} calls)")
        time.sleep(1.0)
    if best[1]:
        log(f"[profiler] no two traces agreed: the fuller ({best[1]} "
            "events)")
        return best[0]
    ms = back_to_back_ms(fn, reps)
    log(f"[profiler] no trace held a kernel: {ms:.4f} ms a call from CUDA "
        "events over back-to-back calls instead (host launch gaps included)")
    return {EVENTS_KEY: ms}


def device_ms_each(fns: list, reps: int) -> list[float]:
    """Mean device milliseconds per call of each of ``fns`` (one kernel a
    call), ``reps`` calls apiece in order, from one torch.profiler trace:
    the kernels' durations split in launch order.  If the trace lost or
    gained kernel events, :func:`profiled_ms` for each fn instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    tail = tail_kernel()
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(reps):
                fn()
        for _ in range(TRACE_TAIL):
            torch.cuda._sleep(16)
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == DeviceType.CUDA and e.name != tail),
                key=lambda e: e.time_range.start)
    if len(ev) != len(fns) * reps:
        log(f"[profiler] one trace of {len(fns)} x {reps} calls held "
            f"{len(ev)} kernel events: a trace per call site instead")
        return [profiled_ms(fn, reps)[0] for fn in fns]
    return [sum(e.device_time_total for e in ev[i * reps:(i + 1) * reps])
            / reps / 1e3 for i in range(len(fns))]


def back_to_back_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``reps`` back-to-back calls of ``fn``
    between two CUDA events: the device time of a call whose kernels keep
    the device busier than the host's launches (one long kernel), with no
    profiler in the way."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph (after warm-up calls on a side stream, as autograd
    inside a capture needs), the graph replayed ``replays`` times between
    two CUDA events, the median replay over ``reps``.  A replay launches
    the captured kernels back to back with no host work between them, so
    this times the device alone, with no profiler in the way."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(out)


# how a device time was taken: the key suffix it is stored under in a
# phase's times, and the words its log lines use
METHODS = {
    "graph": ("_graph", "device time, a CUDA graph of back-to-back calls "
              "between CUDA events"),
    "b2b": ("_b2b", "device time, CUDA events over back-to-back calls "
            "(host launch gaps included)"),
    "profiler": ("", "device time, profiler"),
}


def profiled_ms(fn, reps: int, warmup: int = 2) -> tuple[float, str]:
    """Mean device milliseconds per call of ``fn`` -- the durations of the
    kernels and copies it launched, from torch.profiler; unlike
    :func:`cuda_ms` this leaves out the time the device waits for the
    host -- and the method that produced it: "profiler", or "b2b" where no
    trace held a kernel and CUDA events stood in."""
    by = device_ms_by_kernel(fn, reps, warmup)
    ms = sum(by.values())
    require(ms > 0, "the profiler saw no device time")
    return ms, ("b2b" if EVENTS_KEY in by else "profiler")


def record(times: dict, key: str, ms_method: tuple[float, str]) -> None:
    """Append a (ms, method) time under ``key`` + the method's suffix."""
    ms, method = ms_method
    times.setdefault(key + METHODS[method][0], []).append(ms)


def pick(med: dict, key: str) -> tuple[float, str]:
    """The median time of ``key`` under whichever method took it ->
    (ms, method)."""
    for method, (suffix, _) in METHODS.items():
        if key + suffix in med:
            return med[key + suffix], method
    raise KeyError(key)


def host_ms(fn, reps: int) -> list[float]:
    """Host milliseconds of ``fn`` ending in a device synchronize."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase0() -> str:
    import torch

    card = card_line()
    print(card, flush=True)
    from semi_supervised_asr_tpu_torch import _native

    nvcc = subprocess.run([_native._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    try:
        import yaml
        yaml_ok = f"yes ({yaml.__version__})"
    except ImportError:
        yaml_ok = "no"
    log(f"[phase0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc '{nvcc.strip().splitlines()[-1]}' pyyaml {yaml_ok} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def kernel_label(entry: str) -> str | None:
    """A readable name of a bf16 instance that phase 1 reports, from its
    mangled entry name (None for the others)."""
    for pattern, param in ((r"(flash_mhsa_(?:fwd|bwd_dq|bwd_dkv)_bf16"
                            r"_kernel)ILi(\d)", "NB"),
                           (r"(lstm_(?:fwd|bwd)_cluster_kernel|"
                            r"exchange_floor_kernel)E", None)):
        name = re.search(pattern, entry)
        if name:
            return (f"{name.group(1)}<{param}={name.group(2)}>" if param
                    else name.group(1))
    return None


def phase1() -> dict:
    """Build the kernels; -> {bf16 instance of K5 and of the LSTM cluster
    route: (registers, spill stores, spill loads)} from ptxas; then how
    many clusters of each LSTM cluster plan at B=32 the card holds."""
    from semi_supervised_asr_tpu_torch import _native

    t0 = time.perf_counter()
    cached = _native.library_path().exists()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        path = _native.build(verbose=True)
    _native.lib()
    print(out.getvalue(), flush=True)
    log(f"[phase1] built {path.name} in {time.perf_counter() - t0:.1f} s")
    cluster_occupancy()
    if cached:
        log("[phase1] the library was built before: no ptxas report")
        return {}
    regs, kernel = {}, None
    for line in out.getvalue().splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            kernel = kernel_label(entry.group(1))
        used = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if kernel and spill:
            regs[kernel] = regs.get(kernel, (0,)) + tuple(
                int(x) for x in spill.groups())
        if kernel and used:
            regs[kernel] = (int(used.group(1)),) + regs.get(kernel, (0,))[1:]
    for name, (n, *sp) in sorted(regs.items()):
        log(f"[phase1] {name}: {n} registers, spill stores/loads {sp} bytes")
    require(len(regs) == 9, f"ptxas reported {sorted(regs)}")
    return regs


def cluster_occupancy() -> None:
    """Each cluster plan of K2 and K3 at B=32 (bf16, H of every shipped
    LSTM listener): its shape and cudaOccupancyMaxActiveClusters; at
    timit's H every cluster of a layer's launch must be resident at once."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    for kind in ("fwd", "bwd"):
        for h in CLUSTER_WIDTHS:
            plan = K.cluster_plan(kind, h, 32, torch.bfloat16)
            require(plan.route == "cluster", f"K2/K3 {kind} H={h}: {plan}")
            held = K.cluster_occupancy(kind, plan)
            need = 2 * -(-32 // plan.rows)          # D=2 x row tiles
            log(f"[phase1] {kind} cluster plan H={h} B=32: C={plan.cluster} "
                f"R={plan.rows} u={plan.units} "
                f"threads={plan.threads} smem={plan.smem} B; max active "
                f"clusters {held}, a D=2 launch needs {need}")
            require(held >= 1, f"no cluster of {plan} fits on the card")
            if h == 256:
                require(held >= need, f"timit's {kind} clusters are not all "
                        "resident at once")


def k1_inputs(b: int, t: int, seed: int, cfg):
    """A power spectrum of noise utterances with ragged lengths, plus
    CMVN statistics and SpecAugment bands."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import frontend as F

    g = torch.Generator().manual_seed(seed)
    s = (t - 1) * cfg.hop_length
    lens = torch.randint(s // 4, s + 1, (b,), generator=g)
    lens[0], lens[1] = s, 0
    audio = torch.randn((b, s), generator=g) * 0.1
    audio *= torch.arange(s)[None, :] < lens[:, None]
    audio, lens = audio.to(DEVICE), lens.to(torch.int32).to(DEVICE)
    pspec = F.power_spectrogram(audio, cfg)
    flens = torch.clamp_max(F.frame_lengths(lens, cfg), t)
    lm = F.log_mel_from_power(pspec, cfg)
    valid = lm[F.frame_mask(flens, t)]
    mean, istd = valid.mean(0), 1.0 / torch.sqrt(valid.var(0) + 1e-8)
    nf, nt = 2, 2
    fw = torch.randint(0, 16, (b, nf), generator=g)
    fs = torch.randint(0, cfg.n_mels - 15, (b, nf), generator=g)
    tw = torch.randint(0, 36, (b, nt), generator=g)
    ts = torch.randint(0, max(t - 35, 1), (b, nt), generator=g)
    bands = tuple(x.to(torch.int32).to(DEVICE) for x in (fs, fw, ts, tw))
    return pspec, flens, mean, istd, bands


def edge_bands(lens, t: int, m: int):
    """SpecAugment bands at the edges: a frequency band that ends at the
    last mel bin (fs + fw = m) beside one at bin 0, and a time band that
    starts 5 frames before each row's length and runs past it (and past T)
    beside one at frame 0."""
    import torch

    b = lens.shape[0]
    one = torch.ones((b,), dtype=torch.int32, device=lens.device)
    fs = torch.stack([one * (m - 9), one * 0], 1)
    fw = torch.stack([one * 9, one * 3], 1)
    ts = torch.stack([torch.clamp_min(lens - 5, 0), one * 0], 1)
    tw = torch.stack([one * (t + 40), one * 2], 1)
    return tuple(x.to(torch.int32).contiguous() for x in (fs, fw, ts, tw))


def k1_cases(fcfg):
    """(label, args of fused_post_fft) of every phase-2 case: B=32 at
    T=400, 800 and 1600 (a full and a zero-length row each), without and
    with random SpecAugment bands and with bands at the edges; B=5, T=37
    (185 rows: the last tile ends off 16 bytes) and B=1, T=1, cut from
    the T=400 batch, the same three ways."""
    out = []
    for t in (400, 800, 1600):
        pspec, flens, mean, istd, bands = k1_inputs(32, t, t, fcfg)
        flens[1] = 0    # empty audio still makes one frame
        batches = [(f"B=32 T={t}", pspec, flens, bands)]
        if t == 400:
            for b, tt in ((5, 37), (1, 1)):
                batches.append((f"B={b} T={tt}", pspec[:b, :tt].contiguous(),
                                flens[:b].clamp_max(tt).contiguous(),
                                tuple(x[:b].contiguous() for x in bands)))
        for label, ps, fl, sa in batches:
            for name, bands_ in (("none", None), ("random", sa),
                                 ("edges", edge_bands(fl, ps.shape[1],
                                                      fcfg.n_mels))):
                out.append((f"{label} bands={name}",
                            (ps, fl, fcfg, mean, istd, bands_)))
    return out


@contextlib.contextmanager
def k1_plan(plan: tuple):
    """Run K1's wrapper with another launch plan (rows, stages, blocks per
    SM) than its default."""
    from semi_supervised_asr_tpu_torch.ops import fused_frontend as FF

    keep, FF.PLAN = FF.PLAN, plan
    try:
        yield
    finally:
        FF.PLAN = keep


def phase2(fcfg) -> float:
    """K1 against its plain version on every case of :func:`k1_cases`, each
    under the default plan and the odd shapes under every plan of the
    sweep; a view that starts off 16 bytes must raise, one on 16 bytes
    must run."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import fused_frontend as FF

    worst = 0.0
    cases = k1_cases(fcfg)
    for label, args in cases:
        plans = [FF.PLAN]
        if not label.startswith("B=32"):
            plans += [p for p in K1_PLANS if p != FF.PLAN]
        want = FF.fused_post_fft_reference(*args)
        errs = []
        for plan in plans:
            with k1_plan(plan):
                got = FF.fused_post_fft(*args)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), "K1 output not finite")
            errs.append((got - want).abs().max().item())
            require(errs[-1] <= K1_TOL, f"K1 {label} plan {plan}: error "
                    f"{errs[-1]} > {K1_TOL}")
        worst = max(worst, *errs)
        zeros = (want == 0).float().mean().item()
        log(f"[phase2] K1 {label}: max_abs_err {max(errs):.3e} (tol "
            f"{K1_TOL:g}) over {len(plans)} plan(s), zero share {zeros:.3f}")
    pspec, flens, _, mean, istd, _ = cases[0][1]
    n = pspec.numel()
    big = torch.empty(n + 8, device=pspec.device)
    for offset in (1, 2, 3, 4):
        view = big[offset:offset + n].view(pspec.shape)
        view.copy_(pspec)
        if offset % 4:
            with contextlib.suppress(ValueError):
                FF.fused_post_fft(view, flens, fcfg, mean, istd)
                require(False, f"K1 took a view {offset * 4} bytes past "
                        "16-byte alignment")
        else:
            got = FF.fused_post_fft(view, flens, fcfg, mean, istd)
            want = FF.fused_post_fft_reference(view, flens, fcfg, mean, istd)
            require((got - want).abs().max().item() <= K1_TOL,
                    "K1 on an aligned view disagrees")
    log(f"[phase2] K1 views 4, 8 and 12 bytes past 16-byte alignment raise, "
        f"16 bytes past runs; B=5 T=37: last tile "
        f"{FF.tile_spans(5 * 37, pspec.shape[2], FF.PLAN[0])[-1]} (first "
        "row, rows, bulk bytes, plain floats)")
    return worst


def k2_inputs(t: int, i: int, seed: int, b: int = 32, h: int = 256):
    """Projected gates of both directions for a random layer, as the
    listener computes them, with ragged lengths including 0."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import recurrent as R

    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(h)

    def u(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    x = torch.randn((b, t, i), generator=g)
    lens = torch.randint(1, t + 1, (b,), generator=g)
    lens[0], lens[1] = t, 0
    w_ih, bias, w_hh = u(i, 8 * h), u(8 * h), u(2, h, 4 * h)
    x, w_ih, bias, w_hh = (y.to(DEVICE) for y in (x, w_ih, bias, w_hh))
    lens = lens.to(torch.int32).to(DEVICE)
    valid = R.valid_mask(lens, b, t, DEVICE)
    return x, w_ih, bias, w_hh, valid


def routed(kind: str, compute, call):
    """Run ``call`` and require that it launched K2 (``kind="fwd"``) or K3
    ("bwd") once, on the route the dtype asks for (the cluster route in
    bf16 at these widths, the CUDA cores in f32) -> (result, route)."""
    import torch

    from semi_supervised_asr_tpu_torch import _native

    route = "cluster" if compute == torch.bfloat16 else "simt"
    key = f"lstm_scan_{kind}_{route}"
    before = _native.LAUNCHES[key]
    out = call()
    require(_native.LAUNCHES[key] == before + 1,
            f"K{2 if kind == 'fwd' else 3} did not run on the {route} route")
    return out, route


def phase3() -> tuple[float, float]:
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
    from semi_supervised_asr_tpu_torch.ops import recurrent as R

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, t, i in (("layer0", 800, 80), ("pyramid", 100, 1024)):
        x, w_ih, bias, w_hh, valid = k2_inputs(t, i, t)
        b, h = x.shape[0], w_hh.shape[1]
        for compute in (torch.float32, torch.bfloat16):
            with torch.inference_mode():
                gx = (R.mm(x, w_ih, compute) + bias).view(b, t, 2, 4 * h)
                gx = gx.permute(2, 1, 0, 3).contiguous()
                got, route = routed("fwd", compute, lambda: K.lstm_scan(
                    gx, w_hh, valid, compute, (False, True), residuals=True))
                want = K.lstm_scan_reference(gx, w_hh, valid, compute,
                                             (False, True), residuals=True)
            torch.cuda.synchronize()
            tol = K2_TOL if compute == torch.float32 else BF16_TOL
            errs = [(a - b_).abs().max().item() for a, b_ in zip(got, want)]
            require(all(bool(torch.isfinite(a).all()) for a in got),
                    "K2 output not finite")
            log(f"[phase3] K2 {name} T={t} I={i} B={b} H={h} D=2 "
                f"{str(compute).split('.')[-1]} ({route} route): max_abs_err "
                f"h_out {errs[0]:.3e} hprev {errs[1]:.3e} cprev "
                f"{errs[2]:.3e} acts {errs[3]:.3e} (tol {tol:g})")
            require(max(errs) <= tol, f"K2 error {max(errs)} > {tol}")
            worst[compute] = max(worst[compute], max(errs))
    worst[torch.bfloat16] = max(worst[torch.bfloat16],
                                cluster_checks("phase3", "fwd"))
    return worst[torch.float32], worst[torch.bfloat16]


def scan_inputs(h: int, d: int, b: int, t: int, seed: int):
    """Random gates_x [D, T, B, 4H] (std 0.5, about what the listener's
    projections give), w_hh [D, H, 4H] U(+-1/sqrt(H)), valid [T, B] with
    row 0 full and row 1 empty (zero length), and dh_out [D, T, B, H]."""
    import torch

    g = torch.Generator().manual_seed(seed)
    gx = torch.randn((d, t, b, 4 * h), generator=g) * 0.5
    w_hh = (torch.rand((d, h, 4 * h), generator=g) * 2 - 1) / math.sqrt(h)
    lens = torch.randint(1, t + 1, (b,), generator=g)
    lens[0], lens[1] = t, 0
    valid = (torch.arange(t)[:, None] < lens[None, :]).float()
    dh_out = torch.randn((d, t, b, h), generator=g)
    return [x.to(DEVICE) for x in (gx, w_hh, valid, dh_out)]


def cluster_checks(phase: str, kind: str) -> float:
    """K2 (``kind="fwd"``: h_out and the residuals) or K3 ("bwd": dgates
    from the plain forward's residuals) on the cluster route against its
    plain version, bf16, at every width of CLUSTER_WIDTHS: B=32 and a
    ragged B=5 (one part-filled row tile), T=1 and T=37, a zero-length
    row, both directions at once (D=2) and one reverse direction alone
    (D=1) -> the largest error (each within BF16_TOL)."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    bf16 = torch.bfloat16
    worst = 0.0
    for h in CLUSTER_WIDTHS:
        for rev in ((False, True), (True,)):
            for b in (32, 5):
                for t in (1, 37):
                    gx, w_hh, valid, dh_out = scan_inputs(h, len(rev), b, t,
                                                          h + 7 * b + t)
                    with torch.inference_mode():
                        ref = K.lstm_scan_reference(gx, w_hh, valid, bf16,
                                                    rev, residuals=True)
                        if kind == "fwd":
                            got, _ = routed(kind, bf16, lambda: K.lstm_scan(
                                gx, w_hh, valid, bf16, rev, residuals=True))
                            want = ref
                        else:
                            args = (w_hh, valid, ref[3], ref[2], dh_out, bf16,
                                    rev)
                            got, _ = routed(kind, bf16,
                                            lambda: [K.lstm_scan_bwd(*args)])
                            want = [K.lstm_scan_bwd_reference(*args)]
                    torch.cuda.synchronize()
                    require(all(bool(torch.isfinite(a).all()) for a in got),
                            f"{kind} cluster route output not finite")
                    err = max((a - w).abs().max().item()
                              for a, w in zip(got, want))
                    plan = K.cluster_plan(kind, h, b, bf16)
                    log(f"[{phase}] K{2 if kind == 'fwd' else 3} cluster "
                        f"route H={h} D={len(rev)} reverse={rev} B={b} T={t} "
                        f"(C={plan.cluster} R={plan.rows}): max_abs_err "
                        f"{err:.3e} (tol {BF16_TOL:g})")
                    require(err <= BF16_TOL,
                            f"{kind} cluster route error {err} > {BF16_TOL}")
                    worst = max(worst, err)
    return worst


def bucket_batch(rec, files, frames: int = 400):
    """A full batch of 32 at one bucket: the files cycled over 28 rows,
    4 empty rows (as transcribe pads a partial batch)."""
    from semi_supervised_asr_tpu_torch import transcribe as TR

    pieces = [TR.load_audio(files[r % len(files)])
              for r in range(rec.cfg.train.batch_size - 4)]
    return TR.pad_batch(pieces, rec.spec.samples_for_frames(frames), rec.cfg)


def run_cli(argv: list[str]) -> list[dict]:
    from semi_supervised_asr_tpu_torch import transcribe as TR

    with tempfile.NamedTemporaryFile("r", suffix=".jsonl") as out:
        rc = TR.main([*argv, "--out", out.name])
        require(rc == 0, f"transcribe exited {rc}")
        return [json.loads(line) for line in out.read().splitlines()]


def phase4(d: Path, files: list[Path]) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch import transcribe as TR

    base = ["--config", str(CONFIG), "--load-dir", str(d), "--device",
            DEVICE, *map(str, files)]
    _native.reset_launches()
    beam = run_cli(base)
    launches = dict(_native.LAUNCHES)
    log(f"[phase4] transcribe beam 5: {len(beam)} records, kernel launches "
        f"{launches}")
    greedy = run_cli(["--beam", "1", *base])
    log(f"[phase4] transcribe greedy: {len(greedy)} records")
    for recs in (beam, greedy):
        require(len(recs) == len(files), "one record per file")
        require(all(isinstance(r["text"], str) and math.isfinite(r["score"])
                    for r in recs), "texts and finite scores")
    require(all(launches[k] > 0 for k in LSTM_PATH[:2]),
            f"a kernel of the serving path did not launch: {launches}")
    require(launches["lstm_scan_fwd_cluster"] == launches["lstm_scan_fwd"],
            f"bf16 serving ran K2 off the cluster route: {launches}")
    log(f"[phase4] first record: {json.dumps(beam[0])[:200]}")

    results = {}
    for dtype in ("bfloat16", "float32"):
        cfg = TR.load_config(CONFIG, [f"model.compute_dtype={dtype}"])
        ker = TR.Recognizer.from_dir(cfg, d, DEVICE)
        ref = TR.Recognizer(ker.cfg, ker.model, (ker.mean.cpu(),
                            ker.inv_std.cpu()), ker.vocab,
                            torch.device(DEVICE), backend="reference")
        audio, lens = bucket_batch(ker, files)
        a = torch.as_tensor(audio, device=DEVICE)
        n = torch.as_tensor(lens, device=DEVICE)
        with torch.inference_mode():
            enc_k, mask_k, _ = ker.encode(a, n)
            enc_r, mask_r, _ = ref.encode(a, n)
        require(bool(torch.equal(mask_k, mask_r)), "encoder masks differ")
        err = (enc_k - enc_r).abs().max().item()
        tol = K2_TOL if dtype == "float32" else BF16_TOL
        log(f"[phase4] {dtype} bucket 400 B=32: enc max_abs_err {err:.3e} "
            f"(tol {tol:g})")
        require(err <= tol, f"enc error {err} > {tol}")
        agree = {}
        for mode in ("beam", "greedy"):
            tk, _ = ker.decode(audio, lens, mode)
            tr, _ = ref.decode(audio, lens, mode)
            same_rows = float(np.mean(np.all(tk == tr, axis=1)))
            agree[mode] = same_rows
            log(f"[phase4] {dtype} {mode}: rows with identical tokens "
                f"kernel vs plain {same_rows:.3f}")
            if dtype == "float32":
                require(same_rows == 1.0,
                        f"float32 {mode} tokens differ from the plain path")
        results[dtype] = {"enc_err": err, "agree": agree, "rec": (ker, ref),
                          "batch": (audio, lens)}
    return results, launches


def phase5(results, fcfg, card: str) -> dict:
    import torch

    from semi_supervised_asr_tpu_torch.ops import fused_frontend as FF
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
    from semi_supervised_asr_tpu_torch.ops import recurrent as R

    times = {}
    k1_timing(times, fcfg)
    x, w_ih, bias, w_hh, valid = k2_inputs(400, 80, 3)
    b, t, h = 32, 400, 256
    with torch.inference_mode():
        gx = (R.mm(x, w_ih, torch.bfloat16) + bias).view(b, t, 2, 4 * h)
        gx = gx.permute(2, 1, 0, 3).contiguous()
        args = (gx, w_hh, valid, torch.bfloat16, (False, True))
        kernel_times(times, "lstm_scan_fwd", lambda: K.lstm_scan(*args),
                     lambda: K.lstm_scan_reference(*args), reps=3)
    ker, ref = results["bfloat16"]["rec"]
    audio, lens = results["bfloat16"]["batch"]
    for rec in (ref, ker, ker, ref):
        key = "serve_beam5" + ("_plain" if rec is ref else "")
        times.setdefault(key, []).extend(
            host_ms(lambda: rec.decode(audio, lens, "beam"), reps=3))
        key = "encode" + ("_plain" if rec is ref else "")
        a = torch.as_tensor(audio, device=DEVICE)
        n = torch.as_tensor(lens, device=DEVICE)
        times.setdefault(key, []).extend(
            host_ms(lambda: rec.encode(a, n), reps=3))
    return report("phase5", times, card)


def k1_timing(times: dict, fcfg) -> None:
    """K1 at B=32, T=400 (timit's bucket) and T=1600 (the conformer's):
    device time L2-cold -- each call reads another of a set of inputs that
    together hold twice the 50 MB L2 -- and L2-warm (one input again and
    again), its call time, its plain version's, and the mel product alone,
    ``torch.matmul(pspec, fb)`` (a partial yardstick: the same bytes in and
    out, less work, not the same function); plain, kernel, kernel, plain.
    Then the sweep of K1_PLANS, L2-cold, at both shapes."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import frontend as F
    from semi_supervised_asr_tpu_torch.ops import fused_frontend as FF

    _, fb = F.constants(fcfg, torch.device(DEVICE))

    def kern(ps, fl, mu, sd):
        return FF.fused_post_fft(ps, fl, fcfg, mu, sd)

    def plain(ps, fl, mu, sd):
        return FF.fused_post_fft_reference(ps, fl, fcfg, mu, sd)

    def mel(ps, *_):
        return torch.matmul(ps, fb)

    def rotating(fn, sets):
        it = itertools.cycle(sets)
        return lambda: fn(*next(it))

    shapes = {}
    for t in (400, 1600):
        first = k1_inputs(32, t, 7, fcfg)[:4]
        n = max(2, math.ceil(2 * L2_BYTES / (first[0].numel() * 4)))
        sets = [first] + [k1_inputs(32, t, 7 + i, fcfg)[:4]
                          for i in range(1, n)]
        shapes[t] = sets
        tag = "fused_post_fft" + ("" if t == 400 else f"_t{t}")
        reps = max(16, 2 * n)
        for name, fn in ((tag + "_plain", plain), (tag, kern), (tag, kern),
                         (tag + "_plain", plain)):
            record(times, name, profiled_ms(rotating(fn, sets), reps=reps))
            times.setdefault(name + "_call", []).append(
                cuda_ms(lambda: fn(*first), reps=20))
            if fn is kern:
                record(times, name + "_warm",
                       profiled_ms(lambda: fn(*first), reps=20))
        mm = "mel_matmul" + tag[len("fused_post_fft"):]
        record(times, mm, profiled_ms(rotating(mel, sets), reps=reps))
        record(times, mm + "_warm", profiled_ms(lambda: mel(*first), reps=20))
        log(f"[phase5] K1 T={t}: {n} rotating input sets of "
            f"{first[0].numel() * 4 / 1e6:.1f} MB for the L2-cold times")
    def planned(plan, fn):
        def call():
            with k1_plan(plan):
                fn()
        return call

    per_shape = [device_ms_each([planned(p, rotating(kern, shapes[t]))
                                 for p in K1_PLANS],
                                reps=max(16, 2 * len(shapes[t])))
                 for t in (400, 1600)]
    sweep = {p: [ms[i] for ms in per_shape] for i, p in enumerate(K1_PLANS)}
    best = min(sweep, key=lambda p: sweep[p][0])
    log("[phase5] K1 plan sweep, device ms L2-cold (profiler) at B=32; "
        "rows per tile, row groups, ring stages, blocks per SM:")
    for plan, (a, b) in sorted(sweep.items()):
        log(f"[phase5]   R={plan[0]:2d} G={plan[1]} S={plan[2]} k={plan[3]}: "
            f"T=400 "
            f"{a:.4f}  T=1600 {b:.4f}"
            + ("  <- default" if plan == FF.PLAN else ""))
    log(f"[phase5] K1 fastest plan at T=400: {best} ({sweep[best][0]:.4f} "
        f"ms); the default {FF.PLAN}: {sweep[FF.PLAN][0]:.4f} ms")


def kernel_times(times: dict, name: str, kernel, plain, reps: int) -> None:
    """plain, kernel, kernel, plain: call time (CUDA events, includes the
    host's launch work) and device time into ``times``: the kernel's (one
    that outlasts its launch) by CUDA events over back-to-back calls,
    which needs no profiler (stored under ``name + "_b2b"``), the plain
    version's by the profiler."""
    for key, fn in ((name + "_plain", plain), (name, kernel), (name, kernel),
                    (name + "_plain", plain)):
        times.setdefault(key + "_call", []).append(cuda_ms(fn, reps=reps))
        if fn is kernel:
            times.setdefault(key + "_b2b", []).append(
                back_to_back_ms(fn, reps=2 * reps))
        else:
            record(times, key, profiled_ms(fn, reps=reps))


def report(phase: str, times: dict, card: str,
           shape: str = "bucket 400, B=32, bf16") -> dict:
    med = {k: statistics.median(v) for k, v in times.items()}
    for k in sorted(med):
        what = ("call time, CUDA events" if k.endswith("_call") else
                METHODS["graph"][1] if k.endswith("_graph") else
                METHODS["b2b"][1] if k.endswith("_b2b") else
                "device time, profiler, L2-warm" if k.endswith("_warm") else
                "device time, profiler, L2-cold"
                if k.startswith(("fused_post_fft", "mel_matmul")) else
                "host time to synchronize"
                if k.startswith(("serve", "enc", "train", "conformer", "c4"))
                else
                "device time, profiler")
        log(f"[{phase}] {k}: median {med[k]:.4f} ms ({what}) over "
            f"{len(times[k])} runs at {shape} ({card})")
    return med


def k3_inputs(t: int, i: int, seed: int, compute, b: int = 32,
              h: int = 256):
    """K2's residuals for a random layer (kernel forward) and a random
    dh_out: the inputs of the backward scan."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
    from semi_supervised_asr_tpu_torch.ops import recurrent as R

    x, w_ih, bias, w_hh, valid = k2_inputs(t, i, seed, b, h)
    with torch.inference_mode():
        gx = (R.mm(x, w_ih, compute) + bias).view(b, t, 2, 4 * h)
        gx = gx.permute(2, 1, 0, 3).contiguous()
        _, _, cprev, acts = K.lstm_scan(gx, w_hh, valid, compute,
                                        (False, True), residuals=True)
    g = torch.Generator().manual_seed(seed + 1)
    dh_out = torch.randn((2, t, b, h), generator=g).to(DEVICE)
    return w_hh, valid, acts, cprev, dh_out


def layer_grads(x, w_ih, bias, w_hh, valid, dy, backend):
    """dx, dW_ih, dW_hh, db of one BiLSTM layer (f32) through the
    autograd Function, on the kernels or the plain versions."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    h4 = w_hh.shape[2]
    leaves = [x, w_ih[:, :h4], w_hh[0], bias[:h4], w_ih[:, h4:], w_hh[1],
              bias[h4:]]
    leaves = [a.detach().clone().requires_grad_(True) for a in leaves]
    xg, wif, whf, bf, wib, whb, bb = leaves
    params = {"fwd": {"w_ih": wif, "w_hh": whf, "b": bf},
              "bwd": {"w_ih": wib, "w_hh": whb, "b": bb}}
    lens = valid.sum(0).to(torch.int32)
    y = K.bilstm_kernel(params, xg, lens, torch.float32, backend)
    return torch.autograd.grad((y * dy).sum(), leaves)


def grad_errs(got, want) -> list[float]:
    """Per leaf, max |got - want| over the largest |want| entry of all the
    leaves: the GRAD_TOL measure."""
    scale = max(w.abs().max().item() for w in want)
    return [(g - w).abs().max().item() / scale for g, w in zip(got, want)]


def phase6() -> tuple[float, float]:
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    worst, worst_bf16 = 0.0, 0.0
    rev = (False, True)
    for name, t, i in (("layer0", 800, 80), ("pyramid", 100, 1024)):
        for compute in (torch.float32, torch.bfloat16):
            w_hh, valid, acts, cprev, dh_out = k3_inputs(t, i, t, compute)
            args = (w_hh, valid, acts, cprev, dh_out, compute, rev)
            got, route = routed("bwd", compute,
                                lambda: K.lstm_scan_bwd(*args))
            want = K.lstm_scan_bwd_reference(*args)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), "K3 output not finite")
            err = (got - want).abs().max().item()
            tol = K3_TOL if compute == torch.float32 else BF16_TOL
            log(f"[phase6] K3 {name} T={t} B=32 H=256 D=2 "
                f"{str(compute).split('.')[-1]} ({route} route): dgates "
                f"max_abs_err {err:.3e} (tol {tol:g}), max |dgates| "
                f"{want.abs().max().item():.3e}")
            require(err <= tol, f"K3 error {err} > {tol}")
            if compute == torch.float32:
                worst = max(worst, err)
            else:
                worst_bf16 = max(worst_bf16, err)
        x, w_ih, bias, w_hh, valid = k2_inputs(t, i, t + 2)
        g = torch.Generator().manual_seed(t + 3)
        dy = torch.randn((32, t, 2 * w_hh.shape[1]), generator=g).to(DEVICE)
        got = layer_grads(x, w_ih, bias, w_hh, valid, dy, None)
        want = layer_grads(x, w_ih, bias, w_hh, valid, dy, "reference")
        errs = grad_errs(got, want)
        log(f"[phase6] BiLSTM layer {name} float32 gradients, kernel vs "
            f"plain (max err / the layer's max |g|): dx {errs[0]:.3e} fwd "
            f"dW_ih {errs[1]:.3e} dW_hh {errs[2]:.3e} db {errs[3]:.3e} "
            f"bwd dW_ih {errs[4]:.3e} dW_hh {errs[5]:.3e} db {errs[6]:.3e} "
            f"(tol {GRAD_TOL:g})")
        require(max(errs) <= GRAD_TOL, f"layer gradient error {max(errs)}")
    return worst, max(worst_bf16, cluster_checks("phase6", "bwd"))


def k5_inputs(b: int, t: int, h: int, hd: int, seed: int,
              odd_rows: bool = True):
    """Random q, k, v [B, T, H, D] (float32), a key mask with ragged
    lengths (row 0 full) and a random output cotangent.  ``odd_rows``: row
    1 empty, row 2 of length 1, and every other row from 3 on with holes
    (about a third of its keys masked before its last valid key)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn((b, t, h, hd), generator=g)
                     for _ in range(4))
    lens = torch.randint(max(t // 4, 1), t + 1, (b,), generator=g)
    lens[0] = t
    if odd_rows:
        lens[1:3] = torch.tensor([0, 1])[:max(b - 1, 0)]
    mask = torch.arange(t)[None, :] < lens[:, None]
    if odd_rows:
        holes = torch.rand((b, t), generator=g) < 1 / 3
        holes[:3] = False
        holes[4::2] = False
        holes[torch.arange(b), (lens - 1).clamp_min(0)] = False
        mask &= ~holes
    return [x.to(DEVICE) for x in (q, k, v, mask, dout)]


def k5_grads(q, k, v, mask, dout, compute, backend):
    """(O, dq, dk, dv) of ``mhsa`` on the kernels or the plain version; the
    gradients reach the float32 inputs through the cast to ``compute``."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import flash_mhsa as FM

    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    scale = 1.0 / math.sqrt(q.shape[-1])
    o = FM.mhsa(*leaves, mask, sm_scale=scale, compute=compute,
                backend=backend)
    grads = torch.autograd.grad(o, leaves, dout.to(o.dtype))
    return [o.detach().float(), *(x.float() for x in grads)]


def phase9() -> dict:
    """K5 forward and backward against the plain version."""
    import torch

    worst = {}
    # odd: head dims below one 64-wide box, above it, and 8; T above one
    # tile and not a multiple of 64
    shapes = [("conformer", 32, 100, 8, 64), ("conformer", 32, 400, 8, 64),
              ("odd", 5, 37, 3, 24), ("odd", 5, 70, 2, 128),
              ("odd", 5, 65, 4, 8), ("odd", 5, 129, 2, 64)]
    for name, b, t, h, hd in shapes:
        for compute in (torch.float32, torch.bfloat16):
            q, k, v, mask, dout = k5_inputs(b, t, h, hd, seed=t + hd)
            got = k5_grads(q, k, v, mask, dout, compute, None)
            want = k5_grads(q, k, v, mask, dout, compute, "reference")
            torch.cuda.synchronize()
            require(all(bool(torch.isfinite(x).all()) for x in got),
                    "K5 output or gradient not finite")
            require(bool((got[1][1] == 0).all()),
                    "K5: the empty row's dq is not zero")
            o_err = (got[0] - want[0]).abs().max().item()
            g_errs = grad_errs(got[1:], want[1:])
            f32 = compute == torch.float32
            o_tol = K5_TOL if f32 else K5_BF16_TOL
            g_tol = GRAD_TOL if f32 else K5_BF16_GRAD_TOL
            dt = str(compute).split(".")[-1]
            log(f"[phase9] K5 {name} B={b} T={t} H={h} D={hd} {dt}: O "
                f"max_abs_err {o_err:.3e} (tol {o_tol:g}); gradients (max "
                f"err / max |g|) dq {g_errs[0]:.3e} dk {g_errs[1]:.3e} dv "
                f"{g_errs[2]:.3e} (tol {g_tol:g})")
            require(o_err <= o_tol, f"K5 forward error {o_err} > {o_tol}")
            require(max(g_errs) <= g_tol,
                    f"K5 gradient error {max(g_errs)} > {g_tol}")
            g_abs = max((a - w).abs().max().item()
                        for a, w in zip(got[1:], want[1:]))
            for key, val in ((dt, o_err), (dt + "_grad", max(g_errs)),
                             (dt + "_grad_abs", g_abs)):
                worst[key] = max(worst.get(key, 0.0), val)
    return worst


def conformer_config(extra: list[str]):
    from semi_supervised_asr_tpu_torch import transcribe as TR

    cfg = TR.load_config(CONFORMER_CONFIG, [*CONFORMER_OVERRIDES, *extra])
    return TR.finalize_config(cfg, TR.build_vocab(cfg).size)


def enc_errs(rec_k, rec_r, audio, lens) -> tuple[float, float]:
    """Encoder outputs of one batch on kernels and on the plain versions ->
    (max abs difference, that over the largest |output|)."""
    import torch

    a = torch.as_tensor(audio, device=DEVICE)
    n = torch.as_tensor(lens, device=DEVICE)
    with torch.inference_mode():
        enc_k, mask_k, _ = rec_k.encode(a, n)
        enc_r, mask_r, _ = rec_r.encode(a, n)
    require(bool(torch.equal(mask_k, mask_r)), "encoder masks differ")
    require(bool(torch.isfinite(enc_k).all()), "encoder output not finite")
    err = (enc_k - enc_r).abs().max().item()
    return err, err / enc_r.abs().max().item()


def phase10(d: Path, files: list[Path]) -> tuple[dict, dict]:
    """Serving at ls960_conformer full width with attn_backend flash."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch import transcribe as TR

    base = ["--config", str(CONFORMER_CONFIG), "--load-dir", str(d),
            "--device", DEVICE, *map(str, files), *CONFORMER_OVERRIDES]
    _native.reset_launches()
    beam = run_cli(base)
    launches = dict(_native.LAUNCHES)
    log(f"[phase10] conformer transcribe beam 5: {len(beam)} records, "
        f"kernel launches {launches}")
    greedy = run_cli(["--beam", "1", *base])
    log(f"[phase10] conformer transcribe greedy: {len(greedy)} records")
    for recs in (beam, greedy):
        require(len(recs) == len(files), "one record per file")
        require(all(isinstance(r["text"], str) and math.isfinite(r["score"])
                    for r in recs), "texts and finite scores")
    # one encode per bucket batch, each through the 16 blocks' attention
    require(launches["fused_post_fft"] > 0
            and launches["flash_mhsa_fwd"] > 0
            and launches["flash_mhsa_fwd"] % 16 == 0,
            f"the conformer serving path missed a kernel: {launches}")
    log(f"[phase10] first record: {json.dumps(beam[0])[:200]}")

    results = {}
    for dtype in ("bfloat16", "float32"):
        cfg = conformer_config([f"model.compute_dtype={dtype}"])
        ker = TR.Recognizer.from_dir(cfg, d, DEVICE)
        ref = TR.Recognizer(ker.cfg, ker.model, (ker.mean.cpu(),
                            ker.inv_std.cpu()), ker.vocab,
                            torch.device(DEVICE), backend="reference")
        audio, lens = bucket_batch(ker, files, frames=800)
        err, rel = enc_errs(ker, ref, audio, lens)
        f32 = dtype == "float32"
        tol = CONF_ENC_TOL if f32 else CONF_ENC_BF16_TOL
        log(f"[phase10] conformer {dtype} bucket 800 B=32: enc max_abs_err "
            f"{err:.3e}, over max |enc| {rel:.3e} (tol {tol:g} "
            f"{'absolute' if f32 else 'relative'})")
        require((err if f32 else rel) <= tol, f"conformer enc error {err}")
        agree = {}
        for mode in ("beam", "greedy"):
            tk, _ = ker.decode(audio, lens, mode)
            tr, _ = ref.decode(audio, lens, mode)
            agree[mode] = float(np.mean(np.all(tk == tr, axis=1)))
            log(f"[phase10] conformer {dtype} {mode}: rows with identical "
                f"tokens kernel vs plain {agree[mode]:.3f}")
            if f32:
                require(agree[mode] == 1.0,
                        f"float32 {mode} tokens differ from the plain path")
        results[dtype] = {"enc_err": err, "enc_rel": rel, "agree": agree,
                          "rec": (ker, ref)}
    return results, launches


def phase11(d: Path):
    """Training at ls960_conformer full width with attn_backend flash."""
    import torch

    from semi_supervised_asr_tpu_torch import _native

    log(f"[phase11] overrides {CONFORMER_OVERRIDES + CONFORMER_TRAIN} "
        "(model.enc_dropout, data.sortagrad_epochs and train.async_ckpt "
        "are not ported)")
    s = short_solver(conformer_config(CONFORMER_TRAIN), d / "bf16")
    _native.reset_launches()
    s.train()
    recs = s.history
    for r in recs:
        log(f"[phase11] {r}")
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    log(f"[phase11] conformer train 3 steps, bucket 1600, B=32, bf16: "
        f"losses {[r['loss'] for r in recs]}, kernel launches {launches}")
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in recs), "conformer training loss not finite")
    require(all(launches[k] > 0 for k in ("fused_post_fft", "flash_mhsa_fwd",
                                          "flash_mhsa_bwd")),
            f"a kernel of the conformer training path did not launch: "
            f"{launches}")
    require(launches["fused_post_fft"] == len(recs),
            f"K1 did not launch once a conformer train step: {launches}")
    step_check(short_solver(conformer_config(
        [*CONFORMER_TRAIN, "model.compute_dtype=float32"]), d / "f32"),
        "phase11")
    return s, launches, recs


def gpu_clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def k5_bucket(times: dict, shape: tuple) -> None:
    """K5 forward and backward (bf16) beside SDPA at one shape, device
    times from CUDA graphs of back-to-back calls (:func:`graph_ms`; the
    profiler can stop recording late in a run), with the card's clocks
    before and after; at K5_TIMING also the plain version, and each of the
    three twice, into ``times`` (the kernel table's numbers).  A forward is
    timed under no_grad; a backward as the graph of forward + backward
    minus that of the forward that keeps what the backward needs, for the
    kernels (the autograd Function), the plain version and SDPA alike."""
    import torch
    import torch.nn.functional as Fn

    from semi_supervised_asr_tpu_torch.ops import flash_mhsa as FM

    bf16 = torch.bfloat16
    b, t, h, d = shape
    q, k, v, mask, dout = (x.to(bf16) if x.is_floating_point() else x
                           for x in k5_inputs(*shape, seed=11,
                                              odd_rows=False))
    scale = 1.0 / math.sqrt(d)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    # the library yardstick: SDPA on [B, H, T, D] with the boolean key mask
    sl = [x.transpose(1, 2).contiguous().requires_grad_(True)
          for x in (q, k, v)]
    am = mask[:, None, None, :]
    sdo = dout.transpose(1, 2).contiguous()
    fwds = {
        "kernel": (lambda: FM.mhsa(*leaves, mask, sm_scale=scale,
                                   compute=bf16), leaves, dout),
        "plain": (lambda: FM.mhsa_reference(*leaves, mask, sm_scale=scale,
                                            compute=bf16), leaves, dout),
        "sdpa": (lambda: Fn.scaled_dot_product_attention(
            *sl, attn_mask=am, scale=scale), sl, sdo),
    }

    def fwd_ms(who):
        fwd = fwds[who][0]

        def call():
            with torch.no_grad():
                fwd()
        return graph_ms(call)

    def bwd_ms(who):
        fwd, xs, dy = fwds[who]
        return (graph_ms(lambda: torch.autograd.grad(fwd(), xs, dy))
                - graph_ms(fwd))

    timing = shape == K5_TIMING
    bound = k5_bounds(shape, mask.sum(1))
    for name, ms_of in (("flash_mhsa_fwd", fwd_ms), ("flash_mhsa_bwd",
                                                     bwd_ms)):
        log(f"[phase12] clocks before {name} T'={t}: {gpu_clocks()} (SM "
            "MHz, max SM MHz, W, C)")
        order = (("plain", "kernel", "sdpa", "kernel", "plain") if timing
                 else ("kernel", "sdpa"))
        got = {}
        for who in order:
            got.setdefault(who, []).append(ms_of(who))
            if timing:
                key = {"kernel": name, "plain": name + "_plain",
                       "sdpa": "sdpa" + name[-4:]}[who]
                record(times, key, (got[who][-1], "graph"))
        log(f"[phase12] clocks after {name} T'={t}: {gpu_clocks()}")
        kernel_ms = ms = statistics.median(got["kernel"])
        lib_ms = got["sdpa"][0]
        bms, by = bound[name]
        log(f"[phase12] {name} B={b} T'={t} H={h} D={d} bf16: {ms:.4f} ms, "
            f"SDPA {lib_ms:.4f} ms ({METHODS['graph'][1]}), kernel/SDPA "
            f"{ms / lib_ms:.2f}; bound {bms:.4f} ms ({by}): kernel at "
            f"{bms / ms:.1%}, SDPA at {bms / lib_ms:.1%} of it")
    o, m, l = FM.mhsa_fwd(q, k, v, mask, scale)

    def kernel_bwd():
        return FM.mhsa_bwd(q, k, v, mask, o, m, l, dout, scale)

    if timing:
        # call times (CUDA events around one Python call, host work
        # included): the kernels' entries and the plain versions
        out = FM.mhsa_reference(*leaves, mask, sm_scale=scale, compute=bf16)
        calls = (("flash_mhsa_fwd", lambda: FM.mhsa_fwd(q, k, v, mask,
                                                         scale)),
                 ("flash_mhsa_fwd_plain", lambda: FM.mhsa_reference(
                     q, k, v, mask, sm_scale=scale, compute=bf16)),
                 ("flash_mhsa_bwd", kernel_bwd),
                 ("flash_mhsa_bwd_plain", lambda: torch.autograd.grad(
                     out, leaves, dout, retain_graph=True)))
        for key, fn in calls:
            times.setdefault(key + "_call", []).append(cuda_ms(fn, reps=10))
        # the backward's two launches apart (K5dq, K5dkv): their shares
        # of one profiler trace (a trace that loses events late in a run
        # understates each mean, so the sum is set beside the graph's)
        split = device_ms_by_kernel(kernel_bwd, reps=10)
        total = sum(split.values())
        # the three methods on the same direct calls, side by side
        split_how = "b2b" if EVENTS_KEY in split else "profiler"
        for what, fn, (prof, how) in (
                ("forward", calls[0][1], profiled_ms(calls[0][1], reps=10)),
                ("backward", kernel_bwd, (total, split_how))):
            log(f"[phase12] K5 {what} at T'={t}, one direct call timed "
                f"three ways: {graph_ms(fn):.4f} ms (CUDA graph), "
                f"{prof:.4f} ms ({METHODS[how][1]}), "
                f"{back_to_back_ms(fn, 100):.4f} ms (CUDA events, back to "
                "back)")
        for name, ms in sorted(split.items()):
            short = re.search(r"(\w+)<", name)
            log(f"[phase12] T'={t} flash_mhsa_bwd launch "
                f"{short.group(1) if short else name[:80]}: {ms:.4f} ms, "
                f"{ms / total:.1%} of the trace's {total:.4f} ms "
                f"({METHODS[split_how][1]}; the graph's backward "
                f"{kernel_ms:.4f} ms)")


def phase12(s, files: list[Path], card: str) -> dict:
    """Timings at bucket 1600, B=32, bf16: K5 forward and backward against
    the plain version and SDPA; the conformer serve batch and train step
    (``s``: phase 11's trained Solver)."""
    import torch

    from semi_supervised_asr_tpu_torch import transcribe as TR
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    times = {}
    for t in K5_BUCKETS:
        k5_bucket(times, (*K5_TIMING[:1], t, *K5_TIMING[2:]))
    # the conformer serve batch (beam 5) and train step, kernels vs plain
    ker = TR.Recognizer(s.cfg, s.state.model, s.cmvn, s.vocab,
                        torch.device(DEVICE))
    ref = TR.Recognizer(ker.cfg, ker.model, s.cmvn, ker.vocab,
                        torch.device(DEVICE), backend="reference")
    audio, lens = bucket_batch(ker, files, frames=1600)
    for rec in (ref, ker, ker, ref):
        key = "conformer_serve_beam5" + ("_plain" if rec is ref else "")
        times.setdefault(key, []).extend(
            host_ms(lambda: rec.decode(audio, lens, "beam"), reps=1))
    _, tensors = first_batch(s)
    plain = TS.init_train_state(s.cfg, copy.deepcopy(s.state.model), 0)
    for state, backend in ((plain, "reference"), (s.state, None),
                           (s.state, None), (plain, "reference")):
        key = "conformer_train_step" + ("_plain" if backend else "")
        times.setdefault(key, []).extend(host_ms(
            lambda: TS.supervised_step(s.cfg, state, *tensors, s.cmvn_dev,
                                       backend=backend), reps=2))
    med = report("phase12", times, card, "bucket 1600, B=32, bf16")
    work = {
        "conformer_beam5_b32_t1600": (lambda: ker.decode(audio, lens, "beam"),
                                      med["conformer_serve_beam5"]),
        "conformer_train_step_b32_t1600": (lambda: TS.supervised_step(
            s.cfg, s.state, *tensors, s.cmvn_dev),
            med["conformer_train_step"]),
    }
    return med, work


def semi_solver(d: Path, dtype: str, extra=()):
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    return Solver(load_config(SEMI_CONFIG, [
        *SEMI_OVERRIDES, f"model.compute_dtype={dtype}", *extra]), d, DEVICE)


def semi_step_check(s, loss_tol: float = 1e-5,
                    grad_tol: float = GRAD_TOL) -> None:
    """One C4 step from the Solver's weights (student and EMA teacher),
    the first batch of its streams and fixed SpecAugment bands, gate open
    and every row kept (SEMI_CHECK), in its compute dtype, kernels against
    plain:
    the clean view and the teacher's hypotheses are compared first, then
    both runs take the kernel teacher's hypotheses, so that the student's
    loss and gradients are compared on the same targets (loss within
    ``loss_tol`` relative, every gradient leaf within ``grad_tol`` of the
    model's largest entry); the EMA buffer after the update within 1e-6."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.objectives import losses as LO
    from semi_supervised_asr_tpu_torch.ops import frontend as F
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    cfg = dataclasses.replace(s.cfg, objective=dataclasses.replace(
        s.cfg.objective, **SEMI_CHECK))
    dtype = cfg.model.compute_dtype
    fcfg = cfg.frontend
    _, _, batch = next(s._labeled_stream())
    tensors, unlab = s.step_inputs(batch, *s._unlabeled_streams())
    gen = torch.Generator().manual_seed(5)

    def bands(audio_lens, frames):
        flens = torch.clamp_max(F.frame_lengths(audio_lens, fcfg), frames)
        return F.sample_specaug_params(gen, flens.shape[0], fcfg.n_mels,
                                       flens, fcfg)

    lab_bands = bands(tensors[1], batch.bucket[0])
    max_len = min(cfg.decode.max_decode_len, tensors[2].shape[1])
    views, labels = {}, {}
    for backend in (None, "reference"):
        views[backend] = TS.featurize(cfg, unlab["unlab_audio"],
                                      unlab["unlab_audio_lens"], s.cmvn_dev,
                                      False, backend)
        labels[backend] = LO.teacher_labels(s.state.ema, *views[backend],
                                            max_len, backend)
    unlab_bands = bands(unlab["unlab_audio_lens"], views[None][0].shape[1])
    view_err = (views[None][0] - views["reference"][0]).abs().max().item()
    same = float(np.mean(np.all(
        (labels[None][0] == labels["reference"][0]).cpu().numpy(), axis=1)))
    log(f"[phase13] {dtype} clean view (K1 vs plain) max_abs_err "
        f"{view_err:.3e}; teacher's greedy hypotheses (K2 no-grad vs "
        f"plain) identical in {same:.3f} of the rows")
    if dtype == "float32":
        require(view_err <= K1_TOL, f"clean view error {view_err}")
        # a near-tie of two logits can flip one row's argmax; a fault in
        # the path would move every row
        require(same >= 0.95, "float32 teacher hypotheses differ")
    out = {}
    _native.reset_launches()
    for backend in (None, "reference"):
        state = TS.init_train_state(cfg, copy.deepcopy(s.state.model), 0)
        state.ema = copy.deepcopy(s.state.ema)
        t0 = time.perf_counter()
        loss, aux, grads = TS.loss_and_grads(
            cfg, state, *tensors, s.cmvn_dev, lab_bands, backend, **unlab,
            unlab_specaug=unlab_bands, pseudo_labels=labels[None])
        grads = [g.clone() for g in grads]
        TS.apply_grads(cfg, state, [g.clone() for g in grads])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[backend] = (loss, aux, grads, list(state.ema.parameters()))
        log(f"[phase13] {dtype} check step on "
            f"{backend or 'the kernels'}: {ms:.0f} ms; "
            + ", ".join(f"{k} {float(aux[k]):.6f}"
                        for k in ("ce", "text_ae", "pseudo", "pseudo_gate")))
        del state
    routes = {k: v for k, v in _native.LAUNCHES.items() if v}
    (lk, ak, gk, ek), (lr, ar, gr, er) = out[None], out["reference"]
    rel = abs(lk.item() - lr.item()) / abs(lr.item())
    names = [n for n, _ in s.state.model.named_parameters()]
    errs = dict(zip(names, grad_errs(gk, gr)))
    worst = max(errs, key=errs.get)
    ema_err = max((a - b).abs().max().item() for a, b in zip(ek, er))
    log(f"[phase13] {dtype} C4 step, kernels vs plain (kernel launches "
        f"{routes}): loss {lk.item():.6f} vs {lr.item():.6f} (rel "
        f"{rel:.2e}, tol {loss_tol:g}); worst gradient leaf {worst} "
        f"{errs[worst]:.3e} of the model's max |g| over {len(errs)} leaves "
        f"(tol {grad_tol:g}); EMA buffer max_abs_err {ema_err:.3e} (tol "
        f"1e-6)")
    require(all(float(ak[k]) > 0 for k in ("ce", "text_ae", "pseudo")),
            "a term of the C4 loss is zero")
    require(rel <= loss_tol, f"{dtype} C4 step loss differs: rel {rel}")
    require(errs[worst] <= grad_tol, f"C4 gradient {worst} differs")
    require(ema_err <= 1e-6, f"C4 EMA buffer differs by {ema_err}")


def c4_lstm_times(times: dict, card: str) -> None:
    """K2 and K3 at the C4 step's first-layer shapes (B=64, H=384, both
    directions, bf16, T=400 and 1600): device time by CUDA events over
    back-to-back calls (a launch lasts milliseconds, far beyond its host
    work), and the plain version's call time; the launch plan and how many
    of its clusters the card holds at once."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
    from semi_supervised_asr_tpu_torch.ops import recurrent as R

    bf16 = torch.bfloat16
    for kind in ("fwd", "bwd"):
        plan = K.cluster_plan(kind, 384, 64, bf16)
        require(plan.route == "cluster", f"C4 {kind} plan {plan}")
        held = K.cluster_occupancy(kind, plan)
        log(f"[phase13] {kind} plan at H=384 B=64: C={plan.cluster} "
            f"R={plan.rows} u={plan.units} threads={plan.threads} smem="
            f"{plan.smem} B; max active clusters {held}, a D=2 launch has "
            f"{2 * -(-64 // plan.rows)} ({card})")
    for t in C4_LSTM_T:
        tag = c4_tag(t)
        x, w_ih, bias, w_hh, valid = k2_inputs(t, 80, 3, b=64, h=384)
        with torch.inference_mode():
            gx = (R.mm(x, w_ih, bf16) + bias).view(64, t, 2, -1)
            gx = gx.permute(2, 1, 0, 3).contiguous()
        fwd = (gx, w_hh, valid, bf16, (False, True))
        bwd = (*k3_inputs(t, 80, 3, bf16, b=64, h=384), bf16, (False, True))
        del x, gx
        for name, kern, plain in (
                ("lstm_scan_fwd", lambda: K.lstm_scan(*fwd),
                 lambda: K.lstm_scan_reference(*fwd)),
                ("lstm_scan_bwd", lambda: K.lstm_scan_bwd(*bwd),
                 lambda: K.lstm_scan_bwd_reference(*bwd))):
            with torch.inference_mode():
                for fn, key in ((plain, "_plain_call"), (kern, "_b2b"),
                                (kern, "_b2b"), (plain, "_plain_call")):
                    ms = (back_to_back_ms(fn, reps=6) if key == "_b2b"
                          else cuda_ms(fn, reps=1, warmup=0))
                    times.setdefault(name + tag + key, []).append(ms)
        del fwd, bwd
        torch.cuda.empty_cache()
    # the second wave: at B=64 a D=2 launch has 16 clusters and the card
    # may hold fewer; B=56 (14 clusters) runs in one
    for b in (56, 64, 56, 64):
        x, w_ih, bias, w_hh, valid = k2_inputs(400, 80, 3, b=b, h=384)
        with torch.inference_mode():
            gx = (R.mm(x, w_ih, bf16) + bias).view(b, 400, 2, -1)
            gx = gx.permute(2, 1, 0, 3).contiguous()
            args = (gx, w_hh, valid, bf16, (False, True))
            times.setdefault(f"lstm_scan_fwd_h384_b{b}_t400_b2b", []).append(
                back_to_back_ms(lambda: K.lstm_scan(*args), reps=6))


def launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] - before.get(k, 0)}


def counting(solver, steps: list, evals: list, walls: list) -> None:
    """Record each step's and each validation's kernel launches (the
    difference of the counts around the call, so the run's own counts
    stay whole) and each step's wall time, by wrapping the Solver's
    ``run_step`` and ``validate`` on this instance."""
    import torch

    from semi_supervised_asr_tpu_torch import _native

    run_step, validate = solver.run_step, solver.validate

    def counted_step(args, unlab):
        torch.cuda.synchronize()
        before = dict(_native.LAUNCHES)
        t0 = time.perf_counter()
        m = run_step(args, unlab)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        steps.append(launch_delta(before, _native.LAUNCHES))
        return m

    def counted_validate():
        before = dict(_native.LAUNCHES)
        out = validate()
        evals.append((launch_delta(before, _native.LAUNCHES), out))
        return out

    solver.run_step, solver.validate = counted_step, counted_validate


def first_difference(a, b, path: str = "") -> str | None:
    """The first leaf of two checkpoint trees (dicts, lists, tensors,
    numbers) whose bits differ, or None."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            return f"{path} (keys)"
        for k in a:
            d = first_difference(a[k], b[k], f"{path}.{k}" if path else k)
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return f"{path} (length)"
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_difference(x, y, f"{path}.{i}")
            if d:
                return d
        return None
    if isinstance(a, torch.Tensor):
        same = (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))
        return None if same else path
    return None if a == b else path


def require_launches(what: str, got: dict, want: dict) -> None:
    """``got`` holds exactly ``want``'s counts, every K2 / K3 launch on the
    cluster route."""
    main = {k: got.get(k, 0) for k in LSTM_PATH}
    require(main == {k: want.get(k, 0) for k in LSTM_PATH},
            f"{what}: kernel launches {got}, not {want}")
    for k in ("fwd", "bwd"):
        require(got.get(f"lstm_scan_{k}_cluster", 0)
                == got.get(f"lstm_scan_{k}", 0),
                f"{what} ran K2 or K3 off the cluster route: {got}")


def phase13(d: Path, card: str):
    """The semi-supervised LAS step (C4) at ls100_semi width through the
    Solver: 3 bf16 steps (the gate closed, then open) with a checkpoint at
    step 2 and the final validation on the EMA buffer, each step's and the
    validation's kernel launches by route; step 2's checkpoint resumed in a
    fresh workdir must reproduce step 3 bitwise; a float32 step from fresh
    weights and a bf16 step from the trained ones, kernels against plain;
    K2 and K3 at the step's shapes; the median wall time of a step."""
    import shutil

    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch import train as T
    from semi_supervised_asr_tpu_torch.training.checkpointing import (
        Checkpointer,
    )

    run = d / "run"
    s = semi_solver(run, "bfloat16", SEMI_SOLVER)
    log(f"[phase13] {SEMI_CONFIG.name} at full width, batch 64, bf16, "
        f"through the Solver; cuts: {SEMI_OVERRIDES + SEMI_SOLVER}")
    steps, evals, walls = [], [], []
    counting(s, steps, evals, walls)
    _native.reset_launches()
    final = s.train()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    recs = s.history
    require(len(recs) == len(steps) == 3, f"C4 run took {len(steps)} steps")
    for i, (m, step) in enumerate(zip(recs, steps)):
        log(f"[phase13] step {i + 1}: loss {m['loss']:.4f} ce "
            f"{m['ce']:.4f} text_ae {m['text_ae']:.4f} pseudo "
            f"{m['pseudo']:.4f} pseudo_gate {m['pseudo_gate']:.0f} "
            f"grad_norm {m['grad_norm']:.4f}; wall {walls[i]:.1f} ms; "
            f"kernel launches {step}")
        require(all(math.isfinite(v) for v in m.values()),
                f"C4 step {i + 1}: a metric is not finite")
        require_launches(f"C4 step {i + 1}", step, C4_LAUNCHES)
    require([r["pseudo_gate"] for r in recs] == [0.0, 1.0, 1.0],
            "the pseudo-label gate did not open after step 1")
    require(len(evals) == 1, f"{len(evals)} validations, not 1")
    ev_launches, dev = evals[0]
    n_dev = -(-len(s.bundle.dev) // s.cfg.train.batch_size)
    require_launches("C4 validation", ev_launches,
                     {k: n * n_dev for k, n in SOLVER_EVAL_LAUNCHES.items()})
    log(f"[phase13] validation on the EMA buffer (decode.use_ema=true, "
        f"greedy, {len(s.bundle.dev)} dev utterances in {n_dev} batch): "
        f"{dev}; kernel launches {ev_launches}; run launches {launches}")
    require(all(math.isfinite(v) for v in final.values()),
            "C4 validation not finite")
    require(s.ckpt.all_steps() == [2, 3],
            f"C4 checkpoints {s.ckpt.all_steps()}, not [2, 3]")
    # step 2's checkpoint in a fresh workdir, resumed to step 3
    res = d / "resumed"
    shutil.copytree(run / "checkpoints" / "2", res / "checkpoints" / "2")
    shutil.copy(run / "cmvn.npz", res / "cmvn.npz")
    s2 = semi_solver(res, "bfloat16", SEMI_SOLVER)
    s2.train(resume=True)
    sd_a, meta_a, _ = Checkpointer(run / "checkpoints").load(3)
    sd_b, meta_b, _ = Checkpointer(res / "checkpoints").load(3)
    diff = first_difference(sd_a, sd_b)
    same_rec = all(recs[2][k] == s2.history[0][k]
                   for k in T.METRIC_KEYS + T.SEMI_KEYS)
    log(f"[phase13] resumed from step 2 in a fresh workdir: step 3's "
        f"state (parameters, EMA buffer, Adam moments and count, generator) "
        f"{'bitwise equal' if diff is None else 'differs first at ' + diff};"
        f" data_pos {meta_b['data_pos']} vs {meta_a['data_pos']}; step-3 "
        f"metrics equal: {same_rec}")
    require(diff is None, f"C4 resume differs from the straight run first "
            f"at {diff}")
    require(meta_a["data_pos"] == meta_b["data_pos"], "C4 data_pos differs")
    require(same_rec, f"C4 step-3 metrics differ: {recs[2]} vs "
            f"{s2.history[0]}")
    del s2, sd_a, sd_b
    semi_step_check(semi_solver(d / "f32", "float32"))
    torch.cuda.empty_cache()
    semi_step_check(s, BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)
    times = {"c4_train_step": walls[1:]}
    c4_lstm_times(times, card)
    med = report("phase13", times, card, "ls100_semi, B=64, bf16")
    lab = s._labeled_stream()
    ua, ut = s._unlabeled_streams()
    work = {"c4_train_step_b64": (
        lambda: s.run_step(*s.step_inputs(next(lab)[2], ua, ut)),
        med["c4_train_step"])}
    return med, launches, work


def copy_times(s, card: str) -> None:
    """Host time of one step's input copies: the Solver's (pinned, on its
    side stream) against a plain blocking ``.to(device)`` of the same
    arrays, interleaved, each followed by a synchronize outside the
    timing."""
    import torch

    batch = next(s._labeled_stream())[2]
    arrays = (batch.audio, batch.audio_lens, batch.tokens, batch.real)
    ways = {"pinned, side stream": lambda: s._put(*arrays),
            "plain .to(device)": lambda: tuple(
                torch.as_tensor(a).to(s.device) for a in arrays)}
    times = {k: [] for k in ways}
    for _ in range(10):
        for k in (*ways, *reversed(ways)):
            t0 = time.perf_counter()
            ways[k]()
            times[k].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    log(f"[phase14] a step's input copies ({batch.audio.nbytes / 1e6:.2f} "
        f"MB of audio), host ms, median of 20: " + ", ".join(
            f"{k} {statistics.median(v):.3f}" for k, v in times.items())
        + f" ({card})")


def read_records(workdir: Path) -> list[dict]:
    return [json.loads(line) for line in
            (workdir / "metrics.jsonl").read_text().splitlines()]


def by_prefix(recs: list[dict], prefix: str) -> list[dict]:
    return [r for r in recs if r["prefix"] == prefix]


def phase14(d: Path, card: str) -> dict:
    """The Solver path at timit full width: ``Solver.train`` for 4 steps
    with validation and a checkpoint every 2 (each step's and each
    validation's launches), the same run split at step 2 and resumed by
    ``main --train --resume`` in a fresh process (bitwise equal), the
    retention rule, ``main --test`` with beam 5 and greedy, the checkpoint
    weights against a Recognizer given the same weights (float32), and
    ``transcribe --load-dir`` on the workdir; the card's checkpoint,
    restore, evaluation and start-up times."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import _native, synthetic, weights
    from semi_supervised_asr_tpu_torch import main as M
    from semi_supervised_asr_tpu_torch import train as T
    from semi_supervised_asr_tpu_torch import transcribe as TR
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.data import pipeline as pipe
    from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq
    from semi_supervised_asr_tpu_torch.training.checkpointing import (
        Checkpointer,
    )
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    straight, split = d / "straight", d / "split"
    log(f"[phase14] {CONFIG.name} at full width (enc 256 x (1 + 3) BiLSTM, "
        f"dec 512, bf16, B=32) through the Solver; cuts: {SOLVER_OVERRIDES}")
    s = Solver(load_config(CONFIG, SOLVER_OVERRIDES), straight, DEVICE)
    steps, evals, walls = [], [], []
    counting(s, steps, evals, walls)
    _native.reset_launches()
    t0 = time.perf_counter()
    s.train()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    recs = read_records(straight)
    train = {r["step"]: r for r in by_prefix(recs, "train")}
    dev = by_prefix(recs, "dev")
    require(sorted(train) == [1, 2, 3, 4] and len(steps) == 4,
            f"the Solver logged steps {sorted(train)}")
    for i, step in enumerate(steps):
        r = train[i + 1]
        log(f"[phase14] step {i + 1}: loss {r['loss']:.4f} acc "
            f"{r['acc']:.3f} grad_norm {r['grad_norm']:.4f} frames_per_sec "
            f"{r['frames_per_sec']:.0f}; wall {walls[i]:.1f} ms; kernel "
            f"launches {step}")
        require(all(math.isfinite(r[k]) for k in T.METRIC_KEYS),
                f"step {i + 1}: a metric is not finite")
        require_launches(f"timit Solver step {i + 1}", step,
                         SOLVER_STEP_LAUNCHES)
    n_dev = -(-len(s.bundle.dev) // s.cfg.train.batch_size)
    require(len(evals) == 2, f"{len(evals)} validations, not 2")
    for ev, out in evals:
        require_launches("timit validation", ev, {
            k: n * n_dev for k, n in SOLVER_EVAL_LAUNCHES.items()})
    for r in dev:
        log(f"[phase14] dev at step {r['step']}: dev_error (PER) "
            f"{r['dev_error']:.4f} dev_cap_hit_rate "
            f"{r['dev_cap_hit_rate']:.3f}; eval_wall_s {r['eval_wall_s']:.3f}"
            f" ckpt_wall_s {r['ckpt_wall_s']:.3f} ({card})")
    require(all(launches.get(k, 0) > 0 for k in LSTM_PATH),
            f"a kernel of the Solver path did not launch: {launches}")
    require(s.ckpt.all_steps() == [2, 4],
            f"checkpoints {s.ckpt.all_steps()}, not [2, 4]")
    log(f"[phase14] Solver.train, 4 steps and 2 validations of "
        f"{len(s.bundle.dev)} dev utterances ({n_dev} batch): {run_s:.2f} s;"
        f" kernel launches {launches}")
    # the run's own shapes, kernels against plain: a bf16 step from the
    # trained weights on the Solver's first batch (the dev batch's encode
    # and decode follow with the float32 checks)
    step_check(s, "phase14", BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)
    copy_times(s, card)
    t0 = time.perf_counter()
    s.ckpt.restore(s.state, 4)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0

    # the same run, stopped at step 2 and resumed in a fresh process
    Solver(load_config(CONFIG, [*SOLVER_OVERRIDES, "train.total_steps=2"]),
           split, DEVICE).train()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "semi_supervised_asr_tpu_torch.main",
         "--config", str(CONFIG), "--train", "--resume", "--workdir",
         str(split), "--device", DEVICE, *SOLVER_OVERRIDES],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    resume_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"main --train --resume exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    require("resumed from step 2" in proc.stderr,
            f"the resumed process did not resume: {proc.stderr[-1000:]}")
    sd_a, meta_a, _ = Checkpointer(straight / "checkpoints").load(4)
    sd_b, meta_b, _ = Checkpointer(split / "checkpoints").load(4)
    diff = first_difference(sd_a, sd_b)
    recs_b = read_records(split)
    train_b = {r["step"]: r for r in by_prefix(recs_b, "train")}
    dev_b = {r["step"]: r for r in by_prefix(recs_b, "dev")}
    same_rec = all(train[st][k] == train_b[st][k]
                   for st in (3, 4) for k in T.METRIC_KEYS)
    wall_a = by_prefix(recs, "wall")[0]
    wall_b = [r for r in by_prefix(recs_b, "wall") if r["resumed"]][0]
    log(f"[phase14] main --train --resume in a fresh process ({resume_s:.1f}"
        f" s): step 4's state (parameters, EMA buffer, Adam moments and "
        f"count, generator) "
        f"{'bitwise equal' if diff is None else 'differs first at ' + diff}"
        f"; data_pos {meta_b['data_pos']} vs {meta_a['data_pos']}; step-3/4"
        f" train records equal: {same_rec}; dev_error at 4 "
        f"{dev_b[4]['dev_error']:.4f} vs {dev[-1]['dev_error']:.4f}")
    require(diff is None, f"the resumed run differs from the straight run "
            f"first at {diff}")
    require(meta_a["data_pos"] == meta_b["data_pos"], "data_pos differs")
    require(same_rec, "the step-3/4 train records differ")
    require(dev_b[4]["dev_error"] == dev[-1]["dev_error"],
            "dev_error at step 4 differs")
    del sd_a, sd_b

    # retention: the newest two and the best keep_ckpts (here 1) survive a
    # worse dev_error
    ck = Checkpointer(d / "retention", max_to_keep=1, best_metric="dev_error")
    save_ms = []
    for st, err in ((1, 0.5), (2, 0.4), (3, 0.9), (4, 0.95)):
        t0 = time.perf_counter()
        ck.save(st, s.state, s.data_pos, {"dev_error": err})
        save_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[phase14] retention (keep 1 best + newest 2) after dev_error "
        f"0.5, 0.4, 0.9, 0.95: steps {ck.all_steps()}, best_step "
        f"{ck.best_step()}; save {[round(x, 1) for x in save_ms]} ms")
    require(ck.all_steps() == [2, 3, 4] and ck.best_step() == 2,
            "retention lost the resume anchor or the best checkpoint")

    # main --test, beam 5 and greedy
    tests = {}
    for beam in (5, 1):
        hyp = d / f"hyps_beam{beam}.jsonl"
        buf = io.StringIO()
        _native.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = M.main(["--config", str(CONFIG), "--test", "--load-dir",
                         str(straight), "--beam", str(beam), "--hyp-out",
                         str(hyp), "--device", DEVICE, *SOLVER_OVERRIDES])
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        got = {k: v for k, v in _native.LAUNCHES.items() if v}
        log(f"[phase14] main --test --beam {beam}: {res}; kernel launches "
            f"{got}")
        require(rc == 0 and res["n_utts"] == len(s.bundle.dev)
                and math.isfinite(res["per"]) and "cap_hit_rate" in res,
                f"--test --beam {beam}: {res}")
        require(Path(f"{hyp}.analysis.json").exists(),
                "--hyp-out wrote no analysis")
        require_launches(f"--test --beam {beam}", got, {
            k: n * n_dev for k, n in SOLVER_EVAL_LAUNCHES.items()})
        tests[beam] = res

    # the checkpoint's weights through eval_params against a Recognizer
    # given the same weights, float32
    s32 = Solver(load_config(CONFIG, [*SOLVER_OVERRIDES,
                                      "model.compute_dtype=float32"]),
                 straight, DEVICE)
    batch = next(pipe.epoch_batches(s32.bundle.dev, s32.spec,
                                    s32.cfg.frontend, 32, 0, 0,
                                    drop_remainder=False))
    via_solver = TR.Recognizer(s32.cfg, s32.eval_params(), s32.cmvn,
                               s32.vocab, torch.device(DEVICE))
    # the dev batch through K1 and K2, kernels against plain: the run's
    # bf16 weights (encoder within BF16_TOL) and the checkpoint's in
    # float32 (encoder within K2_TOL, identical tokens below)
    for rec, tol in ((TR.Recognizer(s.cfg, s.state.model, s.cmvn, s.vocab,
                                    torch.device(DEVICE)), BF16_TOL),
                     (via_solver, K2_TOL)):
        ref = TR.Recognizer(rec.cfg, rec.model, s.cmvn, s.vocab,
                            torch.device(DEVICE), backend="reference")
        err, _ = enc_errs(rec, ref, batch.audio, batch.audio_lens)
        log(f"[phase14] {rec.cfg.model.compute_dtype} dev batch (B=32, "
            f"T=400): enc max_abs_err kernels vs plain {err:.3e} (tol "
            f"{tol:g})")
        require(err <= tol, f"dev batch encoder error {err} > {tol}")
    sd, _, best = Checkpointer(straight / "checkpoints").load(
        s32.ckpt.best_step())
    model = Seq2Seq(s32.cfg.model)
    weights.load_flat(model, {k: v.numpy() for k, v in sd["model"].items()})
    direct = TR.Recognizer(s32.cfg, model, s32.cmvn, s32.vocab,
                           torch.device(DEVICE))
    for mode in ("greedy", "beam"):
        tk, _ = via_solver.decode(batch.audio, batch.audio_lens, mode)
        td, _ = direct.decode(batch.audio, batch.audio_lens, mode)
        tr, _ = ref.decode(batch.audio, batch.audio_lens, mode)
        log(f"[phase14] float32 {mode}: eval_params (step {best}) against "
            f"a Recognizer given the same weights: tokens identical "
            f"{bool(np.array_equal(tk, td))}; against the plain versions: "
            f"{bool(np.array_equal(tk, tr))}")
        require(np.array_equal(tk, td), f"float32 {mode} tokens differ")
        require(np.array_equal(tk, tr),
                f"float32 {mode} tokens differ from the plain path")
    del s32, via_solver, direct, model, ref

    # transcribe from the Solver's workdir (phase 4's WAVs, made anew)
    wcfg = load_timit()
    files = synthetic.write_wavs(d, wcfg, TR.build_vocab(wcfg), 8,
                                 min_tokens=5, max_tokens=12,
                                 token_dur_s=0.3)
    _native.reset_launches()
    out = run_cli(["--config", str(CONFIG), "--load-dir", str(straight),
                   "--device", DEVICE, *map(str, files), *SOLVER_OVERRIDES])
    got = {k: v for k, v in _native.LAUNCHES.items() if v}
    log(f"[phase14] transcribe --load-dir (checkpoint step "
        f"{s.ckpt.best_step()}): {len(out)} records, kernel launches {got}; "
        f"first {json.dumps(out[0])[:160]}")
    require(len(out) == len(files) and all(
        isinstance(r["text"], str) and math.isfinite(r["score"])
        for r in out), "transcribe from the checkpoint")
    require(all(got.get(k, 0) > 0 for k in LSTM_PATH[:2]),
            f"transcribe did not launch K1 and K2: {got}")

    fps = statistics.median(train[st]["frames_per_sec"] for st in (2, 3, 4))
    log(f"[phase14] card figures ({card}): ckpt_wall_s "
        f"{[round(r['ckpt_wall_s'], 4) for r in dev]}, restore "
        f"{restore_s:.4f} s (step 4 into the live state), eval_wall_s "
        f"{[round(r['eval_wall_s'], 4) for r in dev]}; startup_wall_s "
        f"{wall_b['startup_wall_s']:.2f} (fresh process, resumed) and "
        f"{wall_a['startup_wall_s']:.2f} (in this process: its age, the "
        f"earlier phases included); "
        f"first_step_wall_s {wall_b['first_step_wall_s']:.3f} (fresh) and "
        f"{wall_a['first_step_wall_s']:.3f} (this process); frames_per_sec "
        f"{fps:.0f} "
        f"(median of steps 2-4); PER beam 5 {tests[5]['per']:.4f}, greedy "
        f"{tests[1]['per']:.4f}; cap_hit_rate beam 5 "
        f"{tests[5]['cap_hit_rate']:.3f}, greedy {tests[1]['cap_hit_rate']:.3f}")
    return launches


def short_solver(cfg, d: Path, steps: int = 3):
    """A Solver of ``cfg`` in the train CLI's short form: ``steps`` steps
    with evaluation off, one checkpoint at the end, weights, batch order
    and draws from seed 0."""
    from semi_supervised_asr_tpu_torch import train as T
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    return Solver(T.short_form(cfg, steps, seed=0), d, DEVICE)


def timit_solver(d: Path, dtype: str):
    from semi_supervised_asr_tpu_torch.config import load_config

    return short_solver(load_config(CONFIG, [
        *TRAIN_OVERRIDES, f"model.compute_dtype={dtype}"]), d)


def first_batch(s):
    """The Solver's first labeled batch and its step's device tensors
    (audio, audio_lens, tokens, real)."""
    batch = next(s._labeled_stream())[2]
    return batch, s.step_inputs(batch)[0]


def phase7(d: Path):
    import torch

    from semi_supervised_asr_tpu_torch import _native

    s = timit_solver(d / "bf16", "bfloat16")
    _native.reset_launches()
    s.train()
    recs = s.history
    for r in recs:
        log(f"[phase7] {r}")
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    log(f"[phase7] train 3 steps, bucket 400, B=32, bf16: losses "
        f"{[r['loss'] for r in recs]}, kernel launches {launches}")
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in recs), "training loss not finite")
    require(all(launches[k] > 0 for k in LSTM_PATH),
            f"a kernel of the training path did not launch: {launches}")
    require(launches["fused_post_fft"] == len(recs),
            f"K1 did not launch once a train step: {launches}")
    require(all(launches[f"lstm_scan_{k}_cluster"] == launches[f"lstm_scan_{k}"]
                for k in ("fwd", "bwd")),
            f"bf16 training ran K2 or K3 off the cluster route: {launches}")

    # one step's loss and gradients, kernels against plain: in bf16 (the
    # cluster route through the autograd Function), then in float32 (the
    # CUDA-core route)
    step_check(s, "phase7", BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)
    step_check(timit_solver(d / "f32", "float32"), "phase7")
    return s, launches, recs


def step_check(s, phase: str, loss_tol: float = 1e-5,
               grad_tol: float = GRAD_TOL) -> None:
    """One step's loss and gradients from the Solver's weights, first
    batch and fixed SpecAugment bands, in its compute dtype: kernels
    against plain, loss within ``loss_tol`` relative and every gradient
    leaf within ``grad_tol`` of the model's largest entry."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.ops import frontend as F
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    batch, tensors = first_batch(s)
    fcfg = s.cfg.frontend
    flens = torch.clamp_max(F.frame_lengths(tensors[1], fcfg),
                            batch.bucket[0])
    bands = F.sample_specaug_params(torch.Generator().manual_seed(5),
                                    flens.shape[0], fcfg.n_mels, flens, fcfg)
    out = {}
    _native.reset_launches()
    for backend in (None, "reference"):
        model = copy.deepcopy(s.state.model)
        state = TS.init_train_state(s.cfg, model, seed=0)
        out[backend] = TS.loss_and_grads(s.cfg, state, *tensors,
                                         s.cmvn_dev, bands, backend)
    routes = {k: v for k, v in _native.LAUNCHES.items()
              if k.startswith("lstm_scan_") and v}
    (lk, _, gk), (lr, _, gr) = out[None], out["reference"]
    rel = abs(lk.item() - lr.item()) / abs(lr.item())
    names = [n for n, _ in s.state.model.named_parameters()]
    errs = dict(zip(names, grad_errs(gk, gr)))
    worst = max(errs, key=errs.get)
    own = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
           for n, a, b in zip(names, gk, gr)}
    own_worst = max(own, key=own.get)
    dtype = s.cfg.model.compute_dtype
    log(f"[{phase}] {dtype} step, kernels vs plain (LSTM launches {routes}): "
        f"loss {lk.item():.6f} vs {lr.item():.6f} (rel {rel:.2e}, tol "
        f"{loss_tol:g}); worst gradient leaf {worst} {errs[worst]:.3e} of "
        f"the model's max |g| over {len(errs)} leaves (tol {grad_tol:g}); "
        f"relative to its own max |g| the worst leaf is {own_worst} "
        f"{own[own_worst]:.3e}")
    require(rel <= loss_tol, f"{dtype} step loss differs: rel {rel}")
    require(errs[worst] <= grad_tol, f"gradient {worst} differs")


def cudnn_lstm(x, w_ih, bias, w_hh, valid):
    """torch.nn.LSTM (cuDNN) holding the layer's weights, bf16 when the
    cell takes it, and its packed input -> (module, packed, dtype)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    b, t, i = x.shape
    h = w_hh.shape[1]
    lstm = torch.nn.LSTM(i, h, batch_first=True, bidirectional=True)
    with torch.no_grad():
        for sfx, dd in (("", 0), ("_reverse", 1)):
            cols = slice(dd * 4 * h, (dd + 1) * 4 * h)
            getattr(lstm, "weight_ih_l0" + sfx).copy_(w_ih[:, cols].t())
            getattr(lstm, "weight_hh_l0" + sfx).copy_(w_hh[dd].t())
            getattr(lstm, "bias_ih_l0" + sfx).copy_(bias[cols])
            getattr(lstm, "bias_hh_l0" + sfx).zero_()
    # packing needs a frame in every row: the zero-length row gets one
    lens = valid.sum(0).clamp_min(1).cpu()
    for dtype in (torch.bfloat16, torch.float32):
        mod = copy.deepcopy(lstm).to(DEVICE, dtype)
        mod.flatten_parameters()        # one weight buffer, as cuDNN wants
        packed = pack_padded_sequence(x.to(dtype).requires_grad_(True), lens,
                                      batch_first=True, enforce_sorted=False)
        try:
            mod(packed)
            return mod, packed, dtype
        except RuntimeError as e:
            log(f"[phase8] cuDNN LSTM refuses {dtype}: {e}")
    raise AssertionError("cuDNN LSTM ran in no dtype")


def port_layer(x, w_ih, bias, w_hh, valid):
    """One BiLSTM layer of the port in bf16 (the input projection as one
    product, then K2; K3, the dW_hh product and the projection's autograd
    backward under autograd), its inputs and weights as leaves -> (forward
    function, leaves)."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    h4 = w_hh.shape[2]
    leaves = [x, w_ih[:, :h4], w_hh[0], bias[:h4], w_ih[:, h4:], w_hh[1],
              bias[h4:]]
    leaves = [a.detach().clone().requires_grad_(True) for a in leaves]
    xg, wif, whf, bf, wib, whb, bb = leaves
    params = {"fwd": {"w_ih": wif, "w_hh": whf, "b": bf},
              "bwd": {"w_ih": wib, "w_hh": whb, "b": bb}}
    lens = valid.sum(0).to(torch.int32)
    return (lambda: K.bilstm_kernel(params, xg, lens, torch.bfloat16),
            leaves)


def weaker(*methods: str) -> str:
    """The method to name a time computed from times of these methods."""
    return max(methods, key=list(METHODS).index)


def backward_ms(fwd, leaves, dy) -> tuple[float, str]:
    """Device ms of a backward pass and the method: (training forward +
    backward) minus the training forward, each on a fresh graph."""
    import torch

    fwd_train, m1 = profiled_ms(fwd, reps=5)
    both, m2 = profiled_ms(lambda: torch.autograd.grad(fwd(), leaves, dy),
                           reps=5)
    return both - fwd_train, weaker(m1, m2)


def rows_times(times: dict, w_hh, valid, acts, cprev, dh_out, gx) -> None:
    """K2 (with residuals) and K3 on timit's cluster size at bucket 400,
    launched straight through their C entries with tiles of 8 rows (the
    plan's CLUSTER_ROWS) and of 16, in turns: device ms (CUDA events over
    back-to-back calls) into ``times``."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    lib, st = _native.lib(), _native.stream_ptr(torch.device(DEVICE))
    d, t, b, h4 = gx.shape
    h = h4 // 4
    for kind in ("fwd", "bwd"):
        plan = K.cluster_plan(kind, h, b, torch.bfloat16)
        w = K.cluster_weights(w_hh, kind, plan)
        if kind == "fwd":
            out = [torch.empty((d, t, b, h), device=DEVICE) for _ in range(3)]
            out.append(torch.empty_like(gx))
            ptrs = (gx.data_ptr(), w.data_ptr(), valid.data_ptr(),
                    *(x.data_ptr() for x in out))
        else:
            ptrs = (w.data_ptr(), valid.data_ptr(), acts.data_ptr(),
                    cprev.data_ptr(), dh_out.data_ptr(),
                    torch.empty_like(acts).data_ptr())
        entry = getattr(lib, f"lstm_scan_{kind}")
        for rows in (8, 16, 8, 16):
            times.setdefault(f"{kind}_rows{rows}_b2b", []).append(
                back_to_back_ms(lambda: _native.check(kind, entry(
                    *ptrs, d, t, b, h, 2, 1, plan.cluster, rows, st)),
                    reps=10))


def phase8(s, card: str) -> dict:
    """Library yardsticks, K2/K3 timings and the train step at bucket 400
    (``s``: phase 7's trained Solver)."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
    from semi_supervised_asr_tpu_torch.ops import recurrent as R
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    times = {}
    bf16 = torch.bfloat16
    # the library yardsticks at layer 0's shape (B=32, T=400, 80 inputs,
    # H=256, both directions): cuDNN's whole layer (torch.nn.LSTM, packed)
    # beside the port's whole layer; never on the port's path.  First in
    # the phase: the profiler can record nothing for a while after the
    # plain K3's trace of ~46k kernels
    x, w_ih, bias, w_hh, valid = k2_inputs(400, 80, 3)
    mod, packed, dtype = cudnn_lstm(x, w_ih, bias, w_hh, valid)
    log(f"[phase8] cuDNN LSTM (torch.nn.LSTM, packed) runs in {dtype}")
    with torch.no_grad():
        record(times, "cudnn_lstm_fwd", profiled_ms(lambda: mod(packed),
                                                    reps=5))
    # backward = (training forward + backward) - training forward, each a
    # fresh graph (device times): dx, dW_ih, dW_hh and the biases
    leaves = [packed.data, *mod.parameters()]
    dy = torch.randn_like(mod(packed)[0].data)
    record(times, "cudnn_lstm_bwd",
           backward_ms(lambda: mod(packed)[0].data, leaves, dy))
    # the port's layer: forward = projection + K2 (no_grad); backward = K3
    # + the dW_hh product + the projection's autograd backward (dx, dW_ih,
    # db), the same difference of two device times
    layer, leaves = port_layer(x, w_ih, bias, w_hh, valid)
    with torch.no_grad():
        record(times, "layer_fwd", profiled_ms(layer, reps=5))
    dy = torch.randn((32, 400, 2 * w_hh.shape[1]), device=DEVICE)
    record(times, "layer_bwd", backward_ms(layer, leaves, dy))
    w_hh, valid, acts, cprev, dh_out = k3_inputs(400, 80, 3, bf16)
    args = (w_hh, valid, acts, cprev, dh_out, bf16, (False, True))
    kernel_times(times, "lstm_scan_bwd", lambda: K.lstm_scan_bwd(*args),
                 lambda: K.lstm_scan_bwd_reference(*args), reps=3)
    with torch.inference_mode():
        gx = (R.mm(x, w_ih, bf16) + bias).view(32, 400, 2, -1)
        gx = gx.permute(2, 1, 0, 3).contiguous()
    rows_times(times, *args[:5], gx)
    # the serial chain's floor of timit's cluster plans: T=400 steps of the
    # exchange and the waits for it alone
    for kind in ("fwd", "bwd"):
        plan = K.cluster_plan(kind, 256, 32, bf16)
        times[f"floor_{kind}_b2b"] = [back_to_back_ms(
            lambda: K.exchange_floor(kind, plan, 2, 400, 32,
                                     torch.device(DEVICE)), reps=20)]
        log(f"[phase8] serial floor of the {kind} plan (C={plan.cluster} "
            f"R={plan.rows}): "
            f"{times[f'floor_{kind}_b2b'][0] / 400 * 1e3:.3f} us a step "
            f"({card})")
    # whole train steps on one batch: kernels vs plain, interleaved
    _, tensors = first_batch(s)
    plain = TS.init_train_state(s.cfg, copy.deepcopy(s.state.model), 0)
    for state, backend in ((plain, "reference"), (s.state, None),
                           (s.state, None), (plain, "reference")):
        key = "train_step" + ("_plain" if backend else "")
        times.setdefault(key, []).extend(host_ms(
            lambda: TS.supervised_step(s.cfg, state, *tensors, s.cmvn_dev,
                                       backend=backend), reps=2))
    med = report("phase8", times, card)
    med["cudnn_dtype"] = str(dtype).split(".")[-1]
    for kind, lib in (("fwd", "cudnn_lstm_fwd"), ("bwd", "cudnn_lstm_bwd")):
        (port, m1), (ref, m2) = pick(med, "layer_" + kind), pick(med, lib)
        log(f"[phase8] layer {kind}: the port {port:.4f} ms ({METHODS[m1][1]})"
            f" against cuDNN {ref:.4f} ms ({METHODS[m2][1]}); ratio "
            f"{port / ref:.3f} ({card})")
    return med


def k5_work(shape: tuple, lens) -> tuple:
    """(bytes, flops) of K5 forward and backward at one [B, T, H, D] bf16
    shape, counting the products these lengths need: every query row
    against the valid keys of its batch row (all T keys for an empty row,
    whose weights are uniform)."""
    b, t, h, d = shape
    f4 = 4
    keys = sum(int(n) if n > 0 else t for n in lens.tolist())
    qkv = b * t * h * d * 2                      # one bf16 [B, T, H, D]
    stats = 2 * b * h * t * f4                   # m and l, f32
    fwd_flops = 4 * h * d * t * keys             # q.k and p.v
    # q, k, v, mask in; o, m, l out
    fwd = (4 * qkv + b * t + stats, fwd_flops)
    # q, k, v, o, dO, mask, m, l in; dq, dk, dv out; s and dP recomputed,
    # then dv, dq, dk: five products where the forward has two
    bwd = (8 * qkv + b * t + stats, fwd_flops * 5 // 2)
    return fwd, bwd


def k5_bounds(shape: tuple, lens) -> dict:
    """K5 forward and backward -> (bound ms, "bytes" or "operations")."""
    return {name: bound_ms(*work) for name, work in
            zip(("flash_mhsa_fwd", "flash_mhsa_bwd"), k5_work(shape, lens))}


def bound_ms(nbytes: float, flops: float) -> tuple:
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOPS * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def lstm_work(t: int, b: int, h: int, d: int = 2) -> tuple:
    """(bytes, flops) of K2 and of K3 at [D, T, B, 4H] with bf16 weights:
    K2 reads gates_x, w_hh and valid and writes h; K3 reads w_hh, valid,
    acts, cprev and dh_out and writes dgates; each step's product is
    2 x 4H x H a row."""
    f4 = 4
    seq = d * t * b
    w = d * h * 4 * h * 2
    flops = 2 * seq * 4 * h * h
    k2 = (seq * 4 * h * f4 + w + t * b * f4 + seq * h * f4, flops)
    k3 = (w + t * b * f4 + seq * 4 * h * f4 + 2 * seq * h * f4
          + seq * 4 * h * f4, flops)
    return k2, k3


def bounds() -> dict:
    """Least time (ms) each kernel could take at its timing shape: the
    larger of its bytes (each input read once, each output written once)
    over HBM bandwidth and its bf16 products over the tensor-core peak, and
    which of the two.  K1-K3 at phases 5 and 8's (bucket 400, B=32, H=256,
    D=2, bf16 weights), K1 also at B=32, T=1600, K2 and K3 also at phase
    13's (ls100_semi: B=64, H=384, T=400 and 1600); K5 at phase 12's
    (B=32, T'=400, 8 heads of 64, bf16), counting the products these
    lengths need: every query row against the valid keys of its batch row
    (all T keys for an empty row, whose weights are uniform)."""
    from semi_supervised_asr_tpu_torch.ops import fused_frontend as FF

    b, t, f4 = 32, 400, 4
    cfg = load_timit()
    fcfg = cfg.frontend
    f, m = fcfg.n_fft // 2 + 1, fcfg.n_mels
    nnz = len(FF._mel_runs_np(fcfg)[0])

    def k1_work(t):
        return (b * t * f * f4 + b * t * m * f4 + nnz * f4 + 3 * m * f4
                + b * f4, 2 * nnz * b * t)

    work = {"fused_post_fft": k1_work(t),
            "fused_post_fft_t1600": k1_work(1600)}
    work["lstm_scan_fwd"], work["lstm_scan_bwd"] = lstm_work(t, b, 256)
    for tt in C4_LSTM_T:
        k2, k3 = lstm_work(tt, 64, 384)
        work[f"lstm_scan_fwd{c4_tag(tt)}"] = k2
        work[f"lstm_scan_bwd{c4_tag(tt)}"] = k3
    lens = k5_inputs(*K5_TIMING, seed=11, odd_rows=False)[3].sum(1)
    work["flash_mhsa_fwd"], work["flash_mhsa_bwd"] = k5_work(K5_TIMING, lens)
    out = {}
    for name, (nbytes, flops) in work.items():
        out[name] = bound_ms(nbytes, flops)
        log(f"[bound] {name}: {nbytes / 1e6:.1f} MB -> "
            f"{nbytes / HBM_BYTES_S * 1e3:.4f} ms, {flops / 1e9:.2f} GFLOP "
            f"-> {flops / BF16_FLOPS * 1e3:.4f} ms")
    return out


def load_timit():
    from semi_supervised_asr_tpu_torch import transcribe as TR

    cfg = TR.load_config(CONFIG)
    return TR.finalize_config(cfg, TR.build_vocab(cfg).size)


def timit_work(results, s, med: dict) -> dict:
    """One beam-5 batch and one train step of the timit path, for
    :func:`profile`."""
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    ker, _ = results["bfloat16"]["rec"]
    audio, lens = results["bfloat16"]["batch"]
    _, tensors = first_batch(s)
    return {
        "beam5_b32_t400": (lambda: ker.decode(audio, lens, "beam"),
                           med["serve_beam5"]),
        "train_step_b32_t400": (lambda: TS.supervised_step(
            s.cfg, s.state, *tensors, s.cmvn_dev), med["train_step"]),
    }


def profile(work: dict, out_dir: Path) -> None:
    """Kernel tables of each piece of ``work`` (name -> (fn, unprofiled
    wall ms)); device busy share against the unprofiled wall time, and the
    largest device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    out_dir.mkdir(parents=True, exist_ok=True)
    for name, (fn, wall_ms) in work.items():
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        (out_dir / f"profile_{name}.txt").write_text(table)
        prof.export_chrome_trace(str(out_dir / f"trace_{name}.json"))
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.device_time_total for e in kernels) / 1e3
        by_name: dict[str, list[float]] = {}
        for e in kernels:
            by_name.setdefault(e.name, []).append(e.device_time_total / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
        log(f"[profile] {name}: {len(kernels)} device kernels and copies, "
            f"{dev_ms:.1f} ms of device time; unprofiled wall "
            f"{wall_ms:.1f} ms, device busy share {dev_ms / wall_ms:.3f}; "
            f"table in {out_dir}")
        for kname, ts in top:
            log(f"[profile] {name}:   {sum(ts):8.2f} ms over {len(ts):5d} "
                f"launches  {kname[:90]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", type=Path, default=None,
                   help="write torch.profiler tables of one beam batch and "
                        "one train step of each path here")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from semi_supervised_asr_tpu_torch import strict_fp32, synthetic
    from semi_supervised_asr_tpu_torch import transcribe as TR

    strict_fp32()
    t0 = time.perf_counter()

    def elapsed(what: str) -> None:
        log(f"[time] {what} done at {time.perf_counter() - t0:.0f} s")

    card = phase0()
    phase1()
    elapsed("phases 0-1 (build)")
    cfg = load_timit()
    vocab = TR.build_vocab(cfg)
    k1_err = phase2(cfg.frontend)
    elapsed("phase 2 (K1 checks)")
    k2_err, k2_bf16 = phase3()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        # eight utterances over buckets 200 and 400
        files = synthetic.write_wavs(d, cfg, vocab, 8, min_tokens=5,
                                     max_tokens=12, token_dur_s=0.3)
        synthetic.write_model_dir(d, cfg, files, seed=0)
        results, serve_launches = phase4(d, files)
    med = phase5(results, cfg.frontend, card)
    elapsed("phases 3-5")
    k3_err, k3_bf16 = phase6()
    with tempfile.TemporaryDirectory() as tmp:
        tr, launches, _ = phase7(Path(tmp))
        med.update(phase8(tr, card))
        if args.profile is not None:
            profile(timit_work(results, tr, med), args.profile)
    del tr
    elapsed("phases 6-8")
    k5 = phase9()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        ccfg = conformer_config([])
        # eight utterances over buckets 400 and 800
        cfiles = synthetic.write_wavs(d, ccfg, TR.build_vocab(ccfg), 8,
                                      min_tokens=8, max_tokens=20,
                                      token_dur_s=0.35)
        synthetic.write_model_dir(d, ccfg, cfiles, seed=0)
        _, conf_serve = phase10(d, cfiles)
        ctr, conf_launches, _ = phase11(d)
        conf_med, conf_work = phase12(ctr, cfiles, card)
        med.update(conf_med)
        if args.profile is not None:
            profile(conf_work, args.profile)
    elapsed("phases 9-12")
    with tempfile.TemporaryDirectory() as tmp:
        c4_med, c4_launches, c4_work = phase13(Path(tmp), card)
        med.update(c4_med)
        if args.profile is not None:
            profile(c4_work, args.profile)
        del c4_work
    elapsed("phase 13")
    with tempfile.TemporaryDirectory() as tmp:
        solver_launches = phase14(Path(tmp), card)
    elapsed("phase 14")
    bound = bounds()
    for kind, name in (("fwd", "lstm_scan_fwd"), ("bwd", "lstm_scan_bwd")):
        log(f"[summary] {name} at bucket 400, B=32, H=256, D=2, bf16: "
            f"{med[name + '_b2b']:.4f} ms device (back to back), "
            f"{med[name + '_call']:.4f} ms call; "
            f"serial floor x T=400 {med['floor_' + kind + '_b2b']:.4f} ms; "
            f"bytes "
            f"bound {bound[name][0]:.4f} ms; plain "
            f"{pick(med, name + '_plain')[0]:.3f} ms; the port's layer "
            f"{pick(med, 'layer_' + kind)[0]:.4f} ms against cuDNN's "
            f"{pick(med, 'cudnn_lstm_' + kind)[0]:.4f} ms ({card})")
        for t in C4_LSTM_T:
            key = name + c4_tag(t)
            ms, (bms, by) = med[key + "_b2b"], bound[key]
            log(f"[summary] {name} at ls100_semi's B=64, T={t}, H=384, D=2, "
                f"bf16: {ms:.4f} ms device (back to back), "
                f"{ms / t * 1e3:.2f} us a step; bound {bms:.4f} ms ({by}), "
                f"share {bms / ms:.3f}; plain {med[key + '_plain_call']:.1f}"
                f" ms a call ({card})")
    for t, tag in ((400, "fused_post_fft"), (1600, "fused_post_fft_t1600")):
        mm = "mel_matmul" + tag[len("fused_post_fft"):]
        (cold, how), (warm, _) = pick(med, tag), pick(med, tag + "_warm")
        log(f"[summary] fused_post_fft at B=32, T={t}: {cold:.4f} ms "
            f"device L2-cold, {warm:.4f} ms L2-warm ({METHODS[how][1]}), "
            f"{med[tag + '_call']:.4f} ms call; bytes bound "
            f"{bound[tag][0]:.4f} ms (share {bound[tag][0] / cold:.3f} "
            f"cold); plain {pick(med, tag + '_plain')[0]:.4f} ms device, "
            f"{med[tag + '_plain_call']:.4f} ms call; torch.matmul(pspec, fb)"
            f" alone (not the same function) {pick(med, mm)[0]:.4f} ms cold, "
            f"{pick(med, mm + '_warm')[0]:.4f} ms warm ({card})")
    log(f"[summary] card: {card}; K2 bf16 max_abs_err {k2_bf16:.3e}, K3 "
        f"{k3_bf16:.3e}; "
        f"bf16 token agreement {results['bfloat16']['agree']}; serving "
        f"launches {serve_launches}; training launches {launches}; train "
        f"step {med['train_step']:.1f} ms on kernels vs "
        f"{med['train_step_plain']:.1f} ms plain; conformer serving "
        f"launches {conf_serve}, training launches {conf_launches}; "
        f"conformer train step {med['conformer_train_step']:.1f} ms on "
        f"kernels vs {med['conformer_train_step_plain']:.1f} ms plain; K5 "
        f"worst errors {k5}; C4 launches over the Solver's 3 steps and "
        f"validation {c4_launches}, C4 step {med['c4_train_step']:.1f} ms "
        f"wall (median of steps 2-3); timit Solver run (4 steps, 2 "
        f"validations) launches {solver_launches}")
    src = "semi_supervised_asr_tpu_torch/csrc/"
    tpu = "semi_supervised_asr_tpu/ops/"
    jax_fa = ("jax/experimental/pallas/ops/tpu/flash_attention.py:{} "
              "(jax 0.9.0), reached from " + tpu + "flash_mhsa.py:123")
    cudnn = (f"cuDNN LSTM (torch.nn.LSTM, packed, {med['cudnn_dtype']}), "
             "the whole layer at bucket 400: ")
    lstm_design = ("bf16: clusters of C blocks, the weight slice resident in "
                   "shared memory, {} through distributed shared memory, "
                   "mma.sync; f32: CUDA cores")
    # launches: K1-K3 from the timit Solver run (phase 14: 4 steps and 2
    # validations), K5 from the conformer training run (phase 11), and by
    # path in launches_by_path;
    # max_abs_err: the route the main path runs (bf16 cluster route for
    # K2/K3, f32 for K1 and K5's table)
    paths = {"timit_serve": serve_launches, "timit_train": launches,
             "conformer_serve": conf_serve, "conformer_train": conf_launches,
             "c4_solver": c4_launches, "timit_solver": solver_launches}
    rows = (
        ("fused_post_fft", "fused_post_fft.cu", tpu + "pallas_frontend.py:50",
         k1_err, None, solver_launches,
         "persistent grid, tiles of rows by cp.async.bulk through an "
         "mbarrier ring, one producer warp; CUDA cores; ms L2-cold at "
         "B=32 T=400", None),
        ("lstm_scan_fwd", "lstm_scan_fwd.cu", tpu + "pallas_lstm.py:41",
         k2_bf16, "cudnn_lstm_fwd", solver_launches, lstm_design.format("h"),
         cudnn + "forward (input projection + recurrence) against the "
         f"port's layer forward (projection + K2) at "
         f"{pick(med, 'layer_fwd')[0]:.4f} ms; f32 route max_abs_err "
         f"{k2_err:.3e}"),
        ("lstm_scan_bwd", "lstm_scan_bwd.cu", tpu + "pallas_lstm.py:85",
         k3_bf16, "cudnn_lstm_bwd", solver_launches,
         lstm_design.format("dgates"),
         cudnn + "backward (dx, dW_ih, dW_hh, biases; training forward + "
         "backward minus training forward) against the port's layer "
         "backward (K3 + the dW_hh product + the projection's autograd "
         f"backward) at {pick(med, 'layer_bwd')[0]:.4f} ms; f32 route "
         f"max_abs_err {k3_err:.3e}"),
        ("flash_mhsa_fwd", "flash_mhsa_fwd.cu", jax_fa.format(331),
         k5["float32"], "sdpa_fwd", conf_launches,
         "bf16: wgmma + TMA ring; f32: CUDA cores",
         "scaled_dot_product_attention with the boolean key mask"),
        ("flash_mhsa_bwd", "flash_mhsa_bwd.cu", jax_fa.format("796 and :1146"),
         k5["float32_grad_abs"], "sdpa_bwd", conf_launches,
         "bf16: wgmma + TMA ring; f32: CUDA cores",
         "scaled_dot_product_attention backward with the boolean key mask "
         "(forward + backward minus forward, as the kernel's)"),
    )

    def entry(name, cu, tpu_src, err, lib, runs, design, vs):
        ms, method = pick(med, name)
        plain, plain_method = pick(med, name + "_plain")
        lib_ms, lib_method = pick(med, lib) if lib else (None, None)
        out = {"name": name, "route": "cuda", "source": src + cu,
               "replaces": tpu_src, "launches": runs[name],
               "max_abs_err": err, "ms": ms, "method": METHODS[method][1],
               "plain_ms": plain, "plain_method": METHODS[plain_method][1],
               "bound_ms": bound[name][0], "bound_by": bound[name][1],
               "library_ms": lib_ms,
               "library_method": lib_method and METHODS[lib_method][1],
               "design": design, "library_vs": vs,
               "launches_by_path": {p: n.get(name, 0)
                                    for p, n in paths.items()}}
        if name.startswith("lstm_scan"):
            out["at_c4"] = [
                {"shape": f"B=64 T={t} H=384 D=2 bf16",
                 "ms": med[name + c4_tag(t) + "_b2b"],
                 "method": METHODS["b2b"][1],
                 "plain_call_ms": med[name + c4_tag(t) + "_plain_call"],
                 "bound_ms": bound[name + c4_tag(t)][0],
                 "bound_by": bound[name + c4_tag(t)][1]}
                for t in C4_LSTM_T]
        return out

    print(json.dumps({"kernels": [entry(*row) for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
