#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --k2-bits ROOT JSON   # stateless K2's bits, ROOT's
                                                # package against JSON's
    python3 chip_smoke.py --export-depth N      # phase 23's ls100_semi
                                                # program at depth N alone

Run from the root of a checkout.  It imports nothing of JAX and fails
(non-zero exit, no result line) when CUDA is unavailable.  Phases; any
failure raises and the script exits non-zero:

0. the card (``nvidia-smi`` name and power limit) and the toolchain;
1. build the CUDA kernels from ``semi_supervised_asr_tpu_torch/csrc``,
   with ptxas's registers and spills of the bf16 instances of K5 and of
   the LSTM cluster, grid and float32 grid routes (and their
   exchange-floor probes), ``cudaOccupancyMaxActiveClusters`` of each
   K2/K3 cluster plan at B=32, H=256/384/512 (timit's must all be
   resident at once), and the grid plans' co-residency at H=768 for D=1,
   B=64 and D=2, B=32 and the float32 grid plans' at the LM's D=1, B=64,
   H=1024 and the fusion listener's D=2, B=64, H=384 (every block
   resident at once);
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
   <= 1e-5 in float32 (the float32 grid route, and the CUDA-core route
   forced), <= BF16_TOL in bfloat16 (the cluster route); then the cluster
   route at H=256, 384 and 512, B=32 and 5, T=1 and 37, D=2 and D=1
   reverse, each with a zero-length row; the grid route at H=640, 768 and
   1024, B=64, 5 and 1, T=1, 37 and 400, D=1 and D=2 with the second
   direction reversed; the float32 grid at the LM's H=1024 (D=1) and the
   fusion listener's H=384 (D=2, the second reversed), B=64, 5 and 1,
   T=1, 37 and 256, within K2_TOL; on both grids each call twice and
   bitwise equal; every call's route is checked by its launch count; a
   grid plan the card cannot hold must raise (cudaError 720) before any
   launch;
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
   cluster and grid routes at phase 3's shapes;
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
    (synthetic corpus, bucket 1600 so that T'=400, B=32, bf16, the
    recipe's SortaGrad epoch, background checkpoint saves and encoder
    dropout 0.1, all as shipped): 3 steps,
    finite losses, K1 once a step, both K5 launch counts > 0; the same run
    stopped at step 2 and resumed must give step 3's state bitwise (the
    conv stem has no atomics in its backward); then one float32 step on
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
    the clean view, the teacher's encoder output (K2_TOL in float32,
    BF16_TOL in bf16) and hypotheses, then the loss and every
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
    the run's frames per second;
15. the data-parallel recipe ``configs/ls960_dp.yaml`` (C5) at full width
    and depth (enc 512 x (1 + 3) BiLSTM, dec 1024 x 2, bf16,
    ``remat_encoder``, ``bf16_weight_stream``, ``sortagrad_epochs`` 1,
    ``async_ckpt``; synthetic corpus, B=32 a rank): (a) ``main --train``
    under torchrun over NCCL at world size 1, 3 steps with a background
    checkpoint at step 2 and the final validation, each step's metrics,
    wall time and launches by route (K1 1, K2 8 -- 4 and 4 recomputed --
    and K3 4 a step, K1 1 and K2 4 a dev batch), the gradient
    all-reduce's bytes and device time; then ``main --train --resume``
    of step 2 in a fresh process and workdir: step 3's state bitwise;
    (b) two ranks sharing the card over gloo, 16 rows each of a global
    32: a float32 step against one process on the 32 rows (loss 1e-5
    relative, every reduced gradient leaf within GRAD_TOL, the ranks'
    gradients bitwise equal), 2 bf16 steps after which the replicas'
    parameters are bitwise equal, and the rank-sharded validation's error
    counts equal to one process's; (c) one step each, kernels only: remat
    on against off (the phase-7 bf16 bounds; K2 8 launches against 4) and
    the bf16 weight stream on against off (the reference's bound), then
    the step kernels against plain; the K2 / K3 launch plans at H=512
    for B=32 and 16;
16. the recipes' regularization, augmentation and BPE units: (a)
    ``configs/ls100_bpe.yaml`` as shipped (enc 384 x (1 + 3) BiLSTM, dec
    768, embed 384, bf16, B=64, SpecAugment with time warp W=80) with a
    BPE model trained in the phase over the synthetic corpus's text (the
    recipe asks 1000 pieces; the size reached is logged), through the
    Solver: 3 steps with a checkpoint each, each step's launches (K1 1, K2
    4 and K3 4, the cluster route), ``test`` beam 5 on the mean of the 3
    checkpoints (``decode.average_ckpts``), one bf16 step kernels against
    plain; (b) one bf16 step with speed perturbation, noise and decoder
    dropout, kernels against plain with the same draws, and
    ``train.grad_accum=2`` against one full step on equal-length rows in
    float32 (loss 1e-5, GRAD_TOL) with both steps' peak memory; (d)
    ``configs/ls960_transformer.yaml`` at full width with the flash route:
    ``main --train`` for 2 steps and the final validation, then remat on
    (as shipped) against off with encoder dropout 0.1 and the
    same masks, gradients bitwise equal, K5 forward 24 against 12
    launches; the step's wall time each way and the device time of a
    conformer step's dropout masks.  Phase 11 runs (c), ls960_conformer
    with its dropout.
17. the CTC family, the transformer speller and the joint CTC head: (a)
    ``configs/ls100_ctc.yaml`` as shipped (enc 384 x (1 + 2) BiLSTM,
    bf16, remat, B=64) through the Solver: 3 steps with their launches
    (K1 1, K2 6, K3 3, the cluster route), step 2's checkpoint resumed
    in a fresh workdir to step 3 bitwise, the same step twice bitwise
    (the CTC loss's backward has no atomic sums), a bf16 step kernels
    against plain, ``test`` by best path and by the prefix beam of 8;
    the step and the CTC loss alone at the 1600-frame bucket; (b)
    ``configs/ls960_aed.yaml`` at full width (one chip's batch of 32):
    ``main --train`` for 3 steps (K1 launched, K5 not), the teacher
    pass's operator count at U=64 and 128 (equal), greedy and beam 5 on
    one dev batch with their peak memory and KV-cache bytes, the beam's
    cache reorder, and the KV write by index against the reference's
    one-hot write (equal logits); (c) timit with
    ``objective.lambda_ctc=0.3``: a step, beam 5 with
    ``decode.ctc_weight=0.3`` rescoring and one-pass, ``main --test
    --beam 0``.
18. the transducer family: (a) ``configs/ls100_transducer.yaml`` as
    shipped (enc 384 x (1 + 3) BiLSTM, pred 512, joint 512, embed 256,
    bf16, remat, B=64) through the Solver: 3 steps with their launches
    (K1 1, K2 9, K3 5: the listener's 4, again under remat, and the
    predictor's), the greedy validation (K1 1, K2 4 a dev batch), step 2's
    checkpoint resumed in a fresh workdir to step 3 bitwise, the same step
    twice bitwise (the lattice loss's backward has no atomic sums), a
    bf16 and a float32 step kernels against plain, ``test`` greedy and
    beam 4; a step at the 1600-frame / 256-token bucket (T' = 200, U + 1
    = 257) with its peak memory and the lattice loss's share; (b)
    ``configs/ls100_transducer_semi.yaml``: 3 steps (K1 3, K2 19, K3 11),
    the gate open from step 2, a bf16 and a float32 step kernels against
    plain (the teacher's encoder output and hypotheses, loss, gradients,
    EMA buffer), ``test`` beam
    4 and the
    4-best of a dev batch; (c) ``configs/ls100_transducer_streaming.yaml``
    offline: 2 steps (the forward-only listener's K2 and K3 on the grid
    route, the predictor's on the cluster route), the validation, ``test``
    beam 4, a bf16 step kernels against plain, the same step twice
    bitwise, the step with the listener on the CUDA-core route against the
    grid route (in turns); K2 and K3 at D=1, B=64: H=768 at T=1600 and
    200 (ragged rows) and H=512 at T=257, against their plain versions,
    then timed with every step valid beside cuDNN's one-direction layer,
    with the grid route's serial floor (the barrier alone, and with the
    exchange's read) and its plans timed in turns.
19. exact chunked streaming (``decode/streaming.py``): (a)
    ``configs/ls100_conformer_streaming.yaml`` as shipped (chunk-causal
    conformer, d_model 256 x 12 blocks, chunks of 16 with 2 left, a causal
    2 x 32 stem, pred 512, joint 512, bf16, no remat, B=64) through the
    Solver: 3 steps at the 448-frame bucket (K1 1, the predictor's K2 1
    and K3 1), the greedy validation, a bf16 step kernels against plain
    (the phase-7 bounds), the same step twice bitwise, ``test`` beam 4 on
    the chunked encoder, a step at 1600 / 256 with its peak memory; its
    float32 and bf16 models streamed in 640 ms pieces: greedy and beam 4
    tokens equal to the offline decode's on the card in float32 (the bf16
    share logged), a single stream's ms a chunk, real-time factor and K1 /
    K2 launches a chunk, a 16-slot ``MultiStreamTranscriber`` fed
    staggered equal to single streams (float32) and its round's ms (bf16);
    (b) ``configs/ls100_transducer_streaming.yaml`` as shipped (forward-only
    768 x (1 + 3), pred 512, joint 512): the listener's 320 ms chunk
    outputs at B=1 and 16 on K2 (the grid route in bf16, within BF16_TOL of
    the plain scan; the float32 grid in float32, within K2_TOL of it and
    within 1e-5 of the offline listener, bitwise equality logged), then
    the same streaming checks as (a) in 320 ms pieces.  Phase 3 holds K2
    started from a carried (h, c) against its plain version on each route
    (the CUDA cores, the cluster, the grid and the float32 grid route), and
    a scan split in two against the whole: outputs and final state bitwise
    equal.
20. MWER, the CTC family's pseudo-labels and token timestamps: (a) the
    MWER step (``objective.lambda_mwer`` 0.3, ``mwer_beam`` 4, no warmup)
    of ``configs/ls100.yaml`` (LAS), ``ls100_ctc`` and ``ls100_transducer``
    as shipped (bf16, B=64, one batch at 400 / 128; ls100 after one CE
    step):
    its ms against the same step without the term (in turns), peak
    memory, launches (the supervised pass's; the transducer's predictor
    once more over the B*K n-best: K1 1, K2 10, K3 6), the step twice
    bitwise; kernels against plain in float32 (the encoder output within
    K2_TOL, the share of rows whose 4-best are equal, the step on the
    kernels' n-best within 1e-5 / GRAD_TOL) and in bf16 (the encoder
    output within BF16_TOL, the 4-best share logged); the transducer's
    MWER step at 1600 / 256 with ``model.joint_chunk_frames=8`` for its
    peak; K2 and K3 at the MWER predictor's shape (D=1, B=256, H=512,
    T=129) against plain, timed beside cuDNN's layer; (b) ``main --train
    --resume`` of (a)'s ls100 checkpoint with MWER for 3 steps, ``mwer``
    and ``mwer_risk`` read back from metrics.jsonl; (c) ``ls100_ctc`` with
    ``objective.lambda_pseudo``: a Solver step (K1 3, K2 12, K3 6) and the
    bf16 semi step kernels against plain (the teacher's encoder output
    within BF16_TOL); (d) ``transcribe --timestamps`` on ``ls100_ctc``,
    timit with its joint-CTC head and ``ls100_transducer`` (greedy) in
    float32 at full width, kernels against plain (texts, starts and ends
    equal), ``align.py`` on a manifest with one entry too long for its
    audio (exit 0, that one failed), and both streaming recipes streamed
    with ``track_frames`` (emission frames equal to the offline greedy
    walk's);
21. the external LM and LM fusion: (a) the LM trainer at
    ``configs/ls100_semi.yaml``'s ``lm`` block (LSTM, embed 256, hidden
    1024, 1 layer, B=64, the 256-token bucket, float32) through
    ``lm_trainer.train_lm`` for 3 steps (K2 1 and K3 1 a step, on the
    float32 grid route), its float32 step kernels against plain (loss 1e-5
    relative, gradients GRAD_TOL), K2 / K3 at that shape (D=1, B=64,
    H=1024, T=256) and at the fusion listener's first layer (D=2, B=64,
    H=384, T=400) against plain, then timed on the float32 grid and forced
    onto the CUDA cores in turns, with the grid's serial floor, beside
    cuDNN's float32 layer and the bound, the same two routes in turns at
    H=128, 192 and 256 (D=2, B=32, T=400: the float32 grid's threshold),
    and a step of the transformer LM (d_model 256, 1 block of 4 heads, ff
    512); (b) shallow fusion of that LM at float32 into one padded
    batch of ``ls100_semi`` (beam 5), ``ls100_ctc`` (prefix beam 8) and
    ``ls100_transducer`` (beam 4, ``ilm_weight`` 0.2) through
    ``Recognizer`` (the LM loaded by ``decode.lm_ckpt``), tokens kernels
    against plain identical, host ms with and without the LM in turns;
    ``ls100_transducer_streaming``'s beam with the LM (``ilm_weight``
    0.3) streamed against offline (tokens and scores equal); (c) cold and deep fusion on ``configs/ls100.yaml``
    in float32 with the LM grafted at startup through the Solver (2 steps,
    K2 4 and K3 4 a step on the float32 grid, the frozen LM bitwise
    unchanged after them, a step kernels against plain, the step with the
    listener forced onto the CUDA cores against the float32 grid in
    turns).
22. BEST-RQ pretraining, its transfer and a self-training round: (a) the
    pretraining CLI (``training/pretrain.py``) of ``configs/ls100_semi.yaml``
    at full width (enc 384 x (1 + 3) BiLSTM, bf16, B=64) in a fresh
    process on the synthetic corpus's unlabeled audio in the 400-frame
    bucket, 4 steps with a resume save every 2: each step's launches (K1
    1, K2 4, K3 4, the cluster route), host ms and peak memory, every
    logged metric finite; (b) the same command to 2 steps, then again to
    4 in fresh processes: the parameters and Adam state bitwise equal to
    (a)'s; (c) one pretraining step kernels against plain with the
    targets (from K1's features) and the draws fixed, float32 (1e-5 /
    GRAD_TOL) and bf16 (the phase-7 bounds), and the share of targets that
    K1's features and the plain ones agree on; (d) ls100_semi's Solver
    (phase 13's cuts) from (a)'s encoder with ``train.freeze=[listener]``,
    2 steps: the listener and its EMA copy equal to the file before step
    1, the listener bitwise unchanged after, the speller moved, K3 still
    launched for the frozen listener; (e) ``configs/ls960_conformer.yaml``
    with the flash route pretrained at B=32 (cut from 256), bucket 400, 3
    steps: K5's launches, a finite loss, host ms and peak memory; (f)
    ``selftrain.py`` from a 1-step timit Solver workdir over 8 synthetic
    WAVs with ``--keep-frac 0.5 --union``: the output read back as a
    training manifest, K1 / K2 launched.
23. contextual biasing and the serving export: (a) one padded batch at
    bucket 400 in float32, biased by a phrase file of the vocabulary's
    labels at bonus 3, through ``Recognizer`` (``decode.bias_phrases``):
    ``ls100_semi`` beam 5, ``ls100_ctc`` prefix beam 8 and its biased
    best-path walk, ``ls100_transducer`` beam 4 and its biased greedy
    walk, kernels against plain (identical tokens, scores 1e-4 relative,
    the launches, one warm call's host ms biased and unbiased, the share
    of rows the bias changed, which must be > 0);
    ``ls100_transducer_streaming`` greedy and beam 4 biased, streamed
    against offline (tokens and scores equal); (b) ``export.py`` on the
    card, in bfloat16 as the recipes ship: ``ls100_semi``'s biased beam 5
    (on (a)'s model directory; K2's bf16 cluster route) and
    ``ls960_conformer``'s flash greedy (cut to 1 of its 16 blocks; K5f's
    bf16 route), both at B=8, 400 frames and ``decode.max_decode_len``
    cut to 8 (the export unrolls every step), and
    ``ls100_transducer_streaming``'s biased beam-4 streaming bundle (K2's
    bf16 grid route); each saved, loaded and run in a fresh process that
    imports torch and the op module only, beside the next export (the
    last beside (a)'s streams): the graphs hold the ``ssasr_torch`` ops,
    the fresh processes launch K1, K2 and K5's forward on those routes,
    tokens equal to the live decode on the kernels in the same dtype and
    scores within 1e-6; export, save, load and call times and the bytes;
    the phase's time against its 90 s budget.  ``--export-depth N`` runs
    the float32 ``ls100_semi`` program at depth N alone (the export time
    and size at the shipped 256).

The line before the last is the kernel table as JSON (with each kernel's
bound, library time and what that library call computes, how each time
was taken, and its design; launches from the timit Solver run (phase 14)
for K1-K3, from the conformer training run for K5, and per path in
``launches_by_path``, the C5 run as ``c5_dp``, phase 19's training run as
``conformer_streaming_train``, phase 20's as ``mwer_*``,
``ctc_pseudo``, ``timestamps_*``, ``align`` and ``stream_timestamps_*``,
phase 21's as ``lm_trainer``, ``fusion_*`` and ``{cold,deep}_fusion``,
phase 22's as ``bestrq_pretrain``, ``bestrq_finetune_frozen``,
``bestrq_conformer`` and ``selftrain``;
K2 and K3 also at the C4 shapes in ``at_c4``, at phase 18's in
``at_transducer``, at the MWER predictor's in ``at_mwer_predictor`` and at
the LM's in ``at_lm``; the float32 grid's kernels of K2 and K3, each its
own ``__global__`` function, as the rows ``lstm_scan_{fwd,bwd}_grid_f32``:
their times at the LM's shape with launches from the LM trainer's run,
and at the fusion listener's in ``at_fusion_listener``);
the
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
import os
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
# (T' = 400 after the 4x stem), with the recipe's SortaGrad epoch,
# background checkpoint saves and encoder dropout 0.1
CONFORMER_TRAIN = ["data.num_synthetic_utts=64", "data.frame_buckets=[1600]"]
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


# the data-parallel path (C5, phase 15): configs/ls960_dp.yaml as shipped
# (enc 512 x (1 + 3) BiLSTM, dec 1024 x 2, bf16, remat_encoder,
# bf16_weight_stream, sortagrad_epochs 1, async_ckpt) but for its data
# section and the run's length: the synthetic corpus of 160 utterances,
# which all land in the 400-frame bucket of [400, 800] (the corpus's
# longest utterance is 1.2 s) and the 128-token bucket, a dev set of 40
# (two batches of 32); a global batch of 32 (32 rows on one rank, 16 on
# each of two), 3 steps, a checkpoint at step 2 and the final validation
# at step 3
C5_CONFIG = ROOT / "configs" / "ls960_dp.yaml"
C5_DATA = ["data.dataset=synthetic", "data.num_synthetic_utts=160",
           "data.frame_buckets=[400,800]"]
C5_RUN = ["train.batch_size=32", "train.total_steps=3", "train.ckpt_every=2",
          "train.eval_every=0", "train.log_every=1"]
C5_DEV = 40
# a C5 step under remat: K1 once, K2 once a layer forward and once again
# in the backward's recomputation, K3 once a layer
C5_STEP_LAUNCHES = {"fused_post_fft": 1, "lstm_scan_fwd": 8,
                    "lstm_scan_bwd": 4}


# phase 16: the recipes' regularization, augmentation and BPE units.
# (a) configs/ls100_bpe.yaml as shipped (enc 384 x (1 + 3) BiLSTM, dec 768,
# embed 384, bf16, B=64, SpecAugment with time warp W=80) but for its data
# and the run's length: the synthetic corpus of 64 utterances (all in the
# 400-frame / 48-token bucket: one batch of 64 an epoch), a BPE model
# trained in the phase over the corpus's text (the recipe asks 1000
# pieces), 3 steps with a checkpoint after each, so that --test averages
# the 3 (decode.average_ckpts)
BPE_CONFIG = ROOT / "configs" / "ls100_bpe.yaml"
BPE_DATA = ["data.dataset=synthetic", "data.num_synthetic_utts=64"]
BPE_RUN = ["train.total_steps=3", "train.ckpt_every=1",
           "train.eval_every=0", "train.log_every=1"]
BPE_PIECES = 1000
# (b) the options no shipped config sets, one step at (a)'s width
UNSHIPPED = {"speed_perturb": (0.9, 1.0, 1.1), "noise_aug_prob": 0.5}
# (d) configs/ls960_transformer.yaml (remat_encoder, enc_dropout 0.1) at
# full width (12 blocks of d_model 512) with the flash attention route, as
# the conformer path runs; synthetic data, one batch of 32 in the
# 1600-frame bucket (T' = 400)
TRANSFORMER_CONFIG = ROOT / "configs" / "ls960_transformer.yaml"
TRANSFORMER_OVERRIDES = ["model.attn_backend=flash", "data.dataset=synthetic",
                         "train.batch_size=32", "data.num_synthetic_utts=32",
                         "data.frame_buckets=[1600]"]


# phase 17: (a) configs/ls100_ctc.yaml as shipped (enc 384 x (1 + 2)
# BiLSTM, 4x reduction, bf16, remat_encoder, B=64) but for its data and the
# run's length: the synthetic corpus of 64 utterances (at most 10
# characters in 1.2 s, so T' >= 25 frames hold the 2U + 1 = 21 a CTC path
# needs), all in one 400-frame / 128-token batch of 64, 3 steps with a
# checkpoint at step 2; then the same corpus in the 1600-frame bucket
# (T' = 400) for the step's and the CTC loss's time
CTC_CONFIG = ROOT / "configs" / "ls100_ctc.yaml"
CTC_DATA = ["data.dataset=synthetic", "data.num_synthetic_utts=64"]
CTC_RUN = ["data.frame_buckets=[400]", "train.total_steps=3",
           "train.ckpt_every=2", "train.eval_every=0", "train.log_every=1"]
# an ls100_ctc step under remat: K1 once, K2 once a layer and again in the
# backward's recomputation, K3 once a layer; a validation batch K1 once and
# K2 once a layer
CTC_STEP_LAUNCHES = {"fused_post_fft": 1, "lstm_scan_fwd": 6,
                     "lstm_scan_bwd": 3}
CTC_EVAL_LAUNCHES = {"fused_post_fft": 1, "lstm_scan_fwd": 3}
# (b) configs/ls960_aed.yaml at full width (12 encoder blocks and 6 decoder
# blocks of 512, dec_max_len 512, tied embedding, bf16, enc and dec dropout
# 0.1) but for its data and batch: one chip's batch of 32 (the recipe's 256
# is global over a mesh), the synthetic corpus of 32 in one 800-frame /
# 128-token bucket, 3 steps through main --train
AED_CONFIG = ROOT / "configs" / "ls960_aed.yaml"
AED_OVERRIDES = ["data.dataset=synthetic", "data.num_synthetic_utts=32",
                 "train.batch_size=32", "data.frame_buckets=[800]",
                 "data.token_buckets=[128]"]
AED_RUN = ["train.total_steps=3", "train.eval_every=0", "train.log_every=1"]


# phase 18: the transducer family.  (a) configs/ls100_transducer.yaml as
# shipped (enc 384 x (1 + 3) BiLSTM, pred 512 x 1, joint 512, embed 256,
# bf16, remat_encoder, B=64, char units) but for its data and the run's
# length: the synthetic corpus of 64 utterances, all in one 400-frame /
# 128-token batch of 64, 3 steps with a checkpoint at step 2 and the final
# greedy validation; then the same corpus padded to the 1600-frame /
# 256-token bucket (T' = 200, U + 1 = 257) for the step's time and memory
TD_CONFIG = ROOT / "configs" / "ls100_transducer.yaml"
TD_DATA = ["data.dataset=synthetic", "data.num_synthetic_utts=64"]
TD_RUN = ["data.frame_buckets=[400]", "train.total_steps=3",
          "train.ckpt_every=2", "train.eval_every=0", "train.log_every=1"]
# a transducer step under remat: K1 once; K2 once a listener layer, again
# in the backward's recomputation, and once for the predictor; K3 once a
# listener layer and once for the predictor.  A validation batch: K1 once
# and K2 once a listener layer (the greedy walk steps the predictor with
# the plain cell)
TD_STEP_LAUNCHES = {"fused_post_fft": 1, "lstm_scan_fwd": 9,
                    "lstm_scan_bwd": 5}
TD_EVAL_LAUNCHES = {"fused_post_fft": 1, "lstm_scan_fwd": 4}
# (b) configs/ls100_transducer_semi.yaml: labeled, unlabeled-audio and
# unlabeled-text batches of 64 from the same corpus, 3 steps with a
# checkpoint at step 2 and the final validation; the one cut beside the
# data and the run's length is the pseudo-label gate opened after one
# step.  The labeled stream lands in the 400-frame / 128-token bucket, the
# unlabeled streams in 1600 / 256 (T' = 200, pseudo-labels capped at the
# labeled bucket's 128).  A step: K1
# for the labeled, the clean and the augmented view; K2 9 as (a), 1 for
# the internal LM's predictor on the text, 4 for the teacher's clean
# encode, 4 + 1 for the student on the augmented view; K3 5 as (a), 1 for
# the internal LM, 4 + 1 for the student
TD_SEMI_CONFIG = ROOT / "configs" / "ls100_transducer_semi.yaml"
TD_SEMI_RUN = ["train.total_steps=3", "train.ckpt_every=2",
               "train.eval_every=0", "train.log_every=1",
               "objective.pseudo_warmup_steps=1"]
TD_SEMI_LAUNCHES = {"fused_post_fft": 3, "lstm_scan_fwd": 19,
                    "lstm_scan_bwd": 11}
# (c) configs/ls100_transducer_streaming.yaml offline (forward-only
# listener of 768, VALID framing), 2 steps at the 400-frame bucket and
# the final validation: the listener's K2 and K3 run on the grid route
# (H=768 is above CLUSTER_MAX_HIDDEN), the predictor's on the cluster
# route
TD_STREAM_CONFIG = ROOT / "configs" / "ls100_transducer_streaming.yaml"
TD_STREAM_RUN = ["data.frame_buckets=[400]", "train.total_steps=2",
                 "train.ckpt_every=0", "train.eval_every=0",
                 "train.log_every=1"]
TD_STREAM_ROUTES = {"lstm_scan_fwd_grid": 8, "lstm_scan_fwd_cluster": 1,
                    "lstm_scan_bwd_grid": 4, "lstm_scan_bwd_cluster": 1}
# the grid plans timed against each other at the streaming listener's
# first layer (D=1, B=64, H=768, T=1600): (hidden units a block, ring
# chunk, stages), each planned by grid_plan with that unit count alone,
# then given that chunk and stage count (0: the plan's own); the first is
# the default plan
GRID_SWEEP = {"fwd": ((16, 0, 0), (16, 384, 2), (8, 0, 0), (32, 0, 0)),
              "bwd": ((16, 0, 0), (16, 512, 3), (32, 0, 0))}
# K2 and K3 at the family's new one-direction shapes, B=64, bf16: (tag, T,
# input width, H, every step valid on the path) -- the streaming listener's
# first layer (80 mels at T=1600) and last pyramid layer (T=200), ragged
# rows, and the predictor over [SOS, y] at the 256-token bucket
TD_LSTM_SHAPES = (("listener_t1600", 1600, 80, 768, False),
                  ("listener_t200", 200, 1536, 768, False),
                  ("predictor_t257", 257, 256, 512, True))


def c4_tag(t: int) -> str:
    return f"_h384_b64_t{t}"


# every shipped LSTM-listener width of the LAS and semi-supervised recipes
# (timit 256; ls100, ls100_semi 384; ls960_dp 512): the cluster route's
# checks (phases 1, 3, 6)
CLUSTER_WIDTHS = (256, 384, 512)
# widths above CLUSTER_MAX_HIDDEN (ls100_transducer_streaming's 768 among
# them): the grid route's checks (phases 3, 6)
GRID_WIDTHS = (640, 768, 1024)
# published peaks of one H100 SXM (NVIDIA H100 datasheet)
HBM_BYTES_S = 3.35e12
L2_BYTES = 50e6
BF16_FLOPS = 989e12
F32_FLOPS = 67e12            # float32 on the CUDA cores (no tensor cores)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the log, after the seconds since the script started
    (where the time limit goes)."""
    print(f"{time.perf_counter() - _T0:7.1f} {msg}", flush=True)


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
    and keeps them when they hold the same number of kernel events, to one
    in ten thousand (their mean: a trace of tens of thousands of kernels
    often drops one event, and each retry of such a trace costs seconds).
    After a trace of tens of thousands of kernels the profiler can record
    nothing for several sessions, so a failed attempt waits a second;
    after three, the fuller trace, or, if no trace held a kernel, CUDA
    events over back-to-back calls under the name ``EVENTS_KEY``, each
    with a log line."""
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
    for _ in range(3):
        (a, na), (b, nb) = trace(), trace()
        if na > 0 and abs(na - nb) <= na // 10_000:
            return {k: (a.get(k, 0.0) + b.get(k, 0.0)) / 2
                    for k in set(a) | set(b)}
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
                           (r"(lstm_(?:fwd|bwd)_(?:cluster|grid|grid_f32)"
                            r"_kernel|(?:exchange|grid|grid_f32)_floor_kernel)"
                            r"E", None)):
        name = re.search(pattern, entry)
        if name:
            return (f"{name.group(1)}<{param}={name.group(2)}>" if param
                    else name.group(1))
    return None


def phase1() -> dict:
    """Build the kernels; -> {bf16 instance of K5 and the kernels of the
    LSTM cluster, grid and float32 grid routes: (registers, spill stores,
    spill loads)} from ptxas; then how many clusters of each LSTM cluster
    plan at B=32 the card holds, and whether the grid plans at H=768 and
    the float32 grid plans at the LM's and the fusion listener's shapes fit
    it all at once."""
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
    grid_coresidency()
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
    require(len(regs) == 15, f"ptxas reported {sorted(regs)}")
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


def grid_coresidency() -> None:
    """The grid plans of K2 and K3 at ls100_transducer_streaming's H=768
    for D=1, B=64 and for D=2, B=32 (bf16), and the float32 grid plans at
    F32_LSTM_SHAPES (the LM, the fusion listener): the blocks an SM holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times the SMs against
    the launch's N * G * D blocks, which must all be resident at once."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    shapes = [(768, d, b, torch.bfloat16) for d, b in ((1, 64), (2, 32))]
    shapes += [(h, d, LM_BATCH, torch.float32)
               for _, _, _, h, d, _ in F32_LSTM_SHAPES]
    for kind in ("fwd", "bwd"):
        for h, d, b, compute in shapes:
            plan = K.cluster_plan(kind, h, b, compute, d)
            want = "grid" if compute == torch.bfloat16 else "grid_f32"
            require(plan.route == want, f"K2/K3 {kind} H={h}: {plan}")
            per_sm, sms = K.grid_occupancy(kind, h, plan)
            need = h // plan.units * plan.groups * d
            log(f"[phase1] {kind} {plan.route} plan H={h} D={d} B={b}: u="
                f"{plan.units} G={plan.groups} R={plan.rows} sub={plan.sub} "
                f"chunk={plan.chunk} stages={plan.stages} smem={plan.smem} "
                f"B; {per_sm} block(s) an SM x {sms} SMs = "
                f"{per_sm * sms} resident, the launch has {need}")
            require(per_sm * sms >= need, f"the {kind} grid at D={d} B={b} "
                    "is not all resident at once")


def simt_plan(*args, **kwargs):
    """cluster_plan's signature: the CUDA-core route at every shape."""
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    return K.Plan("simt")


# the listener-shape checks of phases 3 and 6: float32 on its planned route
# (the float32 grid at H=256) and forced onto the CUDA cores, bf16 on the
# cluster route
LISTENER_ROUTES = (("float32", "grid_f32"), ("float32", "simt"),
                   ("bfloat16", "cluster"))


@contextlib.contextmanager
def forced_plan(plan_fn):
    """Run the scan wrappers with ``plan_fn`` (cluster_plan's signature)
    as their launch plan."""
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    keep, K.cluster_plan = K.cluster_plan, plan_fn
    try:
        yield
    finally:
        K.cluster_plan = keep


def grid_refusal() -> None:
    """A grid plan the card cannot hold all at once (H=768, B=64, D=2 in
    8 row groups of 8 rows: 1,536 blocks for K2, 768 for K3) must raise
    before any launch: no launch counted, and the card still works."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    h, b, t, bf16 = 768, 64, 5, torch.bfloat16

    def too_big(kernel, hidden, batch, compute, directions=1):
        u = 8 if kernel == "fwd" else 16
        return K.Plan("grid", 0, 8, u, K.GRID_THREADS,
                      K.grid_smem(kernel, hidden, u, 8, 8, 384, 2), 8, 8,
                      384, 2)

    gx, w_hh, valid, dh_out = scan_inputs(h, 2, b, t, 5)
    with torch.inference_mode():
        ref = K.lstm_scan_reference(gx, w_hh, valid, bf16, (False, True),
                                    residuals=True)
    for kind, call in (
            ("fwd", lambda: K.lstm_scan(gx, w_hh, valid, bf16,
                                        (False, True))),
            ("bwd", lambda: K.lstm_scan_bwd(w_hh, valid, ref[3], ref[2],
                                            dh_out, bf16, (False, True)))):
        before = dict(_native.LAUNCHES)
        try:
            with forced_plan(too_big), torch.inference_mode():
                call()
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        require("cudaError 720" in raised, f"{kind}: a grid the card cannot "
                f"hold did not raise cudaErrorCooperativeLaunchTooLarge: "
                f"{raised!r}")
        require(_native.LAUNCHES == before, f"{kind}: a refused launch was "
                "counted")
        log(f"[phase3] K{2 if kind == 'fwd' else 3} grid of "
            f"{h // too_big(kind, h, b, bf16).units * 8 * 2} blocks "
            f"refused before launch: {raised}")
    require(float(torch.ones(4, device=DEVICE).sum()) == 4.0,
            "the card is unusable after a refused launch")


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


def routed(kind: str, compute, call, route: str):
    """Run ``call`` and require that it launched K2 (``kind="fwd"``) or K3
    ("bwd") once, on ``route`` -> (result, route)."""
    from semi_supervised_asr_tpu_torch import _native

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
        for dtype, route in LISTENER_ROUTES:
            compute = getattr(torch, dtype)
            force = forced_plan(simt_plan) if route == "simt" else \
                contextlib.nullcontext()
            with force, torch.inference_mode():
                gx = (R.mm(x, w_ih, compute) + bias).view(b, t, 2, 4 * h)
                gx = gx.permute(2, 1, 0, 3).contiguous()
                got, _ = routed("fwd", compute, lambda: K.lstm_scan(
                    gx, w_hh, valid, compute, (False, True), residuals=True),
                    route)
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
                                route_checks("phase3", "fwd", "cluster"),
                                route_checks("phase3", "fwd", "grid"))
    worst[torch.float32] = max(worst[torch.float32],
                               route_checks("phase3", "fwd", "grid_f32"))
    grid_refusal()
    worst[torch.float32] = max(worst[torch.float32], state_checks("phase3"))
    return worst[torch.float32], worst[torch.bfloat16]


def scan_inputs(h: int, d: int, b: int, t: int, seed: int):
    """Random gates_x [D, T, B, 4H] (std 0.5, about what the listener's
    projections give), w_hh [D, H, 4H] U(+-1/sqrt(H)), valid [T, B] with
    row 0 full and row 1 (where B > 1) empty (zero length), and dh_out
    [D, T, B, H]."""
    import torch

    g = torch.Generator().manual_seed(seed)
    gx = torch.randn((d, t, b, 4 * h), generator=g) * 0.5
    w_hh = (torch.rand((d, h, 4 * h), generator=g) * 2 - 1) / math.sqrt(h)
    lens = torch.randint(1, t + 1, (b,), generator=g)
    lens[0] = t
    lens[1:2] = 0
    valid = (torch.arange(t)[:, None] < lens[None, :]).float()
    dh_out = torch.randn((d, t, b, h), generator=g)
    return [x.to(DEVICE) for x in (gx, w_hh, valid, dh_out)]


# each route's checks against the plain version (phases 3 and 6): its
# compute dtype, the (width, directions) pairs (D=2 with the second
# reversed, or one direction), batches and lengths, and whether each call
# runs twice and must be bitwise equal.  The float32 grid: the LM's width
# (D=1, H=1024) and the cold / deep fusion listener's (D=2, H=384)
ROUTE_CHECKS = {
    "cluster": ("bfloat16", tuple((h, rev) for h in CLUSTER_WIDTHS
                                  for rev in ((False, True), (True,))),
                (32, 5), (1, 37), False),
    "grid": ("bfloat16", tuple((h, rev) for h in GRID_WIDTHS
                               for rev in ((False,), (False, True))),
             (64, 5, 1), (1, 37, 400), True),
    "grid_f32": ("float32", ((1024, (False,)), (384, (False, True))),
                 (64, 5, 1), (1, 37, 256), True),
}


# the largest error of each (kernel, route) of route_checks, for the
# kernel table
ROUTE_ERRS: dict = {}


def route_checks(phase: str, kind: str, route: str) -> float:
    """K2 (``kind="fwd"``: h_out and the residuals) or K3 ("bwd": dgates
    from the plain forward's residuals) on the cluster, grid or float32
    grid ``route`` against its plain version, in the route's dtype, at each
    shape of ROUTE_CHECKS[route] (a zero-length row where B > 1), each
    call's route checked by its launch count; on the grid routes each call
    runs twice, bitwise equal (the exchange's ordering) -> the largest
    error (each within BF16_TOL in bf16, K2_TOL / K3_TOL in float32)."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    dtype, shapes, batches, lengths, twice = ROUTE_CHECKS[route]
    compute = getattr(torch, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else (
        K2_TOL if kind == "fwd" else K3_TOL)
    worst = 0.0
    for (h, rev), b, t in itertools.product(shapes, batches, lengths):
        gx, w_hh, valid, dh_out = scan_inputs(h, len(rev), b, t,
                                              h + 7 * b + t)
        with torch.inference_mode():
            ref = K.lstm_scan_reference(gx, w_hh, valid, compute, rev,
                                        residuals=True)
            if kind == "fwd":
                def call():
                    return K.lstm_scan(gx, w_hh, valid, compute, rev,
                                       residuals=True)
                want = ref
            else:
                args = (w_hh, valid, ref[3], ref[2], dh_out, compute, rev)

                def call():
                    return [K.lstm_scan_bwd(*args)]
                want = [K.lstm_scan_bwd_reference(*args)]
            got, _ = routed(kind, compute, call, route)
            again = routed(kind, compute, call, route)[0] if twice else got
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(a).all()) for a in got),
                f"{kind} {route} route output not finite")
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        require(same, f"{kind} {route} route H={h} D={len(rev)} B={b} "
                f"T={t}: two calls differ")
        err = max((a - w).abs().max().item() for a, w in zip(got, want))
        plan = K.cluster_plan(kind, h, b, compute, len(rev))
        shape = (f"C={plan.cluster} R={plan.rows}" if route == "cluster"
                 else f"u={plan.units} G={plan.groups} R={plan.rows} "
                 f"sub={plan.sub} chunk={plan.chunk} stages={plan.stages}, "
                 "twice bitwise equal")
        log(f"[{phase}] K{2 if kind == 'fwd' else 3} {route} route H={h} "
            f"D={len(rev)} reverse={rev} B={b} T={t} {dtype} ({shape}): "
            f"max_abs_err {err:.3e} (tol {tol:g})")
        require(err <= tol, f"{kind} {route} route error {err} > {tol}")
        worst = max(worst, err)
    ROUTE_ERRS[kind, route] = worst
    return worst


# K2 resuming from a carried (h, c) on each route (phase 3): (route,
# compute, H, D, B, T, split step) -- the CUDA cores in float32 (forced),
# the cluster route at timit's width, the grid route at the streaming
# listener's (B=64 and a single stream), the float32 grid at the LM's
# width and the fusion listener's
STATE_SHAPES = (("simt", "float32", 256, 2, 5, 37, 12),
                ("cluster", "bfloat16", 256, 2, 32, 37, 12),
                ("grid", "bfloat16", 768, 1, 64, 40, 16),
                ("grid", "bfloat16", 768, 1, 1, 40, 16),
                ("grid_f32", "float32", 1024, 1, 64, 40, 16),
                ("grid_f32", "float32", 384, 2, 5, 37, 12))


def state_checks(phase: str) -> float:
    """K2 with a carried state on each route of STATE_SHAPES: from random
    (h0, c0) against its plain version (h_out, the residuals and the final
    (h, c) within K2_TOL in float32, BF16_TOL in bf16), and a scan split in
    two (the second half from the first's final state) against the whole
    scan: outputs and final state bitwise equal -> the largest error."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    worst = 0.0
    for route, dtype, h, d, b, t, cut in STATE_SHAPES:
        compute = getattr(torch, dtype)
        gx, w_hh, valid, _ = scan_inputs(h, d, b, t, h + b + t + 1)
        rev = (False,) * d
        g = torch.Generator(DEVICE).manual_seed(h + b)
        h0 = torch.randn((d, b, h), generator=g, device=DEVICE) * 0.5
        c0 = torch.randn((d, b, h), generator=g, device=DEVICE)
        force = forced_plan(simt_plan) if route == "simt" else \
            contextlib.nullcontext()
        with force, torch.inference_mode():
            (got, st), _ = routed("fwd", compute, lambda: K.lstm_scan(
                gx, w_hh, valid, compute, rev, residuals=True, h0=h0, c0=c0,
                return_state=True), route)
            want, wst = K.lstm_scan_reference(gx, w_hh, valid, compute, rev,
                                              True, h0, c0, True)
            (whole, fin), _ = routed("fwd", compute, lambda: K.lstm_scan(
                gx, w_hh, valid, compute, rev, return_state=True), route)
            (a, mid), _ = routed("fwd", compute, lambda: K.lstm_scan(
                gx[:, :cut], w_hh, valid[:cut], compute, rev,
                return_state=True), route)
            (rest, end), _ = routed("fwd", compute, lambda: K.lstm_scan(
                gx[:, cut:], w_hh, valid[cut:], compute, rev, h0=mid[0],
                c0=mid[1], return_state=True), route)
        torch.cuda.synchronize()
        err = max((x - y).abs().max().item()
                  for x, y in zip((*got, *st), (*want, *wst)))
        split = (torch.equal(torch.cat([a, rest], dim=1), whole)
                 and torch.equal(end[0], fin[0])
                 and torch.equal(end[1], fin[1]))
        tol = K2_TOL if compute == torch.float32 else BF16_TOL
        log(f"[{phase}] K2 {route} route with a carried state, H={h} D={d} "
            f"B={b} T={t} {dtype}: from random (h0, c0) max_abs_err "
            f"{err:.3e} (h_out, residuals, final state; tol {tol:g}); split "
            f"at step {cut} and resumed: outputs and final (h, c) bitwise "
            f"equal to the whole scan's: {split}")
        require(err <= tol, f"K2 {route} with h0: error {err} > {tol}")
        require(split, f"K2 {route}: the split scan's state differs")
        worst = max(worst, err)
    return worst


def k2_bits(root: Path, out: Path) -> int:
    """K2 without a carried state, run from the package under ``root``, at
    phase 3's route checks (every cluster, grid and float32 grid shape,
    with residuals) and in float32 at two shapes of the listener and the
    streaming listener, each on the route ``root``'s plan gives it: writes
    the sha256 of every output to ``out`` (JSON), or where ``out`` exists,
    compares with those and returns 1 where a bf16 case differs (a float32
    case moves with its route when a change moves it to another: those
    are listed).  Run once from a parent checkout and once from this one,
    it shows whether a change left the stateless scan's bits alone."""
    import hashlib

    sys.path.insert(0, str(root))
    import torch

    from semi_supervised_asr_tpu_torch import strict_fp32
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    strict_fp32()
    cases = [("float32", 256, (False, True), 32, 37),
             ("float32", 768, (False,), 5, 37)]
    for dtype, shapes, batches, lengths, _ in ROUTE_CHECKS.values():
        cases += [(dtype, h, rev, b, t) for (h, rev), b, t in
                  itertools.product(shapes, batches, lengths)]
    digests = {}
    for dtype, h, rev, b, t in cases:
        gx, w_hh, valid, _ = scan_inputs(h, len(rev), b, t, h + 7 * b + t)
        with torch.inference_mode():
            got = K.lstm_scan(gx, w_hh, valid, getattr(torch, dtype), rev,
                              residuals=True)
        key = f"{dtype} H={h} D={len(rev)} B={b} T={t}"
        digests[key] = [hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
                        for x in got]
    if not out.exists():
        out.write_text(json.dumps(digests, indent=0))
        log(f"[k2-bits] {len(digests)} stateless K2 calls from {root}: "
            f"digests written to {out}")
        return 0
    want = json.loads(out.read_text())
    same = [k for k in digests if digests[k] == want.get(k)]
    moved = sorted((set(want) | set(digests)) - set(same))
    bf16 = [k for k in moved if k.startswith("bfloat16")]
    log(f"[k2-bits] {len(digests)} stateless K2 calls from {root} against "
        f"{out}: h_out and residuals bitwise equal in {len(same)} of "
        f"{len(want)}; bf16 cases differing: {bf16 or 'none'}; float32 "
        f"cases differing: {[k for k in moved if k not in bf16] or 'none'}"
        f" ({card_line()})")
    return 1 if bf16 else 0


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
                     lambda: K.lstm_scan_reference(*args), reps=2)
    ker, ref = results["bfloat16"]["rec"]
    audio, lens = results["bfloat16"]["batch"]
    for rec in (ref, ker, ker, ref):
        key = "serve_beam5" + ("_plain" if rec is ref else "")
        times.setdefault(key, []).extend(
            host_ms(lambda: rec.decode(audio, lens, "beam"), reps=2))
        key = "encode" + ("_plain" if rec is ref else "")
        a = torch.as_tensor(audio, device=DEVICE)
        n = torch.as_tensor(lens, device=DEVICE)
        times.setdefault(key, []).extend(
            host_ms(lambda: rec.encode(a, n), reps=2))
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
        for dtype, route in LISTENER_ROUTES:
            compute = getattr(torch, dtype)
            w_hh, valid, acts, cprev, dh_out = k3_inputs(t, i, t, compute)
            args = (w_hh, valid, acts, cprev, dh_out, compute, rev)
            with (forced_plan(simt_plan) if route == "simt"
                  else contextlib.nullcontext()):
                got, _ = routed("bwd", compute,
                                lambda: K.lstm_scan_bwd(*args), route)
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
    worst = max(worst, route_checks("phase6", "bwd", "grid_f32"))
    return worst, max(worst_bf16, route_checks("phase6", "bwd", "cluster"),
                      route_checks("phase6", "bwd", "grid"))


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

    from semi_supervised_asr_tpu_torch.training.checkpointing import (
        Checkpointer,
    )

    log(f"[phase11] overrides {CONFORMER_OVERRIDES + CONFORMER_TRAIN} "
        f"(model.enc_dropout {conformer_config([]).model.enc_dropout}, as "
        "shipped)")
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
    # exact resume: 2 steps, then a Solver resuming their checkpoint to
    # step 3 in the same workdir, against the straight run's step 3 (the
    # conv stem's backward is a gather and a matmul, with no atomics)
    split = d / "split"
    short_solver(conformer_config(CONFORMER_TRAIN), split, steps=2).train()
    short_solver(conformer_config(CONFORMER_TRAIN), split).train(resume=True)
    sd_a, meta_a, _ = Checkpointer(d / "bf16" / "checkpoints").load(3)
    sd_b, meta_b, _ = Checkpointer(split / "checkpoints").load(3)
    diff = first_difference(sd_a, sd_b)
    log(f"[phase11] conformer run resumed from step 2: step 3's state "
        f"(parameters, EMA buffer, Adam moments and count, generators) "
        f"{'bitwise equal' if diff is None else 'differs first at ' + diff}"
        f"; data_pos {meta_b['data_pos']} vs {meta_a['data_pos']}")
    require(diff is None, f"conformer resume differs first at {diff}")
    require(meta_a["data_pos"] == meta_b["data_pos"],
            "conformer data_pos differs")
    del sd_a, sd_b
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
                                       backend=backend), reps=1))
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
                    grad_tol: float = GRAD_TOL, phase: str = "phase13"
                    ) -> None:
    """One semi-supervised step (C4, the transducer's or the CTC family's:
    the family of the Solver's model) from the Solver's weights (student
    and EMA teacher),
    the first batch of its streams and fixed SpecAugment bands, gate open
    and every row kept (SEMI_CHECK), in its compute dtype, kernels against
    plain:
    the clean view (within K1_TOL in float32) and the teacher's encoder
    output on the kernels' clean view (no grad, within K2_TOL in float32,
    BF16_TOL in bf16) are compared first, and the share of rows whose
    greedy hypotheses agree is logged (required >= 0.95 in float32 only:
    in bf16 a near-tie of two logits flips a row's argmax); then both
    runs take the kernel teacher's hypotheses, so that the student's loss
    and gradients are compared on the same targets (loss within
    ``loss_tol`` relative, every gradient leaf within ``grad_tol`` of the
    model's largest entry); the EMA buffer after the update within 1e-6."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.ops import frontend as F
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    cfg = dataclasses.replace(s.cfg, objective=dataclasses.replace(
        s.cfg.objective, **SEMI_CHECK))
    dtype = cfg.model.compute_dtype
    fam = TS.family_terms(cfg)
    # the CTC family has no text term
    keys = ("ce" if cfg.model.family == "las" else "nll_per_label",
            *(k for k in (fam.TEXT_KEY,) if k), "pseudo")
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
        labels[backend] = fam.step_teacher_labels(
            s.state.ema, cfg, *views[backend], max_len, backend)
    unlab_bands = bands(unlab["unlab_audio_lens"], views[None][0].shape[1])
    view_err = (views[None][0] - views["reference"][0]).abs().max().item()
    with torch.inference_mode():
        enc = {backend: s.state.ema.encode(*views[None], backend)[:2]
               for backend in (None, "reference")}
    require(bool(torch.equal(enc[None][1], enc["reference"][1])),
            "the teacher's encoder masks differ")
    require(bool(torch.isfinite(enc[None][0]).all()),
            "the teacher's encoder output is not finite")
    enc_err = (enc[None][0] - enc["reference"][0]).abs().max().item()
    enc_tol = K2_TOL if dtype == "float32" else BF16_TOL
    del enc
    same = float(np.mean(np.all(
        (labels[None][0] == labels["reference"][0]).cpu().numpy(), axis=1)))
    log(f"[{phase}] {dtype} clean view (K1 vs plain) max_abs_err "
        f"{view_err:.3e}; teacher's encoder output on it (K2 no-grad vs "
        f"plain) max_abs_err {enc_err:.3e} (tol {enc_tol:g}); teacher's "
        f"greedy hypotheses identical in {same:.3f} of the rows")
    require(enc_err <= enc_tol, f"{dtype} teacher encoder error {enc_err}")
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
            cfg, state, *tensors, s.cmvn_dev,
            [TS.StepDraws(TS.Draws(specaug=lab_bands),
                          TS.Draws(specaug=unlab_bands), labels[None])],
            backend, **unlab)
        grads = [g.clone() for g in grads]
        TS.apply_grads(cfg, state, [g.clone() for g in grads])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[backend] = (loss, aux, grads, list(state.ema.parameters()))
        log(f"[{phase}] {dtype} check step on "
            f"{backend or 'the kernels'}: {ms:.0f} ms; "
            + ", ".join(f"{k} {float(aux[k]):.6f}"
                        for k in (*keys, "pseudo_gate")))
        del state
    routes = {k: v for k, v in _native.LAUNCHES.items() if v}
    (lk, ak, gk, ek), (lr, ar, gr, er) = out[None], out["reference"]
    rel = abs(lk.item() - lr.item()) / abs(lr.item())
    names = [n for n, _ in s.state.model.named_parameters()]
    errs = dict(zip(names, grad_errs(gk, gr)))
    worst = max(errs, key=errs.get)
    ema_err = max((a - b).abs().max().item() for a, b in zip(ek, er))
    log(f"[{phase}] {dtype} semi step, kernels vs plain (kernel launches "
        f"{routes}): loss {lk.item():.6f} vs {lr.item():.6f} (rel "
        f"{rel:.2e}, tol {loss_tol:g}); worst gradient leaf {worst} "
        f"{errs[worst]:.3e} of the model's max |g| over {len(errs)} leaves "
        f"(tol {grad_tol:g}); EMA buffer max_abs_err {ema_err:.3e} (tol "
        f"1e-6)")
    require(all(float(ak[k]) > 0 for k in keys),
            f"a term of the {phase} semi loss is zero")
    require(rel <= loss_tol, f"{dtype} semi step loss differs: rel {rel}")
    require(errs[worst] <= grad_tol, f"semi gradient {worst} differs")
    require(ema_err <= 1e-6, f"semi EMA buffer differs by {ema_err}")


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


def counting(solver, steps: list, evals: list, walls: list,
             peaks: list | None = None) -> None:
    """Record each step's and each validation's kernel launches (the
    difference of the counts around the call, so the run's own counts
    stay whole), each step's wall time and, given ``peaks``, its peak
    device memory (GiB), by wrapping the Solver's ``run_step`` and
    ``validate`` on this instance."""
    import torch

    from semi_supervised_asr_tpu_torch import _native

    run_step, validate = solver.run_step, solver.validate

    def counted_step(args, unlab):
        torch.cuda.synchronize()
        if peaks is not None:
            torch.cuda.reset_peak_memory_stats()
        before = dict(_native.LAUNCHES)
        t0 = time.perf_counter()
        m = run_step(args, unlab)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        steps.append(launch_delta(before, _native.LAUNCHES))
        if peaks is not None:
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
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


def require_launches(what: str, got: dict, want: dict,
                     routes: dict | None = None) -> None:
    """``got`` holds exactly ``want``'s counts, and ``routes``' launches by
    route (``lstm_scan_{fwd,bwd}_{cluster,simt}``), by default every K2 /
    K3 launch on the cluster route."""
    main = {k: got.get(k, 0) for k in LSTM_PATH}
    require(main == {k: want.get(k, 0) for k in LSTM_PATH},
            f"{what}: kernel launches {got}, not {want}")
    if routes is not None:
        require(all(got.get(k, 0) == n for k, n in routes.items()),
                f"{what}: launches by route {got}, not {routes}")
        return
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
    # float32 grid route)
    step_check(s, "phase7", BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)
    step_check(timit_solver(d / "f32", "float32"), "phase7")
    return s, launches, recs


def step_check(s, phase: str, loss_tol: float = 1e-5,
               grad_tol: float = GRAD_TOL) -> None:
    """One step's loss and gradients from the Solver's weights, first
    batch and fixed SpecAugment bands, in its compute dtype: kernels
    against plain, loss within ``loss_tol`` relative and every gradient
    leaf within ``grad_tol`` of the model's largest entry."""
    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    batch, tensors = first_batch(s)
    bands = fixed_bands(s, batch, tensors)
    out = {}
    _native.reset_launches()
    for backend in (None, "reference"):
        model = copy.deepcopy(s.state.model)
        state = TS.init_train_state(s.cfg, model, seed=0)
        out[backend] = TS.loss_and_grads(
            s.cfg, state, *tensors, s.cmvn_dev,
            [TS.StepDraws(TS.Draws(specaug=bands))], backend)
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


def cudnn_lstm(x, w_ih, bias, w_hh, valid, dtypes=None):
    """torch.nn.LSTM (cuDNN) holding the layer's weights (w_hh [D, H, 4H]:
    one direction or both), in the first of ``dtypes`` (bf16, then
    float32, by default) the cell takes, and its packed input -> (module,
    packed, dtype)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    b, t, i = x.shape
    d, h = w_hh.shape[:2]
    lstm = torch.nn.LSTM(i, h, batch_first=True, bidirectional=d == 2)
    with torch.no_grad():
        for sfx, dd in (("", 0), ("_reverse", 1))[:d]:
            cols = slice(dd * 4 * h, (dd + 1) * 4 * h)
            getattr(lstm, "weight_ih_l0" + sfx).copy_(w_ih[:, cols].t())
            getattr(lstm, "weight_hh_l0" + sfx).copy_(w_hh[dd].t())
            getattr(lstm, "bias_ih_l0" + sfx).copy_(bias[cols])
            getattr(lstm, "bias_hh_l0" + sfx).zero_()
    # packing needs a frame in every row: the zero-length row gets one
    lens = valid.sum(0).clamp_min(1).cpu()
    for dtype in dtypes or (torch.bfloat16, torch.float32):
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


def port_layer(x, w_ih, bias, w_hh, valid, compute=None):
    """One LSTM layer of the port (BiLSTM where w_hh holds two directions)
    in ``compute`` (bf16 by default): the input projection as one product,
    then K2; K3, the dW_hh product and the projection's autograd backward
    under autograd; its inputs and weights as leaves -> (forward function,
    leaves)."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    compute = compute or torch.bfloat16
    h4 = w_hh.shape[2]
    lens = valid.sum(0).to(torch.int32)
    if w_hh.shape[0] == 1:
        leaves = [a.detach().clone().requires_grad_(True)
                  for a in (x, w_ih[:, :h4], w_hh[0], bias[:h4])]
        xg, wi, wh, bb = leaves
        return (lambda: K.lstm_kernel({"w_ih": wi, "w_hh": wh, "b": bb}, xg,
                                      lens, False, compute), leaves)
    leaves = [x, w_ih[:, :h4], w_hh[0], bias[:h4], w_ih[:, h4:], w_hh[1],
              bias[h4:]]
    leaves = [a.detach().clone().requires_grad_(True) for a in leaves]
    xg, wif, whf, bf, wib, whb, bb = leaves
    params = {"fwd": {"w_ih": wif, "w_hh": whf, "b": bf},
              "bwd": {"w_ih": wib, "w_hh": whb, "b": bb}}
    return lambda: K.bilstm_kernel(params, xg, lens, compute), leaves


def weaker(*methods: str) -> str:
    """The method to name a time computed from times of these methods."""
    return max(methods, key=list(METHODS).index)


def backward_ms(fwd, leaves, dy) -> tuple[float, str]:
    """Device ms of a backward pass and the method: (training forward +
    backward) minus the training forward, each on a fresh graph."""
    import torch

    fwd_train, m1 = profiled_ms(fwd, reps=3)
    both, m2 = profiled_ms(lambda: torch.autograd.grad(fwd(), leaves, dy),
                           reps=3)
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
        w = K.fragment_weights(w_hh, kind, plan)
        if kind == "fwd":
            out = [torch.empty((d, t, b, h), device=DEVICE) for _ in range(3)]
            out.append(torch.empty_like(gx))
            # then no carried state: h0, c0, h_fin, c_fin NULL
            ptrs = (gx.data_ptr(), w.data_ptr(), valid.data_ptr(),
                    *(x.data_ptr() for x in out), None, None, None, None)
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
                 lambda: K.lstm_scan_bwd_reference(*args), reps=2)
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
                                       backend=backend), reps=1))
    med = report("phase8", times, card)
    med["cudnn_dtype"] = str(dtype).split(".")[-1]
    for kind, lib in (("fwd", "cudnn_lstm_fwd"), ("bwd", "cudnn_lstm_bwd")):
        (port, m1), (ref, m2) = pick(med, "layer_" + kind), pick(med, lib)
        log(f"[phase8] layer {kind}: the port {port:.4f} ms ({METHODS[m1][1]})"
            f" against cuDNN {ref:.4f} ms ({METHODS[m2][1]}); ratio "
            f"{port / ref:.3f} ({card})")
    return med


# --------------------------------------------------------------------- #
# phase 15: data parallelism and the ls960_dp recipe (C5)
# --------------------------------------------------------------------- #

def c5_config(extra=()):
    from semi_supervised_asr_tpu_torch.config import load_config

    return load_config(C5_CONFIG, [*C5_DATA, *extra])


def torchrun(nproc: int, argv: list[str], timeout: int) -> str:
    """``argv`` under ``torch.distributed.run --standalone`` with ``nproc``
    ranks (a rendezvous on localhost) -> its stderr; a failure raises."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    require(proc.returncode == 0,
            f"torchrun of {argv[:3]} exited {proc.returncode}: "
            f"{proc.stdout[-1500:]}\n{proc.stderr[-3000:]}")
    return proc.stderr


def c5_rank_a(out: Path) -> None:
    """Part (a), one rank under torchrun: ``main --train`` of the C5
    recipe over NCCL (world 1), with each step's and each validation's
    kernel launches, each step's wall time and each gradient all-reduce's
    bytes and device time recorded around the Solver's own calls."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch import main as M
    from semi_supervised_asr_tpu_torch.parallel import dp as DP
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    steps, evals, walls, reductions = [], [], [], []
    run_step, validate = Solver.run_step, Solver.validate
    all_reduce = DP.all_reduce_grads

    def counted_step(self, args, unlab):
        torch.cuda.synchronize()
        before = dict(_native.LAUNCHES)
        t0 = time.perf_counter()
        m = run_step(self, args, unlab)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        steps.append(launch_delta(before, _native.LAUNCHES))
        return m

    def counted_validate(self):
        before = dict(_native.LAUNCHES)
        res = validate(self)
        evals.append((launch_delta(before, _native.LAUNCHES), res))
        return res

    def timed_all_reduce(grads):
        n0, c0 = DP.STATS["bytes"], DP.STATS["calls"]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = all_reduce(grads)
        ev[1].record()
        torch.cuda.synchronize()
        reductions.append({"bytes": DP.STATS["bytes"] - n0,
                           "buffers": DP.STATS["calls"] - c0,
                           "ms": ev[0].elapsed_time(ev[1])})
        return res

    Solver.run_step, Solver.validate = counted_step, counted_validate
    DP.all_reduce_grads = timed_all_reduce
    _native.reset_launches()
    rc = M.main(["--config", str(C5_CONFIG), "--train", "--workdir",
                 str(out / "run"), *C5_DATA, *C5_RUN])
    torch.cuda.synchronize()
    (out / "rank_a.json").write_text(json.dumps({
        "rc": rc, "steps": steps, "evals": evals, "walls": walls,
        "reductions": reductions,
        "launches": {k: v for k, v in _native.LAUNCHES.items() if v}}))


def c5_rank_b(out: Path) -> None:
    """Part (b), one of two ranks sharing the card over gloo: one float32
    step on the rank's 16 rows of a global batch of 32 (rank 0 also runs
    one process's step on the 32 rows), then 2 bf16 steps of the recipe
    (no checkpoint) and the rank-sharded validation (rank 0 also validates
    alone)."""
    import hashlib

    import torch

    from semi_supervised_asr_tpu_torch import strict_fp32
    from semi_supervised_asr_tpu_torch.parallel import mesh as MESH
    from semi_supervised_asr_tpu_torch.training import train_step as TS
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    strict_fp32()
    device = MESH.maybe_initialize_distributed("cuda", backend="gloo")
    rank = MESH.rank()
    res: dict = {"rank": rank, "device": str(device)}
    s = Solver(c5_config([*C5_RUN, "model.compute_dtype=float32",
                          "train.bf16_weight_stream=false"]),
               out / "f32", device)
    init = copy.deepcopy(s.state.model)
    _, _, batch = next(s._labeled_stream())
    tensors, sizes = s.step_inputs(batch)
    state = TS.init_train_state(s.cfg, copy.deepcopy(init), s.cfg.train.seed)
    loss, _, grads = TS.loss_and_grads(s.cfg, state, *tensors, s.cmvn_dev,
                                       dp=s.dp, **sizes)
    res["rows"] = int(tensors[0].shape[0])
    res["grad_sha"] = hashlib.sha256(b"".join(
        g.detach().cpu().numpy().tobytes() for g in grads)).hexdigest()
    if rank == 0:
        s.world = 1                       # the global batch, one process
        _, _, whole = next(s._labeled_stream())
        s.world = MESH.world_size()
        one, _ = s.step_inputs(whole)
        st1 = TS.init_train_state(s.cfg, copy.deepcopy(init),
                                  s.cfg.train.seed)
        loss1, _, grads1 = TS.loss_and_grads(s.cfg, st1, *one, s.cmvn_dev)
        names = [n for n, _ in init.named_parameters()]
        errs = dict(zip(names, grad_errs(grads, grads1)))
        worst = max(errs, key=errs.get)
        res.update(loss=loss.item(), loss_one=loss1.item(),
                   rows_one=int(one[0].shape[0]), worst_leaf=worst,
                   worst_err=errs[worst], gen_equal=torch.equal(
                       state.gen.get_state(), st1.gen.get_state()))
        del st1, grads1
    del s, state, grads, init
    torch.cuda.empty_cache()
    MESH.barrier()

    run = Solver(c5_config([*C5_RUN, "train.total_steps=2",
                            "train.ckpt_every=0"]), out / "run", device)
    run.train()
    res["history"] = [{k: v for k, v in h.items()
                       if k not in ("frames_per_sec", "steps_per_sec")}
                      for h in run.history]
    res["param_sha"] = hashlib.sha256(b"".join(
        p.detach().cpu().numpy().tobytes()
        for p in run.state.model.parameters())).hexdigest()
    rate, records, _, _ = run._score_batches(run.bundle.dev,
                                             run.state.model, "greedy")
    res.update(dev_rate=rate, errors=sum(r["errors"] for r in records),
               ref_len=sum(r["ref_len"] for r in records),
               n_records=len(records))
    if rank == 0:
        run.world = 1                     # the whole dev set, one process
        rate1, rec1, _, _ = run._score_batches(run.bundle.dev,
                                               run.state.model, "greedy")
        run.world = MESH.world_size()
        res.update(dev_rate_one=rate1,
                   errors_one=sum(r["errors"] for r in rec1),
                   ref_len_one=sum(r["ref_len"] for r in rec1),
                   n_records_one=len(rec1))
    MESH.barrier()
    (out / f"rank_b{rank}.json").write_text(json.dumps(res))
    MESH.destroy()


def c5_part_c(d: Path, card: str) -> None:
    """Part (c), one process, kernels only: the C5 step with remat on and
    off (loss and gradients within the phase-7 bf16 bounds, K2 8 launches
    against 4, K3 4 both) and with the bf16 weight stream on and off
    (loss within BF16_STEP_LOSS_TOL); the step kernels against plain with
    remat on and the stream off; the K2 / K3 launch plans at H=512 for
    the world-1 and the two-rank batch."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.ops import frontend as F
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
    from semi_supervised_asr_tpu_torch.training import train_step as TS
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    for kind in ("fwd", "bwd"):
        for b in (32, 16):
            plan = K.cluster_plan(kind, 512, b, torch.bfloat16)
            held = K.cluster_occupancy(kind, plan)
            log(f"[phase15] K{2 if kind == 'fwd' else 3} plan at H=512 "
                f"B={b}: route {plan.route} C={plan.cluster} R={plan.rows} "
                f"u={plan.units} threads={plan.threads} smem={plan.smem} B;"
                f" max active clusters {held}, a D=2 launch has "
                f"{2 * -(-b // plan.rows)} ({card})")
            require(plan.route == "cluster", f"C5 {kind} plan {plan}")
    s = Solver(c5_config(C5_RUN), d, DEVICE)
    batch, tensors = first_batch(s)
    fcfg = s.cfg.frontend
    flens = torch.clamp_max(F.frame_lengths(tensors[1], fcfg),
                            batch.bucket[0])
    bands = F.sample_specaug_params(torch.Generator().manual_seed(5),
                                    flens.shape[0], fcfg.n_mels, flens, fcfg)

    def one_step(**train):
        cfg = s.cfg.replace(train=dataclasses.replace(s.cfg.train, **train))
        state = TS.init_train_state(cfg, copy.deepcopy(s.state.model), 0)
        torch.cuda.synchronize()
        before = dict(_native.LAUNCHES)
        out = TS.loss_and_grads(cfg, state, *tensors, s.cmvn_dev,
                                [TS.StepDraws(TS.Draws(specaug=bands))])
        torch.cuda.synchronize()
        return out, launch_delta(before, _native.LAUNCHES)

    (lr_, _, gr), on = one_step()
    (ln, _, gn), off = one_step(remat_encoder=False)
    rel = abs(lr_.item() - ln.item()) / abs(ln.item())
    names = [n for n, _ in s.state.model.named_parameters()]
    errs = dict(zip(names, grad_errs(gr, gn)))
    worst = max(errs, key=errs.get)
    same = all(torch.equal(a, b) for a, b in zip(gr, gn))
    log(f"[phase15] C5 step (bf16, bf16 weight stream), remat_encoder on vs "
        f"off: loss {lr_.item():.6f} vs {ln.item():.6f} (rel {rel:.2e}, tol "
        f"{BF16_STEP_LOSS_TOL:g}); worst gradient leaf {worst} "
        f"{errs[worst]:.3e} of the model's max |g| (tol "
        f"{BF16_STEP_GRAD_TOL:g}); gradients bitwise equal: {same}; "
        f"launches on {on}, off {off}")
    require(rel <= BF16_STEP_LOSS_TOL, f"remat changes the loss: {rel}")
    require(errs[worst] <= BF16_STEP_GRAD_TOL, f"remat gradient {worst}")
    require({k: on.get(k, 0) for k in LSTM_PATH} == C5_STEP_LAUNCHES,
            f"remat step launches {on}, not {C5_STEP_LAUNCHES}")
    require({k: off.get(k, 0) for k in LSTM_PATH}
            == {**C5_STEP_LAUNCHES, "lstm_scan_fwd": 4},
            f"step launches without remat {off}")
    del gr, gn
    (l32, _, _), _ = one_step(bf16_weight_stream=False)
    rel = abs(lr_.item() - l32.item()) / abs(l32.item())
    log(f"[phase15] C5 step, bf16 weight stream on vs off: loss "
        f"{lr_.item():.6f} vs {l32.item():.6f} (rel {rel:.2e}, tol "
        f"{BF16_STEP_LOSS_TOL:g})")
    require(rel <= BF16_STEP_LOSS_TOL, f"the bf16 stream moves the loss by "
            f"{rel}")
    torch.cuda.empty_cache()
    nostream = copy.copy(s)
    nostream.cfg = s.cfg.replace(train=dataclasses.replace(
        s.cfg.train, bf16_weight_stream=False))
    step_check(nostream, "phase15", BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)
    lab = s._labeled_stream()
    return lambda: s.run_step(*s.step_inputs(next(lab)[2]))


def phase15(d: Path, card: str) -> tuple[dict, dict]:
    """The C5 recipe (configs/ls960_dp.yaml) at full width: (a) main
    --train under torchrun over NCCL, world 1, with its launches, step
    walls and all-reduces, then main --train --resume of its step-2
    checkpoint in a fresh process and workdir, bitwise at step 3; (b) two
    ranks on the card over gloo against one process; (c) remat and the
    bf16 stream, on against off.  -> (part (a)'s launches, a C5 step to
    profile with its median wall ms)."""
    import shutil

    from semi_supervised_asr_tpu_torch import train as T
    from semi_supervised_asr_tpu_torch.training.checkpointing import (
        Checkpointer,
    )

    log(f"[phase15] {C5_CONFIG.name} as shipped (B=32 a rank, bf16, "
        f"remat_encoder, bf16_weight_stream, sortagrad_epochs 1, async_ckpt)"
        f"; cuts: {C5_DATA + C5_RUN}")
    a = d / "a"
    t0 = time.perf_counter()
    torchrun(1, [__file__, "--c5-rank", "a", str(a)], timeout=900)
    wall = time.perf_counter() - t0
    got = json.loads((a / "rank_a.json").read_text())
    require(got["rc"] == 0, f"main --train returned {got['rc']}")
    recs = read_records(a / "run")
    train = by_prefix(recs, "train")
    require(len(train) == len(got["steps"]) == 3,
            f"C5 run took {len(got['steps'])} steps")
    for i, (m, step) in enumerate(zip(train, got["steps"])):
        log(f"[phase15] (a) step {i + 1}: loss {m['loss']:.4f} ce "
            f"{m['ce']:.4f} acc {m['acc']:.4f} grad_norm "
            f"{m['grad_norm']:.4f} lr {m['lr']:.3e}; wall "
            f"{got['walls'][i]:.1f} ms; kernel launches {step}")
        require(all(math.isfinite(m[k]) for k in T.METRIC_KEYS),
                f"C5 step {i + 1}: a metric is not finite")
        require_launches(f"C5 step {i + 1}", step, C5_STEP_LAUNCHES)
    require(len(got["evals"]) == 1, f"{len(got['evals'])} validations")
    ev, dev = got["evals"][0]
    n_dev = -(-C5_DEV // 32)
    require_launches("C5 validation", ev,
                     {k: n * n_dev for k, n in SOLVER_EVAL_LAUNCHES.items()})
    red = got["reductions"]
    log(f"[phase15] (a) validation (greedy, {C5_DEV} dev utterances in "
        f"{n_dev} batches of 32): {dev}; kernel launches {ev}; run launches "
        f"{got['launches']}; {wall:.1f} s for the torchrun")
    log(f"[phase15] (a) gradient all-reduce over NCCL, world 1, one a step:"
        f" {red[0]['bytes'] / 1e6:.3f} MB (the flat float32 gradients and "
        f"metrics) in {red[0]['buffers']} buffers, device time by CUDA "
        f"events around the call (flatten, all_reduce, views) "
        f"{[round(r['ms'], 4) for r in red]} ms for steps 1-3 ({card})")
    ckpts = Checkpointer(a / "run" / "checkpoints")
    require(ckpts.all_steps() == [2, 3],
            f"C5 checkpoints {ckpts.all_steps()}, not [2, 3]")
    res = d / "resumed"
    shutil.copytree(a / "run" / "checkpoints" / "2", res / "checkpoints" / "2")
    shutil.copy(a / "run" / "cmvn.npz", res / "cmvn.npz")
    err = torchrun(1, ["-m", "semi_supervised_asr_tpu_torch.main",
                       "--config", str(C5_CONFIG), "--train", "--resume",
                       "--workdir", str(res), *C5_DATA, *C5_RUN],
                   timeout=600)
    require("resumed from step 2" in err, f"no resume: {err[-1000:]}")
    sd_a, meta_a, _ = ckpts.load(3)
    sd_b, meta_b, _ = Checkpointer(res / "checkpoints").load(3)
    diff = first_difference(sd_a, sd_b)
    rec_b = by_prefix(read_records(res), "train")
    same_rec = all(train[2][k] == rec_b[0][k] for k in T.METRIC_KEYS)
    log(f"[phase15] (a) main --train --resume of step 2 in a fresh process "
        f"and workdir: step 3's state (parameters, EMA buffer, Adam moments "
        f"and count, generator) "
        f"{'bitwise equal' if diff is None else 'differs first at ' + diff}"
        f"; data_pos {meta_b['data_pos']} vs {meta_a['data_pos']}; step-3 "
        f"record equal: {same_rec}")
    require(diff is None, f"C5 resume differs first at {diff}")
    require(meta_a["data_pos"] == meta_b["data_pos"], "C5 data_pos differs")
    require(same_rec, "C5 step-3 record differs")
    del sd_a, sd_b

    b = d / "b"
    t0 = time.perf_counter()
    torchrun(2, [__file__, "--c5-rank", "b", str(b)], timeout=900)
    wall_b = time.perf_counter() - t0
    r0, r1 = (json.loads((b / f"rank_b{r}.json").read_text())
              for r in (0, 1))
    rel = abs(r0["loss"] - r0["loss_one"]) / abs(r0["loss_one"])
    log(f"[phase15] (b) two ranks over gloo on {r0['device']} and "
        f"{r1['device']}, {r0['rows']} + {r1['rows']} rows against one "
        f"process on {r0['rows_one']}, float32 step: loss {r0['loss']:.6f} "
        f"vs {r0['loss_one']:.6f} (rel {rel:.2e}, tol 1e-5); worst reduced "
        f"gradient leaf {r0['worst_leaf']} {r0['worst_err']:.3e} of the "
        f"model's max |g| (tol {GRAD_TOL:g}); the ranks' reduced gradients "
        f"bitwise equal: {r0['grad_sha'] == r1['grad_sha']}; generator as "
        f"one process's: {r0['gen_equal']}")
    require(r0["rows"] == r1["rows"] == 16 and r0["rows_one"] == 32,
            "the two-rank batch is not 16 + 16 rows of 32")
    require(rel <= 1e-5, f"two-rank loss differs: rel {rel}")
    require(r0["worst_err"] <= GRAD_TOL,
            f"two-rank gradient {r0['worst_leaf']} differs")
    require(r0["grad_sha"] == r1["grad_sha"], "the ranks' gradients differ")
    require(r0["gen_equal"], "a rank's generator moved unlike one process's")
    log(f"[phase15] (b) {len(r0['history'])} bf16 steps on two ranks: "
        f"losses "
        f"{[h['loss'] for h in r0['history']]}; parameter checksums "
        f"{r0['param_sha'][:16]} / {r1['param_sha'][:16]}; sharded "
        f"validation: {r0['n_records']} + {r1['n_records']} records, "
        f"{r0['errors']} + {r1['errors']} errors over "
        f"{r0['ref_len'] + r1['ref_len']} reference units, rate "
        f"{r0['dev_rate']:.4f}; one process: {r0['n_records_one']} "
        f"records, {r0['errors_one']} errors over {r0['ref_len_one']}, rate "
        f"{r0['dev_rate_one']:.4f}; {wall_b:.1f} s for the torchrun")
    require(r0["param_sha"] == r1["param_sha"], "the replicas differ")
    require(r0["history"] == r1["history"], "the ranks' metrics differ")
    require(r0["errors"] + r1["errors"] == r0["errors_one"]
            and r0["ref_len"] + r1["ref_len"] == r0["ref_len_one"]
            and r0["n_records"] + r1["n_records"] == r0["n_records_one"]
            and r0["dev_rate"] == r1["dev_rate"] == r0["dev_rate_one"],
            "the sharded validation's counts differ from one process's")
    require(min(r0["n_records"], r1["n_records"]) > 0,
            "a rank decoded no dev batch")
    step = c5_part_c(d / "c", card)
    wall = statistics.median(got["walls"][1:])
    log(f"[phase15] (a) C5 step wall time, median of steps 2-3: "
        f"{wall:.1f} ms ({card})")
    return got["launches"], {"c5_train_step_b32": (step, wall)}


# --------------------------------------------------------------------- #
# phase 16: ls100_bpe (BPE units, time warp), the options no shipped config
# sets, and ls960_transformer's remat with encoder dropout
# --------------------------------------------------------------------- #

def train_bpe_model(d: Path) -> tuple[int, int]:
    """A BPE model trained over the text of phase 16's synthetic corpus
    (built with the merge-free default vocab), written to d/bpe.json ->
    (its units, its merges)."""
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.data.bpe import train_bpe
    from semi_supervised_asr_tpu_torch.data.registry import build_datasets

    ds = build_datasets(load_config(BPE_CONFIG,
                                    [*BPE_DATA, "data.bpe_path="])).train
    vocab = train_bpe([ds[i].text for i in range(len(ds))], BPE_PIECES)
    vocab.save(d / "bpe.json")
    return vocab.size, len(vocab.merges)


def variant(s, cfg):
    """A shallow copy of Solver ``s`` that runs ``cfg``, its model rebuilt
    for ``cfg.model`` with ``s``'s weights (for step_check)."""
    from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq

    v = copy.copy(s)
    v.cfg = cfg
    model = Seq2Seq(cfg.model).to(s.device)
    model.load_state_dict(s.state.model.state_dict())
    v.state = dataclasses.replace(s.state, model=model)
    return v


def accum_check(s, card: str) -> dict:
    """``train.grad_accum=2`` against one full-batch step on equal-length
    rows (every row's audio the whole buffer, its tokens cut to the
    batch's shortest), float32, augmentation and dropout off: loss within
    1e-5 relative, every gradient leaf within GRAD_TOL; each step's peak
    memory above what was allocated before it."""
    import torch

    from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    f32 = variant(s, s.cfg.replace(
        model=dataclasses.replace(s.cfg.model, compute_dtype="float32"),
        frontend=dataclasses.replace(s.cfg.frontend, spec_augment=False)))
    batch, (audio, lens, tokens, real) = first_batch(f32)
    k = int(batch.token_lens.min())
    tokens = tokens.clone()
    tokens[:, k - 1] = EOS
    tokens[:, k:] = PAD
    lens = torch.full_like(lens, audio.shape[1])
    real = torch.ones_like(real)
    out = {}
    for accum in (1, 2):
        cfg = f32.cfg.replace(train=dataclasses.replace(f32.cfg.train,
                                                        grad_accum=accum))
        state = TS.init_train_state(cfg, copy.deepcopy(f32.state.model), 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, _, grads = TS.loss_and_grads(cfg, state, audio, lens, tokens,
                                           real, f32.cmvn_dev)
        torch.cuda.synchronize()
        out[accum] = (loss, grads,
                      (torch.cuda.max_memory_allocated() - base) / 2**20)
        del state
    (l1, g1, m1), (l2, g2, m2) = out[1], out[2]
    rel = abs(l2.item() - l1.item()) / abs(l1.item())
    names = [n for n, _ in s.state.model.named_parameters()]
    errs = dict(zip(names, grad_errs(g2, g1)))
    worst = max(errs, key=errs.get)
    log(f"[phase16] grad_accum=2 vs one step, B={audio.shape[0]} rows of "
        f"{audio.shape[1]} samples and {k} tokens, float32: loss "
        f"{l2.item():.6f} vs {l1.item():.6f} (rel {rel:.2e}, tol 1e-05); "
        f"worst gradient leaf {worst} {errs[worst]:.3e} of the model's max "
        f"|g| (tol {GRAD_TOL:g}); peak memory above the state "
        f"{m2:.1f} MiB vs {m1:.1f} MiB ({card})")
    require(rel <= 1e-5, f"accumulated loss differs: rel {rel}")
    require(errs[worst] <= GRAD_TOL, f"accumulated gradient {worst}")
    return {"accum_peak_mib": m2, "full_peak_mib": m1}


def transformer_remat(d: Path, card: str) -> dict:
    """ls960_transformer at full width with attn_backend flash: ``main
    --train`` for 2 steps and the final validation (its launches are the
    path's); then one step
    with remat_encoder on (as shipped) and one with it off, enc_dropout
    0.1 drawing the same masks (both states seeded alike): loss and every
    gradient bitwise equal; K1 1, K5 forward 24 (12 blocks, again in the
    recomputation) against 12, K5 backward 12 launches; then the step's
    wall time each way."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch import main as M
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.training import train_step as TS
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    # main --train as a user runs it: 2 steps and the final validation
    _native.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = M.main(["--config", str(TRANSFORMER_CONFIG), "--train",
                     "--workdir", str(d / "transformer_main"),
                     *TRANSFORMER_OVERRIDES, "train.total_steps=2",
                     "train.eval_every=0", "train.log_every=1"])
    torch.cuda.synchronize()
    run = {k: v for k, v in _native.LAUNCHES.items() if v}
    final = json.loads(out.getvalue().strip().splitlines()[-1])["final_dev"]
    log(f"[phase16] ls960_transformer main --train, 2 steps and the final "
        f"validation: {final}; kernel launches {run}")
    require(rc == 0 and math.isfinite(final["dev_error"]),
            f"transformer main --train: rc {rc}, {final}")
    require(run.get("fused_post_fft", 0) > 0
            and run.get("flash_mhsa_fwd", 0) > 0
            and run.get("flash_mhsa_bwd", 0) > 0,
            f"the transformer path missed a kernel: {run}")
    t = Solver(load_config(TRANSFORMER_CONFIG, TRANSFORMER_OVERRIDES),
               d / "transformer", DEVICE)
    m = t.cfg.model
    require(t.cfg.train.remat_encoder and m.enc_dropout > 0,
            "ls960_transformer ships remat_encoder and enc_dropout")
    _, tensors = first_batch(t)

    def one_step(remat: bool):
        cfg = t.cfg.replace(train=dataclasses.replace(t.cfg.train,
                                                      remat_encoder=remat))
        state = TS.init_train_state(cfg, copy.deepcopy(t.state.model), 0)
        torch.cuda.synchronize()
        before = dict(_native.LAUNCHES)
        t0 = time.perf_counter()
        out = TS.loss_and_grads(cfg, state, *tensors, t.cmvn_dev)
        torch.cuda.synchronize()
        return out, launch_delta(before, _native.LAUNCHES), (
            time.perf_counter() - t0) * 1e3

    (l1, _, g1), on, _ = one_step(True)
    (l0, _, g0), off, ms_off = one_step(False)
    same = bool(torch.equal(l0, l1)) and all(
        torch.equal(a, b) for a, b in zip(g0, g1))
    _, _, ms_on = one_step(True)
    log(f"[phase16] ls960_transformer ({m.enc_blocks} blocks, d_model "
        f"{m.enc_out_dim}, bf16, B={tensors[0].shape[0]}, bucket 1600, "
        f"enc_dropout {m.enc_dropout}), remat_encoder on vs off with the "
        f"same masks: loss {l1.item():.6f} vs {l0.item():.6f}; gradients "
        f"bitwise equal: {same}; launches on {on}, off {off}; step wall "
        f"{ms_on:.1f} ms on, {ms_off:.1f} ms off ({card})")
    require(same, "remat with dropout changes the gradients")
    blocks = m.enc_blocks
    require(on.get("fused_post_fft") == 1
            and on.get("flash_mhsa_fwd") == 2 * blocks
            and off.get("flash_mhsa_fwd") == blocks
            and on.get("flash_mhsa_bwd") == off.get("flash_mhsa_bwd")
            == blocks, f"transformer step launches {on} / {off}")
    return {"launches": run, "ms_on": ms_on, "ms_off": ms_off}


def dropout_draw_ms(card: str) -> dict:
    """Device time of one conformer step's encoder dropout masks
    (ls960_conformer: 4 sites a block, [32, 400, 512] each), drawn for the
    batch alone and, as a rank of two does, for a global batch of 64 with
    its 32 rows kept."""
    import torch

    from semi_supervised_asr_tpu_torch.ops.dropout import draw_keep_masks

    m = conformer_config([]).model
    shapes = [(32, 400, m.enc_out_dim)] * (4 * m.enc_blocks)
    gen = torch.Generator(DEVICE).manual_seed(0)
    one = cuda_ms(lambda: draw_keep_masks(gen, shapes, m.enc_dropout,
                                          DEVICE), reps=5)
    two = cuda_ms(lambda: draw_keep_masks(gen, shapes, m.enc_dropout,
                                          DEVICE, rows=(0, 32, 64)), reps=5)
    log(f"[phase16] conformer encoder dropout masks, {len(shapes)} sites of "
        f"{list(shapes[0])}: {one:.3f} ms device; drawn at a 2-rank global "
        f"shape (64 rows, 32 kept) {two:.3f} ms (CUDA events, median of 5; "
        f"{card})")
    return {"dropout_draw_ms": one, "dropout_draw_dp2_ms": two}


def phase16(d: Path, card: str) -> tuple[dict, dict]:
    """(a) ls100_bpe as shipped through the Solver with a BPE model trained
    in the phase: 3 steps, each step's launches (K1 1, K2 4, K3 4, the
    cluster route), a checkpoint every step, --test beam 5 on the average
    of the 3; one step kernels against plain (SpecAugment bands and time
    warp fixed, dropout off: ls100_bpe sets none) within the bf16 bounds;
    (b) one step with speed perturbation, noise and decoder dropout,
    kernels against plain with the same draws, and grad_accum=2 against
    one step (accum_check); (d) ls960_transformer's remat with dropout
    (transformer_remat); the dropout draw's device time."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    size, merges = train_bpe_model(d)
    log(f"[phase16] BPE trained over the synthetic corpus's text: {size} "
        f"units ({merges} merges) of the {BPE_PIECES} the recipe asks (the "
        "text has no more repeating pairs)")
    cfg = load_config(BPE_CONFIG, [*BPE_DATA, *BPE_RUN,
                                   f"data.bpe_path={d / 'bpe.json'}"])
    s = Solver(cfg, d / "run", DEVICE)
    require(s.vocab.unit == "bpe" and s.vocab.size == size,
            f"the Solver's vocab {s.vocab.unit} {s.vocab.size}")
    require(s.cfg.frontend.time_warp_param == 80, "ls100_bpe's W")
    log(f"[phase16] {BPE_CONFIG.name} at full width (enc "
        f"{s.cfg.model.enc_hidden} x ({s.cfg.model.enc_base_layers} + "
        f"{s.cfg.model.enc_layers}), dec {s.cfg.model.dec_hidden}, B="
        f"{s.cfg.train.batch_size}, {s.cfg.model.compute_dtype}) through "
        f"the Solver; cuts: {BPE_DATA + BPE_RUN}")
    steps, evals, walls = [], [], []
    counting(s, steps, evals, walls)
    _native.reset_launches()
    s.train()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    recs = s.history
    require(len(recs) == len(steps) == 3, f"{len(steps)} ls100_bpe steps")
    for i, (r, st) in enumerate(zip(recs, steps)):
        log(f"[phase16] step {i + 1}: loss {r['loss']:.4f} acc "
            f"{r['acc']:.4f} grad_norm {r['grad_norm']:.4f}; wall "
            f"{walls[i]:.1f} ms; kernel launches {st}")
        require(all(math.isfinite(r[k]) for k in ("loss", "grad_norm")),
                f"ls100_bpe step {i + 1} not finite")
        require_launches(f"ls100_bpe step {i + 1}", st, SOLVER_STEP_LAUNCHES)
    require(s.ckpt.all_steps() == [1, 2, 3],
            f"ls100_bpe checkpoints {s.ckpt.all_steps()}")
    _, avg = s.ckpt.average_params(s.state, s.cfg.decode.average_ckpts)
    test = s.test(mode="beam")
    log(f"[phase16] --test beam {s.cfg.decode.beam_size} on the mean of "
        f"steps {avg}: {test}")
    require(list(avg) == [1, 2, 3], f"averaged steps {avg}")
    require("ter" in test and "wer" in test and test["n_utts"] == len(
        s.bundle.dev) and all(math.isfinite(test[k]) for k in ("ter", "wer")),
        f"ls100_bpe test {test}")
    step_check(s, "phase16", BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)
    opts = variant(s, s.cfg.replace(
        frontend=dataclasses.replace(s.cfg.frontend, **UNSHIPPED),
        model=dataclasses.replace(s.cfg.model, dec_dropout=0.1)))
    log(f"[phase16] the options no shipped config sets: {UNSHIPPED}, "
        "model.dec_dropout 0.1")
    step_check(opts, "phase16", BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)
    del opts
    out = accum_check(s, card)
    out["bpe_step_ms"] = statistics.median(walls[1:])
    out["bpe_units"] = size
    del s
    torch.cuda.empty_cache()
    tr = transformer_remat(d, card)
    out.update(dropout_draw_ms(card))
    out.update(transformer_step_on_ms=tr["ms_on"],
               transformer_step_off_ms=tr["ms_off"])
    log(f"[phase16] summary {json.dumps(out)}")
    return launches, dict(out, transformer_launches=tr["launches"])


# --------------------------------------------------------------------- #
# phase 17: the CTC family (ls100_ctc), the transformer speller (ls960_aed)
# and the LAS joint-CTC head
# --------------------------------------------------------------------- #

class OpCount:
    """Counts the aten operators dispatched inside a ``with`` block (each
    launches at least one kernel on the card)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def same_step_twice(s) -> bool:
    """The same step (weights, batch, SpecAugment bands) run twice: loss
    and every gradient bitwise equal (the CTC and transducer losses'
    backwards have no atomic sums)."""
    import torch

    from semi_supervised_asr_tpu_torch.training import train_step as TS

    batch, tensors = first_batch(s)
    bands = fixed_bands(s, batch, tensors)
    outs = []
    for _ in range(2):
        state = TS.init_train_state(s.cfg, copy.deepcopy(s.state.model), 0)
        outs.append(TS.loss_and_grads(s.cfg, state, *tensors, s.cmvn_dev,
                                      [TS.StepDraws(TS.Draws(specaug=bands))]))
    (la, _, ga), (lb, _, gb) = outs
    return bool(torch.equal(la, lb)) and all(
        torch.equal(a, b) for a, b in zip(ga, gb))


def ctc_loss_ms(s, reps: int = 3) -> tuple[float, tuple]:
    """Wall time of the CTC NLL's forward and backward alone at the step's
    shapes of the Solver ``s``'s first batch (the encoder's output drawn,
    float32, every frame valid: the recursion runs over all T' frames
    either way) -> (median ms, [B, T', e] shape)."""
    import torch

    from semi_supervised_asr_tpu_torch.objectives import losses as LO

    batch, (_, _, tokens, _) = first_batch(s)
    m = s.cfg.model
    t_enc = batch.bucket[0] // m.time_reduction
    mask = torch.ones((tokens.shape[0], t_enc), dtype=torch.bool,
                      device=DEVICE)
    gen = torch.Generator(DEVICE).manual_seed(0)
    enc = torch.randn((tokens.shape[0], t_enc, m.enc_out_dim), device=DEVICE,
                      generator=gen, requires_grad=True)
    ms = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nll, _ = LO.ctc_per_utt_nll(s.state.model.ctc, enc, mask, tokens)
        nll.sum().backward()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms[1:]), tuple(enc.shape)


def phase17_ctc(d: Path, card: str) -> tuple[dict, dict]:
    """(a) configs/ls100_ctc.yaml at full width through the Solver: 3 steps
    with their launches (K1 1, K2 6 under remat, K3 3), a checkpoint at
    step 2 resumed in a fresh workdir to step 3 bitwise, the same step
    twice bitwise, a bf16 step kernels against plain, test by best path
    and by the shipped prefix beam; then the step and the CTC loss alone
    at the 1600-frame bucket (T' = 400)."""
    import shutil

    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.training.checkpointing import (
        Checkpointer,
    )
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    def solver(wd, extra=()):
        return Solver(load_config(CTC_CONFIG, [*CTC_DATA, *CTC_RUN, *extra]),
                      wd, DEVICE)

    run = d / "run"
    s = solver(run)
    m = s.cfg.model
    require(m.family == "ctc" and s.cfg.train.remat_encoder
            and m.enc_layers == 2 and m.compute_dtype == "bfloat16",
            f"ls100_ctc as shipped: {m}")
    log(f"[phase17] {CTC_CONFIG.name} at full width (enc {m.enc_hidden} x "
        f"({m.enc_base_layers} + {m.enc_layers}), {m.compute_dtype}, "
        f"remat_encoder, B={s.cfg.train.batch_size}, vocab {m.vocab_size}) "
        f"through the Solver; cuts: {CTC_DATA + CTC_RUN}")
    steps, evals, walls = [], [], []
    counting(s, steps, evals, walls)
    _native.reset_launches()
    final = s.train()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    recs = s.history
    require(len(recs) == len(steps) == 3, f"{len(steps)} ls100_ctc steps")
    for i, (r, st) in enumerate(zip(recs, steps)):
        log(f"[phase17] ls100_ctc step {i + 1}: loss {r['loss']:.4f} "
            f"nll_per_label {r['nll_per_label']:.4f} grad_norm "
            f"{r['grad_norm']:.4f}; wall {walls[i]:.1f} ms; kernel launches "
            f"{st}")
        require(all(math.isfinite(r[k]) for k in ("loss", "grad_norm")),
                f"ls100_ctc step {i + 1} not finite")
        require_launches(f"ls100_ctc step {i + 1}", st, CTC_STEP_LAUNCHES)
    n_dev = -(-len(s.bundle.dev) // s.cfg.train.batch_size)
    require(len(evals) == 1, f"{len(evals)} validations")
    require_launches("ls100_ctc validation", evals[0][0],
                     {k: n * n_dev for k, n in CTC_EVAL_LAUNCHES.items()})
    log(f"[phase17] ls100_ctc validation (best path, {len(s.bundle.dev)} "
        f"utterances): {final}; kernel launches {evals[0][0]}; run "
        f"launches {launches}")
    require(math.isfinite(final["dev_error"]), f"ls100_ctc dev {final}")
    res = d / "resumed"
    shutil.copytree(run / "checkpoints" / "2", res / "checkpoints" / "2")
    shutil.copy(run / "cmvn.npz", res / "cmvn.npz")
    solver(res).train(resume=True)
    sd_a, meta_a, _ = Checkpointer(run / "checkpoints").load(3)
    sd_b, meta_b, _ = Checkpointer(res / "checkpoints").load(3)
    diff = first_difference(sd_a, sd_b)
    log(f"[phase17] ls100_ctc resumed from step 2 in a fresh workdir: step "
        f"3's state {'bitwise equal' if diff is None else 'differs at ' + diff}"
        f"; data_pos {meta_b['data_pos']} vs {meta_a['data_pos']}")
    require(diff is None and meta_a["data_pos"] == meta_b["data_pos"],
            f"ls100_ctc resume differs at {diff}")
    del sd_a, sd_b
    same = same_step_twice(s)
    log(f"[phase17] ls100_ctc: the same step twice, loss and every gradient "
        f"bitwise equal: {same}")
    require(same, "two runs of one ls100_ctc step differ")
    step_check(s, "phase17", BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)
    out = {"ctc_step_ms": statistics.median(walls[1:])}
    for mode, what in (("greedy", "best path (--beam 1)"),
                       ("beam", f"prefix beam {s.cfg.decode.beam_size}")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        test = s.test(mode=mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[f"ctc_test_{mode}_ms"] = ms
        log(f"[phase17] ls100_ctc --test {what} on the dev batch "
            f"({len(s.bundle.dev)} utterances in {n_dev} batch of "
            f"{s.cfg.train.batch_size}): {test}; {ms:.1f} ms wall ({card})")
        require(test["n_utts"] == len(s.bundle.dev)
                and math.isfinite(test["cer"]), f"ls100_ctc test {test}")
    del s
    torch.cuda.empty_cache()
    big = solver(d / "t1600", ["data.frame_buckets=[1600]"])
    lab = big._labeled_stream()
    walls_1600 = []
    for _ in range(3):
        args, unlab = big.step_inputs(next(lab)[2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big.run_step(args, unlab)
        torch.cuda.synchronize()
        walls_1600.append((time.perf_counter() - t0) * 1e3)
    loss_ms, shape = ctc_loss_ms(big)
    out.update(ctc_step_1600_ms=statistics.median(walls_1600[1:]),
               ctc_loss_1600_ms=loss_ms)
    out["ctc_loss_share_1600"] = loss_ms / out["ctc_step_1600_ms"]
    log(f"[phase17] ls100_ctc at the 1600-frame bucket: step "
        f"{out['ctc_step_1600_ms']:.1f} ms wall (median of steps 2-3); the "
        f"CTC NLL's forward + backward alone at enc {list(shape)}, labels "
        f"[{shape[0]}, 128]: {loss_ms:.1f} ms wall (median of 3), "
        f"{out['ctc_loss_share_1600']:.3f} of the step; at bucket 400 the "
        f"step takes {out['ctc_step_ms']:.1f} ms ({card})")
    return launches, out


def aed_first_dev_batch(t):
    from semi_supervised_asr_tpu_torch.data import pipeline as pipe

    return next(iter(pipe.epoch_batches(
        t.bundle.dev, t.spec, t.cfg.frontend, t.cfg.train.batch_size,
        seed=0, epoch=0, drop_remainder=False)))


def phase17_aed(d: Path, card: str) -> tuple[dict, dict]:
    """(b) configs/ls960_aed.yaml at full width: ``main --train`` for 3
    steps and the final validation (K1 launched, K5 not), the teacher
    pass's operator count at U=64 and U=128 (equal: one parallel pass),
    greedy and beam-5 decoding of one dev batch (wall time, peak memory,
    KV-cache bytes, the beam's cache reorder), and the step's write into
    the KV cache by index against the reference's one-hot form (equal
    logits)."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch import main as M
    from semi_supervised_asr_tpu_torch import transcribe as TR
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.models.transformer_speller import (
        TransformerSpeller,
    )
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    wd = d / "aed"
    _native.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as so:
        rc = M.main(["--config", str(AED_CONFIG), "--train", "--workdir",
                     str(wd), *AED_OVERRIDES, *AED_RUN])
    torch.cuda.synchronize()
    run = {k: v for k, v in _native.LAUNCHES.items() if v}
    final = json.loads(so.getvalue().strip().splitlines()[-1])["final_dev"]
    recs = [r for r in read_records(wd) if r.get("prefix") == "train"]
    step_ms = [1e3 / r["steps_per_sec"] for r in recs]
    t = Solver(load_config(AED_CONFIG, AED_OVERRIDES), wd, DEVICE)
    m = t.cfg.model
    log(f"[phase17] {AED_CONFIG.name} at full width ({m.enc_blocks} encoder "
        f"blocks x {m.enc_out_dim}, {m.dec_blocks} decoder blocks x "
        f"{m.dec_hidden}, dec_max_len {m.dec_max_len}, tied embedding "
        f"{m.tie_embedding}, {m.compute_dtype}, enc/dec dropout "
        f"{m.enc_dropout}/{m.dec_dropout}, attn_backend {m.attn_backend}); "
        f"cut: one chip's batch of {t.cfg.train.batch_size} (the recipe's "
        f"256 is global over a mesh), synthetic data; {AED_OVERRIDES}")
    for i, (r, ms) in enumerate(zip(recs, step_ms)):
        log(f"[phase17] ls960_aed step {i + 1}: loss {r['loss']:.4f} ce "
            f"{r['ce']:.4f} grad_norm {r['grad_norm']:.4f}; {ms:.1f} ms wall "
            f"(the log interval)")
    log(f"[phase17] ls960_aed main --train, {len(recs)} steps and the final "
        f"validation: {final}; kernel launches {run}")
    require(rc == 0 and len(recs) == 3 and math.isfinite(final["dev_error"])
            and all(math.isfinite(r["loss"]) for r in recs),
            f"ls960_aed main --train: rc {rc}, {final}")
    require(run.get("fused_post_fft", 0) > 0
            and run.get("flash_mhsa_fwd", 0) == 0
            and run.get("flash_mhsa_bwd", 0) == 0,
            f"ls960_aed launches {run}: K1 must run and K5 must not")
    model = t.eval_params()
    speller = model.speller
    gen = torch.Generator(DEVICE).manual_seed(0)
    t_enc = 800 // m.time_reduction
    enc = torch.randn((32, t_enc, m.enc_out_dim), device=DEVICE,
                      generator=gen)
    mask = torch.ones((32, t_enc), dtype=torch.bool, device=DEVICE)
    ops = {}
    for u in (64, 128):
        tokens = torch.randint(3, m.vocab_size, (32, u), device=DEVICE,
                               generator=gen)
        with OpCount() as c:
            logits, _ = speller.forward_teacher(enc, mask, tokens)
        logits.float().sum().backward()
        ops[u] = c.n
    log(f"[phase17] ls960_aed teacher pass, operators dispatched (each "
        f"launches >= 1 kernel): U=64 {ops[64]}, U=128 {ops[128]}")
    require(ops[64] == ops[128], f"the teacher pass grows with U: {ops}")
    model.zero_grad(set_to_none=True)
    rec = TR.Recognizer(t.cfg, model, t.cmvn, t.vocab, torch.device(DEVICE))
    batch = aed_first_dev_batch(t)
    out = {"aed_step_ms": statistics.median(step_ms[1:])}
    t_dev = batch.bucket[0] // m.time_reduction
    max_u = TR.max_decode_steps(t.cfg, t_dev)
    b = batch.audio.shape[0]
    for mode, k in (("greedy", 1), ("beam", t.cfg.decode.beam_size)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        hyps, _ = rec.decode(batch.audio, batch.audio_lens, mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        cache = 2 * b * k * m.dec_blocks * max_u * m.dec_hidden * 4
        out[f"aed_{mode}_ms"] = ms
        log(f"[phase17] ls960_aed {mode} (beam {k}) on one dev batch of {b} "
            f"rows ({len(t.bundle.dev)} real), {max_u} steps: {ms:.1f} ms "
            f"wall, peak memory {peak:.1f} MiB above the model, KV cache "
            f"{cache / 2**20:.1f} MiB (k and v, float32) ({card})")
        require(hyps.shape == (b, max_u), f"{mode} hypotheses {hyps.shape}")
    # the beam's reorder of the cache leaves, one step
    state = speller.init_state(b * t.cfg.decode.beam_size, mask, max_u)
    rows = torch.arange(state["kv_k"].shape[0], device=DEVICE).flip(0)
    reorder = cuda_ms(lambda: {n: v.index_select(0, rows)
                               for n, v in state.items()}, reps=5)
    out["aed_beam_reorder_ms"] = reorder
    log(f"[phase17] ls960_aed beam: one step's reorder of the KV cache "
        f"({2 * state['kv_k'].numel() * 4 / 2**20:.1f} MiB) {reorder:.3f} ms "
        f"device (CUDA events, median of 5), x {max_u} steps a batch "
        f"({card})")
    del state
    # the cache write: by index against the reference's one-hot where
    with torch.inference_mode():
        cache_kv = speller.precompute_decode_cache(enc)
        logits = {}
        for name, write in (("index", TransformerSpeller.write_kv),
                            ("onehot", onehot_write)):
            st = speller.init_state(32, mask, 16)
            toks = torch.full((32,), 1, dtype=torch.int32, device=DEVICE)
            seq = []
            with mock_attr(TransformerSpeller, "write_kv",
                           staticmethod(write)):
                for _ in range(16):
                    st, lg, _ = speller.step(st, toks, cache_kv, enc, mask)
                    toks = lg.argmax(-1).to(torch.int32)
                    seq.append(lg)
            logits[name] = torch.stack(seq)
    same = bool(torch.equal(logits["index"], logits["onehot"]))
    log(f"[phase17] ls960_aed KV-cache write by index vs the reference's "
        f"one-hot where, 16 greedy steps at B=32: logits bitwise equal "
        f"{same}")
    require(same, "the KV-cache write by index changes the logits")
    return run, out


def onehot_write(kv, li, pos, new):
    """The reference's cache write: a one-hot ``where`` over every slot."""
    import torch

    hit = torch.arange(kv.shape[2], device=kv.device)[None, :] \
        == pos[:, None]
    kv[:, li] = torch.where(hit[..., None], new[:, None, :], kv[:, li])


@contextlib.contextmanager
def mock_attr(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def phase17_joint(d: Path, card: str) -> dict:
    """(c) LAS with the joint CTC head at timit width
    (``objective.lambda_ctc=0.3``): one step through the Solver, beam 5
    with ``decode.ctc_weight=0.3`` (n-best rescoring) and with
    ``decode.ctc_one_pass``, and ``main --test --beam 0``."""
    import torch

    from semi_supervised_asr_tpu_torch import main as M
    from semi_supervised_asr_tpu_torch.config import load_config

    over = [*TRAIN_OVERRIDES, "objective.lambda_ctc=0.3"]
    s = short_solver(load_config(CONFIG, over), d / "joint", steps=1)
    steps, evals, walls = [], [], []
    counting(s, steps, evals, walls)
    s.train()
    r = s.history[0]
    log(f"[phase17] timit + objective.lambda_ctc=0.3 ("
        f"{s.cfg.model.compute_dtype}, B={s.cfg.train.batch_size}): step 1 "
        f"loss {r['loss']:.4f} ce {r['ce']:.4f} ctc {r['ctc']:.4f}; wall "
        f"{walls[0]:.1f} ms; kernel launches {steps[0]}")
    require(all(math.isfinite(r[k]) for k in ("loss", "ce", "ctc")),
            f"joint step not finite: {r}")
    require_launches("joint-CTC step", steps[0], SOLVER_STEP_LAUNCHES)
    out = {}
    for name, kw in (("rescoring", {"ctc_weight": 0.3}),
                     ("one_pass", {"ctc_weight": 0.3, "ctc_one_pass": True})):
        v = copy.copy(s)
        v.cfg = s.cfg.replace(decode=dataclasses.replace(
            s.cfg.decode, beam_size=5, **kw))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        test = v.test(mode="beam")
        torch.cuda.synchronize()
        out[f"joint_{name}_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"[phase17] joint CTC-attention beam 5, {name} {kw}: {test}; "
            f"{out[f'joint_{name}_ms']:.1f} ms wall ({card})")
        require(math.isfinite(test["per"]), f"joint {name}: {test}")
    with contextlib.redirect_stdout(io.StringIO()) as so:
        rc = M.main(["--config", str(CONFIG), "--test", "--load-dir",
                     str(d / "joint"), "--beam", "0", *over])
    test = json.loads(so.getvalue().strip().splitlines()[-1])
    log(f"[phase17] main --test --beam 0 (the CTC head's best path): {test}")
    require(rc == 0 and test["mode"] == "ctc" and math.isfinite(test["per"]),
            f"--beam 0: rc {rc}, {test}")
    return out


def phase17(d: Path, card: str) -> tuple[dict, dict, dict]:
    """Phase 17: (a) ls100_ctc, (b) ls960_aed, (c) the joint-CTC head ->
    (ls100_ctc's launches, ls960_aed's, the numbers)."""
    import torch

    ctc_launches, out = phase17_ctc(d / "ctc", card)
    torch.cuda.empty_cache()
    aed_launches, aed = phase17_aed(d, card)
    out.update(aed)
    torch.cuda.empty_cache()
    out.update(phase17_joint(d, card))
    log(f"[phase17] summary {json.dumps(out)}")
    return ctc_launches, aed_launches, out


def td_solver(config: Path, d: Path, extra=()):
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    return Solver(load_config(config, [*TD_DATA, *extra]), d, DEVICE)


def td_run(s, what: str, want: dict, eval_want: dict | None,
           routes: dict | None = None, eval_routes: dict | None = None
           ) -> tuple[dict, list, list, list, dict]:
    """``s.train()`` with each step's launches (``want``, by route
    ``routes``: default all on the cluster route), wall time and peak
    memory, and its one validation's launches (``eval_want`` a dev batch)
    -> (the run's launches, the steps' records, walls, peaks, the final
    validation)."""
    import torch

    from semi_supervised_asr_tpu_torch import _native

    steps, evals, walls, peaks = [], [], [], []
    counting(s, steps, evals, walls, peaks)
    _native.reset_launches()
    final = s.train()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    recs = s.history
    require(len(recs) == len(steps) == s.cfg.train.total_steps,
            f"{what}: {len(steps)} steps")
    keys = [k for k in ("loss", "nll_per_label", "text_ilm", "pseudo",
                        "pseudo_gate", "grad_norm") if k in recs[0]]
    for i, (r, st) in enumerate(zip(recs, steps)):
        log(f"[phase18] {what} step {i + 1}: "
            + " ".join(f"{k} {r[k]:.4f}" for k in keys)
            + f"; wall {walls[i]:.1f} ms; peak memory {peaks[i]:.2f} GiB; "
            f"kernel launches {st}")
        require(all(math.isfinite(r[k]) for k in keys),
                f"{what} step {i + 1} not finite")
        require_launches(f"{what} step {i + 1}", st, want, routes)
    n_dev = -(-len(s.bundle.dev) // s.cfg.train.batch_size)
    require(len(evals) == 1, f"{what}: {len(evals)} validations")
    scale = {k: n * n_dev for k, n in (eval_want or {}).items()}
    require_launches(f"{what} validation", evals[0][0], scale,
                     eval_routes and {k: n * n_dev
                                      for k, n in eval_routes.items()})
    log(f"[phase18] {what} validation (greedy, {len(s.bundle.dev)} "
        f"utterances in {n_dev} batch): {final}; kernel launches "
        f"{evals[0][0]}; run launches {launches}")
    require(math.isfinite(final["dev_error"]), f"{what} dev {final}")
    return launches, recs, walls, peaks, final


def td_test(s, mode: str, what: str, card: str, beam: int | None = None
            ) -> float:
    """``Solver.test`` (``main --test``) on the dev set by ``mode``, the
    beam at ``beam`` -> host ms; the error rate must be finite."""
    import torch

    cfg = s.cfg
    if beam is not None:
        s.cfg = dataclasses.replace(cfg, decode=dataclasses.replace(
            cfg.decode, beam_size=beam))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = s.test(mode=mode)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    s.cfg = cfg
    log(f"[phase18] {what} --test {mode}"
        f"{'' if beam is None else f' {beam}'} on the dev set "
        f"({len(s.bundle.dev)} utterances): {out}; {ms:.1f} ms wall "
        f"({card})")
    require(out["n_utts"] == len(s.bundle.dev) and math.isfinite(out["cer"]),
            f"{what} test {out}")
    return ms


def lattice_ms(s, reps: int = 3) -> tuple[float, float, tuple]:
    """Wall ms of the transducer loss's forward + backward at the step
    shapes of the Solver ``s``'s first batch (every frame and label
    valid: the passes run over every diagonal either way): the lattice
    Function alone on drawn terms, and the joint grid + lattice terms +
    Function on the model's joint -> (Function ms, whole loss ms, [B, T',
    U + 1])."""
    import torch

    from semi_supervised_asr_tpu_torch.models import transducer as TDM
    from semi_supervised_asr_tpu_torch.objectives import transducer_loss as TL

    batch, (_, _, tokens, _) = first_batch(s)
    m = s.cfg.model
    b, u = tokens.shape
    t_enc = batch.bucket[0] // m.time_reduction
    gen = torch.Generator(DEVICE).manual_seed(0)
    enc_lens = torch.full((b,), t_enc, dtype=torch.int32, device=DEVICE)
    label_lens = torch.full((b,), u, dtype=torch.int32, device=DEVICE)
    labels = torch.randint(4, m.vocab_size, (b, u), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    terms = [torch.log_softmax(torch.randn((b, t_enc, u + 1, 2),
                                           generator=gen, device=DEVICE),
                               -1)[..., i].requires_grad_(True)
             for i in range(2)]
    enc = torch.randn((b, t_enc, m.enc_out_dim), generator=gen,
                      device=DEVICE, requires_grad=True)
    pred = torch.randn((b, u + 1, m.pred_hidden), generator=gen,
                       device=DEVICE, requires_grad=True)

    joint = s.state.model.joint

    def lattice():
        loss, _ = TL.transducer_loss_from_parts(*terms, enc_lens, label_lens)
        torch.autograd.grad(loss, terms)

    def whole():
        logits = TDM.joint_logits(joint, enc, pred, m)
        loss, _ = TL.transducer_loss(logits, enc_lens, labels, label_lens)
        torch.autograd.grad(loss, [enc, pred, *joint.parameters()])

    out = []
    for fn in (lattice, whole):
        ms = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out.append(statistics.median(ms[1:]))
    return out[0], out[1], (b, t_enc, u + 1)


def phase18_td(d: Path, card: str) -> tuple[dict, dict]:
    """(a) configs/ls100_transducer.yaml at full width through the Solver:
    3 steps (K1 1, K2 9, K3 5 under remat), the greedy validation, step 2's
    checkpoint resumed in a fresh workdir to step 3 bitwise, the same step
    twice bitwise, a bf16 and a float32 step kernels against plain, test
    greedy and beam 4; then a step and the loss alone at the 1600-frame /
    256-token bucket with its peak memory."""
    import shutil

    import torch

    from semi_supervised_asr_tpu_torch.training.checkpointing import (
        Checkpointer,
    )

    run = d / "run"
    s = td_solver(TD_CONFIG, run, TD_RUN)
    m = s.cfg.model
    require(m.family == "transducer" and s.cfg.train.remat_encoder
            and m.enc_layers == 3 and m.pred_hidden == 512
            and m.joint_dim == 512 and m.compute_dtype == "bfloat16",
            f"ls100_transducer as shipped: {m}")
    log(f"[phase18] {TD_CONFIG.name} at full width (enc {m.enc_hidden} x "
        f"({m.enc_base_layers} + {m.enc_layers}), pred {m.pred_hidden}, "
        f"joint {m.joint_dim}, embed {m.embed_dim}, {m.compute_dtype}, "
        f"remat_encoder, B={s.cfg.train.batch_size}, vocab {m.vocab_size}) "
        f"through the Solver; cuts: {TD_DATA + TD_RUN}")
    launches, _, walls, peaks, _ = td_run(s, "ls100_transducer",
                                          TD_STEP_LAUNCHES, TD_EVAL_LAUNCHES)
    res = d / "resumed"
    shutil.copytree(run / "checkpoints" / "2", res / "checkpoints" / "2")
    shutil.copy(run / "cmvn.npz", res / "cmvn.npz")
    td_solver(TD_CONFIG, res, TD_RUN).train(resume=True)
    sd_a, meta_a, _ = Checkpointer(run / "checkpoints").load(3)
    sd_b, meta_b, _ = Checkpointer(res / "checkpoints").load(3)
    diff = first_difference(sd_a, sd_b)
    log(f"[phase18] ls100_transducer resumed from step 2 in a fresh "
        f"workdir: step 3's state "
        f"{'bitwise equal' if diff is None else 'differs at ' + diff}; "
        f"data_pos {meta_b['data_pos']} vs {meta_a['data_pos']}")
    require(diff is None and meta_a["data_pos"] == meta_b["data_pos"],
            f"ls100_transducer resume differs at {diff}")
    del sd_a, sd_b
    same = same_step_twice(s)
    log(f"[phase18] ls100_transducer: the same step twice, loss and every "
        f"gradient bitwise equal: {same}")
    require(same, "two runs of one ls100_transducer step differ")
    step_check(s, "phase18", BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)
    step_check(td_solver(TD_CONFIG, d / "f32",
                         [*TD_RUN, "model.compute_dtype=float32"]),
               "phase18")
    out = {"td_step_ms": statistics.median(walls[1:]),
           "td_step_peak_gib": max(peaks)}
    out["td_test_greedy_ms"] = td_test(s, "greedy", "ls100_transducer",
                                       card)
    out["td_test_beam4_ms"] = td_test(s, "beam", "ls100_transducer", card,
                                      beam=4)
    del s
    torch.cuda.empty_cache()
    big = td_solver(TD_CONFIG, d / "t1600",
                    ["data.frame_buckets=[1600]", "data.token_buckets=[256]"])
    lab = big._labeled_stream()
    walls_1600, peaks_1600 = [], []
    for _ in range(3):
        args, unlab = big.step_inputs(next(lab)[2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        big.run_step(args, unlab)
        torch.cuda.synchronize()
        walls_1600.append((time.perf_counter() - t0) * 1e3)
        peaks_1600.append(torch.cuda.max_memory_allocated() / 2**30)
    lat_ms, whole_ms, shape = lattice_ms(big)
    out.update(td_step_1600_ms=statistics.median(walls_1600[1:]),
               td_step_1600_peak_gib=max(peaks_1600),
               td_lattice_1600_ms=lat_ms, td_loss_1600_ms=whole_ms)
    out["td_lattice_share_1600"] = lat_ms / out["td_step_1600_ms"]
    out["td_loss_share_1600"] = whole_ms / out["td_step_1600_ms"]
    log(f"[phase18] ls100_transducer at the 1600-frame / 256-token bucket: "
        f"step {out['td_step_1600_ms']:.1f} ms wall (median of steps 2-3), "
        f"peak memory {out['td_step_1600_peak_gib']:.2f} GiB; the lattice "
        f"Function's forward + backward alone at [B, T', U+1] = "
        f"{list(shape)}: {lat_ms:.1f} ms wall (median of 3), "
        f"{out['td_lattice_share_1600']:.3f} of the step; the joint grid + "
        f"lattice terms + Function: {whole_ms:.1f} ms, "
        f"{out['td_loss_share_1600']:.3f} of the step; at bucket 400 the "
        f"step takes {out['td_step_ms']:.1f} ms, peak "
        f"{out['td_step_peak_gib']:.2f} GiB ({card})")
    return launches, out


def phase18_semi(d: Path, card: str) -> tuple[dict, dict]:
    """(b) configs/ls100_transducer_semi.yaml at full width through the
    Solver: 3 steps with labeled, unlabeled-audio and text batches of 64
    (K1 3, K2 19, K3 11), the gate open from step 2; a bf16 step from the
    trained weights and a float32 step from fresh ones, kernels against
    plain; test beam 4 and the 4-best of one dev batch."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import transcribe as TR
    from semi_supervised_asr_tpu_torch.data import pipeline as pipe

    s = td_solver(TD_SEMI_CONFIG, d / "semi", TD_SEMI_RUN)
    o = s.cfg.objective
    require(o.lambda_text_ae > 0 and o.lambda_pseudo > 0
            and o.use_ema_teacher and s.cfg.decode.beam_size == 4,
            f"ls100_transducer_semi as shipped: {o}")
    log(f"[phase18] {TD_SEMI_CONFIG.name} at full width, B=64, bf16, "
        f"through the Solver; cuts: {TD_DATA + TD_SEMI_RUN}")
    launches, recs, walls, peaks, _ = td_run(
        s, "ls100_transducer_semi", TD_SEMI_LAUNCHES, TD_EVAL_LAUNCHES)
    require([r["pseudo_gate"] for r in recs] == [0.0, 1.0, 1.0],
            "the pseudo-label gate did not open after step 1")
    semi_step_check(s, BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL, "phase18")
    semi_step_check(td_solver(TD_SEMI_CONFIG, d / "semi_f32", [
        *TD_SEMI_RUN, "model.compute_dtype=float32"]), phase="phase18")
    torch.cuda.empty_cache()
    out = {"td_semi_step_ms": statistics.median(walls[1:]),
           "td_semi_step_peak_gib": max(peaks)}
    out["td_semi_test_beam4_ms"] = td_test(s, "beam",
                                           "ls100_transducer_semi", card)
    rec = TR.Recognizer(s.cfg, s.state.model, s.cmvn, s.vocab,
                        torch.device(DEVICE))
    batch = next(iter(pipe.epoch_batches(
        s.bundle.dev, s.spec, s.cfg.frontend, s.cfg.train.batch_size,
        seed=0, epoch=0, drop_remainder=False)))
    hyps, scores = rec.decode(batch.audio, batch.audio_lens, "beam",
                              nbest=True)
    log(f"[phase18] ls100_transducer_semi 4-best of a dev batch: tokens "
        f"{hyps.shape}, scores of row 0 {scores[0].tolist()}")
    require(hyps.shape[1] == 4 and np.isfinite(scores).all()
            and (np.diff(scores, axis=1) <= 0).all(),
            "the 4-best is not sorted best first")
    return launches, out


def td_lstm_shapes(times: dict, errs: dict, card: str,
                   shapes: tuple = TD_LSTM_SHAPES, b: int = 64,
                   phase: str = "phase18") -> None:
    """K2 and K3 at ``shapes`` (D=1, B=``b``, bf16; TD_LSTM_SHAPES at B=64
    by default): each against its plain version (bf16 bound) with the
    path's masking (the listener's
    ragged rows with a zero-length one), and the route each launch took;
    then, with every step valid, so that the work is the T x B steps that
    ``bounds`` counts: the device time of each by CUDA events over
    back-to-back calls, the plain version's call time, and cuDNN's
    one-direction layer forward and backward (training forward + backward
    minus training forward) beside the port's layer (projection + K2; K3
    + the dW_hh product + the projection's backward), CUDA events over
    back-to-back calls."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
    from semi_supervised_asr_tpu_torch.ops import recurrent as R

    bf16 = torch.bfloat16
    tol_f = tol_b = BF16_TOL
    for tag, t, i, h, full in shapes:
        x, w_ih, bias, w_hh, valid = k2_inputs(t, i, 18, b=b, h=h)
        w_ih, bias, w_hh = w_ih[:, :4 * h], bias[:4 * h], w_hh[:1]
        if full:
            valid = torch.ones_like(valid)
        with torch.inference_mode():
            gx = (R.mm(x, w_ih, bf16) + bias).transpose(0, 1)[None]
            gx = gx.contiguous()
        g = torch.Generator().manual_seed(19)
        dh_out = torch.randn((1, t, b, h), generator=g).to(DEVICE)
        fwd = (gx, w_hh, valid, bf16, (False,))
        _native.reset_launches()
        with torch.inference_mode():
            got = K.lstm_scan(*fwd, residuals=True)
            torch.cuda.synchronize()
            want = K.lstm_scan_reference(*fwd, residuals=True)
        route_f = [k for k in ("cluster", "grid", "simt")
                   if _native.LAUNCHES[f"lstm_scan_fwd_{k}"]]
        err_f = max((a - b).abs().max().item() for a, b in zip(got, want))
        bwd = (w_hh, valid, got[3], got[2], dh_out, bf16, (False,))
        with torch.inference_mode():
            dg = K.lstm_scan_bwd(*bwd)
            torch.cuda.synchronize()
            dg_want = K.lstm_scan_bwd_reference(*bwd)
        route_b = [k for k in ("cluster", "grid", "simt")
                   if _native.LAUNCHES[f"lstm_scan_bwd_{k}"]]
        err_b = (dg - dg_want).abs().max().item()
        log(f"[{phase}] K2 at {tag} (D=1, B={b}, T={t}, H={h}, "
            f"{str(bf16)[6:]}, {route_f} route): h, hprev, cprev, acts "
            f"max_abs_err {err_f:.3e} (tol {tol_f:g}); K3 ({route_b} "
            f"route): dgates max_abs_err {err_b:.3e} (tol {tol_b:g})")
        require(err_f <= tol_f and err_b <= tol_b,
                f"K2/K3 at {tag} differ from plain: {err_f}, {err_b}")
        want_route = "grid" if h > K.CLUSTER_MAX_HIDDEN else "cluster"
        require(route_f == route_b == [want_route],
                f"K2/K3 at {tag} took the routes {route_f}, {route_b}")
        errs[tag] = (err_f, err_b, route_f[0])
        del got, want, dg, dg_want
        if not full:
            # the timing runs every step of every row
            valid = torch.ones_like(valid)
            fwd = (gx, w_hh, valid, bf16, (False,))
            with torch.inference_mode():
                got = K.lstm_scan(*fwd, residuals=True)
            bwd = (w_hh, valid, got[3], got[2], dh_out, bf16, (False,))
            del got
        with torch.inference_mode():
            for fn, key in (
                    (lambda: K.lstm_scan_reference(*fwd), "fwd_plain_call"),
                    (lambda: K.lstm_scan(*fwd), "fwd_b2b"),
                    (lambda: K.lstm_scan_bwd_reference(*bwd),
                     "bwd_plain_call"),
                    (lambda: K.lstm_scan_bwd(*bwd), "bwd_b2b"),
                    (lambda: K.lstm_scan(*fwd), "fwd_b2b"),
                    (lambda: K.lstm_scan_bwd(*bwd), "bwd_b2b")):
                ms = (back_to_back_ms(fn, reps=4) if key.endswith("b2b")
                      else cuda_ms(fn, reps=1, warmup=0))
                times.setdefault(f"td_{tag}_{key}", []).append(ms)
            if h > K.CLUSTER_MAX_HIDDEN:
                grid_floors(times, tag, t, h)
            if tag == "listener_t1600":
                grid_sweep(times, tag, fwd, bwd, h)
        del fwd, bwd, gx
        # the library column: cuDNN's layer against the port's, like with
        # like (input projection included), forward and backward
        mod, packed, dtype = cudnn_lstm(x, w_ih, bias, w_hh, valid, (bf16,))
        require(dtype == bf16, f"cuDNN's layer at {tag} ran in {dtype}")
        leaves = [a.detach().clone().requires_grad_(True)
                  for a in (x, w_ih, w_hh[0], bias)]
        lens = valid.sum(0).to(torch.int32)

        def port_fwd():
            xg, wi, wh, bb = leaves
            # the listener's layer takes lengths (all T here), the
            # predictor's none
            return K.lstm_kernel({"w_ih": wi, "w_hh": wh, "b": bb}, xg,
                                 None if full else lens, False, bf16)

        def cudnn_fwd():
            return mod(packed)[0].data

        for name, fn, params in (("port", port_fwd, leaves),
                                 ("cudnn", cudnn_fwd,
                                  [packed.data, *mod.parameters()])):
            dy = torch.randn_like(fn())
            with torch.no_grad():
                f_ms = back_to_back_ms(fn, reps=4)
            ft_ms = back_to_back_ms(fn, reps=4)
            both = back_to_back_ms(
                lambda: torch.autograd.grad(fn(), params, dy), reps=4)
            times.setdefault(f"td_{tag}_{name}_layer_fwd_b2b", []).append(
                f_ms)
            times.setdefault(f"td_{tag}_{name}_layer_bwd_b2b", []).append(
                both - ft_ms)
        del mod, packed, leaves, x
        torch.cuda.empty_cache()


def f32_scan_times(times: dict, errs: dict, shape: tuple, b: int,
                   card: str, phase: str = "phase21") -> None:
    """K2 and K3 in float32 at ``shape`` (tag, T, input width, H, D, every
    step valid) and B=``b``: each against its plain version (K2_TOL /
    K3_TOL) with the path's masking (ragged rows with a zero-length one
    unless every step is valid) on its planned route, the float32 grid
    (checked by the launch counts); then, with every step valid: the
    device time of each on the float32 grid and forced onto the CUDA
    cores, in turns (grid, CUDA cores, CUDA cores, grid; CUDA events over
    back-to-back calls), the grid's serial floor (the exchange and the
    barrier alone) and the barrier alone, the plain version's call time,
    and cuDNN's float32 layer forward and backward (training forward +
    backward minus training forward) beside the port's (projection + K2;
    K3 + the dW_hh product + the projection's backward), one direction or
    both as D says."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
    from semi_supervised_asr_tpu_torch.ops import recurrent as R

    f32 = torch.float32
    tag, t, i, h, d, full = shape
    rev = (False, True)[:d]
    x, w_ih, bias, w_hh, valid = k2_inputs(t, i, 18, b=b, h=h)
    if d == 1:
        w_ih, bias, w_hh = w_ih[:, :4 * h], bias[:4 * h], w_hh[:1]
    g = torch.Generator().manual_seed(19)
    dh_out = torch.randn((d, t, b, h), generator=g).to(DEVICE)
    plans = [K.cluster_plan(k, h, b, f32, d) for k in ("fwd", "bwd")]
    require(all(p.route == "grid_f32" for p in plans),
            f"float32 at {tag} is not planned on the float32 grid: {plans}")
    if full:
        valid = torch.ones_like(valid)
    with torch.inference_mode():
        gx = (R.mm(x, w_ih, f32) + bias).view(b, t, d, 4 * h)
        gx = gx.permute(2, 1, 0, 3).contiguous()
        fwd = (gx, w_hh, valid, f32, rev)
        got, _ = routed("fwd", f32, lambda: K.lstm_scan(
            *fwd, residuals=True), "grid_f32")
        bwd = (w_hh, valid, got[3], got[2], dh_out, f32, rev)
        dg, _ = routed("bwd", f32, lambda: K.lstm_scan_bwd(*bwd),
                       "grid_f32")
        torch.cuda.synchronize()
        want = K.lstm_scan_reference(*fwd, residuals=True)
        dg_want = K.lstm_scan_bwd_reference(*bwd)
    err_f = max((a - c).abs().max().item() for a, c in zip(got, want))
    err_b = (dg - dg_want).abs().max().item()
    log(f"[{phase}] K2 at {tag} (D={d}, B={b}, T={t}, H={h}, float32, "
        f"grid_f32 route: u={plans[0].units} G={plans[0].groups} "
        f"chunk={plans[0].chunk} stages={plans[0].stages}): h, hprev, "
        f"cprev, acts max_abs_err {err_f:.3e} (tol {K2_TOL:g}); K3 "
        f"(chunk={plans[1].chunk} stages={plans[1].stages}): dgates "
        f"max_abs_err {err_b:.3e} (tol {K3_TOL:g})")
    require(err_f <= K2_TOL and err_b <= K3_TOL,
            f"K2/K3 at {tag} differ from plain: {err_f}, {err_b}")
    errs[tag] = (err_f, err_b, "grid_f32")
    del got, want, dg, dg_want
    # the timings run every step of every row
    key = f"td_{tag}_"
    valid = torch.ones_like(valid)
    fwd = (gx, w_hh, valid, f32, rev)
    with torch.inference_mode():
        got = K.lstm_scan(*fwd, residuals=True)
        bwd = (w_hh, valid, got[3], got[2], dh_out, f32, rev)
        del got
        for route in ("grid_f32", "simt", "simt", "grid_f32"):
            sfx = "" if route == "grid_f32" else "simt_"
            with (forced_plan(simt_plan) if route == "simt"
                  else contextlib.nullcontext()):
                for kind, fn in (("fwd", lambda: K.lstm_scan(*fwd)),
                                 ("bwd", lambda: K.lstm_scan_bwd(*bwd))):
                    times.setdefault(f"{key}{kind}_{sfx}b2b", []).append(
                        back_to_back_ms(fn, reps=4))
        for fn, name in ((lambda: K.lstm_scan_reference(*fwd), "fwd"),
                         (lambda: K.lstm_scan_bwd_reference(*bwd), "bwd")):
            times.setdefault(f"{key}{name}_plain_call", []).append(
                cuda_ms(fn, reps=1, warmup=0))
    for kind, plan in zip(("fwd", "bwd"), plans):
        for name, read in (("floor", True), ("barrier", False)):
            times.setdefault(f"{key}{name}_{kind}_b2b", []).append(
                back_to_back_ms(lambda: K.exchange_floor(
                    kind, plan, d, t, b, torch.device(DEVICE), h, read),
                    reps=4))
    del fwd, bwd, gx
    # the library column: cuDNN's float32 layer against the port's, like
    # with like (input projection included), forward and backward
    mod, packed, dtype = cudnn_lstm(x, w_ih, bias, w_hh, valid, (f32,))
    require(dtype == f32, f"cuDNN's layer at {tag} ran in {dtype}")
    layer, leaves = port_layer(x, w_ih, bias, w_hh, valid, f32)
    for name, fn, params in (("port", layer, leaves),
                             ("cudnn", lambda: mod(packed)[0].data,
                              [packed.data, *mod.parameters()])):
        dy = torch.randn_like(fn())
        with torch.no_grad():
            f_ms = back_to_back_ms(fn, reps=4)
        ft_ms = back_to_back_ms(fn, reps=4)
        both = back_to_back_ms(
            lambda: torch.autograd.grad(fn(), params, dy), reps=4)
        times.setdefault(f"{key}{name}_layer_fwd_b2b", []).append(f_ms)
        times.setdefault(f"{key}{name}_layer_bwd_b2b", []).append(
            both - ft_ms)
    med = {k: statistics.median(v) for k, v in times.items()
           if k.startswith(key)}
    turns = {k: times[key + k] for k in ("fwd_b2b", "fwd_simt_b2b",
                                         "bwd_b2b", "bwd_simt_b2b")}
    log(f"[{phase}] {tag} float32 (D={d}, B={b}, T={t}, H={h}), device ms "
        f"(back to back): K2 {med[key + 'fwd_b2b']:.4f} on the float32 grid "
        f"against {med[key + 'fwd_simt_b2b']:.4f} on the CUDA cores, K3 "
        f"{med[key + 'bwd_b2b']:.4f} against {med[key + 'bwd_simt_b2b']:.4f}"
        f" (in turns {turns}); "
        f"the grid's serial floor fwd {med[key + 'floor_fwd_b2b']:.4f} / "
        f"bwd {med[key + 'floor_bwd_b2b']:.4f} (the barrier alone "
        f"{med[key + 'barrier_fwd_b2b']:.4f} / "
        f"{med[key + 'barrier_bwd_b2b']:.4f}); plain call "
        f"{med[key + 'fwd_plain_call']:.1f} / "
        f"{med[key + 'bwd_plain_call']:.1f}; the port's layer "
        f"{med[key + 'port_layer_fwd_b2b']:.4f} / "
        f"{med[key + 'port_layer_bwd_b2b']:.4f} against cuDNN's float32 "
        f"{med[key + 'cudnn_layer_fwd_b2b']:.4f} / "
        f"{med[key + 'cudnn_layer_bwd_b2b']:.4f} ({card})")
    del mod, packed, leaves, x
    torch.cuda.empty_cache()


def f32_grid_sweep(times: dict, card: str) -> None:
    """K2 and K3 at the LM's shape (D=1, B=64, H=1024, T=256, float32,
    every step valid) under each ring plan of F32_GRID_SWEEP that fits, in
    turns (each plan, then again in reverse order), CUDA events over
    back-to-back calls."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    f32 = torch.float32
    tag, t, _, h, d, _ = LM_LSTM_SHAPE
    gx, w_hh, valid, dh_out = scan_inputs(h, d, LM_BATCH, t, 21)
    valid = torch.ones_like(valid)
    with torch.inference_mode():
        res = K.lstm_scan_reference(gx, w_hh, valid, f32, (False,),
                                    residuals=True)
        for kind, call in (
                ("fwd", lambda: K.lstm_scan(gx, w_hh, valid, f32, (False,))),
                ("bwd", lambda: K.lstm_scan_bwd(w_hh, valid, res[3], res[2],
                                                dh_out, f32, (False,)))):
            base = K.cluster_plan(kind, h, LM_BATCH, f32, d)
            for chunk, stages in (*F32_GRID_SWEEP, *F32_GRID_SWEEP[::-1]):
                plan = base._replace(chunk=chunk, stages=stages,
                                     smem=K.grid_smem(
                                         kind, h, base.units, base.rows,
                                         base.sub, chunk, stages, f32))
                if plan.smem > K.MAX_SMEM:
                    continue
                with forced_plan(lambda *a, **k: plan):
                    n = _native.LAUNCHES[f"lstm_scan_{kind}_grid_f32"]
                    ms = back_to_back_ms(call, reps=2)
                    require(_native.LAUNCHES[f"lstm_scan_{kind}_grid_f32"]
                            == n + 4, f"the {kind} sweep left the grid")
                times.setdefault(f"td_{tag}_{kind}_c{chunk}_s{stages}_b2b",
                                 []).append(ms)
            for chunk, stages in F32_GRID_SWEEP:
                key = f"td_{tag}_{kind}_c{chunk}_s{stages}_b2b"
                if key in times:
                    log(f"[phase21] float32 grid plan {kind} at {tag}: chunk="
                        f"{chunk} stages={stages}: {times[key]} ms (the plan: "
                        f"chunk={base.chunk} stages={base.stages}) ({card})")


def f32_threshold_sweep(times: dict, card: str) -> None:
    """K2 and K3 in float32 at the widths of F32_SWEEP_WIDTHS around
    ``GRID_F32_MIN_HIDDEN`` (timit's listener shape otherwise: D=2, B=32,
    T=400, every step valid) on the float32 grid (its plan forced where
    the threshold sends the width to the CUDA cores) and on the CUDA cores,
    in turns, CUDA events over back-to-back calls."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    f32, d, b, t = torch.float32, 2, 32, 400
    rev = (False, True)

    def grid(kernel, hidden, batch, compute, directions=1):
        return K.grid_plan(kernel, hidden, batch, directions, compute)

    for h in F32_SWEEP_WIDTHS:
        gx, w_hh, valid, dh_out = scan_inputs(h, d, b, t, h)
        valid = torch.ones_like(valid)
        with torch.inference_mode():
            res = K.lstm_scan_reference(gx, w_hh, valid, f32, rev,
                                        residuals=True)
            fns = {"fwd": lambda: K.lstm_scan(gx, w_hh, valid, f32, rev),
                   "bwd": lambda: K.lstm_scan_bwd(w_hh, valid, res[3], res[2],
                                                  dh_out, f32, rev)}
            for route in ("grid_f32", "simt", "simt", "grid_f32"):
                with forced_plan(grid if route == "grid_f32" else simt_plan):
                    for kind, fn in fns.items():
                        times.setdefault(f"f32_sweep_h{h}_{kind}_{route}",
                                         []).append(
                            back_to_back_ms(fn, reps=4))
        med = {k: statistics.median(times[f"f32_sweep_h{h}_{k}"])
               for k in ("fwd_grid_f32", "fwd_simt", "bwd_grid_f32",
                         "bwd_simt")}
        log(f"[phase21] float32 at H={h} (D=2, B=32, T=400), device ms "
            f"(back to back, in turns): K2 {med['fwd_grid_f32']:.4f} on the "
            f"float32 grid against {med['fwd_simt']:.4f} on the CUDA cores, "
            f"K3 {med['bwd_grid_f32']:.4f} against {med['bwd_simt']:.4f}; "
            f"planned: {K.cluster_plan('fwd', h, b, f32, d).route} "
            f"(GRID_F32_MIN_HIDDEN {K.GRID_F32_MIN_HIDDEN}) ({card})")


def grid_floors(times: dict, tag: str, t: int, h: int) -> None:
    """The grid route's serial floor at one of TD_LSTM_SHAPES (D=1, B=64):
    T steps of each plan's protocol alone, CUDA events over back-to-back
    calls -- with the step's read of the exchanged rows (``floor``) and
    the step barrier alone (``barrier``)."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    for kind in ("fwd", "bwd"):
        plan = K.cluster_plan(kind, h, 64, torch.bfloat16, 1)
        for key, read in (("floor", True), ("barrier", False)):
            times.setdefault(f"td_{tag}_{key}_{kind}_b2b", []).append(
                back_to_back_ms(lambda: K.exchange_floor(
                    kind, plan, 1, t, 64, torch.device(DEVICE), h, read),
                    reps=4))


@contextlib.contextmanager
def grid_units(kind: str, units: tuple):
    """Plan the grid route of K2 (``kind="fwd"``) or K3 with these unit
    counts a block alone."""
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    keep = K.GRID_UNITS[kind]
    K.GRID_UNITS[kind] = units
    try:
        yield
    finally:
        K.GRID_UNITS[kind] = keep


def grid_sweep(times: dict, tag: str, fwd: tuple, bwd: tuple,
               h: int) -> None:
    """K2 and K3 at ``tag`` under each grid plan of GRID_SWEEP, in turns
    (each plan, then again in reverse order), CUDA events over
    back-to-back calls."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    for kind, call in (("fwd", lambda: K.lstm_scan(*fwd)),
                       ("bwd", lambda: K.lstm_scan_bwd(*bwd))):
        order = GRID_SWEEP[kind]
        for u, chunk, stages in (*order, *order[::-1]):
            with grid_units(kind, (u,)):
                plan = K.cluster_plan(kind, h, 64, torch.bfloat16, 1)
            require(plan.route == "grid" and plan.units == u,
                    f"no grid plan of {kind} with {u} units: {plan}")
            if chunk:
                plan = plan._replace(chunk=chunk, stages=stages,
                                     smem=K.grid_smem(kind, h, u, plan.rows,
                                                      plan.sub, chunk,
                                                      stages))
            with forced_plan(lambda *a, **k: plan), torch.inference_mode():
                n = _native.LAUNCHES[f"lstm_scan_{kind}_grid"]
                ms = back_to_back_ms(call, reps=2)
                require(_native.LAUNCHES[f"lstm_scan_{kind}_grid"] == n + 4,
                        f"the {kind} sweep left the grid route")
            key = f"u{u}_c{plan.chunk}_s{plan.stages}"
            times.setdefault(f"td_{tag}_{kind}_{key}_b2b", []).append(ms)
            log(f"[phase18] grid plan {kind} at {tag}: u={u} G={plan.groups}"
                f" R={plan.rows} sub={plan.sub} chunk={plan.chunk} stages="
                f"{plan.stages} smem={plan.smem}: {ms:.4f} ms")


def step_routes(s, grid: str = "grid") -> dict:
    """A Solver's step with the K2 and K3 launches that its plans put on
    the ``grid`` route ("grid" or "grid_f32") forced onto the CUDA-core
    route (the route before the grid's) and on their own route, in turns
    (simt, grid, grid, simt), two steps each, the second timed (host ms to
    a synchronize) -> {route: median ms}."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    plan = K.cluster_plan

    def simt(kernel, hidden, batch, compute, directions=1):
        p = plan(kernel, hidden, batch, compute, directions)
        return K.Plan("simt") if p.route == grid else p

    lab = s._labeled_stream()
    walls = {"simt": [], grid: []}
    for route in ("simt", grid, grid, "simt"):
        with forced_plan(simt if route == "simt" else plan):
            for i in range(2):
                args, unlab = s.step_inputs(next(lab)[2])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.run_step(args, unlab)
                torch.cuda.synchronize()
                if i:
                    walls[route].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in walls.items()}


def phase18_stream(d: Path, card: str) -> tuple[dict, dict, dict]:
    """(c) configs/ls100_transducer_streaming.yaml offline at full width:
    2 steps (the listener's K2 and K3 on the grid route, the predictor's
    on the cluster route), the greedy validation, test beam 4, a bf16 step
    kernels against plain, the same step twice bitwise, the step with the
    listener on the CUDA-core route against the grid route; then K2 and K3
    at TD_LSTM_SHAPES against plain and cuDNN, the grid route's floors and
    plans."""
    s = td_solver(TD_STREAM_CONFIG, d / "stream", TD_STREAM_RUN)
    m = s.cfg.model
    require(not m.enc_bidirectional and m.enc_hidden == 768
            and m.enc_out_dim == 768 and not s.cfg.frontend.center,
            f"ls100_transducer_streaming as shipped: {m}")
    log(f"[phase18] {TD_STREAM_CONFIG.name} offline at full width "
        f"(forward-only enc {m.enc_hidden} x ({m.enc_base_layers} + "
        f"{m.enc_layers}), VALID framing, pred {m.pred_hidden}, bf16, remat, "
        f"B=64) through the Solver; cuts: {TD_DATA + TD_STREAM_RUN}")
    launches, _, walls, peaks, _ = td_run(
        s, "ls100_transducer_streaming", TD_STEP_LAUNCHES, TD_EVAL_LAUNCHES,
        TD_STREAM_ROUTES, {"lstm_scan_fwd_grid": 4})
    out = {"td_stream_step_ms": statistics.median(walls[1:]),
           "td_stream_step_peak_gib": max(peaks)}
    out["td_stream_test_beam4_ms"] = td_test(
        s, "beam", "ls100_transducer_streaming", card)
    step_check(s, "phase18", BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)
    same = same_step_twice(s)
    log(f"[phase18] ls100_transducer_streaming: the same step twice (the "
        f"listener's K2 8 and K3 4 on the grid route), loss and every "
        f"gradient bitwise equal: {same}")
    require(same, "two runs of one ls100_transducer_streaming step differ")
    routes = step_routes(s)
    out["td_stream_step_simt_ms"] = routes["simt"]
    out["td_stream_step_grid_ms"] = routes["grid"]
    log(f"[phase18] ls100_transducer_streaming step at 400 frames, in turns: "
        f"listener on the CUDA-core route {routes['simt']:.1f} ms, on the "
        f"grid route {routes['grid']:.1f} ms (host ms to a synchronize, "
        f"median of 2) ({card})")
    del s
    times, errs = {}, {}
    td_lstm_shapes(times, errs, card)
    med = report("phase18", times, card, "D=1, B=64, bf16")
    out.update(med)
    return launches, out, errs


def phase18(d: Path, card: str) -> tuple[dict, dict, dict, dict]:
    """Phase 18: the transducer family, (a) ls100_transducer, (b)
    ls100_transducer_semi, (c) ls100_transducer_streaming offline -> (each
    one's launches, the numbers, K2/K3 errors at the new shapes)."""
    import torch

    launches = {}
    launches["ls100_transducer"], out = phase18_td(d / "td", card)
    torch.cuda.empty_cache()
    launches["ls100_transducer_semi"], semi = phase18_semi(d, card)
    out.update(semi)
    torch.cuda.empty_cache()
    launches["ls100_transducer_streaming"], stream, errs = phase18_stream(
        d, card)
    out.update(stream)
    log(f"[phase18] summary {json.dumps(out)}")
    return launches, out, errs


# phase 19: exact chunked streaming.  (a) configs/ls100_conformer_streaming
# .yaml as shipped (chunk-causal conformer of d_model 256, 12 blocks, 4
# heads, ff 1024, conv 15, a causal stem of 2 x 32 channels, chunks of 16
# encoder frames with 2 left; pred 512, joint 512, embed 256, bf16, char
# units, no remat, B=64) but for its data and the run's length: the
# synthetic corpus of 64 utterances in one 448-frame / 128-token batch of
# 64, 3 steps and the final greedy validation; then one step at the largest
# bucket, 1600 / 256
CS_CONFIG = ROOT / "configs" / "ls100_conformer_streaming.yaml"
CS_RUN = ["data.frame_buckets=[448]", "data.token_buckets=[128]",
          "train.total_steps=3", "train.ckpt_every=0", "train.eval_every=0",
          "train.log_every=1"]
# a step: K1 once, the predictor's K2 and K3 once each (the cluster route
# at H=512); a validation batch: K1 once (the conformer runs no LSTM, and
# the greedy walk steps the predictor with the plain cell)
CS_STEP_LAUNCHES = {"fused_post_fft": 1, "lstm_scan_fwd": 1,
                    "lstm_scan_bwd": 1}
CS_EVAL_LAUNCHES = {"fused_post_fft": 1}
# the streamed utterances: the synthetic corpus's first (0.96-2.4 s each),
# fed in 640 ms pieces to the conformer (its chunk) and 320 ms pieces to
# the forward-only listener (transcribe's --stream-chunk-ms default); the
# multi-stream checks serve MULTI_STREAMS of them at once
STREAM_UTTS = 3
MULTI_STREAMS = 16


def stream_model(config: Path, dtype: str):
    """A recipe at full width in ``dtype`` with random weights from seed 0
    (the same weights in either dtype), on the card -> (cfg, model)."""
    from semi_supervised_asr_tpu_torch import transcribe as TR
    from semi_supervised_asr_tpu_torch import weights
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.models.seq2seq import build_model

    cfg = load_config(config, [*TD_DATA, f"model.compute_dtype={dtype}"])
    cfg = TR.finalize_config(cfg, TR.build_vocab(cfg).size)
    model = build_model(cfg.model)
    weights.load_flat(model, weights.init_numpy(cfg.model, 0))
    return cfg, model.to(DEVICE).eval()


def stream_audio(cfg, n: int) -> tuple[list, tuple]:
    """The synthetic corpus's first ``n`` utterances (float32) and the
    global CMVN statistics of their frames, on the card."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import transcribe as TR
    from semi_supervised_asr_tpu_torch.data.synthetic import make_utterance
    from semi_supervised_asr_tpu_torch.ops import frontend_oracle as oracle

    vocab = TR.build_vocab(cfg)
    wavs = [make_utterance(i, vocab, cfg.data, cfg.frontend, min_tokens=8,
                           max_tokens=20).audio.astype(np.float32)
            for i in range(n)]
    lm = np.concatenate([oracle.log_mel(w.astype(np.float64), cfg.frontend)
                         for w in wavs])
    cmvn = tuple(torch.as_tensor(x.astype(np.float32), device=DEVICE)
                 for x in oracle.cmvn_stats(lm))
    return wavs, cmvn


def offline_tokens(model, cfg, cmvn, wav, beam: int, **fuse):
    """The port's offline decode of one file on the card, padded to the
    streaming chunk grid as a bucketed batch pads it -> (tokens, score);
    ``fuse`` (lm, lm_weight, ilm_weight, bias) goes to the beam, ``bias``
    also to the greedy walk."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch.decode.transducer_beam import (
        transducer_beam_from_enc,
    )
    from semi_supervised_asr_tpu_torch.decode.transducer_greedy import (
        transducer_greedy_from_enc,
    )
    from semi_supervised_asr_tpu_torch.training.train_step import featurize

    m, f, dc = cfg.model, cfg.frontend, cfg.decode
    c = m.time_reduction * (m.enc_attn_chunk or 1)
    n_frames = 1 + (len(wav) - f.n_fft) // f.hop_length
    need = (-(-n_frames // c) * c - 1) * f.hop_length + f.n_fft
    a = np.zeros((need,), np.float32)
    a[:len(wav)] = wav
    with torch.inference_mode():
        feats, flens = featurize(cfg, torch.from_numpy(a)[None].to(DEVICE),
                                 torch.tensor([len(wav)], device=DEVICE),
                                 cmvn)
        enc, mask = model.encode(feats, flens)
        if beam > 1:
            toks, score = transducer_beam_from_enc(
                model, m, enc, mask, dc.max_decode_len, beam, dc.max_symbols,
                **fuse)
        else:
            toks, score = transducer_greedy_from_enc(
                model, m, enc, mask, dc.max_decode_len, dc.max_symbols,
                bias=fuse.get("bias"))
    return [int(x) for x in toks[0].tolist() if x != 0], float(score[0])


def streamed(model, cfg, cmvn, wav, beam: int, piece_ms: int, **fuse):
    """One StreamingTranscriber fed ``wav`` in ``piece_ms`` pieces (the
    beam fused by ``fuse``: lm, lm_weight, ilm_weight) -> (tokens, score,
    chunk steps run, host ms to a synchronize)."""
    import torch

    from semi_supervised_asr_tpu_torch.decode import streaming as S

    piece = cfg.frontend.sample_rate * piece_ms // 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = S.StreamingTranscriber(model, cfg, cmvn, cfg.decode.max_decode_len,
                                max_symbols=cfg.decode.max_symbols,
                                beam_size=beam, **fuse)
    calls = [0]

    def counted(step):
        def run(*args):
            calls[0] += 1
            return step(*args)
        return run

    st._chunk_step = counted(st._chunk_step)
    st._final_step = counted(st._final_step)
    for s in range(0, len(wav), piece):
        st.feed(wav[s: s + piece])
    toks, score = st.finalize()
    torch.cuda.synchronize()
    return toks, score, calls[0], (time.perf_counter() - t0) * 1e3


def stream_checks(what: str, cfg32, m32, cfg16, m16, wavs, cmvn,
                  piece_ms: int, card: str) -> dict:
    """Streamed against offline tokens: float32 greedy and beam 4 equal
    (required), bf16 greedy's share of equal files (logged); a single
    stream's ms a chunk, real-time factor and K1 / K2 launches a chunk
    (bf16, greedy); a MULTI_STREAMS-slot MultiStreamTranscriber fed
    staggered against single streams in float32 (equal tokens required),
    and its round's ms in bf16 -> the numbers."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.decode import streaming as S

    out = {}
    for beam in (1, 4):
        for i, w in enumerate(wavs):
            off = offline_tokens(m32, cfg32, cmvn, w, beam)
            got = streamed(m32, cfg32, cmvn, w, beam, piece_ms)
            log(f"[phase19] {what} float32 {'greedy' if beam == 1 else 'beam 4'}"
                f" utterance {i} ({len(w) / 16000:.2f} s): streamed "
                f"{len(got[0])} tokens == offline {len(off[0])}: "
                f"{got[0] == off[0]}, scores {got[1]:.4f} / {off[1]:.4f}")
            require(got[0] == off[0], f"{what}: streamed tokens differ from "
                    f"offline (float32, beam {beam}, utterance {i})")
    agree = sum(streamed(m16, cfg16, cmvn, w, 1, piece_ms)[0]
                == offline_tokens(m16, cfg16, cmvn, w, 1)[0] for w in wavs)
    out["bf16_agree"] = agree / len(wavs)
    # a single stream's chunk cost in bf16, greedy (the serving dtype)
    streamed(m16, cfg16, cmvn, wavs[0], 1, piece_ms)          # warm
    _native.reset_launches()
    toks, _, chunks, ms = streamed(m16, cfg16, cmvn, wavs[0], 1, piece_ms)
    launches = dict(_native.LAUNCHES)
    m = cfg16.model
    chunk_ms = (cfg16.frontend.hop_length * 1e3 / cfg16.frontend.sample_rate
                * m.time_reduction * (m.enc_attn_chunk or 1))
    out.update(chunk_ms=ms / chunks, rtf=ms / chunks / chunk_ms,
               k1_a_chunk=launches["fused_post_fft"] / chunks,
               k2_a_chunk=launches["lstm_scan_fwd"] / chunks,
               k2_grid_a_chunk=launches["lstm_scan_fwd_grid"] / chunks)
    require(launches["fused_post_fft"] == chunks,
            f"{what}: K1 did not run once a chunk: {launches}, {chunks}")
    log(f"[phase19] {what} bf16 streaming (greedy, {piece_ms} ms pieces, "
        f"chunks of {chunk_ms:.0f} ms): {ms / chunks:.2f} ms a chunk for one "
        f"stream (host ms to a synchronize, {chunks} chunk steps), real-time "
        f"factor {out['rtf']:.4f}; launches a chunk K1 "
        f"{out['k1_a_chunk']:.2f}, K2 {out['k2_a_chunk']:.2f} (grid route "
        f"{out['k2_grid_a_chunk']:.2f}); {launches}; float32 greedy and "
        f"beam 4 streamed == offline on all {len(wavs)}; bf16 greedy "
        f"streamed == offline on {agree} of {len(wavs)} ({card})")

    def multi(model, cfg, files) -> tuple[list, float, int]:
        ms_ = S.MultiStreamTranscriber(model, cfg, cmvn,
                                       cfg.decode.max_decode_len,
                                       MULTI_STREAMS,
                                       max_symbols=cfg.decode.max_symbols)
        sids = [ms_.open() for _ in files]
        piece = cfg.frontend.sample_rate * piece_ms // 1000
        cursors = [-(piece * i) // 4 for i in range(len(files))]  # staggered
        res, rounds, t_rounds = {}, 0, 0.0
        while len(res) < len(files):
            for i, (sid, w) in enumerate(zip(sids, files)):
                if i in res:
                    continue
                lo, hi = max(cursors[i], 0), cursors[i] + piece
                if hi > 0:
                    ms_.feed(sid, w[lo:hi])
                cursors[i] = hi
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = ms_.pump()
            torch.cuda.synchronize()
            if n:
                rounds += n
                t_rounds += (time.perf_counter() - t0) * 1e3
            for i, (sid, w) in enumerate(zip(sids, files)):
                if i not in res and cursors[i] >= len(w):
                    res[i] = ms_.finalize(sid)[0]
        return [res[i] for i in range(len(files))], t_rounds / rounds, rounds

    files = [wavs[i % len(wavs)][: len(wavs[i % len(wavs)]) - 160 * (i // 4)]
             for i in range(MULTI_STREAMS)]
    singles = [streamed(m32, cfg32, cmvn, w, 1, piece_ms)[0] for w in files]
    got, _, rounds = multi(m32, cfg32, files)
    same = sum(a == b for a, b in zip(got, singles))
    require(same == len(files), f"{what}: {MULTI_STREAMS} streams differ "
            f"from single streams ({same} of {len(files)} equal)")
    multi(m16, cfg16, files)                                     # warm
    _, round_ms, rounds16 = multi(m16, cfg16, files)
    out.update(round_ms=round_ms, round_rtf=round_ms / chunk_ms,
               launches={k: v for k, v in launches.items() if v})
    log(f"[phase19] {what} MultiStreamTranscriber of {MULTI_STREAMS} slots "
        f"fed staggered: float32 tokens == single streams on {same} of "
        f"{len(files)} files ({rounds} rounds); bf16 round {round_ms:.2f} ms "
        f"for up to {MULTI_STREAMS} streams (host ms to a synchronize, "
        f"mean of {rounds16} rounds), {round_ms / MULTI_STREAMS:.3f} ms a "
        f"stream-chunk ({card})")
    return out


def phase19_conformer(d: Path, card: str) -> tuple[dict, dict]:
    """(a) ls100_conformer_streaming as shipped through the Solver: 3
    steps (K1 1, K2 1, K3 1: the predictor's), the greedy validation, a
    bf16 step kernels against plain, the same step twice bitwise, test
    beam 4 on the chunked encoder; a step at 1600 / 256 with its peak
    memory; then streaming at 640 ms chunks against offline."""
    import torch

    s = td_solver(CS_CONFIG, d / "cs", CS_RUN)
    m = s.cfg.model
    require(m.encoder_arch == "conformer" and m.enc_out_dim == 256
            and m.enc_blocks == 12 and m.enc_heads == 4
            and m.enc_ff_dim == 1024 and m.conformer_conv_width == 15
            and m.conv_subsample == 2 and m.conv_channels == 32
            and (m.enc_attn_chunk, m.enc_attn_left_chunks) == (16, 2)
            and m.pred_hidden == 512 and m.joint_dim == 512
            and m.compute_dtype == "bfloat16" and m.attn_backend == "xla"
            and not s.cfg.train.remat_encoder,
            f"ls100_conformer_streaming as shipped: {m}")
    log(f"[phase19] {CS_CONFIG.name} at full width (chunk-causal conformer "
        f"d_model {m.enc_out_dim} x {m.enc_blocks} blocks, {m.enc_heads} "
        f"heads, ff {m.enc_ff_dim}, conv {m.conformer_conv_width}, causal "
        f"stem {m.conv_subsample} x {m.conv_channels}, chunk "
        f"{m.enc_attn_chunk} left {m.enc_attn_left_chunks}; pred "
        f"{m.pred_hidden}, joint {m.joint_dim}, bf16, no remat, "
        f"B={s.cfg.train.batch_size}) through the Solver; cuts: "
        f"{TD_DATA + CS_RUN}")
    launches, _, walls, peaks, _ = td_run(
        s, "ls100_conformer_streaming", CS_STEP_LAUNCHES, CS_EVAL_LAUNCHES)
    out = {"cs_step_ms": statistics.median(walls[1:]),
           "cs_step_peak_gib": max(peaks)}
    step_check(s, "phase19", BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)
    same = same_step_twice(s)
    log(f"[phase19] ls100_conformer_streaming: the same step twice, loss and "
        f"every gradient bitwise equal: {same}")
    require(same, "two runs of one ls100_conformer_streaming step differ")
    out["cs_test_beam4_ms"] = td_test(s, "beam", "ls100_conformer_streaming",
                                      card, beam=4)
    del s
    torch.cuda.empty_cache()
    big = td_solver(CS_CONFIG, d / "cs1600", ["data.frame_buckets=[1600]",
                                              "data.token_buckets=[256]"])
    lab = big._labeled_stream()
    walls_1600, peaks_1600 = [], []
    for _ in range(2):
        args, unlab = big.step_inputs(next(lab)[2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        big.run_step(args, unlab)
        torch.cuda.synchronize()
        walls_1600.append((time.perf_counter() - t0) * 1e3)
        peaks_1600.append(torch.cuda.max_memory_allocated() / 2**30)
    out.update(cs_step_1600_ms=walls_1600[1],
               cs_step_1600_peak_gib=max(peaks_1600))
    log(f"[phase19] ls100_conformer_streaming at the 1600-frame / 256-token "
        f"bucket (T' = 400, U + 1 = 257, B=64): step "
        f"{out['cs_step_1600_ms']:.1f} ms wall (the second), peak memory "
        f"{out['cs_step_1600_peak_gib']:.2f} GiB; at 448 frames "
        f"{out['cs_step_ms']:.1f} ms, peak {out['cs_step_peak_gib']:.2f} GiB "
        f"({card})")
    del big
    torch.cuda.empty_cache()
    cfg32, m32 = stream_model(CS_CONFIG, "float32")
    cfg16, m16 = stream_model(CS_CONFIG, "bfloat16")
    wavs, cmvn = stream_audio(cfg32, STREAM_UTTS)
    st = stream_checks("ls100_conformer_streaming", cfg32, m32, cfg16, m16,
                       wavs, cmvn, 640, card)
    launches = {"conformer_streaming_train": launches,
                "conformer_streaming_stream": st.pop("launches")}
    out.update({"cs_stream_" + k: v for k, v in st.items()})
    return launches, out


def phase19_listener(card: str) -> dict:
    """(b) ls100_transducer_streaming as shipped: the forward-only
    listener's chunk outputs (320 ms chunks, B=1 and B=MULTI_STREAMS) on K2
    (the grid route) against the plain scan in bf16 and against the
    offline listener in float32; then streaming against offline."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.models import listener as L
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
    from semi_supervised_asr_tpu_torch.training.train_step import featurize

    cfg32, m32 = stream_model(TD_STREAM_CONFIG, "float32")
    cfg16, m16 = stream_model(TD_STREAM_CONFIG, "bfloat16")
    m = cfg16.model
    require(not m.enc_bidirectional and m.enc_hidden == 768
            and (m.enc_base_layers, m.enc_layers) == (1, 3),
            f"ls100_transducer_streaming as shipped: {m}")
    wavs, cmvn = stream_audio(cfg32, STREAM_UTTS)
    out = {}
    chunk = 32                      # 320 ms of feature frames
    for b in (1, MULTI_STREAMS):
        batch = [wavs[i % len(wavs)] for i in range(b)]
        n = max(len(w) for w in batch)
        audio = torch.zeros((b, n), device=DEVICE)
        for i, w in enumerate(batch):
            audio[i, :len(w)] = torch.from_numpy(w)
        lens = torch.tensor([len(w) for w in batch], device=DEVICE)
        feats, flens = featurize(cfg32, audio, lens, cmvn)
        t = feats.shape[1] // chunk * chunk
        feats, flens = feats[:, :t], torch.clamp_max(flens, t)
        errs = {}
        for dtype, model in (("float32", m32), ("bfloat16", m16)):
            res = {}
            for backend in (None, "reference"):
                st = L.listener_stream_init(model.cfg, b, DEVICE)
                outs = []
                _native.reset_launches()
                with torch.inference_mode():
                    for i in range(0, t, chunk):
                        o, st = L.listener_apply_stream(
                            model.listener, feats[:, i:i + chunk], st,
                            torch.clamp(flens - i, 0, chunk), backend)
                        outs.append(o)
                    res[backend] = torch.cat(outs, dim=1)
                    if backend is None:
                        runs = dict(_native.LAUNCHES)
                        off, _ = model.listener(feats, flens)
            torch.cuda.synchronize()
            route = K.cluster_plan("fwd", m.enc_hidden, b,
                                   getattr(torch, dtype)).route
            n_calls = 4 * t // chunk
            require(runs["lstm_scan_fwd_" + route] == n_calls,
                    f"streaming listener {dtype} B={b}: launches {runs}")
            vs_plain = (res[None] - res["reference"]).abs().max().item()
            vs_off = (res[None] - off).abs().max().item()
            bitwise = torch.equal(res[None], off)
            errs[dtype] = (vs_plain, vs_off, bitwise)
            log(f"[phase19] ls100_transducer_streaming listener, {dtype}, "
                f"B={b}, {t} frames in {chunk}-frame chunks (K2 on the "
                f"{route} route, {n_calls} launches): chunk outputs against "
                f"the plain scan max_abs_err {vs_plain:.3e}; against the "
                f"offline listener on kernels {vs_off:.3e} (bitwise equal: "
                f"{bitwise})")
        require(errs["bfloat16"][0] <= BF16_TOL,
                f"streaming listener bf16 B={b} vs plain {errs['bfloat16']}")
        require(errs["float32"][0] <= K2_TOL,
                f"streaming listener f32 B={b} vs plain {errs['float32']}")
        scale = 1e-5 * max(off.abs().max().item(), 1.0)
        require(errs["float32"][1] <= scale,
                f"streaming listener f32 B={b} vs offline {errs['float32']}")
        out[f"listener_b{b}"] = errs
    st = stream_checks("ls100_transducer_streaming", cfg32, m32, cfg16, m16,
                       wavs, cmvn, 320, card)
    out["launches"] = st.pop("launches")
    out.update({"ts_stream_" + k: v for k, v in st.items()})
    return out


def phase19(d: Path, card: str) -> tuple[dict, dict]:
    """Phase 19: exact chunked streaming, (a) ls100_conformer_streaming,
    (b) ls100_transducer_streaming -> (launches of each path: the training
    run and one bf16 stream of each recipe, numbers)."""
    import torch

    launches, out = phase19_conformer(d, card)
    torch.cuda.empty_cache()
    lis = phase19_listener(card)
    launches["transducer_streaming_stream"] = lis.pop("launches")
    out.update(lis)
    log(f"[phase19] summary {json.dumps(out)}")
    return launches, out


# phase 20: MWER sequence training on the three families, the CTC family's
# pseudo-labels and token timestamps.  (a) each family's recipe as shipped
# at full width (bf16, B=64) with objective.lambda_mwer 0.3, mwer_beam 4
# and no warmup, on one batch in the 400-frame / 128-token bucket:
# configs/ls100.yaml (LAS, the MWER fine-tuning recipe), ls100_ctc and
# ls100_transducer; cuts: synthetic data (64 utterances), and for ls100 one
# CE step first (the checkpoint that (b) resumes with MWER)
MWER_TERM = {"lambda_mwer": 0.3, "mwer_beam": 4, "mwer_warmup_steps": 0}
MWER = [f"objective.{k}={v}" for k, v in MWER_TERM.items()]
MWER_DATA = ["data.dataset=synthetic", "data.num_synthetic_utts=64",
             "data.frame_buckets=[400]", "data.token_buckets=[128]"]
# a step's launches with the MWER term: the supervised pass's, and for the
# transducer the predictor's K2 and K3 once more over the B*K n-best (the
# LAS beam and rescoring step the speller's plain cell; the CTC family's
# prefix beam and marginals run no kernel)
MWER_RECIPES = {
    "ls100": (ROOT / "configs" / "ls100.yaml",
              {"fused_post_fft": 1, "lstm_scan_fwd": 4, "lstm_scan_bwd": 4}),
    "ls100_ctc": (CTC_CONFIG, CTC_STEP_LAUNCHES),
    "ls100_transducer": (TD_CONFIG, {"fused_post_fft": 1,
                                     "lstm_scan_fwd": 10,
                                     "lstm_scan_bwd": 6}),
}
# the transducer's MWER step again at 1600 / 256 (T' = 200, U + 1 = 257),
# the B*K joint grids in chunks of 8 frames, for its peak memory
MWER_TD_1600 = ["data.frame_buckets=[1600]", "data.token_buckets=[256]",
                "model.joint_chunk_frames=8"]
# K2 and K3 at the MWER predictor's shape: one direction over the B*K =
# 256 n-best rows at H=512, T = U + 1 = 129, every step valid
MWER_BATCH = 256
MWER_LSTM_SHAPE = ("mwer_predictor_t129", 129, 256, 512, True)
# (c) ls100_ctc with the pseudo-label term (gate open, every row kept):
# K1 3 (the labeled, clean and augmented views), K2 12 (the labeled
# pass's 3 and 3 recomputed, the teacher's 3, the student's 3), K3 6
CTC_SEMI = ["data.dataset=synthetic", "data.num_synthetic_utts=64",
            "data.frame_buckets=[400]", "objective.lambda_pseudo=0.5",
            "objective.pseudo_warmup_steps=0",
            "objective.pseudo_confidence=0"]
CTC_SEMI_LAUNCHES = {"fused_post_fft": 3, "lstm_scan_fwd": 12,
                     "lstm_scan_bwd": 6}
# (d) transcribe --timestamps: each recipe at full width in float32,
# random weights from seed 0, 4 synthetic files, the recipe's own decode
# (timit with its joint-CTC head; the transducer greedy, --beam 1)
STAMP_RECIPES = {"ls100_ctc": (CTC_CONFIG, [], "beam"),
                 "timit": (CONFIG, ["objective.lambda_ctc=0.3"], "beam"),
                 "ls100_transducer": (TD_CONFIG, [], "greedy")}


def with_mwer(cfg):
    """``cfg`` with the MWER term of MWER_TERM."""
    return cfg.replace(objective=dataclasses.replace(cfg.objective,
                                                     **MWER_TERM))


def fixed_bands(s, batch, tensors):
    """SpecAugment bands for the Solver ``s``'s batch from seed 5."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import frontend as F

    fcfg = s.cfg.frontend
    flens = torch.clamp_max(F.frame_lengths(tensors[1], fcfg),
                            batch.bucket[0])
    return F.sample_specaug_params(torch.Generator().manual_seed(5),
                                   flens.shape[0], fcfg.n_mels, flens, fcfg)


def mwer_vs_plain(s, cfg_mw, tensors, bands, name: str) -> dict:
    """The MWER step from the Solver's weights, kernels against plain: in
    float32 and bf16 the encoder output on the kernels' features (K2_TOL /
    BF16_TOL) and the share of rows whose K hypotheses are equal (logged;
    float32 >= 0.95); in float32 the step on the kernels' n-best (loss
    1e-5 relative, every gradient leaf within GRAD_TOL)."""
    import torch

    from semi_supervised_asr_tpu_torch.models.seq2seq import build_model
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    out = {}
    sd = TS.module_state(s.state.model)
    tokens = TS.mask_unreal(tensors[2], tensors[3])
    for dtype in ("float32", "bfloat16"):
        cfg = cfg_mw.replace(model=dataclasses.replace(
            cfg_mw.model, compute_dtype=dtype))
        model = s.state.model
        if dtype != cfg_mw.model.compute_dtype:
            model = build_model(cfg.model).to(DEVICE)
            TS.load_module_state(model, sd)
        fam = TS.family_terms(cfg)
        with torch.inference_mode():
            feats, flens = TS.featurize(cfg, tensors[0], tensors[1],
                                        s.cmvn_dev, True, None,
                                        TS.Draws(specaug=bands))
            enc = {b: model.encode(feats, flens, b)[:2]
                   for b in (None, "reference")}
            nbest = {b: fam.step_mwer_nbest(model, cfg, *enc[b],
                                            tokens.shape[1])
                     for b in (None, "reference")}
        enc_err = (enc[None][0] - enc["reference"][0]).abs().max().item()
        same = (nbest[None][0] == nbest["reference"][0]).flatten(1).all(1)
        same = same.float().mean().item()
        tol = K2_TOL if dtype == "float32" else BF16_TOL
        log(f"[phase20] {name} {dtype}: encoder output, kernels vs plain, "
            f"max_abs_err {enc_err:.3e} (tol {tol:g}); the MWER beam's "
            f"{cfg.objective.mwer_beam}-best identical in {same:.3f} of the "
            f"rows")
        require(enc_err <= tol, f"{name} {dtype} encoder output differs")
        out[f"{dtype}_nbest_same"] = same
        if dtype != "float32":
            continue
        # a near-tie of two scores can reorder one row's n-best
        require(same >= 0.95, f"{name} float32 n-best differ")
        res = {}
        for backend in (None, "reference"):
            state = TS.init_train_state(cfg, copy.deepcopy(model), 0)
            res[backend] = TS.loss_and_grads(
                cfg, state, *tensors, s.cmvn_dev,
                [TS.StepDraws(TS.Draws(specaug=bands),
                              mwer_nbest=nbest[None])], backend)
        (lk, ak, gk), (lr, ar, gr) = res[None], res["reference"]
        rel = abs(lk.item() - lr.item()) / abs(lr.item())
        names = [n for n, _ in model.named_parameters()]
        errs = dict(zip(names, grad_errs(gk, gr)))
        worst = max(errs, key=errs.get)
        log(f"[phase20] {name} float32 MWER step on the kernels' n-best, "
            f"kernels vs plain: loss {lk.item():.6f} vs {lr.item():.6f} (rel "
            f"{rel:.2e}, tol 1e-5); mwer {float(ak['mwer']):.6f} vs "
            f"{float(ar['mwer']):.6f}, mwer_risk {float(ak['mwer_risk']):.4f}"
            f"; worst gradient leaf {worst} {errs[worst]:.3e} of the model's "
            f"max |g| (tol {GRAD_TOL:g})")
        require(float(ak["mwer_risk"]) > 0, f"{name}: the MWER term is empty")
        require(rel <= 1e-5, f"{name} float32 MWER loss differs: {rel}")
        require(errs[worst] <= GRAD_TOL, f"{name} MWER gradient {worst}")
        out.update(float32_loss_rel=rel, float32_grad_err=errs[worst])
        del res, gk, gr
    return out


def mwer_family(name: str, d: Path, card: str) -> tuple[dict, dict]:
    """(a) one recipe: for ls100 a CE step through the Solver (the
    checkpoint (b) resumes), then the step without and with MWER from the
    Solver's weights, in turns (CE, MWER, CE, MWER: the seconds timed), the
    MWER step's launches and peak memory, its two runs bitwise equal
    (metrics and updated parameters), and :func:`mwer_vs_plain` -> (the
    MWER step's launches, numbers)."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    config, want = MWER_RECIPES[name]
    s = short_solver(load_config(config, MWER_DATA), d, steps=1)
    m = s.cfg.model
    require(m.compute_dtype == "bfloat16" and s.cfg.train.batch_size == 64
            and m.enc_hidden == 384, f"{name} as shipped: {m}")
    if name == "ls100":
        s.train()
    ce, mw = s.cfg, with_mwer(s.cfg)
    batch, tensors = first_batch(s)
    bands = fixed_bands(s, batch, tensors)
    draws = [TS.StepDraws(TS.Draws(specaug=bands))]
    walls, runs, peak, launches = {"ce": [], "mwer": []}, [], 0.0, {}
    for kind in ("ce", "mwer", "ce", "mwer"):
        cfg = mw if kind == "mwer" else ce
        state = TS.init_train_state(cfg, copy.deepcopy(s.state.model), 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _native.reset_launches()
        t0 = time.perf_counter()
        metrics = TS.supervised_step(cfg, state, *tensors, s.cmvn_dev, draws)
        torch.cuda.synchronize()
        walls[kind].append((time.perf_counter() - t0) * 1e3)
        if kind == "mwer":
            launches = {k: v for k, v in _native.LAUNCHES.items() if v}
            peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
            runs.append((metrics, [p.detach().clone()
                                   for p in state.model.parameters()]))
        del state
    (ma, pa), (mb, pb) = runs
    same = all(bool(torch.equal(ma[k], mb[k]))
               for k in ("loss", "mwer", "mwer_risk", "grad_norm")) and all(
        torch.equal(a, b) for a, b in zip(pa, pb))
    del runs, pa, pb
    out = {"step_ms": walls["mwer"][1], "ce_step_ms": walls["ce"][1],
           "peak_gib": peak}
    log(f"[phase20] {name} at full width (enc {m.enc_hidden}, bf16, B=64, "
        f"bucket 400 / 128, K={mw.objective.mwer_beam}): the step with MWER "
        f"{walls['mwer'][0]:.1f} / {walls['mwer'][1]:.1f} ms, without "
        f"{walls['ce'][0]:.1f} / {walls['ce'][1]:.1f} ms (in turns, first / "
        f"second), overhead {out['step_ms'] - out['ce_step_ms']:.1f} ms; "
        f"peak memory {peak:.2f} GiB; loss {float(ma['loss']):.4f}, mwer "
        f"{float(ma['mwer']):.4f}, mwer_risk {float(ma['mwer_risk']):.4f}; "
        f"kernel launches {launches}; run twice bitwise equal: {same} "
        f"({card})")
    require(all(math.isfinite(float(ma[k])) for k in ("loss", "mwer"))
            and float(ma["mwer_risk"]) > 0, f"{name} MWER step {ma}")
    require_launches(f"{name} MWER step", launches, want)
    require(same, f"two runs of one {name} MWER step differ")
    out.update(mwer_vs_plain(s, mw, tensors, bands, name))
    return launches, out


def mwer_td_1600(d: Path, card: str) -> dict:
    """The transducer's MWER step at 1600 / 256 with the B*K joint grids in
    chunks of 8 frames: wall time and peak memory."""
    import torch

    from semi_supervised_asr_tpu_torch.config import load_config

    s = short_solver(load_config(TD_CONFIG, [*MWER_DATA, *MWER_TD_1600,
                                             *MWER]), d, steps=1)
    args, unlab = s.step_inputs(next(s._labeled_stream())[2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = s.run_step(args, unlab)
    torch.cuda.synchronize()
    out = {"td_1600_step_ms": (time.perf_counter() - t0) * 1e3,
           "td_1600_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[phase20] ls100_transducer MWER step at 1600 / 256 (T' = 200, "
        f"U + 1 = 257, B*K = 256 lattices, model.joint_chunk_frames=8): "
        f"{out['td_1600_step_ms']:.1f} ms wall (the first), peak memory "
        f"{out['td_1600_peak_gib']:.2f} GiB; mwer {float(m['mwer']):.4f} "
        f"({card})")
    require(math.isfinite(float(m["loss"])), "the 1600 MWER step")
    return out


def mwer_resume(d: Path, card: str) -> dict:
    """(b) ``main --train --resume`` of the ls100 CE checkpoint (step 1)
    with MWER for 3 steps: ``mwer`` and ``mwer_risk`` read back from
    metrics.jsonl -> the run's launches."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch import main as M

    _native.reset_launches()
    t0 = time.perf_counter()
    rc = M.main(["--config", str(MWER_RECIPES["ls100"][0]), "--train",
                 "--resume", "--workdir", str(d), "--device", DEVICE, "--",
                 *MWER_DATA, "train.seed=0", "train.total_steps=4",
                 "train.eval_every=0", "train.ckpt_every=4",
                 "train.log_every=1", *MWER])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    recs = [r for r in by_prefix(read_records(d), "train") if "mwer" in r]
    log(f"[phase20] main --train --resume at ls100 width with MWER: rc {rc}"
        f", {wall:.1f} s; records "
        + "; ".join(f"step {r['step']} loss {r['loss']:.4f} mwer "
                    f"{r['mwer']:.4f} mwer_risk {r['mwer_risk']:.4f}"
                    for r in recs)
        + f"; kernel launches {launches} ({card})")
    require(rc == 0 and [r["step"] for r in recs] == [2, 3, 4],
            f"main --train --resume with MWER: {recs}")
    require(all(math.isfinite(r["mwer"]) and r["mwer_risk"] > 0
                for r in recs), "MWER metrics")
    require(all(launches.get(k, 0) >= 3 for k in LSTM_PATH),
            f"the resumed MWER run's launches {launches}")
    return launches


def ctc_pseudo(d: Path, card: str) -> dict:
    """(c) ls100_ctc with the pseudo-label term: one Solver step with its
    launches, then ``semi_step_check`` in bf16 (the teacher's encoder
    output on the clean view within BF16_TOL, its best paths' agreement,
    the step kernels vs plain on the same pseudo-labels) -> launches."""
    from semi_supervised_asr_tpu_torch.config import load_config

    s = short_solver(load_config(CTC_CONFIG, CTC_SEMI), d, steps=1)
    steps, evals, walls = [], [], []
    counting(s, steps, evals, walls)
    s.train()
    log(f"[phase20] ls100_ctc with objective.lambda_pseudo, a step: "
        f"{s.history[0]}; {walls[0]:.1f} ms wall (the first); kernel "
        f"launches {steps[0]} ({card})")
    require(s.history[0]["pseudo"] > 0 and s.history[0]["pseudo_gate"] == 1,
            f"ls100_ctc pseudo step {s.history[0]}")
    require_launches("ls100_ctc pseudo step", steps[0], CTC_SEMI_LAUNCHES)
    semi_step_check(s, BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL, "phase20")
    return steps[0]


def offline_frames(model, cfg, cmvn, wav) -> tuple[list, list]:
    """The offline greedy walk of one file (padded to the streaming chunk
    grid, as ``offline_tokens``) with its emission frames -> (tokens,
    frames)."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch.decode.transducer_greedy import (
        transducer_greedy_from_enc,
    )
    from semi_supervised_asr_tpu_torch.training.train_step import featurize

    m, f, dc = cfg.model, cfg.frontend, cfg.decode
    c = m.time_reduction * (m.enc_attn_chunk or 1)
    n_frames = 1 + (len(wav) - f.n_fft) // f.hop_length
    a = np.zeros(((-(-n_frames // c) * c - 1) * f.hop_length + f.n_fft,),
                 np.float32)
    a[:len(wav)] = wav
    with torch.inference_mode():
        feats, flens = featurize(cfg, torch.from_numpy(a)[None].to(DEVICE),
                                 torch.tensor([len(wav)], device=DEVICE),
                                 cmvn)
        toks, _, frames = transducer_greedy_from_enc(
            model, m, *model.encode(feats, flens), dc.max_decode_len,
            dc.max_symbols, track_frames=True)
    n = int((toks[0] != 0).sum())
    return toks[0, :n].tolist(), frames[0, :n].tolist()


def timestamps(d: Path, card: str) -> dict:
    """(d) ``transcribe --timestamps`` of STAMP_RECIPES in float32 on the
    kernels and on ``backend="reference"`` (records equal: texts, tokens,
    starts and ends), ``align.py`` on the CTC recipe's files and one entry
    too long for its audio (exit 0, that one ``"failed"``), then both
    streaming recipes streamed with ``track_frames``: emission frames equal
    to the offline greedy walk's -> launches by path."""
    import torch

    from semi_supervised_asr_tpu_torch import _native, synthetic
    from semi_supervised_asr_tpu_torch import align as A
    from semi_supervised_asr_tpu_torch import transcribe as TR
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.data.synthetic import make_utterance
    from semi_supervised_asr_tpu_torch.decode import streaming as S

    paths = {}
    for name, (config, over, mode) in STAMP_RECIPES.items():
        dd = d / f"stamps_{name}"
        dd.mkdir()
        over = ["data.dataset=synthetic", "model.compute_dtype=float32",
                *over]
        cfg = load_config(config, over)
        vocab = TR.build_vocab(cfg)
        fin = TR.finalize_config(cfg, vocab.size)
        utt = dict(min_tokens=5, max_tokens=12, token_dur_s=0.3)
        files = synthetic.write_wavs(dd, fin, vocab, 4, **utt)
        synthetic.write_model_dir(dd, fin, files, seed=0)
        recs, ms = {}, {}
        for backend in (None, "reference"):
            rec = TR.Recognizer.from_dir(cfg, dd, DEVICE, backend)
            torch.cuda.synchronize()
            _native.reset_launches()
            t0 = time.perf_counter()
            recs[backend] = TR.transcribe(rec, files, mode, timestamps=True)
            torch.cuda.synchronize()
            ms[backend] = (time.perf_counter() - t0) * 1e3
            if backend is None:
                paths[f"timestamps_{name}"] = {
                    k: v for k, v in _native.LAUNCHES.items() if v}
        got, want = recs[None], recs["reference"]
        n_tok = sum(len(r["tokens"]) for r in got)
        log(f"[phase20] transcribe --timestamps {name} ({mode}, float32, "
            f"one batch of {len(files)} files): {ms[None]:.1f} ms on the "
            f"kernels, {ms['reference']:.1f} ms plain; {n_tok} tokens timed;"
            f" texts and times equal kernels vs plain: "
            f"{[(r['text'], r['tokens']) for r in got] == [(r['text'], r['tokens']) for r in want]}"
            f"; kernel launches {paths[f'timestamps_{name}']}; first record "
            f"{json.dumps(got[0])[:300]} ({card})")
        require([(r["text"], r["tokens"]) for r in got]
                == [(r["text"], r["tokens"]) for r in want],
                f"{name} timestamps differ kernels vs plain")
        require(n_tok > 0, f"{name}: no token timed")
        require(all(paths[f"timestamps_{name}"].get(k, 0) > 0
                    for k in LSTM_PATH[:2]), f"{name} timestamps launches")
        if name != "ls100_ctc":
            continue
        # align.py: the files' own transcripts and one 200 characters
        # long on the first file's 1-3 s (no CTC path fits)
        texts = [make_utterance(i, vocab, fin.data, fin.frontend, **utt).text
                 for i in range(len(files))]
        entries = [{"uid": f"u{i}", "audio": str(f), "text": t}
                   for i, (f, t) in enumerate(zip(files, texts))]
        entries.append({"uid": "long", "audio": str(files[0]),
                        "text": ("abc " * 50)[:200]})
        manifest, out = dd / "manifest.jsonl", dd / "aligned.jsonl"
        manifest.write_text("".join(json.dumps(e) + "\n" for e in entries))
        _native.reset_launches()
        t0 = time.perf_counter()
        rc = A.main(["--config", str(config), "--load-dir", str(dd),
                     "--manifest", str(manifest), "--out", str(out),
                     "--device", DEVICE, *over])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        paths["align"] = {k: v for k, v in _native.LAUNCHES.items() if v}
        aligned = [json.loads(x) for x in out.read_text().splitlines()]
        failed = [r["uid"] for r in aligned if "failed" in r]
        log(f"[phase20] align.py on {len(entries)} entries: rc {rc}, "
            f"{wall:.1f} ms; failed {failed}; logp_per_frame "
            f"{[r.get('logp_per_frame') for r in aligned]}; kernel launches "
            f"{paths['align']} ({card})")
        require(rc == 0 and failed == ["long"]
                and all(r["tokens"] for r in aligned[:-1]),
                f"align.py: rc {rc}, failed {failed}")
        require(all(paths["align"].get(k, 0) > 0 for k in LSTM_PATH[:2]),
                "align.py launches")
    for name, config, piece_ms in (
            ("ls100_transducer_streaming", TD_STREAM_CONFIG, 320),
            ("ls100_conformer_streaming", CS_CONFIG, 640)):
        cfg, model = stream_model(config, "float32")
        wavs, cmvn = stream_audio(cfg, 2)
        piece = cfg.frontend.sample_rate * piece_ms // 1000
        _native.reset_launches()
        for wav in wavs:
            st = S.StreamingTranscriber(
                model, cfg, cmvn, cfg.decode.max_decode_len,
                max_symbols=cfg.decode.max_symbols, track_frames=True)
            for i in range(0, len(wav), piece):
                st.feed(wav[i: i + piece])
            toks, _ = st.finalize()
            frames = st.emission_frames()
            off_toks, off_frames = offline_frames(model, cfg, cmvn, wav)
            log(f"[phase20] {name} --streaming --timestamps (float32, "
                f"{piece_ms} ms pieces): {len(toks)} tokens, frames "
                f"{frames[:12]}...; equal to the offline greedy walk's: "
                f"tokens {toks == off_toks}, frames {frames == off_frames}")
            require(toks == off_toks and frames == off_frames and frames,
                    f"{name} streamed emission frames differ")
        paths[f"stream_timestamps_{name}"] = {
            k: v for k, v in _native.LAUNCHES.items() if v}
        require(paths[f"stream_timestamps_{name}"].get("fused_post_fft", 0)
                > 0, f"{name} streaming launches")
        del model
        torch.cuda.empty_cache()
    return paths


def phase20(d: Path, card: str) -> tuple[dict, dict, dict]:
    """Phase 20: (a) the MWER step of ls100, ls100_ctc and
    ls100_transducer, the transducer's at 1600 / 256, K2 / K3 at the MWER
    predictor's shape; (b) ``main --train --resume`` with MWER; (c)
    ls100_ctc's pseudo-label step; (d) timestamps and ``align.py`` ->
    (launches by path, numbers, K2 / K3 errors at the predictor's
    shape)."""
    import torch

    launches, out, times, errs = {}, {}, {}, {}
    for name in MWER_RECIPES:
        launches[f"mwer_{name}"], res = mwer_family(name, d / name, card)
        out.update({f"{name}_{k}": v for k, v in res.items()})
        torch.cuda.empty_cache()
    out.update(mwer_td_1600(d / "td1600", card))
    torch.cuda.empty_cache()
    td_lstm_shapes(times, errs, card, (MWER_LSTM_SHAPE,), MWER_BATCH,
                   "phase20")
    out.update({k: statistics.median(v) for k, v in times.items()})
    launches["mwer_resume"] = mwer_resume(d / "ls100", card)
    torch.cuda.empty_cache()
    launches["ctc_pseudo"] = ctc_pseudo(d / "ctc_pseudo", card)
    torch.cuda.empty_cache()
    launches.update(timestamps(d, card))
    log(f"[phase20] summary {json.dumps(out)}")
    return launches, out, errs


# phase 21: the external LM and LM fusion.  (a) configs/ls100_semi.yaml's
# lm block as shipped (LSTM, embed 256, hidden 1024, 1 layer, lm.batch_size
# 64, float32, Adam at 1e-3) over the config's unlabeled-text stream, at
# the largest token bucket (256); cuts: synthetic text (64 utterances) and
# 3 steps.  The transformer LM at the same block (d_model 256, 1 block of
# 4 heads, ff 512, max_len 256)
LM_DATA = ["data.dataset=synthetic", "data.num_synthetic_utts=64"]
LM_RUN = ["lm.total_steps=3", "lm.log_every=1"]
LM_TRANSFORMER = ["lm.arch=transformer", "lm.heads=4", "lm.ff_dim=512",
                  "lm.max_len=256"]
# a step: K2 and K3 once (one layer, every step valid), float32, on the
# float32 grid
LM_STEP_LAUNCHES = {"lstm_scan_fwd": 1, "lstm_scan_bwd": 1}
LM_STEP_ROUTES = {"lstm_scan_fwd_grid_f32": 1, "lstm_scan_bwd_grid_f32": 1}
# K2 / K3 in float32 at the LM's shape and at the first listener layer of
# the cold / deep fusion step (ls100 in float32, bucket 400): (tag, T,
# input width, H, D, every step valid), at B=LM_BATCH
LM_LSTM_SHAPE = ("lm_t256", 256, 256, 1024, 1, True)
FUSION_LSTM_SHAPE = ("fusion_listener_t400", 400, 80, 384, 2, False)
F32_LSTM_SHAPES = (LM_LSTM_SHAPE, FUSION_LSTM_SHAPE)
# widths around the float32 grid's threshold (GRID_F32_MIN_HIDDEN)
F32_SWEEP_WIDTHS = (128, 192, 256)
# the float32 grid's ring plans timed at the LM's shape: (chunk, stages)
F32_GRID_SWEEP = ((128, 2), (64, 2), (64, 3), (64, 4), (32, 4))
LM_BATCH = 64
# (b) shallow fusion of (a)'s LM in float32 (tokens kernels vs plain must
# be identical), each recipe at full width as shipped but for its data (the
# synthetic corpus, one padded batch of 64 in the 400-frame bucket) and the
# compute dtype: ls100_semi's attention beam 5, ls100_ctc's prefix beam 8
# (its config suggests lm_weight 0.3), ls100_transducer's beam at 4 with
# the internal-LM correction
FUSION_WEIGHTS = ["decode.lm_weight=0.3"]
# (a)'s LM read by the recipes that do not ship ls100_semi's lm block
LM_BLOCK = {"embed_dim": 256, "hidden": 1024, "layers": 1}
FUSION_RECIPES = {
    "las": (SEMI_CONFIG, []),
    "ctc": (CTC_CONFIG, []),
    "td": (TD_CONFIG, ["decode.beam_size=4", "decode.ilm_weight=0.2"]),
}
FUSION_FILES = 8
# (c) deep and cold fusion in configs/ls100.yaml's LSTM speller (dec 768),
# the frozen LM (a)'s, grafted at startup (model.lm_fusion_* its widths);
# cuts: float32, the synthetic corpus of 64 in the 400-frame bucket, 2
# steps
LS100_CONFIG = ROOT / "configs" / "ls100.yaml"
FUSION_GRAFT = ["model.lm_fusion_embed=256", "model.lm_fusion_hidden=1024",
                "model.lm_fusion_layers=1", "model.compute_dtype=float32",
                "data.dataset=synthetic", "data.num_synthetic_utts=64",
                "data.frame_buckets=[400]"]


def lm_trainer_phase(d: Path, card: str) -> tuple[dict, dict, Path]:
    """Phase 21 (a) -> (the run's launches, numbers, the LM's workdir)."""
    import torch

    import numpy as np

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.data import pipeline as pipe
    from semi_supervised_asr_tpu_torch.data.registry import (
        build_datasets, build_vocab,
    )
    from semi_supervised_asr_tpu_torch.models import lm as LM
    from semi_supervised_asr_tpu_torch.training import lm_trainer as LT

    out = {}
    cfg = load_config(SEMI_CONFIG, [*LM_DATA, *LM_RUN])
    require((cfg.lm.arch, cfg.lm.embed_dim, cfg.lm.hidden, cfg.lm.layers,
             cfg.lm.batch_size, max(cfg.data.token_buckets))
            == ("lstm", 256, 1024, 1, 64, 256), f"lm block {cfg.lm}")
    steps, walls = [], []
    step = LT.train_step

    def counted(*args, **kw):
        torch.cuda.synchronize()
        before = dict(_native.LAUNCHES)
        t0 = time.perf_counter()
        loss = step(*args, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        steps.append(launch_delta(before, _native.LAUNCHES))
        return loss

    lm_dir = d / "lm"
    _native.reset_launches()
    LT.train_step = counted
    try:
        res = LT.train_lm(cfg, lm_dir, DEVICE)
    finally:
        LT.train_step = step
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    for i, (st, w) in enumerate(zip(steps, walls)):
        log(f"[phase21] lm_trainer step {i + 1}: {w:.1f} ms wall; kernel "
            f"launches {st}")
        require_launches(f"LM step {i + 1}", st, LM_STEP_LAUNCHES,
                         LM_STEP_ROUTES)
    log(f"[phase21] lm_trainer (B=64, T=256, H=1024, float32, 3 steps): "
        f"{res}; run launches {launches} ({card})")
    require(len(steps) == 3 and math.isfinite(res["lm_loss"]),
            f"lm_trainer {res}")
    out["lm_step_ms"] = statistics.median(walls[1:])

    # one step's loss and gradients from the trained LM on the stream's
    # first batch, kernels against plain, float32
    vocab = build_vocab(cfg).size
    lm = LT.load_lm(lm_dir, cfg, vocab, device=DEVICE)
    text, real = next(pipe.text_batches(
        build_datasets(cfg).unlabeled_text, max(cfg.data.token_buckets),
        cfg.lm.batch_size, cfg.train.seed))
    tokens = torch.as_tensor(np.where(real[:, None], text, 0), device=DEVICE)
    got = {}
    for backend in (None, "reference"):
        loss = LM.lm_loss(lm, tokens, backend)
        got[backend] = (loss.detach(), torch.autograd.grad(
            loss, list(lm.parameters())))
    (lk, gk), (lr, gr) = got[None], got["reference"]
    rel = abs(lk.item() - lr.item()) / abs(lr.item())
    names = [n for n, _ in lm.named_parameters()]
    errs = dict(zip(names, grad_errs(gk, gr)))
    worst = max(errs, key=errs.get)
    log(f"[phase21] LM float32 step, kernels vs plain: loss "
        f"{lk.item():.6f} vs {lr.item():.6f} (rel {rel:.2e}, tol 1e-5); "
        f"worst gradient leaf {worst} {errs[worst]:.3e} of the LM's max |g| "
        f"(tol {GRAD_TOL:g})")
    require(rel <= 1e-5 and errs[worst] <= GRAD_TOL,
            f"LM step kernels vs plain: loss rel {rel}, {worst} "
            f"{errs[worst]}")
    out["lm_step_loss_rel"], out["lm_step_grad_err"] = rel, errs[worst]

    # the transformer LM's step at the same block (plain products)
    tcfg = load_config(SEMI_CONFIG, [*LM_DATA, *LM_TRANSFORMER])
    tl = LT.init_lm_params(tcfg, vocab, 0, DEVICE)
    opt = LT.adam(tcfg, tl)
    _native.reset_launches()
    t_walls = host_ms(lambda: LT.train_step(tl, opt, tokens), 3)
    t_loss = LM.lm_loss(tl, tokens).item()
    require(math.isfinite(t_loss) and not any(_native.LAUNCHES.values()),
            f"transformer LM step: loss {t_loss}, {_native.LAUNCHES}")
    out["lm_transformer_step_ms"] = statistics.median(t_walls[1:])
    log(f"[phase21] transformer LM step (d_model 256, 1 block, B=64, "
        f"T=256, float32): {t_walls} ms wall, loss {t_loss:.4f}; no "
        f"kernel launch (plain products, as the reference) ({card})")
    return launches, out, lm_dir


def fusion_recognizers(config: Path, extra: list, d: Path, lm_dir: Path):
    """A recipe's Recognizer on kernels with the LM of ``lm_dir`` loaded by
    ``decode.lm_ckpt`` (``Recognizer.from_dir``), the same on the plain
    versions, and the same model without the LM -> (kernels, plain,
    no LM, a padded batch of the recipe's batch size at bucket 400)."""
    import torch

    from semi_supervised_asr_tpu_torch import synthetic
    from semi_supervised_asr_tpu_torch import transcribe as TR

    cfg = TR.load_config(config, [
        *LM_DATA, "model.compute_dtype=float32", *FUSION_WEIGHTS,
        f"decode.lm_ckpt={lm_dir}", *extra,
        *(f"lm.{k}={v}" for k, v in LM_BLOCK.items())])
    vocab = TR.build_vocab(cfg)
    cfg = TR.finalize_config(cfg, vocab.size)
    d.mkdir(parents=True)
    files = synthetic.write_wavs(d, cfg, vocab, FUSION_FILES, min_tokens=8,
                                 max_tokens=20)
    synthetic.write_model_dir(d, cfg, files, seed=0)
    ker = TR.Recognizer.from_dir(cfg, d, DEVICE)
    ref = TR.Recognizer.from_dir(cfg, d, DEVICE, backend="reference")
    bare = TR.Recognizer(ker.cfg, ker.model, (ker.mean.cpu(),
                         ker.inv_std.cpu()), ker.vocab, torch.device(DEVICE))
    pieces = [TR.load_audio(files[r % len(files)])
              for r in range(cfg.train.batch_size - 4)]
    return ker, ref, bare, TR.pad_batch(
        pieces, ker.spec.samples_for_frames(400), cfg)


def fusion_phase(d: Path, lm_dir: Path, card: str) -> tuple[dict, dict]:
    """Phase 21 (b) -> (launches by recipe, numbers)."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.training import lm_trainer as LT

    launches, out = {}, {}
    for name, (config, extra) in FUSION_RECIPES.items():
        ker, ref, bare, (audio, lens) = fusion_recognizers(
            config, extra, d / name, lm_dir)
        require(ker.lm is not None and ref.lm is not None and bare.lm is None,
                f"{name}: the LM was not loaded")
        _native.reset_launches()
        tk, sk = ker.decode(audio, lens, "beam")
        torch.cuda.synchronize()
        launches[f"fusion_{name}"] = {k: v for k, v in
                                      _native.LAUNCHES.items() if v}
        tr, sr = ref.decode(audio, lens, "beam")
        same = float(np.mean(np.all(tk == tr, axis=1)))
        score_err = float(np.max(np.abs(sk - sr) / np.maximum(np.abs(sr),
                                                              1.0)))
        tb, _ = bare.decode(audio, lens, "beam")
        moved = float(np.mean(np.any(tk != tb, axis=1)))
        walls = {"lm": [], "bare": []}
        for rec, key in ((ker, "lm"), (bare, "bare"), (ker, "lm"),
                         (bare, "bare")):
            walls[key] += host_ms(lambda: rec.decode(audio, lens, "beam"), 1)
        for key, w in walls.items():
            out[f"fusion_{name}_{key}_ms"] = statistics.median(w)
        log(f"[phase21] {name} beam {ker.cfg.decode.beam_size} with the LM "
            f"(lm_weight {ker.cfg.decode.lm_weight}, ilm_weight "
            f"{ker.cfg.decode.ilm_weight}; B={len(lens)}, bucket 400, "
            f"float32): kernel launches {launches[f'fusion_{name}']}; rows "
            f"with identical tokens kernels vs plain {same:.3f}, scores "
            f"within {score_err:.2e} relative; rows the LM changed "
            f"{moved:.3f}; host ms with the LM {walls['lm']}, without "
            f"{walls['bare']} (in turns) ({card})")
        require(same == 1.0, f"{name}: fused tokens differ from plain")
        require(score_err <= 1e-4, f"{name}: fused scores differ {score_err}")
        require(launches[f"fusion_{name}"].get("fused_post_fft", 0) == 1
                and launches[f"fusion_{name}"].get("lstm_scan_fwd", 0) > 0,
                f"{name}: {launches[f'fusion_{name}']}")
        del ker, ref, bare
        torch.cuda.empty_cache()

    # a streaming recipe's beam with the LM: streamed == offline.  The ILM
    # correction at the LM's weight: at 0.2 (as (b)'s transducer) the
    # fused beam emits nothing on these files with the random weights,
    # which would leave the LM's terms out of the check
    cfg, model = stream_model(TD_STREAM_CONFIG, "float32")
    cfg = cfg.replace(decode=dataclasses.replace(
        cfg.decode, lm_weight=0.3, ilm_weight=0.3, lm_ckpt=str(lm_dir)),
        lm=dataclasses.replace(cfg.lm, **LM_BLOCK))
    lm = LT.decode_lm(cfg, cfg.model.vocab_size, DEVICE, log)
    fuse = dict(lm=lm, lm_weight=0.3, ilm_weight=0.3)
    wavs, cmvn = stream_audio(cfg, 2)
    _native.reset_launches()
    for i, wav in enumerate(wavs):
        off, off_score = offline_tokens(model, cfg, cmvn, wav, 4, **fuse)
        toks, score, calls, ms = streamed(model, cfg, cmvn, wav, 4, 320,
                                          **fuse)
        log(f"[phase21] ls100_transducer_streaming beam 4 with the LM, file "
            f"{i} ({len(wav)} samples, float32): streamed {len(toks)} tokens"
            f" in {calls} chunk calls, {ms:.1f} ms; equal to offline "
            f"{toks == off}; scores {score:.4f} vs {off_score:.4f} ({card})")
        require(toks == off and abs(score - off_score)
                <= 1e-4 * max(abs(off_score), 1.0),
                f"fused stream {i} differs from offline: {toks} vs {off}, "
                f"{score} vs {off_score}")
    launches["fusion_stream"] = {k: v for k, v in _native.LAUNCHES.items()
                                 if v}
    return launches, out


def fusion_graft_phase(d: Path, lm_dir: Path, card: str) -> tuple[dict, dict]:
    """Phase 21 (c) -> (launches by kind, numbers)."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.training import lm_trainer as LT

    launches, out = {}, {}
    for kind in ("cold", "deep"):
        cfg = load_config(LS100_CONFIG, [
            *FUSION_GRAFT, f"model.lm_fusion={kind}",
            f"model.lm_fusion_ckpt={lm_dir}"])
        s = short_solver(cfg, d / kind, steps=2)
        m = s.cfg.model
        lm = LT.load_lm(lm_dir, s.cfg, s.vocab.size, dims=(
            m.lm_fusion_embed, m.lm_fusion_hidden, m.lm_fusion_layers),
            device=DEVICE)
        frozen = [p.detach().clone() for p in
                  s.state.model.speller.fusion_lm.parameters()]
        require(all(torch.equal(a, b) for a, b in zip(frozen, lm.parameters())),
                f"{kind}: the trained LM was not grafted")
        require(all(torch.equal(a, b) for a, b in zip(
            frozen, s.state.ema.speller.fusion_lm.parameters())),
            f"{kind}: the EMA buffer does not hold the graft")
        steps, evals, walls = [], [], []
        counting(s, steps, evals, walls)
        _native.reset_launches()
        s.train()
        torch.cuda.synchronize()
        launches[f"{kind}_fusion"] = {k: v for k, v in
                                      _native.LAUNCHES.items() if v}
        for i, (r, st, w) in enumerate(zip(s.history, steps, walls)):
            log(f"[phase21] ls100 {kind} fusion step {i + 1} (float32, "
                f"B=64, bucket 400): loss {r['loss']:.4f}; {w:.1f} ms wall; "
                f"kernel launches {st} ({card})")
            require(math.isfinite(r["loss"]), f"{kind} step loss")
            require_launches(f"{kind} fusion step {i + 1}", st,
                             {"fused_post_fft": 1, "lstm_scan_fwd": 4,
                              "lstm_scan_bwd": 4},
                             {"lstm_scan_fwd_grid_f32": 4,
                              "lstm_scan_bwd_grid_f32": 4})
        out[f"{kind}_fusion_step_ms"] = statistics.median(walls)
        same = all(torch.equal(a, b) for a, b in zip(
            frozen, s.state.model.speller.fusion_lm.parameters()))
        log(f"[phase21] {kind} fusion: the frozen LM bitwise unchanged "
            f"after {len(walls)} steps: {same}")
        require(same, f"{kind}: the frozen LM moved")
        step_check(s, "phase21")
        routes = step_routes(s, "grid_f32")
        out[f"{kind}_fusion_step_simt_ms"] = routes["simt"]
        out[f"{kind}_fusion_step_grid_f32_ms"] = routes["grid_f32"]
        log(f"[phase21] ls100 {kind} fusion step (float32, B=64, bucket "
            f"400), in turns: the listener's K2 / K3 on the CUDA-core route "
            f"{routes['simt']:.1f} ms, on the float32 grid "
            f"{routes['grid_f32']:.1f} ms (host ms to a synchronize, median "
            f"of 2) ({card})")
        del s
        torch.cuda.empty_cache()
    return launches, out


def phase21(d: Path, card: str) -> tuple[dict, dict, dict]:
    """Phase 21: (a) the LM trainer, K2 / K3 in float32 at its shape and
    the fusion listener's, the float32 grid's threshold; (b) shallow
    fusion in the four beams; (c) cold and deep fusion -> (launches by
    path, numbers, K2 / K3 errors at the LM's shape)."""
    import torch

    launches, out = {}, {}
    launches["lm_trainer"], res, lm_dir = lm_trainer_phase(d, card)
    out.update(res)
    times, errs = {}, {}
    for shape in F32_LSTM_SHAPES:
        f32_scan_times(times, errs, shape, LM_BATCH, card)
    f32_threshold_sweep(times, card)
    f32_grid_sweep(times, card)
    out.update({k: statistics.median(v) for k, v in times.items()})
    torch.cuda.empty_cache()
    fl, res = fusion_phase(d, lm_dir, card)
    launches.update(fl)
    out.update(res)
    gl, res = fusion_graft_phase(d, lm_dir, card)
    launches.update(gl)
    out.update(res)
    log(f"[phase21] summary {json.dumps(out)}")
    return launches, out, errs


# --------------------------------------------------------------------- #
# phase 22: BEST-RQ pretraining, its transfer, train.freeze, selftrain
# --------------------------------------------------------------------- #

# (a) the pretraining CLI at configs/ls100_semi.yaml full width (enc 384 x
# (1 + 3) BiLSTM, bf16, B=64); cuts: the synthetic corpus (its unlabeled
# audio stream, 64 utterances) in the 400-frame bucket, 4 steps
BRQ_RUN = ["data.dataset=synthetic", "data.num_synthetic_utts=64",
           "data.frame_buckets=[400]", "pretrain.total_steps=4",
           "pretrain.ckpt_every=2", "pretrain.log_every=1"]
# a pretraining step: K1 once (the clean view), K2 and K3 once a listener
# layer (both directions in one launch), on the cluster route
BRQ_STEP_LAUNCHES = {"fused_post_fft": 1, "lstm_scan_fwd": 4,
                     "lstm_scan_bwd": 4}
# (e) configs/ls960_conformer.yaml with the flash route at B=32 (cut from
# 256) in the 400-frame bucket, 3 steps (the host ms of steps 2-3)
BRQ_CONFORMER = ["model.attn_backend=flash", "data.dataset=synthetic",
                 "data.num_synthetic_utts=32", "data.frame_buckets=[400]",
                 "train.batch_size=32", "pretrain.total_steps=3",
                 "pretrain.log_every=1"]
# (d) ls100_semi (phase 13's cuts) from (a)'s encoder with the listener
# frozen, 2 steps
BRQ_FINETUNE = ["train.freeze=[listener]"]


def counted_pretrain(steps: list, walls: list, peaks: list):
    """Wrap ``pretrain.loss_and_grads`` and ``schedules.update`` so that
    each step's launches (the count's difference around the step), host
    ms to a synchronize and peak device memory (GiB) are recorded; ->
    the function that undoes it."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.training import pretrain as PT
    from semi_supervised_asr_tpu_torch.training import schedules

    grads_fn, update = PT.loss_and_grads, schedules.update
    mark = {}

    def counted_grads(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mark["before"] = dict(_native.LAUNCHES)
        mark["t0"] = time.perf_counter()
        return grads_fn(*args, **kw)

    def counted_update(*args, **kw):
        out = update(*args, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - mark["t0"]) * 1e3)
        steps.append(launch_delta(mark["before"], _native.LAUNCHES))
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        return out

    PT.loss_and_grads, schedules.update = counted_grads, counted_update

    def undo():
        PT.loss_and_grads, schedules.update = grads_fn, update

    return undo


def pretrain_run(out: Path, argv: list[str]) -> None:
    """``chip_smoke.py --pretrain-run OUT ARGV``: the pretraining CLI in
    this process with ARGV, each step's launches, host ms and peak memory
    written to OUT (JSON)."""
    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.training import pretrain as PT

    steps, walls, peaks = [], [], []
    counted_pretrain(steps, walls, peaks)
    _native.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = PT.main(argv)
    out.write_text(json.dumps({
        "rc": rc, "result": json.loads(buf.getvalue().strip()
                                       .splitlines()[-1]),
        "steps": steps, "walls": walls, "peaks": peaks,
        "launches": {k: v for k, v in _native.LAUNCHES.items() if v}}))


def pretrain_process(workdir: Path, extra: list[str], tag: str) -> dict:
    """The pretraining CLI of ls100_semi in a fresh process -> what
    :func:`pretrain_run` recorded (and its stderr)."""
    out = workdir.parent / f"pretrain_{tag}.json"
    argv = ["--config", str(SEMI_CONFIG), "--workdir", str(workdir),
            "--device", DEVICE, *BRQ_RUN, *extra]
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--pretrain-run",
         str(out), *argv], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    require(proc.returncode == 0, f"pretrain exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    got = json.loads(out.read_text())
    got["stderr"] = proc.stderr
    return got


def bestrq_state(workdir: Path) -> dict:
    import torch

    from semi_supervised_asr_tpu_torch.training import pretrain as PT

    return torch.load(workdir / "train_ckpt" / PT.STATE_FILE,
                      weights_only=False)


def bestrq_vs_plain(d: Path, card: str) -> dict:
    """Phase 22 (c): one pretraining step of ls100_semi kernels against
    ``backend="reference"`` with the targets (from K1's features) and the
    draws fixed, float32 then bf16 -> numbers."""
    import torch

    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.data import pipeline as pipe
    from semi_supervised_asr_tpu_torch.data.bucketing import make_bucket_spec
    from semi_supervised_asr_tpu_torch.data.registry import build_datasets
    from semi_supervised_asr_tpu_torch.objectives import best_rq as BRQ
    from semi_supervised_asr_tpu_torch.training import pretrain as PT
    from semi_supervised_asr_tpu_torch.training import train_step as TS
    from semi_supervised_asr_tpu_torch.training.solver import DeviceCopier
    from semi_supervised_asr_tpu_torch.transcribe import finalize_config

    out = {}
    for dtype, loss_tol, grad_tol in (
            ("float32", 1e-5, GRAD_TOL),
            ("bfloat16", BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL)):
        cfg = load_config(SEMI_CONFIG, [*BRQ_RUN,
                                        f"model.compute_dtype={dtype}"])
        bundle = build_datasets(cfg)
        cfg = finalize_config(cfg, bundle.vocab.size)
        spec = make_bucket_spec(cfg.data, cfg.frontend,
                                cfg.model.time_reduction)
        b = next(pipe.repeating_batches(bundle.unlabeled_audio, spec,
                                        cfg.frontend, cfg.train.batch_size,
                                        cfg.train.seed,
                                        drop_remainder=False))
        audio, lens, real = DeviceCopier(torch.device(DEVICE))(
            b.audio, b.audio_lens, b.real)
        cmvn = tuple(torch.as_tensor(a, device=DEVICE) for a in
                     pipe.compute_global_cmvn(bundle.unlabeled_audio,
                                              cfg.frontend))
        quant = PT.quantizer(cfg, DEVICE)
        feats = {}
        with torch.no_grad():
            for backend in (None, "reference"):
                feats[backend] = TS.featurize(cfg, audio, lens, cmvn,
                                              backend=backend)
        r = cfg.model.time_reduction
        labels = BRQ.bestrq_targets(feats[None][0], *quant, r)
        plain = BRQ.bestrq_targets(feats["reference"][0], *quant, r)
        agree = (labels == plain).float().mean().item()
        model = PT.init_model(cfg, 0, DEVICE)
        draws = BRQ.draw_masking(PT.step_generator(0, 1, DEVICE),
                                 model.listener, cfg.model, cfg.pretrain,
                                 tuple(feats[None][0].shape),
                                 feats[None][1])
        got = {backend: PT.loss_and_grads(cfg, model, audio, lens, real,
                                          cmvn, quant, None, backend,
                                          draws=draws, labels=labels)
               for backend in (None, "reference")}
        (lk, mk, gk), (lr, mr, gr) = got[None], got["reference"]
        rel = abs(lk.item() - lr.item()) / abs(lr.item())
        names = [n for n, _ in model.named_parameters()]
        errs = dict(zip(names, grad_errs(gk, gr)))
        worst = max(errs, key=errs.get)
        log(f"[phase22] ls100_semi pretraining step, {dtype}, kernels vs "
            f"plain (targets from K1's features, the draws fixed): loss "
            f"{lk.item():.6f} vs {lr.item():.6f} (rel {rel:.2e}, tol "
            f"{loss_tol:g}); mask_acc {float(mk['mask_acc']):.4f} vs "
            f"{float(mr['mask_acc']):.4f}; worst gradient leaf {worst} "
            f"{errs[worst]:.3e} of the model's max |g| (tol {grad_tol:g}); "
            f"targets from K1's features equal to the plain features' on "
            f"{agree:.5f} of the stacked frames ({card})")
        require(rel <= loss_tol and errs[worst] <= grad_tol,
                f"{dtype} pretraining step kernels vs plain: loss rel {rel},"
                f" {worst} {errs[worst]}")
        out[f"bestrq_{dtype}_loss_rel"] = rel
        out[f"bestrq_{dtype}_grad_err"] = errs[worst]
        out[f"bestrq_{dtype}_target_agree"] = agree
        del model, got
        torch.cuda.empty_cache()
    return out


def bestrq_finetune(d: Path, enc_dir: Path, card: str) -> tuple[dict, dict]:
    """Phase 22 (d): ls100_semi's Solver as ``main --train`` builds it,
    from (a)'s encoder with the listener frozen, 2 steps -> (launches,
    numbers)."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.training import pretrain as PT

    s = short_solver(load_config(SEMI_CONFIG, [
        *SEMI_OVERRIDES, *BRQ_FINETUNE,
        f"train.init_encoder_from={enc_dir}"]), d / "finetune", steps=2)
    with np.load(PT.encoder_ckpt_dir(enc_dir) / PT.PARAMS_FILE) as z:
        want = {k: torch.as_tensor(z[k]) for k in z.files}

    def same(module) -> bool:
        return all(torch.equal(p.detach().cpu(), want[n])
                   for n, p in module.named_parameters())

    start = same(s.state.model.listener) and same(s.state.ema.listener)
    speller = [p.detach().clone() for p in s.state.model.speller.parameters()]
    steps, evals, walls = [], [], []
    counting(s, steps, evals, walls)
    _native.reset_launches()
    s.train()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    frozen = same(s.state.model.listener)
    moved = not all(torch.equal(a, b) for a, b in zip(
        speller, s.state.model.speller.parameters()))
    for i, (r, st, w) in enumerate(zip(s.history, steps, walls)):
        log(f"[phase22] ls100_semi from the pretrained encoder, listener "
            f"frozen, step {i + 1}: loss {r['loss']:.4f} grad_norm "
            f"{r['grad_norm']:.4f}; {w:.1f} ms wall; kernel launches {st} "
            f"({card})")
        require(math.isfinite(r["loss"]), "fine-tuning loss not finite")
        require_launches(f"frozen fine-tuning step {i + 1}", st,
                         C4_LAUNCHES)
    log(f"[phase22] the listener and its EMA copy equal the encoder file "
        f"bitwise before step 1: {start}; the frozen listener bitwise "
        f"unchanged after {len(walls)} steps: {frozen}; the speller moved: "
        f"{moved}; K3 still runs for the frozen listener (the reference "
        f"zeroes its gradients after the backward): "
        f"{[st.get('lstm_scan_bwd', 0) for st in steps]} launches a step")
    require(start and frozen and moved,
            f"transfer / freeze: start {start} frozen {frozen} moved {moved}")
    out = {"bestrq_finetune_step_ms": statistics.median(walls)}
    del s
    torch.cuda.empty_cache()
    return launches, out


def bestrq_conformer(d: Path, card: str) -> tuple[dict, dict]:
    """Phase 22 (e): ls960_conformer's listener pretrained on the flash
    route at B=32, 3 steps -> (launches, numbers)."""
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.training import pretrain as PT

    steps, walls, peaks = [], [], []
    undo = counted_pretrain(steps, walls, peaks)
    _native.reset_launches()
    try:
        res = PT.train_bestrq(load_config(CONFORMER_CONFIG, BRQ_CONFORMER),
                              d / "conformer", DEVICE)
    finally:
        undo()
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    for i, (st, w, pk) in enumerate(zip(steps, walls, peaks)):
        log(f"[phase22] ls960_conformer pretraining step {i + 1} (d_model "
            f"512 x 16 blocks, flash, bf16, B=32, bucket 400): {w:.1f} ms "
            f"wall, peak {pk:.2f} GiB; kernel launches {st} ({card})")
        require(st.get("flash_mhsa_fwd", 0) > 0
                and st.get("flash_mhsa_bwd", 0) > 0
                and st.get("fused_post_fft", 0) == 1,
                f"conformer pretraining step {i + 1}: launches {st}")
    log(f"[phase22] ls960_conformer pretraining: {res}")
    require(len(steps) == 3 and math.isfinite(res["loss"]),
            f"conformer pretraining {res}")
    torch.cuda.empty_cache()
    return launches, {"bestrq_conformer_step_ms": statistics.median(
        walls[1:3]), "bestrq_conformer_peak_gib": max(peaks)}


def bestrq_selftrain(d: Path, card: str) -> tuple[dict, dict]:
    """Phase 22 (f): a self-training round over synthetic WAVs from a
    1-step timit-width Solver workdir -> (launches, numbers)."""
    import torch

    from semi_supervised_asr_tpu_torch import _native, selftrain, synthetic
    from semi_supervised_asr_tpu_torch import transcribe as TR
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.data.corpus import (
        ManifestDataset, load_audio,
    )

    teacher = d / "teacher"
    s = short_solver(load_config(CONFIG, TRAIN_OVERRIDES), teacher, steps=1)
    s.train()
    cfg, vocab, text = s.cfg, s.vocab, s.bundle.train[0].text
    del s
    wavs = d / "wavs"
    wavs.mkdir()
    files = synthetic.write_wavs(wavs, cfg, vocab, 8, min_tokens=5,
                                 max_tokens=12, token_dur_s=0.3)
    manifest = wavs / "unlabeled.jsonl"
    manifest.write_text("".join(json.dumps(
        {"uid": f"u{i}", "audio": f.name,
         "n_samples": int(load_audio(f).shape[0])}) + "\n"
        for i, f in enumerate(files)))
    labeled = wavs / "labeled.jsonl"
    labeled.write_text(json.dumps({"uid": "l0", "audio": files[0].name,
                                   "n_samples": int(load_audio(files[0])
                                                    .shape[0]),
                                   "text": text}) + "\n")
    out = wavs / "pseudo.jsonl"
    buf = io.StringIO()
    _native.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = selftrain.main(["--config", str(CONFIG), "--load-dir",
                             str(teacher), "--manifest", str(manifest),
                             "--out", str(out), "--keep-frac", "0.5",
                             "--union", str(labeled), "--device", DEVICE,
                             *TRAIN_OVERRIDES])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    ds = ManifestDataset(out, TR.build_vocab(cfg))
    rows = [ds[i] for i in range(len(ds))]
    log(f"[phase22] selftrain (timit teacher after 1 step, beam 5, "
        f"--keep-frac 0.5 --union, 8 files): {stats}; {wall:.1f} s wall "
        f"(the Solver's start-up included); kernel launches {launches}; "
        f"the output read back as a training manifest: {len(rows)} rows, "
        f"token counts {[len(u.tokens) for u in rows]} ({card})")
    require(rc == 0 and stats["total"] == 8 and len(rows) == 1
            + stats["kept"] and all(len(u.tokens) > 0 and len(u.audio) > 0
                                    for u in rows),
            f"selftrain {stats}, {len(rows)} manifest rows")
    require(launches.get("fused_post_fft", 0) > 0
            and launches.get("lstm_scan_fwd", 0) > 0,
            f"selftrain decoded without K1 / K2: {launches}")
    return launches, {"selftrain_wall_s": wall}


def phase22(d: Path, card: str) -> tuple[dict, dict]:
    """Phase 22: BEST-RQ pretraining of ls100_semi's listener through the
    CLI (a), resumed in fresh processes (b), a step kernels against plain
    (c), the transfer into ls100_semi with the listener frozen (d), the
    conformer's pretraining on K5 (e), a self-training round (f), each
    pretraining step's host ms and peak memory (g) -> (launches by path,
    numbers)."""
    import torch

    launches, out = {}, {}
    straight = d / "straight"
    a = pretrain_process(straight, [], "straight")
    for i, (st, w, pk) in enumerate(zip(a["steps"], a["walls"],
                                        a["peaks"])):
        log(f"[phase22] ls100_semi pretraining step {i + 1} (enc 384 x "
            f"(1 + 3) BiLSTM, bf16, B=64, bucket 400): {w:.1f} ms wall, "
            f"peak {pk:.2f} GiB; kernel launches {st} ({card})")
        require_launches(f"pretraining step {i + 1}", st, BRQ_STEP_LAUNCHES)
    recs = read_records(straight)
    log(f"[phase22] pretraining CLI in a fresh process: {a['result']}; "
        f"metrics.jsonl {[{k: r[k] for k in r if k.startswith('bestrq_')} for r in recs]}")
    require(len(a["steps"]) == 4 and [r["step"] for r in recs]
            == [1, 2, 3, 4] and all(math.isfinite(v) for r in recs
                                    for k, v in r.items()
                                    if k.startswith("bestrq_")),
            f"pretraining records {recs}")
    launches["bestrq_pretrain"] = a["launches"]
    out["bestrq_step_ms"] = statistics.median(a["walls"][1:3])
    out["bestrq_peak_gib"] = max(a["peaks"])

    split = d / "split"
    pretrain_process(split, ["pretrain.total_steps=2"], "split_2")
    b = pretrain_process(split, [], "split_4")
    diff = first_difference(bestrq_state(straight), bestrq_state(split))
    log(f"[phase22] 2 steps, then the same command to 4 in a fresh process "
        f"(resumed: {'bestrq resumed from step 2' in b['stderr']}): step "
        f"4's parameters and Adam state "
        f"{'bitwise equal' if diff is None else 'differ first at ' + diff}"
        f" to the straight run's")
    require(diff is None and "bestrq resumed from step 2" in b["stderr"],
            f"the resumed pretraining differs at {diff}")

    out.update(bestrq_vs_plain(d, card))
    fl, res = bestrq_finetune(d, straight, card)
    launches["bestrq_finetune_frozen"] = fl
    out.update(res)
    cl, res = bestrq_conformer(d, card)
    launches["bestrq_conformer"] = cl
    out.update(res)
    sl, res = bestrq_selftrain(d, card)
    launches["selftrain"] = sl
    out.update(res)
    log(f"[phase22] pretraining step host ms (median of steps 2-3) "
        f"ls100_semi {out['bestrq_step_ms']:.1f} ms, peak "
        f"{out['bestrq_peak_gib']:.2f} GiB; ls960_conformer (B=32) "
        f"{out['bestrq_conformer_step_ms']:.1f} ms, peak "
        f"{out['bestrq_conformer_peak_gib']:.2f} GiB ({card})")
    log(f"[phase22] summary {json.dumps(out)}")
    torch.cuda.empty_cache()
    return launches, out


# phase 23: contextual biasing at full width and the serving export.  (a)
# biased decodes of one padded batch at bucket 400 in float32 through
# Recognizer (the trie from decode.bias_phrases, a phrase file built from
# the vocabulary, bonus BIAS_BONUS: large enough to force phrases on random
# weights), kernels against backend="reference": ls100_semi beam 5,
# ls100_ctc prefix beam 8 and its biased best-path walk, ls100_transducer
# beam 4 and its biased greedy walk; ls100_transducer_streaming streamed
# (greedy and beam 4, biased) against its offline decode in float32.  (b)
# the export, in bfloat16 as the recipes ship, so that each program runs
# the kernel routes serving runs: ls100_semi's biased beam 5 (B=8, 400
# frames; the listener on K2's bf16 cluster route, the weights of (a)'s
# model directory), ls960_conformer with attn_backend=flash (greedy, B=8,
# 400 frames; K5f's bf16 route) and ls100_transducer_streaming's biased
# beam-4 streaming bundle (the listener on K2's bf16 grid route), each
# saved, then loaded and run in a fresh process that imports torch and the
# port's op module only, and held to the live decode on the kernels in the
# same dtype (tokens equal, scores within 1e-6).  The offline programs
# unroll decode.max_decode_len steps: cut to EXPORT_DEPTH to hold the
# phase's time (widths as shipped); ``--export-depth N`` times the float32
# ls100_semi program at depth N alone.  The conformer's program is cut to
# EXPORT_CONFORMER_BLOCKS of its 16 blocks (a depth cut, widths as
# shipped: at 16 blocks its 468 MB of float32 weights took 10 s to save and
# 23 s to load on an H100 80GB HBM3 at 700 W).  No program is exported on
# the plain versions: a plain BLSTM listener's program would unroll every
# step of its scans (~750 at 400 frames); (a) holds the biased decodes to
# the plain versions in float32, and earlier phases the bf16 kernels.  Each
# fresh process runs beside the next export, the last beside (a)'s biased
# streams: its load and call times are taken under that load.
PHASE23_BUDGET_S = 90
BIAS_BONUS = 3.0
BIAS_DATA = ["data.dataset=synthetic", "data.num_synthetic_utts=64"]
BIAS_RECIPES = {
    "las": (SEMI_CONFIG, [], ("beam",)),
    "ctc": (CTC_CONFIG, ["decode.beam_size=8"], ("beam", "greedy")),
    "td": (TD_CONFIG, ["decode.beam_size=4"], ("beam", "greedy")),
}
BIAS_FILES = 8
EXPORT_DEPTH = 8
EXPORT_CONFORMER_BLOCKS = 1
EXPORT_BATCH, EXPORT_FRAMES = 8, 400
# what a fresh process runs: the program (offline: one warm-up call and
# one timed call; streaming: the bundle's host loop, as StreamingArtifact
# drives it), importing torch and the op module alone
FRESH_RUN = r'''
import json, sys, time
import torch
import semi_supervised_asr_tpu_torch.ops.library  # registers the ops
from semi_supervised_asr_tpu_torch import _native   # the launch counts
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kind, path, inputs, out = sys.argv[1:5]


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


t0 = time.perf_counter()
if kind == "offline":
    fn = torch.export.load(path).module()
    load_s = time.perf_counter() - t0
    audio, lens = torch.load(inputs)
    fn(audio, lens)
    sync()
    _native.reset_launches()
    t1 = time.perf_counter()
    toks, scores = fn(audio, lens)
    sync()
    call_ms = (time.perf_counter() - t1) * 1e3
    torch.save((toks.cpu(), scores.cpu()), out)
else:
    meta = json.load(open(path + "/manifest.json"))["streaming"]
    progs = {n: torch.export.load(path + "/" + f).module()
             for n, f in meta["files"].items()}
    load_s = time.perf_counter() - t0
    wav = torch.load(inputs)
    _native.reset_launches()
    t1 = time.perf_counter()
    state = progs["init"]()
    cs, hop = meta["chunk_samples"], meta["hop_length"]
    step = meta["chunk_frames"] * hop
    pos = 0
    while len(wav) - pos >= cs:
        state = progs["chunk"](state, wav[pos: pos + cs])
        pos += step
    rem = len(wav) - pos
    dec = state[1]
    if rem >= meta["n_fft"]:
        audio = torch.zeros((cs,), device=wav.device)
        audio[:rem] = wav[pos:]
        dec = progs["final"](state, audio, torch.tensor(
            rem, dtype=torch.int32, device=wav.device))
    toks, count, score = progs["emit"](dec)
    sync()
    call_ms = (time.perf_counter() - t1) * 1e3
    torch.save((toks[: int(count)].cpu(), score.cpu()), out)
print(json.dumps({"load_s": load_s, "call_ms": call_ms,
                  "launches": {k: v for k, v in _native.LAUNCHES.items()
                               if v}}))
'''


def phrase_file(d: Path, vocab) -> Path:
    """Three phrases of the vocabulary's labels (two and three letters),
    written one a line; each must encode back to its labels."""
    labels = [i for i in range(4, vocab.size)
              if vocab.decode_text([i]).strip()]
    phrases = [labels[3:5], labels[5:8], labels[8:10]]
    hot = d / "hot.txt"
    hot.write_text("".join(vocab.decode_text(p) + "\n" for p in phrases))
    from semi_supervised_asr_tpu_torch.decode import biasing as BZ

    require(BZ.load_bias_phrases(str(hot), vocab) == phrases,
            f"phrases do not encode back: {phrases}")
    return hot


def bias_recognizers(config: Path, extra: list, d: Path, bias: bool = True,
                     plain: bool = True, dtype: str = "float32"):
    """A recipe's Recognizer (``Recognizer.from_dir`` on a model directory
    written to ``d``, in ``dtype``, biased by a phrase file of its
    vocabulary unless ``bias`` is off), the same on the plain versions
    (None unless ``plain``), the same model without biasing, and a padded
    batch of the recipe's batch size at bucket 400."""
    import torch

    from semi_supervised_asr_tpu_torch import synthetic
    from semi_supervised_asr_tpu_torch import transcribe as TR

    d.mkdir(parents=True)
    keys = [*BIAS_DATA, f"model.compute_dtype={dtype}", *extra]
    cfg = TR.load_config(config, keys)
    vocab = TR.build_vocab(cfg)
    if bias:
        hot = phrase_file(d, vocab)
        cfg = TR.load_config(config, [
            *keys, f"decode.bias_phrases={hot}",
            f"decode.bias_bonus={BIAS_BONUS}"])
    cfg = TR.finalize_config(cfg, vocab.size)
    files = synthetic.write_wavs(d, cfg, vocab, BIAS_FILES, min_tokens=8,
                                 max_tokens=20)
    synthetic.write_model_dir(d, cfg, files, seed=0)
    ker = TR.Recognizer.from_dir(cfg, d, DEVICE)
    ref = (TR.Recognizer.from_dir(cfg, d, DEVICE, backend="reference")
           if plain else None)
    bare = TR.Recognizer(ker.cfg, ker.model, (ker.mean.cpu(),
                         ker.inv_std.cpu()), ker.vocab, torch.device(DEVICE))
    pieces = [TR.load_audio(files[r % len(files)])
              for r in range(cfg.train.batch_size - 4)]
    return ker, ref, bare, TR.pad_batch(
        pieces, ker.spec.samples_for_frames(400), cfg)


def biased_greedy(rec, audio, lens, trie):
    """The greedy walk of the CTC family (the best path) or the transducer
    on ``rec``'s encoder, biased by ``trie`` (None: unbiased) -> (tokens,
    scores) as numpy."""
    import torch

    from semi_supervised_asr_tpu_torch.decode import ctc as CTC
    from semi_supervised_asr_tpu_torch.decode import biasing as BZ
    from semi_supervised_asr_tpu_torch.decode.transducer_greedy import (
        transducer_greedy_from_enc,
    )
    from semi_supervised_asr_tpu_torch.transcribe import max_decode_steps

    cfg = rec.cfg
    with torch.inference_mode():
        a = torch.as_tensor(audio, device=DEVICE)
        n = torch.as_tensor(lens, dtype=torch.int32, device=DEVICE)
        enc, mask = rec.encode(a, n)
        max_u = max_decode_steps(cfg, enc.shape[1])
        if rec.ctc_family:
            c = CTC.ctc_greedy_stream(
                rec.model.ctc, enc, mask, max_u,
                CTC.ctc_greedy_stream_init(enc.shape[0], max_u, DEVICE,
                                           bias=trie is not None),
                bias=trie)
            toks, scores = c[1], c[3]
            if trie is not None:
                scores = scores + c[-1] - BZ.bias_pending(trie, c[-2])
        else:
            toks, scores = transducer_greedy_from_enc(
                rec.model, cfg.model, enc, mask, max_u,
                cfg.decode.max_symbols, bias=trie)
    return toks.cpu().numpy(), scores.cpu().numpy()


def biased_decodes(d: Path, card: str) -> tuple[dict, dict, tuple]:
    """Phase 23 (a)'s offline decodes -> (launches by decode, numbers,
    ls100_semi's (config, model directory, the first EXPORT_BATCH rows of
    its batch) for the export)."""
    import numpy as np
    import torch

    from semi_supervised_asr_tpu_torch import _native

    launches, out = {}, {}
    for name, (config, extra, modes) in BIAS_RECIPES.items():
        ker, ref, bare, (audio, lens) = bias_recognizers(config, extra,
                                                         d / name)
        require(ker.bias is not None and ref.bias is not None
                and bare.bias is None, f"{name}: no trie")
        if name == "las":
            las = (ker.cfg, d / name,
                   (audio[:EXPORT_BATCH], lens[:EXPORT_BATCH]))
        for mode in modes:
            tag = f"bias_{name}_{mode}"

            def run(rec, trie):
                if mode == "beam":
                    return rec.decode(audio, lens, "beam")
                return biased_greedy(rec, audio, lens, trie)

            _native.reset_launches()
            tk, sk = run(ker, ker.bias)
            torch.cuda.synchronize()
            launches[tag] = {k: v for k, v in _native.LAUNCHES.items() if v}
            # host ms of one biased and one unbiased call, both warm
            bare_out = []
            out[tag + "_bare_ms"] = host_ms(
                lambda: bare_out.append(run(bare, None)), 1)[0]
            out[tag + "_ms"] = host_ms(lambda: run(ker, ker.bias), 1)[0]
            tb = bare_out[0][0]
            if mode == "beam":
                tr, sr = ref.decode(audio, lens, "beam")
            else:
                tr, sr = biased_greedy(ref, audio, lens, ref.bias)
            same = float(np.mean(np.all(tk == tr, axis=1)))
            score_err = float(np.max(np.abs(sk - sr) / np.maximum(
                np.abs(sr), 1.0)))
            moved = float(np.mean(np.any(tk != tb, axis=1)))
            log(f"[phase23] {name} {mode} biased ({ker.bias.next_node.shape[0]}"
                f" trie nodes, bonus {BIAS_BONUS}; B={len(lens)}, bucket 400,"
                f" float32): host ms biased {out[tag + '_ms']:.1f}, unbiased "
                f"{out[tag + '_bare_ms']:.1f} (one warm call each); launches "
                f"{launches[tag]}; rows with identical tokens kernels vs plain"
                f" {same:.3f}, scores within {score_err:.2e} relative; rows "
                f"the bias changed {moved:.3f} ({card})")
            require(same == 1.0, f"{tag}: tokens differ from plain")
            require(score_err <= 1e-4, f"{tag}: scores differ {score_err}")
            require(moved > 0.0, f"{tag}: the bias changed no row")
            require(launches[tag].get("fused_post_fft", 0) == 1
                    and launches[tag].get("lstm_scan_fwd", 0) > 0,
                    f"{tag}: {launches[tag]}")
        del ker, ref, bare
        torch.cuda.empty_cache()
    return launches, out, las


def stream_trie(d: Path):
    """ls100_transducer_streaming's biasing trie from a phrase file of its
    vocabulary (written to ``d``)."""
    from semi_supervised_asr_tpu_torch import transcribe as TR
    from semi_supervised_asr_tpu_torch.decode import biasing as BZ

    vocab = TR.build_vocab(TR.load_config(TD_STREAM_CONFIG, TD_DATA))
    d.mkdir(parents=True)
    return BZ.build_bias_trie(
        BZ.load_bias_phrases(str(phrase_file(d, vocab)), vocab),
        vocab.size, BIAS_BONUS, DEVICE)


def biased_streams(trie, card: str) -> dict:
    """Phase 23 (a)'s streams: ls100_transducer_streaming biased, streamed
    == offline in float32 (greedy and beam 4) -> the launches."""
    from semi_supervised_asr_tpu_torch import _native

    cfg, model = stream_model(TD_STREAM_CONFIG, "float32")
    wavs, cmvn = stream_audio(cfg, 2)
    _native.reset_launches()
    for beam in (1, 4):
        for i, wav in enumerate(wavs):
            off, off_score = offline_tokens(model, cfg, cmvn, wav, beam,
                                            bias=trie)
            toks, score, calls, ms = streamed(model, cfg, cmvn, wav, beam,
                                              320, bias=trie)
            log(f"[phase23] ls100_transducer_streaming {'beam 4' if beam > 1 else 'greedy'} "
                f"biased, file {i} ({len(wav)} samples, float32): streamed "
                f"{len(toks)} tokens in {calls} chunk calls, {ms:.1f} ms; "
                f"equal to offline {toks == off}; scores {score:.4f} vs "
                f"{off_score:.4f} ({card})")
            require(toks == off and abs(score - off_score)
                    <= 1e-4 * max(abs(off_score), 1.0),
                    f"biased stream {i} (beam {beam}) differs from offline: "
                    f"{toks} vs {off}, {score} vs {off_score}")
    return {k: v for k, v in _native.LAUNCHES.items() if v}


def fresh_runs(kind: str, jobs: list, started: list):
    """Start exported programs, each in a fresh process (torch and the op
    module only), all at once: ``jobs`` of (program path, inputs, output
    file), the processes appended to ``started`` (the caller kills what is
    left of them) -> a function that waits for them and returns each run's
    load seconds, call ms and launch counts."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", FRESH_RUN, kind, str(path), str(inputs),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)})
        for path, inputs, out in jobs]
    started.extend(procs)
    return lambda: fresh_wait(kind, jobs, procs)


def fresh_wait(kind: str, jobs: list, procs: list) -> list[dict]:
    runs = []
    for (path, _, _), proc in zip(jobs, procs):
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        require(proc.returncode == 0, f"fresh {kind} run of {path} failed:"
                f"\n{out}\n{err[-4000:]}")
        runs.append(json.loads(out.strip().splitlines()[-1]))
    return runs


def export_offline(rec, d: Path, tag: str, mode: str, card: str,
                   batch_rows, started: list, routes: tuple):
    """Export ``rec``'s decode, save it and start it in a fresh process
    (appended to ``started``) on ``batch_rows``, to be held to ``rec``'s
    live decode -> a function that waits for the run, checks it (the
    launch counters ``routes`` must have risen there) and returns
    (launches in the fresh run, numbers)."""
    import copy

    import torch

    from semi_supervised_asr_tpu_torch import export as EX

    audio, lens = batch_rows
    inputs = d / f"{tag}_inputs.pt"
    torch.save((torch.as_tensor(audio, device=DEVICE),
                torch.as_tensor(lens, dtype=torch.int32, device=DEVICE)),
               inputs)
    live = rec.decode(audio, lens, mode)
    if live[1].ndim == 2:
        # greedy: the per-step log-probs, summed on the card as the
        # program sums them
        live = (live[0], torch.as_tensor(live[1], device=DEVICE).sum(
            dim=-1).cpu().numpy())
    t0 = time.perf_counter()
    ep = EX.export_decode(rec.cfg, copy.deepcopy(rec.model),
                          (rec.mean, rec.inv_std), EXPORT_BATCH,
                          EXPORT_FRAMES, mode,
                          bias=rec.bias if mode == "beam" else None,
                          vocab=rec.vocab)
    export_s = time.perf_counter() - t0
    ops = {str(n.target).split(".")[1] for n in ep.graph.nodes
           if str(n.target).startswith("ssasr_torch.")}
    # the dtype of K5f's q in the graph (its route)
    attn = {str(n.args[0].meta["val"].dtype).removeprefix("torch.")
            for n in ep.graph.nodes
            if str(n.target).startswith("ssasr_torch.flash_mhsa_fwd")}
    path = d / f"{tag}.pt2"
    t0 = time.perf_counter()
    torch.export.save(ep, str(path))
    made = (path, ops, attn, len(ep.graph.nodes), export_s,
            time.perf_counter() - t0)
    del ep
    wait = fresh_runs("offline", [(path, inputs, d / f"{tag}_out.pt")],
                      started)
    return lambda: program_checks(tag, mode, card, made, wait()[0], live,
                                  rec.cfg, d, routes)


def program_checks(tag: str, mode: str, card: str, made: tuple, run: dict,
                   live, cfg, d: Path, routes: tuple) -> tuple[dict, dict]:
    """:func:`export_offline`'s checks of the fresh ``run`` of the program
    ``made`` against the ``live`` decode -> (launches, numbers)."""
    import numpy as np
    import torch

    path, ops, attn, nodes, export_s, save_s = made
    toks, scores = (x.numpy() for x in torch.load(d / f"{tag}_out.pt"))
    nums = {tag + "_export_s": export_s, tag + "_bytes": path.stat().st_size,
            tag + "_load_s": run["load_s"], tag + "_call_ms": run["call_ms"]}
    m = cfg.model
    log(f"[phase23] export {tag} ({mode}, {m.compute_dtype}, B={EXPORT_BATCH}"
        f", {EXPORT_FRAMES} frames, decode.max_decode_len "
        f"{cfg.decode.max_decode_len}): {nodes} graph nodes, ops "
        f"{sorted(ops)}{f', K5f q {sorted(attn)}' if attn else ''}; export "
        f"{export_s:.1f} s, save {save_s:.1f} s, {path.stat().st_size} "
        f"bytes; fresh process (beside phase 23's next work): load "
        f"{run['load_s']:.1f} s, one call {run['call_ms']:.1f} ms, launches "
        f"{run['launches']} ({card})")
    require(ops >= ({"fused_post_fft", "lstm_scan_fwd"}
                    if m.encoder_arch == "blstm" else
                    {"fused_post_fft", "flash_mhsa_fwd"}),
            f"{tag}: the graph holds {ops}")
    require(m.encoder_arch == "blstm" or attn == {str(m.compute_dtype)},
            f"{tag}: K5f runs {attn} in a {m.compute_dtype} program")
    require(all(run["launches"].get(r, 0) > 0 for r in routes),
            f"{tag}: the fresh run launched {run['launches']}, not {routes}")
    same_live = bool((toks == live[0]).all())
    score_err = float(np.abs(scores - live[1]).max())
    log(f"[phase23] {tag}: fresh-process tokens equal to the live decode "
        f"{same_live} (scores within {score_err:.2e}) ({card})")
    require(same_live and score_err <= 1e-6, f"{tag}: program != live")
    return run["launches"], nums


def export_stream(d: Path, card: str, started: list, trie):
    """ls100_transducer_streaming's biased beam-4 bundle in bfloat16 (as
    shipped), started in a fresh process (appended to ``started``), to be
    held to the live StreamingTranscriber on the kernels -> a function that
    waits for it, checks it and returns (launches in the fresh run,
    numbers)."""
    import copy

    import torch

    from semi_supervised_asr_tpu_torch import export as EX

    cfg, model = stream_model(TD_STREAM_CONFIG, "bfloat16")
    cfg = cfg.replace(decode=dataclasses.replace(cfg.decode, beam_size=4))
    wavs, cmvn = stream_audio(cfg, 1)
    wav = wavs[0]
    live = streamed(model, cfg, cmvn, wav, 4, 320, bias=trie)
    inputs = d / "stream_wav.pt"
    torch.save(torch.from_numpy(wav).to(DEVICE), inputs)
    out = d / "export_stream"
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    b = EX.export_streaming(cfg, copy.deepcopy(model), cmvn, "beam",
                            bias=trie)
    export_s = time.perf_counter() - t0
    files, size, ops = {}, 0, set()
    for name, ep in b["programs"].items():
        ops |= {str(n.target).split(".")[1] for n in ep.graph.nodes
                if str(n.target).startswith("ssasr_torch.")}
        torch.export.save(ep, str(out / f"{name}.pt2"))
        files[name] = f"{name}.pt2"
        size += (out / f"{name}.pt2").stat().st_size
    (out / "manifest.json").write_text(json.dumps(
        {"streaming": {**b["meta"], "files": files}}))
    made = (ops, size, export_s, b["meta"])
    wait = fresh_runs("stream", [(out, inputs, d / "export_stream_out.pt")],
                      started)
    return lambda: bundle_checks(card, made, wait()[0], live, len(wav), d)


def bundle_checks(card: str, made: tuple, run: dict, live, samples: int,
                  d: Path) -> tuple[dict, dict]:
    """:func:`export_stream`'s checks of the fresh ``run`` of the bundle
    ``made`` against the ``live`` stream -> (launches, numbers)."""
    import torch

    ops, size, export_s, meta = made
    toks, score = torch.load(d / "export_stream_out.pt")
    toks, score = [int(x) for x in toks.tolist()], float(score)
    nums = {"export_stream_export_s": export_s, "export_stream_bytes": size,
            "export_stream_load_s": run["load_s"],
            "export_stream_call_ms": run["call_ms"]}
    log(f"[phase23] export_stream (beam 4, biased, bfloat16, chunks of "
        f"{meta['chunk_frames']} frames): ops {sorted(ops)}; export "
        f"{export_s:.1f} s, {size} bytes; fresh process (beside phase 23's "
        f"next work): load {run['load_s']:.1f} s, the file ({samples} "
        f"samples) {run['call_ms']:.1f} ms, launches {run['launches']} "
        f"({card})")
    require(ops >= {"fused_post_fft", "lstm_scan_fwd"},
            f"export_stream: the graph holds {ops}")
    require(run["launches"].get("lstm_scan_fwd_grid", 0) > 0,
            f"export_stream: the listener left the bf16 grid route: "
            f"{run['launches']}")
    log(f"[phase23] streaming bundle: tokens equal to the live "
        f"StreamingTranscriber {toks == live[0]} ({len(toks)} tokens; scores"
        f" {score:.6f} vs {live[1]:.6f}) ({card})")
    require(toks == live[0] and abs(score - live[1]) <= 1e-6,
            "the streaming bundle differs from the live stream")
    return run["launches"], nums


def export_las(las: tuple, d: Path, card: str, started: list):
    """ls100_semi's biased beam-5 program in bfloat16 (as shipped) at
    EXPORT_DEPTH, from (a)'s model directory and rows -> as
    :func:`export_offline`."""
    from semi_supervised_asr_tpu_torch import transcribe as TR

    cfg, model_dir, rows = las
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
        decode=dataclasses.replace(cfg.decode, max_decode_len=EXPORT_DEPTH))
    rec = TR.Recognizer.from_dir(cfg, model_dir, DEVICE)
    return export_offline(rec, d, "export_las", "beam", card, rows, started,
                          ("fused_post_fft", "lstm_scan_fwd_cluster"))


def export_conformer(d: Path, card: str, started: list):
    """ls960_conformer's flash greedy program in bfloat16 (as shipped),
    cut to EXPORT_CONFORMER_BLOCKS blocks, at EXPORT_DEPTH -> as
    :func:`export_offline`."""
    rec, _, _, (audio, lens) = bias_recognizers(
        CONFORMER_CONFIG, [*CONFORMER_OVERRIDES,
                           f"model.enc_blocks={EXPORT_CONFORMER_BLOCKS}",
                           f"decode.max_decode_len={EXPORT_DEPTH}"],
        d / "conformer", bias=False, plain=False, dtype="bfloat16")
    return export_offline(rec, d, "export_conformer", "greedy", card,
                          (audio[:EXPORT_BATCH], lens[:EXPORT_BATCH]),
                          started, ("fused_post_fft", "flash_mhsa_fwd"))


def op_cost(card: str, calls: int = 200) -> dict:
    """What a custom op adds to a launch: K1, K2 and K5's forward called
    through their ``ssasr_torch`` op and through their launch function,
    in turns, at shapes whose device time is small (one streamed chunk:
    B=1, 8 frames) -> host us a call of each, over ``calls`` calls with
    the queue drained before and after."""
    import torch

    from semi_supervised_asr_tpu_torch.config import FrontendConfig
    from semi_supervised_asr_tpu_torch.ops import flash_mhsa as FM
    from semi_supervised_asr_tpu_torch.ops import frontend as F
    from semi_supervised_asr_tpu_torch.ops import fused_frontend as FF
    from semi_supervised_asr_tpu_torch.ops import library as LIB
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    g = torch.Generator(device=DEVICE).manual_seed(0)
    fcfg = FrontendConfig()
    runs = FF._mel_runs_on(fcfg, DEVICE)
    _, fb = F.constants(fcfg, DEVICE)
    pspec = torch.rand((1, 8, fcfg.n_fft // 2 + 1), device=DEVICE,
                       generator=g)
    flens = torch.full((1,), 8, dtype=torch.int32, device=DEVICE)
    mean = torch.zeros((fcfg.n_mels,), device=DEVICE)
    istd = torch.ones((fcfg.n_mels,), device=DEVICE)
    gx = torch.randn((1, 8, 1, 4 * 384), device=DEVICE, generator=g)
    w = torch.randn((1, 384, 4 * 384), device=DEVICE, generator=g) * 0.05
    valid = torch.ones((8, 1), device=DEVICE)
    q = torch.randn((1, 16, 4, 64), device=DEVICE, generator=g).to(
        torch.bfloat16)
    km = torch.ones((1, 16), dtype=torch.bool, device=DEVICE)
    pairs = {
        "fused_post_fft": (
            lambda: LIB.fused_post_fft(pspec, flens, *runs, fb, mean, istd,
                                       None, None, None, None,
                                       fcfg.log_floor),
            lambda: FF.launch_post_fft(pspec, flens, *runs, mean, istd,
                                       None, fcfg.log_floor)),
        "lstm_scan_fwd": (
            lambda: LIB.lstm_scan_fwd(gx, w, valid, torch.float32, 0, False,
                                      None, None, False),
            lambda: K.launch_scan_fwd(gx, w, valid, torch.float32, (False,),
                                      False, None, None, False)),
        "flash_mhsa_fwd": (
            lambda: LIB.flash_mhsa_fwd(q, q, q, km, 0.125),
            lambda: FM.mhsa_fwd(q, q, q, km, 0.125)),
    }
    out = {}
    with torch.inference_mode():
        for name, (op, direct) in pairs.items():
            us = {"op": [], "direct": []}
            for key in ("op", "direct", "op", "direct"):
                fn = op if key == "op" else direct
                fn()
                us[key] += [x * 1e3 / calls for x in host_ms(
                    lambda: [fn() for _ in range(calls)], 1)]
            out[name] = {k: statistics.median(v) for k, v in us.items()}
            log(f"[phase23] {name} through its custom op {us['op']} us a "
                f"call, its launch function {us['direct']} us (in turns, "
                f"{calls} calls at a streamed chunk's shape) ({card})")
    return out


def phase23(d: Path, card: str) -> tuple[dict, dict]:
    """Phase 23 -> (launches by path, numbers)."""
    import torch

    t0 = time.perf_counter()
    launches, out, las = biased_decodes(d / "bias", card)
    out["op_cost_us"] = op_cost(card)
    trie = stream_trie(d / "hot")
    exports, started = {}, []
    try:
        # (b): each program's fresh process runs beside the next export;
        # the bundle (the longest export) first
        exports["export_stream"] = export_stream(d, card, started, trie)
        torch.cuda.empty_cache()
        exports["export_las"] = export_las(las, d, card, started)
        torch.cuda.empty_cache()
        exports["export_conformer"] = export_conformer(d, card, started)
        torch.cuda.empty_cache()
        # (a)'s streams while the last programs load and run
        launches["bias_stream"] = biased_streams(trie, card)
        fresh = {}
        for tag, check in exports.items():
            fresh[tag], nums = check()
            out.update(nums)
    finally:
        for proc in started:
            proc.kill()
    log(f"[phase23] launches in the fresh processes {json.dumps(fresh)}")
    launches.update(fresh)
    out["phase23_s"] = time.perf_counter() - t0
    log(f"[phase23] summary {json.dumps(out)}; phase 23 took "
        f"{out['phase23_s']:.1f} s against a budget of {PHASE23_BUDGET_S} s "
        f"({card})")
    return launches, out


def export_depth_timing(depth: int) -> int:
    """``--export-depth N``: ls100_semi's biased beam-5 program (B=8, 400
    frames, float32) at decode.max_decode_len N alone: export, save, load
    and one call in a fresh process, tokens held to the live decode."""
    card = phase0()
    started = []
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        ker, _, _, (audio, lens) = bias_recognizers(
            SEMI_CONFIG, [f"decode.max_decode_len={depth}"], d / "las",
            plain=False)
        try:
            _, nums = export_offline(
                ker, d, f"export_las_depth{depth}", "beam", card,
                (audio[:EXPORT_BATCH], lens[:EXPORT_BATCH]), started,
                ("fused_post_fft", "lstm_scan_fwd_grid_f32"))()
        finally:
            for proc in started:
                proc.kill()
    log(f"[export-depth] {json.dumps(nums)} ({card})")
    return 0


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


def bound_ms(nbytes: float, flops: float,
             peak: float = BF16_FLOPS) -> tuple:
    """The larger of bytes over HBM bandwidth and operations over
    ``peak`` (bf16 tensor cores by default) -> (ms, what bounds it)."""
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def lstm_work(t: int, b: int, h: int, d: int = 2, wbytes: int = 2) -> tuple:
    """(bytes, flops) of K2 and of K3 at [D, T, B, 4H] with weights of
    ``wbytes`` a value (bf16 by default): K2 reads gates_x, w_hh and valid
    and writes h; K3 reads w_hh, valid, acts, cprev and dh_out and writes
    dgates; each step's product is 2 x 4H x H a row."""
    f4 = 4
    seq = d * t * b
    w = d * h * 4 * h * wbytes
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
    13's (ls100_semi: B=64, H=384, T=400 and 1600), phase 18's
    (TD_LSTM_SHAPES: D=1, B=64, H=768 at T=1600 and 200, H=512 at T=257,
    timed with every step valid, as counted here) and phase 20's (the MWER
    predictor: D=1, B=256, H=512, T=129) and phase 21's (F32_LSTM_SHAPES:
    the LM, D=1, B=64, H=1024, T=256, and the fusion listener's first
    layer, D=2, B=64, H=384, T=400; float32 weights and products, against
    the CUDA cores' float32 peak); K5 at phase 12's
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
    for bb, shapes in ((64, TD_LSTM_SHAPES), (MWER_BATCH, (MWER_LSTM_SHAPE,))):
        for tag, tt, _, h, _ in shapes:
            k2, k3 = lstm_work(tt, bb, h, d=1)
            work[f"lstm_scan_fwd_{tag}"] = k2
            work[f"lstm_scan_bwd_{tag}"] = k3
    lens = k5_inputs(*K5_TIMING, seed=11, odd_rows=False)[3].sum(1)
    work["flash_mhsa_fwd"], work["flash_mhsa_bwd"] = k5_work(K5_TIMING, lens)
    f32_work = {}
    for tag, tt, _, h, d, _ in F32_LSTM_SHAPES:
        f32_work.update(zip((f"lstm_scan_fwd_{tag}", f"lstm_scan_bwd_{tag}"),
                            lstm_work(tt, LM_BATCH, h, d=d, wbytes=4)))
    out = {}
    for name, (nbytes, flops) in {**work, **f32_work}.items():
        peak = F32_FLOPS if name in f32_work else BF16_FLOPS
        out[name] = bound_ms(nbytes, flops, peak)
        log(f"[bound] {name}: {nbytes / 1e6:.1f} MB -> "
            f"{nbytes / HBM_BYTES_S * 1e3:.4f} ms, {flops / 1e9:.2f} GFLOP "
            f"-> {flops / peak * 1e3:.4f} ms")
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
    p.add_argument("--c5-rank", nargs=2, metavar=("PART", "DIR"),
                   help=argparse.SUPPRESS)   # phase 15's ranks (torchrun)
    p.add_argument("--pretrain-run", nargs=argparse.REMAINDER,
                   help=argparse.SUPPRESS)   # phase 22's pretraining CLI
    p.add_argument("--export-depth", type=int, default=None, metavar="N",
                   help="time the export of ls100_semi's biased beam-5 "
                        "float32 program at decode.max_decode_len N alone, "
                        "and exit")
    p.add_argument("--k2-bits", nargs=2, metavar=("ROOT", "JSON"),
                   type=Path,
                   help="hash stateless K2 outputs of the package under ROOT "
                        "into JSON, or compare them with JSON's")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    if args.k2_bits:
        return k2_bits(*args.k2_bits)
    sys.path.insert(0, str(ROOT))
    if args.c5_rank:
        part, out = args.c5_rank
        {"a": c5_rank_a, "b": c5_rank_b}[part](Path(out))
        return 0
    if args.pretrain_run:
        pretrain_run(Path(args.pretrain_run[0]), args.pretrain_run[1:])
        return 0
    if args.export_depth:
        from semi_supervised_asr_tpu_torch import strict_fp32

        strict_fp32()
        phase1()
        return export_depth_timing(args.export_depth)
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
    with tempfile.TemporaryDirectory() as tmp:
        c5_launches, c5_work = phase15(Path(tmp), card)
        if args.profile is not None:
            profile(c5_work, args.profile)
        del c5_work
    elapsed("phase 15")
    with tempfile.TemporaryDirectory() as tmp:
        bpe_launches, p16 = phase16(Path(tmp), card)
    elapsed("phase 16")
    with tempfile.TemporaryDirectory() as tmp:
        ctc_launches, aed_launches, p17 = phase17(Path(tmp), card)
    elapsed("phase 17")
    with tempfile.TemporaryDirectory() as tmp:
        td_launches, p18, td_errs = phase18(Path(tmp), card)
    elapsed("phase 18")
    with tempfile.TemporaryDirectory() as tmp:
        cs_launches, p19 = phase19(Path(tmp), card)
    elapsed("phase 19")
    with tempfile.TemporaryDirectory() as tmp:
        p20_launches, p20, p20_errs = phase20(Path(tmp), card)
    elapsed("phase 20")
    with tempfile.TemporaryDirectory() as tmp:
        p21_launches, p21, p21_errs = phase21(Path(tmp), card)
    elapsed("phase 21")
    with tempfile.TemporaryDirectory() as tmp:
        p22_launches, p22 = phase22(Path(tmp), card)
    elapsed("phase 22")
    with tempfile.TemporaryDirectory() as tmp:
        p23_launches, p23 = phase23(Path(tmp), card)
    elapsed("phase 23")
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
        f"validations) launches {solver_launches}; C5 run under torchrun "
        f"(3 steps, 1 validation) launches {c5_launches}; ls100_bpe "
        f"Solver run (3 steps) launches {bpe_launches}, step "
        f"{p16['bpe_step_ms']:.1f} ms wall; ls960_transformer step "
        f"launches {p16['transformer_launches']}; ls100_ctc Solver run (3 "
        f"steps, 1 validation) launches {ctc_launches}, step "
        f"{p17['ctc_step_ms']:.1f} ms wall at bucket 400, "
        f"{p17['ctc_step_1600_ms']:.1f} ms at 1600; ls960_aed main --train "
        f"(3 steps, 1 validation) launches {aed_launches}, step "
        f"{p17['aed_step_ms']:.1f} ms wall; transducer Solver runs "
        f"launches {td_launches}, ls100_transducer step "
        f"{p18['td_step_ms']:.1f} ms wall at bucket 400, "
        f"{p18['td_step_1600_ms']:.1f} ms at 1600 / 256 (peak "
        f"{p18['td_step_1600_peak_gib']:.2f} GiB), ls100_transducer_semi "
        f"step {p18['td_semi_step_ms']:.1f} ms, streaming step "
        f"{p18['td_stream_step_ms']:.1f} ms (in turns: listener on the "
        f"CUDA-core route {p18['td_stream_step_simt_ms']:.1f} ms, on the "
        f"grid route {p18['td_stream_step_grid_ms']:.1f} ms)")
    for tag, name in (("cs", "ls100_conformer_streaming"),
                      ("ts", "ls100_transducer_streaming")):
        log(f"[summary] {name} streaming, bf16 greedy: "
            f"{p19[tag + '_stream_chunk_ms']:.2f} ms a chunk for one stream "
            f"(real-time factor {p19[tag + '_stream_rtf']:.4f}), "
            f"{p19[tag + '_stream_round_ms']:.2f} ms a {MULTI_STREAMS}-stream "
            f"round (real-time factor {p19[tag + '_stream_round_rtf']:.4f}); "
            f"launches a chunk K1 {p19[tag + '_stream_k1_a_chunk']:.2f}, K2 "
            f"{p19[tag + '_stream_k2_a_chunk']:.2f}; bf16 streamed == offline "
            f"tokens on {p19[tag + '_stream_bf16_agree']:.2f} of the files "
            f"({card})")
    for name in MWER_RECIPES:
        log(f"[summary] {name} MWER step (K=4, bf16, B=64, bucket 400 / "
            f"128): {p20[name + '_step_ms']:.1f} ms wall against "
            f"{p20[name + '_ce_step_ms']:.1f} ms without the term; peak "
            f"{p20[name + '_peak_gib']:.2f} GiB; launches "
            f"{p20_launches['mwer_' + name]}; float32 n-best equal kernels "
            f"vs plain on {p20[name + '_float32_nbest_same']:.3f} of the "
            f"rows, bf16 on {p20[name + '_bfloat16_nbest_same']:.3f} "
            f"({card})")
    log(f"[summary] ls100_transducer MWER step at 1600 / 256 with "
        f"joint_chunk_frames=8: {p20['td_1600_step_ms']:.1f} ms, peak "
        f"{p20['td_1600_peak_gib']:.2f} GiB; CTC pseudo-label step launches "
        f"{p20_launches['ctc_pseudo']}; timestamps launches "
        + json.dumps({k: v for k, v in p20_launches.items()
                      if "stamp" in k or k == "align"}) + f" ({card})")
    log(f"[summary] ls100_conformer_streaming step {p19['cs_step_ms']:.1f} ms "
        f"wall at 448 frames, {p19['cs_step_1600_ms']:.1f} ms at 1600 / 256 "
        f"(peak {p19['cs_step_1600_peak_gib']:.2f} GiB); launches "
        f"{cs_launches} ({card})")
    for kind in ("fwd", "bwd"):
        name = "lstm_scan_" + kind
        for tag, t, _, h, _ in TD_LSTM_SHAPES:
            key = f"td_{tag}_"
            ms, (bms, by) = p18[key + kind + "_b2b"], bound[f"{name}_{tag}"]
            floor = ""
            if key + "floor_" + kind + "_b2b" in p18:
                floor = (f"; serial floor {p18[key + 'floor_' + kind + '_b2b']:.4f}"
                         f" ms (the barrier alone "
                         f"{p18[key + 'barrier_' + kind + '_b2b']:.4f} ms)")
            log(f"[summary] {name} at {tag} (B=64, T={t}, H={h}, D=1, bf16, "
                f"{td_errs[tag][2]} route): {ms:.4f} ms device (back to "
                f"back), {ms / t * 1e3:.2f} us a step{floor}; bound "
                f"{bms:.4f} ms ({by}), share {bms / ms:.3f}; "
                f"plain {p18[key + kind + '_plain_call']:.1f} ms a call; the "
                f"port's layer {kind} {p18[key + 'port_layer_' + kind + '_b2b']:.4f}"
                f" ms against cuDNN's {p18[key + 'cudnn_layer_' + kind + '_b2b']:.4f}"
                f" ms ({card})")
    tag, t, _, h, _ = MWER_LSTM_SHAPE
    for kind in ("fwd", "bwd"):
        key, name = f"td_{tag}_", "lstm_scan_" + kind
        ms, (bms, by) = p20[key + kind + "_b2b"], bound[f"{name}_{tag}"]
        log(f"[summary] {name} at {tag} (B={MWER_BATCH}, T={t}, H={h}, D=1, "
            f"bf16, {p20_errs[tag][2]} route): {ms:.4f} ms device (back to "
            f"back), {ms / t * 1e3:.2f} us a step; bound {bms:.4f} ms ({by}), "
            f"share {bms / ms:.3f}; plain "
            f"{p20[key + kind + '_plain_call']:.1f} ms a call; the port's "
            f"layer {kind} {p20[key + 'port_layer_' + kind + '_b2b']:.4f} ms "
            f"against cuDNN's {p20[key + 'cudnn_layer_' + kind + '_b2b']:.4f}"
            f" ms ({card})")
    for tag, t, _, h, d, _ in F32_LSTM_SHAPES:
        for kind in ("fwd", "bwd"):
            key, name = f"td_{tag}_", "lstm_scan_" + kind
            ms, (bms, by) = p21[key + kind + "_b2b"], bound[f"{name}_{tag}"]
            log(f"[summary] {name} at {tag} (B={LM_BATCH}, T={t}, H={h}, "
                f"D={d}, float32, {p21_errs[tag][2]} route): {ms:.4f} ms "
                f"device (back to back), {ms / t * 1e3:.2f} us a step, "
                f"against {p21[key + kind + '_simt_b2b']:.4f} ms on the "
                f"CUDA cores (in turns); serial floor "
                f"{p21[key + 'floor_' + kind + '_b2b']:.4f} ms (the barrier "
                f"alone {p21[key + 'barrier_' + kind + '_b2b']:.4f} ms); "
                f"bound {bms:.4f} ms ({by}), share {bms / ms:.3f}; plain "
                f"{p21[key + kind + '_plain_call']:.1f} ms a call; the "
                f"port's layer {kind} "
                f"{p21[key + 'port_layer_' + kind + '_b2b']:.4f} ms against "
                f"cuDNN's float32 "
                f"{p21[key + 'cudnn_layer_' + kind + '_b2b']:.4f} ms ({card})")
    fusion = {k: v for k, v in p21.items() if k.startswith("fusion_")}
    log(f"[summary] phase 21: LM step {p21['lm_step_ms']:.1f} ms wall "
        f"(transformer LM {p21['lm_transformer_step_ms']:.1f} ms); fused "
        f"beams host ms (with the LM / without) {json.dumps(fusion)}; cold "
        f"fusion step {p21['cold_fusion_step_ms']:.1f} ms, deep "
        f"{p21['deep_fusion_step_ms']:.1f} ms (ls100, float32; in turns, "
        f"the listener on the CUDA cores / on the float32 grid: cold "
        f"{p21['cold_fusion_step_simt_ms']:.1f} / "
        f"{p21['cold_fusion_step_grid_f32_ms']:.1f} ms, deep "
        f"{p21['deep_fusion_step_simt_ms']:.1f} / "
        f"{p21['deep_fusion_step_grid_f32_ms']:.1f} ms); launches "
        f"{json.dumps(p21_launches)} ({card})")
    log(f"[summary] phase 22: BEST-RQ pretraining step (host ms, median of "
        f"steps 2-3) ls100_semi {p22['bestrq_step_ms']:.1f} ms (peak "
        f"{p22['bestrq_peak_gib']:.2f} GiB), ls960_conformer at B=32 "
        f"{p22['bestrq_conformer_step_ms']:.1f} ms (peak "
        f"{p22['bestrq_conformer_peak_gib']:.2f} GiB); kernels vs plain "
        f"loss rel float32 {p22['bestrq_float32_loss_rel']:.2e} / bf16 "
        f"{p22['bestrq_bfloat16_loss_rel']:.2e}, targets from K1's "
        f"features equal on {p22['bestrq_float32_target_agree']:.5f}; "
        f"frozen fine-tuning step {p22['bestrq_finetune_step_ms']:.1f} ms; "
        f"launches {json.dumps(p22_launches)} ({card})")
    log(f"[summary] phase 23: biased decodes host ms "
        + json.dumps({k: v for k, v in p23.items() if k.startswith("bias_")})
        + "; export (B=8, 400 frames, decode.max_decode_len "
        f"{EXPORT_DEPTH}; the streaming bundle's 4 programs) seconds, bytes, "
        "fresh-process load seconds and one call's ms "
        + json.dumps({k: v for k, v in p23.items()
                      if k.startswith("export_")})
        + f"; launches {json.dumps(p23_launches)} ({card})")
    src = "semi_supervised_asr_tpu_torch/csrc/"
    tpu = "semi_supervised_asr_tpu/ops/"
    jax_fa = ("jax/experimental/pallas/ops/tpu/flash_attention.py:{} "
              "(jax 0.9.0), reached from " + tpu + "flash_mhsa.py:123")
    cudnn = (f"cuDNN LSTM (torch.nn.LSTM, packed, {med['cudnn_dtype']}), "
             "the whole layer at bucket 400: ")
    lstm_design = ("bf16 at H <= 512: clusters of C blocks, the weight slice "
                   "resident in shared memory, {0} through distributed "
                   "shared memory, mma.sync; bf16 above H = 512: one "
                   "co-resident grid (cooperative launch), the weight slice "
                   "resident in shared memory, {0} through L2 by step "
                   "parity with a step barrier on a global counter, "
                   "mma.sync; f32: the same grid in float32 (see the "
                   "_grid_f32 row); what fits no grid: CUDA cores")
    # launches: K1-K3 from the timit Solver run (phase 14: 4 steps and 2
    # validations), K5 from the conformer training run (phase 11), and by
    # path in launches_by_path;
    # max_abs_err: the route the main path runs (bf16 cluster route for
    # K2/K3, f32 for K1 and K5's table)
    paths = {"timit_serve": serve_launches, "timit_train": launches,
             "conformer_serve": conf_serve, "conformer_train": conf_launches,
             "c4_solver": c4_launches, "timit_solver": solver_launches,
             "c5_dp": c5_launches, "ls100_bpe": bpe_launches,
             "transformer_remat": p16["transformer_launches"],
             "ls100_ctc": ctc_launches, "ls960_aed": aed_launches,
             **td_launches, **cs_launches, **p20_launches, **p21_launches,
             **p22_launches, **p23_launches}
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
            kind = name[len("lstm_scan_"):]
            out["at_transducer"] = [
                {"shape": f"{tag}: B=64 T={t} H={h} D=1 bf16",
                 "route": td_errs[tag][2],
                 "max_abs_err": td_errs[tag][0 if kind == "fwd" else 1],
                 "ms": p18[f"td_{tag}_{kind}_b2b"],
                 "method": METHODS["b2b"][1],
                 "plain_call_ms": p18[f"td_{tag}_{kind}_plain_call"],
                 "bound_ms": bound[f"{name}_{tag}"][0],
                 "bound_by": bound[f"{name}_{tag}"][1],
                 "floor_ms": p18.get(f"td_{tag}_floor_{kind}_b2b"),
                 "barrier_ms": p18.get(f"td_{tag}_barrier_{kind}_b2b"),
                 "port_layer_ms": p18[f"td_{tag}_port_layer_{kind}_b2b"],
                 "library_ms": p18[f"td_{tag}_cudnn_layer_{kind}_b2b"],
                 "library_vs": "cuDNN LSTM (torch.nn.LSTM, one direction, "
                               "packed, bf16), the whole layer " + kind
                               + " against the port's layer"}
                for tag, t, _, h, _ in TD_LSTM_SHAPES]
            tag, t, _, h, _ = MWER_LSTM_SHAPE
            out["at_mwer_predictor"] = {
                "shape": f"{tag}: B={MWER_BATCH} T={t} H={h} D=1 bf16",
                "route": p20_errs[tag][2],
                "max_abs_err": p20_errs[tag][0 if kind == "fwd" else 1],
                "ms": p20[f"td_{tag}_{kind}_b2b"],
                "method": METHODS["b2b"][1],
                "plain_call_ms": p20[f"td_{tag}_{kind}_plain_call"],
                "bound_ms": bound[f"{name}_{tag}"][0],
                "bound_by": bound[f"{name}_{tag}"][1],
                "port_layer_ms": p20[f"td_{tag}_port_layer_{kind}_b2b"],
                "library_ms": p20[f"td_{tag}_cudnn_layer_{kind}_b2b"],
                "library_vs": "cuDNN LSTM (torch.nn.LSTM, one direction, "
                              "packed, bf16), the whole layer " + kind
                              + " against the port's layer"}
            tag, t, _, h, _, _ = LM_LSTM_SHAPE
            out["at_lm"] = {
                "shape": f"{tag}: B={LM_BATCH} T={t} H={h} D=1 float32",
                "route": p21_errs[tag][2],
                "max_abs_err": p21_errs[tag][0 if kind == "fwd" else 1],
                "ms": p21[f"td_{tag}_{kind}_b2b"],
                "method": METHODS["b2b"][1],
                "plain_call_ms": p21[f"td_{tag}_{kind}_plain_call"],
                "bound_ms": bound[f"{name}_{tag}"][0],
                "bound_by": bound[f"{name}_{tag}"][1],
                "port_layer_ms": p21[f"td_{tag}_port_layer_{kind}_b2b"],
                "library_ms": p21[f"td_{tag}_cudnn_layer_{kind}_b2b"],
                "library_vs": "cuDNN LSTM (torch.nn.LSTM, one direction, "
                              "packed, float32), the whole layer " + kind
                              + " against the port's layer"}
        return out

    def f32_entry(kind: str) -> dict:
        """The float32 grid's kernel of K2 or K3 (its own __global__
        function): ms, plain and library at the LM's shape, launches from
        the LM trainer's run, and the fusion listener's shape beside."""
        name = f"lstm_scan_{kind}_grid_f32"
        f32_design = (
            "one co-resident grid (cooperative launch) of H/8 blocks a "
            "direction and row group, w_hh's slice of 8 units resident in "
            "shared memory in float32, " + ("h" if kind == "fwd" else
                                            "dgates")
            + " through L2 in float32 (k-major, 64 rows a sub-tile) by step "
            "parity with a step barrier on a global counter, read through a "
            "ring fed by bulk copies from a producer warp (mbarriers, no "
            "block barrier a chunk), the product on the CUDA cores' FMAs (a "
            "lane's 4 x 8 / 4 x 4 register tile), k-parts added in a fixed "
            "order")

        def at(shape):
            tag, t, _, h, d, _ = shape
            key = f"td_{tag}_"
            return {
                "shape": f"{tag}: B={LM_BATCH} T={t} H={h} D={d} float32",
                "route": p21_errs[tag][2],
                "max_abs_err": p21_errs[tag][0 if kind == "fwd" else 1],
                "ms": p21[key + kind + "_b2b"], "method": METHODS["b2b"][1],
                "simt_ms": p21[key + kind + "_simt_b2b"],
                "floor_ms": p21[key + "floor_" + kind + "_b2b"],
                "barrier_ms": p21[key + "barrier_" + kind + "_b2b"],
                "plain_call_ms": p21[key + kind + "_plain_call"],
                "bound_ms": bound[f"lstm_scan_{kind}_{tag}"][0],
                "bound_by": bound[f"lstm_scan_{kind}_{tag}"][1],
                "port_layer_ms": p21[key + "port_layer_" + kind + "_b2b"],
                "library_ms": p21[key + "cudnn_layer_" + kind + "_b2b"]}

        lm = at(LM_LSTM_SHAPE)
        return {"name": name, "route": "cuda",
                "source": src + f"lstm_scan_{kind}.cu",
                "replaces": tpu + ("pallas_lstm.py:41" if kind == "fwd"
                                   else "pallas_lstm.py:85"),
                "launches": p21_launches["lm_trainer"].get(name, 0),
                "max_abs_err": ROUTE_ERRS[kind, "grid_f32"],
                "ms": lm["ms"], "method": lm["method"],
                "plain_ms": lm["plain_call_ms"],
                "plain_method": "call time, CUDA events",
                "bound_ms": lm["bound_ms"], "bound_by": lm["bound_by"],
                "library_ms": lm["library_ms"],
                "library_method": METHODS["b2b"][1], "design": f32_design,
                "library_vs": "cuDNN LSTM (torch.nn.LSTM, packed, float32), "
                              "the whole layer " + kind + " at the LM's shape "
                              "against the port's layer at "
                              f"{lm['port_layer_ms']:.4f} ms",
                "launches_by_path": {p: n.get(name, 0)
                                     for p, n in paths.items()},
                "at_lm": lm, "at_fusion_listener": at(FUSION_LSTM_SHAPE)}

    kernels = [entry(*row) for row in rows]
    kernels[3:3] = [f32_entry("fwd"), f32_entry("bwd")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
