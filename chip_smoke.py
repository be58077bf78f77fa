#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout.  It imports nothing of JAX and fails
(non-zero exit, no result line) when CUDA is unavailable.  Phases; any
failure raises and the script exits non-zero:

0. the card (``nvidia-smi`` name and power limit) and the toolchain;
1. build the CUDA kernels from ``semi_supervised_asr_tpu_torch/csrc``,
   with ptxas's registers and spills of K5's bf16 instances;
2. K1 (fused post-FFT frontend) against its plain version at the timit
   shapes (B=32, T=400 and 800, F=257, M=80), with and without
   SpecAugment bands: max abs error <= 1e-5;
3. K2 (LSTM forward scan) against its plain version at the listener's
   shapes (T=800 / input 80 and T=100 / input 1024, B=32, H=256, both
   directions, variable lengths with a zero-length row, residuals):
   <= 1e-5 in float32, <= BF16_TOL in bfloat16;
4. the serving slice at ``configs/timit.yaml`` full width (random weights
   from seed 0, synthetic WAVs in two buckets) through the port's
   ``transcribe`` entry, beam 5 and greedy, with each kernel's launch
   count from that run; then the same bucket-400 batch with
   ``backend="reference"``: encoder outputs within the phase-3 tolerance
   and, in a float32-compute run, identical tokens;
5. median times per batch of 32 at bucket 400: each kernel against its
   plain version, and the whole serving path (features -> encoder ->
   beam 5) on kernels against the plain versions;
6. K3 (LSTM backward scan) against its plain version at the listener's
   shapes (T=800 / input 80 and T=100 / input 1024, B=32, H=256, both
   directions, ragged lengths with a zero-length row, random dh_out):
   dgates <= 1e-5 in float32, <= BF16_TOL in bfloat16; then the
   gradients of one whole BiLSTM layer (dx, dW_ih, dW_hh, db) through the
   autograd Function, kernel against plain, in float32;
7. the training slice at ``configs/timit.yaml`` full width through the
   port's ``train`` entry (synthetic corpus, bucket 400, B=32, bf16,
   weights from seed 0): 3 steps, the loss of each, finite losses, and
   each kernel's launch count from that run (all three > 0); then one
   float32 step from the same weights, batch and SpecAugment bands on
   kernels and on ``backend="reference"``: loss to 1e-5 relative, every
   gradient leaf within GRAD_TOL;
8. at bucket 400, B=32, bf16: K3 against its plain version and cuDNN's
   LSTM backward, cuDNN's LSTM forward beside K2, and the median host
   time of a train step on kernels against the plain versions;
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
11. the training slice at the same width through ``train`` (synthetic
    corpus, bucket 1600 so that T'=400, B=32, bf16): 3 steps, finite
    losses, K1 and both K5 launch counts > 0; then one float32 step on
    kernels against the plain versions, as in phase 7;
12. K5 forward and backward (bf16, B=32, 8 heads of 64) against
    ``scaled_dot_product_attention`` with the boolean key mask (the
    library yardstick, never on the port's path) at the T' of all four
    ls960_conformer buckets (100-400), with the card's clocks, power and
    temperature before and after each K5 timing, each ratio and each
    share of the bound; at T'=400 (bucket 1600) also against the plain
    version; then the conformer's beam-5 serve batch and train step on
    kernels against the plain versions.

The line before the last is the kernel table as JSON (with each kernel's
bound and library time; launches from the timit training run for K1-K3,
from the conformer training run for K5); the last line is ``{"ok": true,
"device": {...}}``.  ``--profile DIR`` also writes ``torch.profiler``
tables of one beam-5 batch and of one train step of each path there.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
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
K2_TOL = 1e-5
# bf16: kernel and plain version round h to bf16 identically but sum the
# f32 products in different orders; when that flips one bf16 rounding of
# an h unit (ulp ~4e-3 at |h| ~ 1), each gate of the next step moves by
# |w_hh| * ulp ~ 2.5e-4 at H=256 (weights U(+-1/16)).  A few such flips
# over a sequence stay under 2e-3.
BF16_TOL = 2e-3
K3_TOL = 1e-5
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
# (T' = 400 after the 4x stem); dropout and SortaGrad are not ported
CONFORMER_TRAIN = ["model.enc_dropout=0", "data.sortagrad_epochs=0",
                   "data.num_synthetic_utts=64", "data.frame_buckets=[1600]"]
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
# published peaks of one H100 SXM (NVIDIA H100 datasheet)
HBM_BYTES_S = 3.35e12
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


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call of ``fn``: the durations of the
    kernels and copies it launched, from torch.profiler.  Unlike
    :func:`cuda_ms` this excludes the time the device waits for the host,
    which dominates a call of a sub-millisecond kernel."""
    ms = sum(device_ms_by_kernel(fn, reps, warmup).values())
    require(ms > 0, "the profiler saw no device time")
    return ms


def device_ms_by_kernel(fn, reps: int, warmup: int = 2) -> dict:
    """Mean device milliseconds per call of ``fn`` for each kernel it
    launches (torch.profiler), by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total
    return {k: us / reps / 1e3 for k, us in out.items()}


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


def phase1() -> dict:
    """Build the kernels; -> {K5 bf16 instance: (registers, spill stores,
    spill loads)} from ptxas."""
    from semi_supervised_asr_tpu_torch import _native

    t0 = time.perf_counter()
    cached = _native.library_path().exists()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        path = _native.build(verbose=True)
    _native.lib()
    print(out.getvalue(), flush=True)
    log(f"[phase1] built {path.name} in {time.perf_counter() - t0:.1f} s")
    if cached:
        log("[phase1] the library was built before: no ptxas report")
        return {}
    regs, kernel = {}, None
    for line in out.getvalue().splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            name = re.search(r"(flash_mhsa_(?:fwd|bwd_dq|bwd_dkv)_bf16"
                             r"_kernel)ILi(\d)", entry.group(1))
            kernel = f"{name.group(1)}<NB={name.group(2)}>" if name else None
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
    require(len(regs) == 6, f"ptxas reported {sorted(regs)}")
    return regs


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


def phase2(fcfg) -> float:
    import torch

    from semi_supervised_asr_tpu_torch.ops import fused_frontend as FF

    worst = 0.0
    for t in (400, 800):
        pspec, flens, mean, istd, bands = k1_inputs(32, t, t, fcfg)
        for sa in (None, bands):
            got = FF.fused_post_fft(pspec, flens, fcfg, mean, istd, sa)
            want = FF.fused_post_fft_reference(pspec, flens, fcfg, mean,
                                               istd, sa)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), "K1 output not finite")
            err = (got - want).abs().max().item()
            zeros = (got == 0).float().mean().item()
            log(f"[phase2] K1 B=32 T={t} bands={sa is not None}: "
                f"max_abs_err {err:.3e} (tol {K1_TOL:g}), zero share "
                f"{zeros:.3f}")
            require(err <= K1_TOL, f"K1 error {err} > {K1_TOL}")
            worst = max(worst, err)
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
                got = K.lstm_scan(gx, w_hh, valid, compute, (False, True),
                                  residuals=True)
                want = K.lstm_scan_reference(gx, w_hh, valid, compute,
                                             (False, True), residuals=True)
            torch.cuda.synchronize()
            tol = K2_TOL if compute == torch.float32 else BF16_TOL
            errs = [(a - b_).abs().max().item() for a, b_ in zip(got, want)]
            require(all(bool(torch.isfinite(a).all()) for a in got),
                    "K2 output not finite")
            log(f"[phase3] K2 {name} T={t} I={i} B={b} H={h} D=2 "
                f"{str(compute).split('.')[-1]}: max_abs_err h_out "
                f"{errs[0]:.3e} hprev {errs[1]:.3e} cprev {errs[2]:.3e} "
                f"acts {errs[3]:.3e} (tol {tol:g})")
            require(max(errs) <= tol, f"K2 error {max(errs)} > {tol}")
            worst[compute] = max(worst[compute], max(errs))
    return worst[torch.float32], worst[torch.bfloat16]


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
    pspec, flens, mean, istd, _ = k1_inputs(32, 400, 7, fcfg)
    args = (pspec, flens, fcfg, mean, istd)
    kernel_times(times, "fused_post_fft", lambda: FF.fused_post_fft(*args),
                 lambda: FF.fused_post_fft_reference(*args), reps=20)
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


def kernel_times(times: dict, name: str, kernel, plain, reps: int) -> None:
    """plain, kernel, kernel, plain: call time (CUDA events, includes the
    host's launch work) and device time (profiler) into ``times``."""
    for key, fn in ((name + "_plain", plain), (name, kernel), (name, kernel),
                    (name + "_plain", plain)):
        times.setdefault(key + "_call", []).append(cuda_ms(fn, reps=reps))
        times.setdefault(key, []).append(device_ms(fn, reps=reps))


def report(phase: str, times: dict, card: str,
           shape: str = "bucket 400, B=32, bf16") -> dict:
    med = {k: statistics.median(v) for k, v in times.items()}
    for k in sorted(med):
        what = ("call time, CUDA events" if k.endswith("_call") else
                "host time to synchronize"
                if k.startswith(("serve", "enc", "train", "conformer")) else
                "device time, profiler")
        log(f"[{phase}] {k}: median {med[k]:.4f} ms ({what}) over "
            f"{len(times[k])} runs at {shape} ({card})")
    return med


def k3_inputs(t: int, i: int, seed: int, compute):
    """K2's residuals for a random layer (kernel forward) and a random
    dh_out: the inputs of the backward scan."""
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
    from semi_supervised_asr_tpu_torch.ops import recurrent as R

    x, w_ih, bias, w_hh, valid = k2_inputs(t, i, seed)
    b, h = x.shape[0], w_hh.shape[1]
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


def phase6() -> float:
    import torch

    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    worst = 0.0
    rev = (False, True)
    for name, t, i in (("layer0", 800, 80), ("pyramid", 100, 1024)):
        for compute in (torch.float32, torch.bfloat16):
            w_hh, valid, acts, cprev, dh_out = k3_inputs(t, i, t, compute)
            args = (w_hh, valid, acts, cprev, dh_out, compute, rev)
            got = K.lstm_scan_bwd(*args)
            want = K.lstm_scan_bwd_reference(*args)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), "K3 output not finite")
            err = (got - want).abs().max().item()
            tol = K3_TOL if compute == torch.float32 else BF16_TOL
            log(f"[phase6] K3 {name} T={t} B=32 H=256 D=2 "
                f"{str(compute).split('.')[-1]}: dgates max_abs_err "
                f"{err:.3e} (tol {tol:g}), max |dgates| "
                f"{want.abs().max().item():.3e}")
            require(err <= tol, f"K3 error {err} > {tol}")
            if compute == torch.float32:
                worst = max(worst, err)
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
    return worst


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
    from semi_supervised_asr_tpu_torch import train as T

    log(f"[phase11] overrides {CONFORMER_OVERRIDES + CONFORMER_TRAIN} "
        "(model.enc_dropout and data.sortagrad_epochs are not ported)")
    tr = T.Trainer(conformer_config(CONFORMER_TRAIN), d / "bf16", DEVICE,
                   seed=0)
    _native.reset_launches()
    recs = tr.run(3, log=lambda m: log(f"[phase11] {m}"))
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
    tr32 = T.Trainer(conformer_config(
        [*CONFORMER_TRAIN, "model.compute_dtype=float32"]), d / "f32",
        DEVICE, seed=0)
    step_check(tr32, "phase11")
    return tr, launches, recs


def gpu_clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def k5_bucket(times: dict, shape: tuple) -> None:
    """K5 forward and backward (bf16) beside SDPA at one shape, device
    times, with the card's clocks before and after each K5 timing; at
    K5_TIMING also the plain version, interleaved, into ``times`` (the
    kernel table's numbers)."""
    import torch
    import torch.nn.functional as Fn

    from semi_supervised_asr_tpu_torch.ops import flash_mhsa as FM

    bf16 = torch.bfloat16
    b, t, h, d = shape
    q, k, v, mask, dout = (x.to(bf16) if x.is_floating_point() else x
                           for x in k5_inputs(*shape, seed=11,
                                              odd_rows=False))
    scale = 1.0 / math.sqrt(d)
    o, m, l = FM.mhsa_fwd(q, k, v, mask, scale)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = FM.mhsa_reference(*leaves, mask, sm_scale=scale, compute=bf16)
    # the library yardstick: SDPA on [B, H, T, D] with the boolean key mask
    sl = [x.transpose(1, 2).contiguous().requires_grad_(True)
          for x in (q, k, v)]
    am = mask[:, None, None, :]
    so = Fn.scaled_dot_product_attention(*sl, attn_mask=am, scale=scale)
    sdo = dout.transpose(1, 2).contiguous()

    def sdpa_fwd():
        with torch.no_grad():
            Fn.scaled_dot_product_attention(*sl, attn_mask=am, scale=scale)

    work = {
        "flash_mhsa_fwd": (lambda: FM.mhsa_fwd(q, k, v, mask, scale),
                           lambda: FM.mhsa_reference(
                               q, k, v, mask, sm_scale=scale, compute=bf16),
                           sdpa_fwd),
        "flash_mhsa_bwd": (
            lambda: FM.mhsa_bwd(q, k, v, mask, o, m, l, dout, scale),
            lambda: torch.autograd.grad(out, leaves, dout,
                                        retain_graph=True),
            lambda: torch.autograd.grad(so, sl, sdo, retain_graph=True)),
    }
    bound = k5_bounds(shape, mask.sum(1))
    for name, (kernel, plain, lib) in work.items():
        log(f"[phase12] clocks before {name} T'={t}: {gpu_clocks()} (SM "
            "MHz, max SM MHz, W, C)")
        if shape == K5_TIMING:
            kernel_times(times, name, kernel, plain, reps=10)
            ms = statistics.median(times[name])
        else:
            ms = device_ms(kernel, reps=10)
        lib_ms = device_ms(lib, reps=10)
        log(f"[phase12] clocks after {name} T'={t}: {gpu_clocks()}")
        if shape == K5_TIMING:
            times["sdpa" + name[-4:]] = [lib_ms]
        bms, by = bound[name]
        log(f"[phase12] {name} B={b} T'={t} H={h} D={d} bf16: {ms:.4f} ms "
            f"(device time, profiler), SDPA {lib_ms:.4f} ms, kernel/SDPA "
            f"{ms / lib_ms:.2f}; bound {bms:.4f} ms ({by}): kernel at "
            f"{bms / ms:.1%}, SDPA at {bms / lib_ms:.1%} of it")
    # the backward's two launches apart (K5dq, K5dkv)
    split = device_ms_by_kernel(work["flash_mhsa_bwd"][0], reps=10)
    for name, ms in sorted(split.items()):
        short = re.search(r"(\w+)<", name)
        log(f"[phase12] T'={t} flash_mhsa_bwd launch "
            f"{short.group(1) if short else name[:80]}: {ms:.4f} ms (device "
            f"time, profiler)")


def phase12(tr, files: list[Path], card: str) -> dict:
    """Timings at bucket 1600, B=32, bf16: K5 forward and backward against
    the plain version and SDPA; the conformer serve batch and train step."""
    import torch

    from semi_supervised_asr_tpu_torch import train as T
    from semi_supervised_asr_tpu_torch import transcribe as TR
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    times = {}
    for t in K5_BUCKETS:
        k5_bucket(times, (*K5_TIMING[:1], t, *K5_TIMING[2:]))
    # the conformer serve batch (beam 5) and train step, kernels vs plain
    ker = TR.Recognizer(tr.cfg, tr.state.model, (tr.cmvn[0].cpu(),
                        tr.cmvn[1].cpu()), TR.build_vocab(tr.cfg),
                        torch.device(DEVICE))
    ref = TR.Recognizer(ker.cfg, ker.model, (tr.cmvn[0].cpu(),
                        tr.cmvn[1].cpu()), ker.vocab, torch.device(DEVICE),
                        backend="reference")
    audio, lens = bucket_batch(ker, files, frames=1600)
    for rec in (ref, ker, ker, ref):
        key = "conformer_serve_beam5" + ("_plain" if rec is ref else "")
        times.setdefault(key, []).extend(
            host_ms(lambda: rec.decode(audio, lens, "beam"), reps=1))
    batch = next(tr.batches)
    tensors = T.batch_tensors(batch, tr.device)
    plain = TS.init_train_state(tr.cfg, copy.deepcopy(tr.state.model), 0)
    for state, backend in ((plain, "reference"), (tr.state, None),
                           (tr.state, None), (plain, "reference")):
        key = "conformer_train_step" + ("_plain" if backend else "")
        times.setdefault(key, []).extend(host_ms(
            lambda: TS.supervised_step(tr.cfg, state, *tensors, tr.cmvn,
                                       backend=backend), reps=2))
    med = report("phase12", times, card, "bucket 1600, B=32, bf16")
    work = {
        "conformer_beam5_b32_t1600": (lambda: ker.decode(audio, lens, "beam"),
                                      med["conformer_serve_beam5"]),
        "conformer_train_step_b32_t1600": (lambda: TS.supervised_step(
            tr.cfg, tr.state, *tensors, tr.cmvn),
            med["conformer_train_step"]),
    }
    return med, work


def trainer(d: Path, dtype: str):
    from semi_supervised_asr_tpu_torch import train as T

    cfg = T.load_config(CONFIG, [*TRAIN_OVERRIDES,
                                 f"model.compute_dtype={dtype}"])
    return T.Trainer(cfg, d, DEVICE, seed=0)


def phase7(d: Path):
    import torch

    from semi_supervised_asr_tpu_torch import _native

    tr = trainer(d, "bfloat16")
    _native.reset_launches()
    recs = tr.run(3, log=lambda m: log(f"[phase7] {m}"))
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    log(f"[phase7] train 3 steps, bucket 400, B=32, bf16: losses "
        f"{[r['loss'] for r in recs]}, kernel launches {launches}")
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in recs), "training loss not finite")
    require(all(launches[k] > 0 for k in LSTM_PATH),
            f"a kernel of the training path did not launch: {launches}")

    # float32: one step's loss and gradients, kernels against plain
    step_check(trainer(d, "float32"), "phase7")
    return tr, launches, recs


def step_check(tr32, phase: str) -> None:
    """One float32 step's loss and gradients from the trainer's weights,
    first batch and fixed SpecAugment bands: kernels against plain."""
    import torch

    from semi_supervised_asr_tpu_torch import train as T
    from semi_supervised_asr_tpu_torch.ops import frontend as F
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    batch = next(tr32.batches)
    tensors = T.batch_tensors(batch, tr32.device)
    fcfg = tr32.cfg.frontend
    flens = torch.clamp_max(F.frame_lengths(tensors[1], fcfg),
                            batch.bucket[0])
    bands = F.sample_specaug_params(torch.Generator().manual_seed(5),
                                    flens.shape[0], fcfg.n_mels, flens, fcfg)
    out = {}
    for backend in (None, "reference"):
        model = copy.deepcopy(tr32.state.model)
        state = TS.init_train_state(tr32.cfg, model, seed=0)
        out[backend] = TS.loss_and_grads(tr32.cfg, state, *tensors,
                                         tr32.cmvn, bands, backend)
    (lk, _, gk), (lr, _, gr) = out[None], out["reference"]
    rel = abs(lk.item() - lr.item()) / abs(lr.item())
    names = [n for n, _ in tr32.state.model.named_parameters()]
    errs = dict(zip(names, grad_errs(gk, gr)))
    worst = max(errs, key=errs.get)
    own = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
           for n, a, b in zip(names, gk, gr)}
    own_worst = max(own, key=own.get)
    log(f"[{phase}] float32 step, kernels vs plain: loss {lk.item():.6f} vs "
        f"{lr.item():.6f} (rel {rel:.2e}, tol 1e-5); worst gradient leaf "
        f"{worst} {errs[worst]:.3e} of the model's max |g| over "
        f"{len(errs)} leaves (tol {GRAD_TOL:g}); relative to its own max "
        f"|g| the worst leaf is {own_worst} {own[own_worst]:.3e}")
    require(rel <= 1e-5, f"float32 step loss differs: rel {rel}")
    require(errs[worst] <= GRAD_TOL, f"gradient {worst} differs")


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


def phase8(tr, card: str) -> dict:
    import torch

    from semi_supervised_asr_tpu_torch import train as T
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    times = {}
    bf16 = torch.bfloat16
    w_hh, valid, acts, cprev, dh_out = k3_inputs(400, 80, 3, bf16)
    args = (w_hh, valid, acts, cprev, dh_out, bf16, (False, True))
    kernel_times(times, "lstm_scan_bwd", lambda: K.lstm_scan_bwd(*args),
                 lambda: K.lstm_scan_bwd_reference(*args), reps=3)
    x, w_ih, bias, w_hh, valid = k2_inputs(400, 80, 3)
    mod, packed, dtype = cudnn_lstm(x, w_ih, bias, w_hh, valid)
    log(f"[phase8] cuDNN LSTM (torch.nn.LSTM, packed) runs in {dtype}")
    with torch.no_grad():
        times["cudnn_lstm_fwd"] = [device_ms(lambda: mod(packed), reps=5)]
    # backward = (training forward + backward) - training forward, each a
    # fresh graph (device times)
    leaves = [packed.data, *mod.parameters()]
    dy = torch.randn_like(mod(packed)[0].data)
    fwd_train = device_ms(lambda: mod(packed), reps=5)
    both = device_ms(lambda: torch.autograd.grad(mod(packed)[0].data, leaves,
                                                 dy), reps=5)
    times["cudnn_lstm_bwd"] = [both - fwd_train]
    # whole train steps on one batch: kernels vs plain, interleaved
    batch = next(tr.batches)
    tensors = T.batch_tensors(batch, tr.device)
    plain = TS.init_train_state(tr.cfg, copy.deepcopy(tr.state.model), 0)
    for state, backend in ((plain, "reference"), (tr.state, None),
                           (tr.state, None), (plain, "reference")):
        key = "train_step" + ("_plain" if backend else "")
        times.setdefault(key, []).extend(host_ms(
            lambda: TS.supervised_step(tr.cfg, state, *tensors, tr.cmvn,
                                       backend=backend), reps=2))
    med = report("phase8", times, card)
    med["cudnn_dtype"] = str(dtype).split(".")[-1]
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


def bounds() -> dict:
    """Least time (ms) each kernel could take at its timing shape: the
    larger of its bytes (each input read once, each output written once)
    over HBM bandwidth and its bf16 products over the tensor-core peak, and
    which of the two.  K1-K3 at phases 5 and 8's (bucket 400, B=32, H=256,
    D=2, bf16 weights); K5 at phase 12's (B=32, T'=400, 8 heads of 64,
    bf16), counting the products these lengths need: every query row
    against the valid keys of its batch row (all T keys for an empty row,
    whose weights are uniform)."""
    from semi_supervised_asr_tpu_torch.ops import fused_frontend as FF

    b, t, d, h, f4 = 32, 400, 2, 256, 4
    cfg = load_timit()
    fcfg = cfg.frontend
    f, m = fcfg.n_fft // 2 + 1, fcfg.n_mels
    nnz = len(FF._mel_runs_np(fcfg)[0])
    seq = d * t * b
    k1 = (b * t * f * f4 + b * t * m * f4 + nnz * f4 + 3 * m * f4 + b * f4,
          2 * nnz * b * t)
    w = d * h * 4 * h * 2
    k2 = (seq * 4 * h * f4 + w + t * b * f4 + seq * h * f4,
          2 * seq * 4 * h * h)
    k3 = (w + t * b * f4 + seq * 4 * h * f4 + 2 * seq * h * f4
          + seq * 4 * h * f4, 2 * seq * 4 * h * h)
    lens = k5_inputs(*K5_TIMING, seed=11, odd_rows=False)[3].sum(1)
    k5f, k5b = k5_work(K5_TIMING, lens)
    out = {}
    for name, (nbytes, flops) in (("fused_post_fft", k1),
                                  ("lstm_scan_fwd", k2),
                                  ("lstm_scan_bwd", k3),
                                  ("flash_mhsa_fwd", k5f),
                                  ("flash_mhsa_bwd", k5b)):
        out[name] = bound_ms(nbytes, flops)
        log(f"[bound] {name}: {nbytes / 1e6:.1f} MB -> "
            f"{nbytes / HBM_BYTES_S * 1e3:.4f} ms, {flops / 1e9:.2f} GFLOP "
            f"-> {flops / BF16_FLOPS * 1e3:.4f} ms")
    return out


def load_timit():
    from semi_supervised_asr_tpu_torch import transcribe as TR

    cfg = TR.load_config(CONFIG)
    return TR.finalize_config(cfg, TR.build_vocab(cfg).size)


def timit_work(results, tr, med: dict) -> dict:
    """One beam-5 batch and one train step of the timit path, for
    :func:`profile`."""
    from semi_supervised_asr_tpu_torch import train as T
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    ker, _ = results["bfloat16"]["rec"]
    audio, lens = results["bfloat16"]["batch"]
    tensors = T.batch_tensors(next(tr.batches), tr.device)
    return {
        "beam5_b32_t400": (lambda: ker.decode(audio, lens, "beam"),
                           med["serve_beam5"]),
        "train_step_b32_t400": (lambda: TS.supervised_step(
            tr.cfg, tr.state, *tensors, tr.cmvn), med["train_step"]),
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
    card = phase0()
    phase1()
    cfg = load_timit()
    vocab = TR.build_vocab(cfg)
    k1_err = phase2(cfg.frontend)
    k2_err, k2_bf16 = phase3()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        # eight utterances over buckets 200 and 400
        files = synthetic.write_wavs(d, cfg, vocab, 8, min_tokens=5,
                                     max_tokens=12, token_dur_s=0.3)
        synthetic.write_model_dir(d, cfg, files, seed=0)
        results, serve_launches = phase4(d, files)
    med = phase5(results, cfg.frontend, card)
    k3_err = phase6()
    with tempfile.TemporaryDirectory() as tmp:
        tr, launches, _ = phase7(Path(tmp))
        med.update(phase8(tr, card))
        if args.profile is not None:
            profile(timit_work(results, tr, med), args.profile)
    del tr
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
    bound = bounds()
    log(f"[summary] card: {card}; K2 bf16 max_abs_err {k2_bf16:.3e}; "
        f"bf16 token agreement {results['bfloat16']['agree']}; serving "
        f"launches {serve_launches}; training launches {launches}; train "
        f"step {med['train_step']:.1f} ms on kernels vs "
        f"{med['train_step_plain']:.1f} ms plain; conformer serving "
        f"launches {conf_serve}, training launches {conf_launches}; "
        f"conformer train step {med['conformer_train_step']:.1f} ms on "
        f"kernels vs {med['conformer_train_step_plain']:.1f} ms plain; K5 "
        f"worst errors {k5}")
    src = "semi_supervised_asr_tpu_torch/csrc/"
    tpu = "semi_supervised_asr_tpu/ops/"
    jax_fa = ("jax/experimental/pallas/ops/tpu/flash_attention.py:{} "
              "(jax 0.9.0), reached from " + tpu + "flash_mhsa.py:123")
    # launches: K1-K3 from the timit training run (phase 7), K5 from the
    # conformer training run (phase 11)
    rows = (
        ("fused_post_fft", "fused_post_fft.cu", tpu + "pallas_frontend.py:50",
         k1_err, None, launches),
        ("lstm_scan_fwd", "lstm_scan_fwd.cu", tpu + "pallas_lstm.py:41",
         k2_err, med["cudnn_lstm_fwd"], launches),
        ("lstm_scan_bwd", "lstm_scan_bwd.cu", tpu + "pallas_lstm.py:85",
         k3_err, med["cudnn_lstm_bwd"], launches),
        ("flash_mhsa_fwd", "flash_mhsa_fwd.cu", jax_fa.format(331),
         k5["float32"], med["sdpa_fwd"], conf_launches),
        ("flash_mhsa_bwd", "flash_mhsa_bwd.cu", jax_fa.format("796 and :1146"),
         k5["float32_grad_abs"], med["sdpa_bwd"], conf_launches),
    )
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + cu,
         "replaces": tpu_src, "launches": runs[name], "max_abs_err": err,
         "ms": med[name], "plain_ms": med[name + "_plain"],
         "bound_ms": bound[name][0], "bound_by": bound[name][1],
         "library_ms": lib}
        for name, cu, tpu_src, err, lib, runs in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
