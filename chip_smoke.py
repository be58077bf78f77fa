#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout.  It imports nothing of JAX and fails
(non-zero exit, no result line) when CUDA is unavailable.  Phases; any
failure raises and the script exits non-zero:

0. the card (``nvidia-smi`` name and power limit) and the toolchain;
1. build the CUDA kernels from ``semi_supervised_asr_tpu_torch/csrc``;
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
   time of a train step on kernels against the plain versions.

The line before the last is the kernel table as JSON (with each kernel's
bound and library time); the last line is ``{"ok": true, "device":
{...}}``.  ``--profile DIR`` also writes ``torch.profiler`` tables of one
beam-5 batch and of one train step there.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
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
DEVICE = "cuda"
# the training slice on the synthetic corpus: two batches of 32 per epoch,
# all in the 400-frame bucket
TRAIN_OVERRIDES = ["data.dataset=synthetic", "data.num_synthetic_utts=64",
                   "data.frame_buckets=[400]"]
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
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    require(us > 0, "the profiler saw no device time")
    return us / reps / 1e3


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


def phase1() -> None:
    from semi_supervised_asr_tpu_torch import _native

    t0 = time.perf_counter()
    path = _native.build(verbose=True)
    _native.lib()
    log(f"[phase1] built {path.name} in {time.perf_counter() - t0:.1f} s")


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
    serving = ("fused_post_fft", "lstm_scan_fwd")
    require(all(launches[k] > 0 for k in serving),
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


def report(phase: str, times: dict, card: str) -> dict:
    med = {k: statistics.median(v) for k, v in times.items()}
    for k in sorted(med):
        what = ("call time, CUDA events" if k.endswith("_call") else
                "host time to synchronize"
                if k.startswith(("serve", "enc", "train")) else
                "device time, profiler")
        log(f"[{phase}] {k}: median {med[k]:.4f} ms ({what}) over "
            f"{len(times[k])} runs at bucket 400, B=32, bf16 ({card})")
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


def trainer(d: Path, dtype: str):
    from semi_supervised_asr_tpu_torch import train as T

    cfg = T.load_config(CONFIG, [*TRAIN_OVERRIDES,
                                 f"model.compute_dtype={dtype}"])
    return T.Trainer(cfg, d, DEVICE, seed=0)


def phase7(d: Path):
    import torch

    from semi_supervised_asr_tpu_torch import _native
    from semi_supervised_asr_tpu_torch import train as T
    from semi_supervised_asr_tpu_torch.ops import frontend as F
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    tr = trainer(d, "bfloat16")
    _native.reset_launches()
    recs = tr.run(3, log=lambda m: log(f"[phase7] {m}"))
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    log(f"[phase7] train 3 steps, bucket 400, B=32, bf16: losses "
        f"{[r['loss'] for r in recs]}, kernel launches {launches}")
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in recs), "training loss not finite")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the training path did not launch: {launches}")

    # float32: one step's loss and gradients, kernels against plain
    tr32 = trainer(d, "float32")
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
    log(f"[phase7] float32 step, kernels vs plain: loss {lk.item():.6f} vs "
        f"{lr.item():.6f} (rel {rel:.2e}, tol 1e-5); worst gradient leaf "
        f"{worst} {errs[worst]:.3e} of the model's max |g| over "
        f"{len(errs)} leaves (tol {GRAD_TOL:g}); relative to its own max "
        f"|g| the worst leaf is {own_worst} {own[own_worst]:.3e}")
    require(rel <= 1e-5, f"float32 step loss differs: rel {rel}")
    require(errs[worst] <= GRAD_TOL, f"gradient {worst} differs")
    return tr, launches, recs


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


def bounds() -> dict:
    """Least time (ms) each kernel could take at its phase-5/8 timing shape
    (bucket 400, B=32, H=256, D=2, bf16 weights): the larger of its bytes
    (each input read once, each output written once) over HBM bandwidth and
    its bf16 products over the tensor-core peak, and which of the two."""
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
    out = {}
    for name, (nbytes, flops) in (("fused_post_fft", k1),
                                  ("lstm_scan_fwd", k2),
                                  ("lstm_scan_bwd", k3)):
        by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOPS * 1e3
        out[name] = (max(by_bytes, by_ops),
                     "bytes" if by_bytes >= by_ops else "operations")
        log(f"[bound] {name}: {nbytes / 1e6:.1f} MB -> {by_bytes:.4f} ms, "
            f"{flops / 1e9:.2f} GFLOP -> {by_ops:.4f} ms")
    return out


def load_timit():
    from semi_supervised_asr_tpu_torch import transcribe as TR

    cfg = TR.load_config(CONFIG)
    return TR.finalize_config(cfg, TR.build_vocab(cfg).size)


def profile(results, tr, out_dir: Path, med: dict) -> None:
    """Kernel tables of one beam-5 batch and of one train step; device busy
    share against the unprofiled wall time of the same work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from semi_supervised_asr_tpu_torch import train as T
    from semi_supervised_asr_tpu_torch.training import train_step as TS

    ker, _ = results["bfloat16"]["rec"]
    audio, lens = results["bfloat16"]["batch"]
    tensors = T.batch_tensors(next(tr.batches), tr.device)
    work = {
        "beam5_b32_t400": (lambda: ker.decode(audio, lens, "beam"),
                           med["serve_beam5"]),
        "train_step_b32_t400": (lambda: TS.supervised_step(
            tr.cfg, tr.state, *tensors, tr.cmvn), med["train_step"]),
    }
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
        log(f"[profile] {name}: {len(kernels)} device kernels and copies, "
            f"{dev_ms:.1f} ms of device time; unprofiled wall "
            f"{wall_ms:.1f} ms, device busy share {dev_ms / wall_ms:.3f}; "
            f"table in {out_dir}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", type=Path, default=None,
                   help="write torch.profiler tables of one beam batch and "
                        "one train step here")
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
            profile(results, tr, args.profile, med)
    bound = bounds()
    log(f"[summary] card: {card}; K2 bf16 max_abs_err {k2_bf16:.3e}; "
        f"bf16 token agreement {results['bfloat16']['agree']}; serving "
        f"launches {serve_launches}; training launches {launches}; train "
        f"step {med['train_step']:.1f} ms on kernels vs "
        f"{med['train_step_plain']:.1f} ms plain")
    src = "semi_supervised_asr_tpu_torch/csrc/"
    rows = (
        ("fused_post_fft", "fused_post_fft.cu", "pallas_frontend.py:50",
         k1_err, None),
        ("lstm_scan_fwd", "lstm_scan_fwd.cu", "pallas_lstm.py:41", k2_err,
         med["cudnn_lstm_fwd"]),
        ("lstm_scan_bwd", "lstm_scan_bwd.cu", "pallas_lstm.py:85", k3_err,
         med["cudnn_lstm_bwd"]),
    )
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + cu,
         "replaces": "semi_supervised_asr_tpu/ops/" + tpu,
         "launches": launches[name], "max_abs_err": err, "ms": med[name],
         "plain_ms": med[name + "_plain"], "bound_ms": bound[name][0],
         "bound_by": bound[name][1], "library_ms": lib}
        for name, cu, tpu, err, lib in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
