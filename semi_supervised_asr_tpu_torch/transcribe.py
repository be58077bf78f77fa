"""Transcription CLI of the PyTorch port: raw audio files in, text out.

    python -m semi_supervised_asr_tpu_torch.transcribe \\
        --config configs/timit.yaml --load-dir DIR [--beam K] [--nbest N] \\
        [--out hyps.jsonl] a.wav b.flac dir/ [section.key=value ...]

Counterpart of the offline path of ``semi_supervised_asr_tpu/
transcribe.py``: files are bucketed by frame count (the training buckets),
files longer than the largest bucket are decoded in bucket-sized chunks and
their texts joined, rows are padded to ``train.batch_size``, and each
batch is decoded with beam search (default) or greedy (``--beam 1``).
Each file prints one JSON object ``{"audio", "text", "score"}`` (plus
``nbest`` with ``--nbest N``, ``no_eos`` when the length cap cut it,
``chunks`` for chunked files).

``DIR`` is a Solver's workdir (``main --train``): it decodes with the
best, else the latest checkpoint (``decode.average_ckpts`` and
``decode.use_ema`` apply, as in ``main --test``).  Or ``DIR`` holds
``params.npz`` (``weights.save_npz``, e.g. weights carried across from a
JAX run) and ``cmvn.npz`` (``mean``, ``inv_std``).  ``--device``
defaults to ``cuda``; ``--device cpu`` runs every kernel's plain version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from semi_supervised_asr_tpu_torch.config import Config, load_config
from semi_supervised_asr_tpu_torch.data.bucketing import make_bucket_spec
from semi_supervised_asr_tpu_torch.data.corpus import load_audio
from semi_supervised_asr_tpu_torch.data.registry import build_vocab
from semi_supervised_asr_tpu_torch.data.vocab import EOS
from semi_supervised_asr_tpu_torch.ops.frontend_oracle import pad_for_batch
from semi_supervised_asr_tpu_torch import strict_fp32, weights
from semi_supervised_asr_tpu_torch.decode.beam import (
    beam_decode_from_enc, check_supported,
)
from semi_supervised_asr_tpu_torch.decode.greedy import greedy_decode_from_enc
from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq
from semi_supervised_asr_tpu_torch.training.train_step import featurize

AUDIO_EXTS = (".wav", ".npy", ".flac")


def collect_files(paths: list[str]) -> list[Path]:
    """Audio files named on the command line; a directory contributes
    every file below it with an audio extension, sorted."""
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(
                f for f in p.rglob("*") if f.suffix.lower() in AUDIO_EXTS
            ))
        else:
            out.append(p)
    return out


def finalize_config(cfg: Config, vocab_size: int) -> Config:
    """Fill the model fields the JAX Solver derives from the data."""
    return cfg.replace(model=dataclasses.replace(
        cfg.model, vocab_size=vocab_size, n_mels=cfg.frontend.n_mels,
        ctc_head=cfg.model.ctc_head or cfg.objective.lambda_ctc > 0.0,
    ))


def max_decode_steps(cfg: Config, enc_frames: int) -> int:
    """Decode loop length for a bucket (as the JAX Solver computes it)."""
    d = cfg.decode
    ratio_cap = (int(d.max_decode_ratio * enc_frames)
                 if d.max_decode_ratio > 0 else 10**9)
    return max(1, min(cfg.data.token_buckets[-1], d.max_decode_len,
                      ratio_cap))


class Recognizer:
    """A model, its CMVN statistics and vocab on one device: decodes
    padded audio batches."""

    def __init__(self, cfg: Config, model: Seq2Seq, cmvn: tuple, vocab,
                 device: torch.device, backend: str | None = None):
        self.cfg, self.vocab, self.device = cfg, vocab, device
        self.model = model.to(device).eval()
        self.mean = torch.as_tensor(np.asarray(cmvn[0]), dtype=torch.float32,
                                    device=device)
        self.inv_std = torch.as_tensor(np.asarray(cmvn[1]),
                                       dtype=torch.float32, device=device)
        self.backend = backend
        self.spec = make_bucket_spec(cfg.data, cfg.frontend,
                                     cfg.model.time_reduction)

    @classmethod
    def from_dir(cls, cfg: Config, load_dir: str | Path, device,
                 backend: str | None = None) -> "Recognizer":
        """A Solver's workdir (it holds ``train.ckpt_dir``) decodes with
        ``Solver.eval_params``'s weights (best, then latest checkpoint;
        ``decode.average_ckpts``; ``decode.use_ema``); a directory with
        ``params.npz`` instead decodes with those weights."""
        load_dir = Path(load_dir)
        if (load_dir / cfg.train.ckpt_dir).is_dir():
            from semi_supervised_asr_tpu_torch.training.solver import Solver

            solver = Solver(cfg, load_dir, device)
            return cls(solver.cfg, solver.eval_params(require_ckpt=True),
                       solver.cmvn, solver.vocab, torch.device(device),
                       backend)
        if not (load_dir / "params.npz").exists():
            raise SystemExit(
                f"{load_dir}: found neither {cfg.train.ckpt_dir}/ (a "
                "Solver's checkpoints) nor params.npz to decode with")
        vocab = build_vocab(cfg)
        cfg = finalize_config(cfg, vocab.size)
        model = Seq2Seq(cfg.model)
        weights.load_npz(model, load_dir / "params.npz")
        with np.load(load_dir / "cmvn.npz") as z:
            cmvn = (z["mean"], z["inv_std"])
        return cls(cfg, model, cmvn, vocab, torch.device(device), backend)

    @torch.inference_mode()
    def encode(self, audio: torch.Tensor, lens: torch.Tensor):
        """Padded audio [B, S] -> (enc, enc_mask, keys) on the device."""
        feats, flens = featurize(self.cfg, audio, lens,
                                 (self.mean, self.inv_std),
                                 backend=self.backend)
        return self.model.encode(feats, flens, self.backend)

    @torch.inference_mode()
    def decode(self, audio: np.ndarray, lens: np.ndarray, mode: str,
               nbest: bool = False):
        """[B, S] padded audio, [B] sample lengths -> (tokens, scores) as
        numpy: greedy gives per-step log-probs, beam the normalized
        score (or all K lattices and scores with ``nbest``)."""
        a = torch.as_tensor(audio, device=self.device)
        n = torch.as_tensor(lens, dtype=torch.int32, device=self.device)
        enc, enc_mask, keys = self.encode(a, n)
        max_u = max_decode_steps(self.cfg, enc.shape[1])
        speller = self.model.speller
        if mode == "greedy":
            out = greedy_decode_from_enc(speller, enc, enc_mask, keys, max_u)
        else:
            out = beam_decode_from_enc(speller, self.cfg.decode, enc,
                                       enc_mask, keys, max_u,
                                       return_nbest=nbest)
        return out[0].cpu().numpy(), out[1].cpu().numpy()


def pad_batch(pieces: list[np.ndarray], s_len: int,
              cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """Audio pieces -> a [train.batch_size, s_len] batch, each row cut to
    ``s_len`` and padded as the reference pads it, and the rows' sample
    lengths (0 for the empty rows after the pieces)."""
    audio = np.zeros((cfg.train.batch_size, s_len), np.float32)
    lens = np.zeros((cfg.train.batch_size,), np.int32)
    for r, a in enumerate(pieces):
        m = min(len(a), s_len)
        audio[r] = pad_for_batch(a[:m].astype(np.float32), s_len,
                                 cfg.frontend)
        lens[r] = m
    return audio, lens


def transcribe(rec: Recognizer, files: list[Path], mode: str,
               nbest: int = 1) -> list[dict]:
    """Bucket + batch the files, decode -> [{audio, text, score, ...}]."""
    if mode not in ("beam", "greedy"):
        raise SystemExit(f"unknown decode mode {mode!r}")
    if nbest > 1 and mode != "beam":
        raise SystemExit(f"--nbest needs beam decoding (got mode={mode!r}); "
                         "drop --beam 1 or --nbest")
    use_nbest = nbest > 1
    spec, cfg = rec.spec, rec.cfg
    max_bucket = spec.frame_buckets[-1]
    by_bucket: dict[int, list[tuple[tuple[Path, int], np.ndarray]]] = {}
    n_chunks: dict[str, int] = {}
    for f in files:
        audio = load_audio(f)
        frames = spec.frames_for_samples(len(audio))
        if spec.frame_bucket(frames) is None:
            chunk_samples = spec.samples_for_frames(max_bucket)
            pieces = [audio[s: s + chunk_samples]
                      for s in range(0, len(audio), chunk_samples)]
            print(f"WARNING: {f} ({frames} frames) exceeds the largest "
                  f"bucket ({max_bucket}) — decoding {len(pieces)} chunks "
                  "and joining the texts", file=sys.stderr)
        else:
            pieces = [audio]
        n_chunks[str(f)] = len(pieces)
        for ci, piece in enumerate(pieces):
            fb = spec.frame_bucket(spec.frames_for_samples(len(piece)))
            by_bucket.setdefault(fb, []).append(((f, ci), piece))

    batch_size = cfg.train.batch_size
    cap_hits, n_hyps = 0, 0
    chunk_results: dict[tuple[str, int], dict] = {}
    for fb, items in sorted(by_bucket.items()):
        s_len = spec.samples_for_frames(fb)
        for start in range(0, len(items), batch_size):
            chunk = items[start: start + batch_size]
            audio, lens = pad_batch([a for _, a in chunk], s_len, cfg)
            hyps, scores = rec.decode(audio, lens, mode, nbest=use_nbest)
            for r in range(len(chunk)):
                path, ci = chunk[r][0]
                if use_nbest:
                    cands = [
                        {"text": rec.vocab.decode_text(hyps[r, j]),
                         "score": float(scores[r, j])}
                        for j in range(min(nbest, hyps.shape[1]))
                    ]
                    res = {"text": cands[0]["text"],
                           "score": cands[0]["score"], "nbest": cands}
                    best = hyps[r, 0]
                else:
                    res = {"text": rec.vocab.decode_text(hyps[r]),
                           "score": float(scores[r].sum()
                                          if scores[r].ndim else scores[r])}
                    best = hyps[r]
                n_hyps += 1
                if not bool((best == EOS).any()):
                    cap_hits += 1
                    res["no_eos"] = True
                chunk_results[(str(path), ci)] = res

    results = []
    for f in files:
        key = str(f)
        parts = [chunk_results[(key, ci)] for ci in range(n_chunks[key])]
        if len(parts) == 1:
            results.append({"audio": key, **parts[0]})
        else:
            results.append({
                "audio": key,
                "text": " ".join(p["text"] for p in parts if p["text"]),
                "score": float(sum(p["score"] for p in parts)),
                "chunks": len(parts),
            })
    if n_hyps and cap_hits / n_hyps > 0.01:
        print(
            f"WARNING: LENGTH-CAP SATURATION — {cap_hits}/{n_hyps} "
            f"hypotheses filled decode.max_decode_len="
            f"{cfg.decode.max_decode_len} without emitting EOS; those "
            "transcripts are TRUNCATED (records carry no_eos). Raise "
            "decode.max_decode_len for long audio.",
            file=sys.stderr,
        )
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="semi_supervised_asr_tpu_torch.transcribe")
    p.add_argument("--config", required=True)
    p.add_argument("--load-dir", required=True,
                   help="a Solver's workdir (checkpoints/), or a directory "
                        "holding params.npz and cmvn.npz")
    p.add_argument("--beam", type=int, default=None,
                   help="beam size; 1 = greedy")
    p.add_argument("--nbest", type=int, default=1,
                   help="(beam) emit the top-N hypotheses per file")
    p.add_argument("--out", default=None, help="write jsonl here too")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    for flag in ("--timestamps", "--streaming"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    p.add_argument("inputs", nargs="+",
                   help="audio files (wav/npy/flac) and/or directories, "
                        "then section.key=value overrides")
    args, overrides = p.parse_known_args(argv)

    if args.beam == 0:
        raise SystemExit("--beam 0 (CTC greedy) is not ported yet")
    for flag in ("timestamps", "streaming"):
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is not ported yet")
    # an EXISTING path wins even if it contains '='
    paths = [x for x in args.inputs if Path(x).exists() or "=" not in x]
    overrides += [x for x in args.inputs
                  if not Path(x).exists() and "=" in x]
    cfg = load_config(args.config, overrides)
    if args.beam is not None and args.beam > 1:
        cfg = cfg.replace(decode=dataclasses.replace(cfg.decode,
                                                     beam_size=args.beam))
    mode = "greedy" if args.beam == 1 else "beam"
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu to run "
                             "the plain PyTorch versions")
        strict_fp32()
    files = collect_files(paths)
    if not files:
        raise SystemExit("no audio files found")
    try:
        check_supported(cfg.decode)
        rec = Recognizer.from_dir(cfg, args.load_dir, device)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    results = transcribe(rec, files, mode, nbest=args.nbest)
    out_f = open(args.out, "w") if args.out else None
    try:
        for r in results:
            line = json.dumps(r)
            print(line)
            if out_f:
                out_f.write(line + "\n")
    finally:
        if out_f:
            out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
