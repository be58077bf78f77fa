"""Transcription CLI of the PyTorch port: raw audio files in, text out.

    python -m semi_supervised_asr_tpu_torch.transcribe \\
        --config configs/timit.yaml --load-dir DIR [--beam K] [--nbest N] \\
        [--out hyps.jsonl] a.wav b.flac dir/ [section.key=value ...]

Counterpart of the offline path of ``semi_supervised_asr_tpu/
transcribe.py``: files are bucketed by frame count (the training buckets),
files longer than the largest bucket are decoded in bucket-sized chunks and
their texts joined, rows are padded to ``train.batch_size``, and each
batch is decoded with beam search (default: the attention beam, the CTC
family's prefix beam or the transducer's alignment-synchronous beam),
greedy (``--beam 1``: the CTC family's best path, the transducer's
frame-synchronous walk) or the CTC head's best path (``--beam 0``: a LAS
model with the joint CTC head, or the CTC family; the transducer refuses
it).
Each file prints one JSON object ``{"audio", "text", "score"}`` (plus
``nbest`` with ``--nbest N``, ``no_eos`` when the length cap cut it,
``chunks`` for chunked files).  ``--timestamps`` adds ``"tokens": [{"t",
"start_s", "end_s"}]``: the CTC family and a LAS model with the joint-CTC
head time the decoded hypothesis by Viterbi forced alignment on the CTC
head's posteriors (``ops/ctc_align.py``, any decode mode), the transducer
by its greedy walk's emission frames (``--beam 1``; start == end); a
chunked file's times are offset by its chunks.

``--streaming`` decodes each file through the exact streaming path
(``decode/streaming.py``) instead, fed in ``--stream-chunk-ms`` pieces, greedy
(``--beam 0`` or ``1``) or with the beam; ``--streams N`` serves N files at
once through one ``MultiStreamTranscriber``.  Its records carry
``"streaming": true``; with ``--timestamps`` (greedy, one stream) the
tokens' times come from the walk's own emission frames, tracked across
chunks.

Shallow LM fusion follows ``decode.lm_weight`` / ``decode.lm_ckpt`` (an
``lm_trainer`` workdir), offline and under ``--streaming``, on every beam
(the transducer's with ``decode.ilm_weight``), as ``main --test`` does.
Contextual biasing follows ``decode.bias_phrases`` (a phrase file) and
``decode.bias_bonus``: every beam (offline, ``--nbest``) and every
streamed walk, greedy included, boosts the phrases; the offline greedy
decodes run unbiased and say so, as the reference's do.

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
from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD
from semi_supervised_asr_tpu_torch.ops.frontend_oracle import pad_for_batch
from semi_supervised_asr_tpu_torch import strict_fp32, weights
from semi_supervised_asr_tpu_torch.decode import biasing as BZ
from semi_supervised_asr_tpu_torch.decode.beam import beam_decode_from_enc
from semi_supervised_asr_tpu_torch.decode.ctc import (
    ctc_greedy_from_enc, ctc_head_logits,
)
from semi_supervised_asr_tpu_torch.decode.ctc_beam import ctc_beam_from_enc
from semi_supervised_asr_tpu_torch.decode.greedy import greedy_decode_from_enc
from semi_supervised_asr_tpu_torch.decode.transducer_beam import (
    transducer_beam_from_enc,
)
from semi_supervised_asr_tpu_torch.decode.transducer_greedy import (
    transducer_greedy_from_enc,
)
from semi_supervised_asr_tpu_torch.models.seq2seq import build_model
from semi_supervised_asr_tpu_torch.ops.ctc_align import ctc_viterbi_align
from semi_supervised_asr_tpu_torch.training.lm_trainer import (
    LMNotFound, decode_lm,
)
from semi_supervised_asr_tpu_torch.training.train_step import featurize
from semi_supervised_asr_tpu_torch.utils.metrics import hyp_lengths

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


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr)


GREEDY_UNBIASED = (
    "WARNING: offline/eval greedy decode runs unbiased — decode.bias_phrases "
    "applies to beam decode, and to streaming greedy (transcribe "
    "--streaming, frame-synchronous families)")


class Recognizer:
    """A model (``Seq2Seq``, ``CTCModel`` or ``Transducer``), its CMVN
    statistics and vocab on one device: decodes padded audio batches.
    ``warn`` reports a ``decode.ctc_weight`` that cannot apply (stderr by
    default).  ``lm`` (an external LM, ``training/lm_trainer.py::
    decode_lm``) fuses every beam shallowly at ``decode.lm_weight``.
    ``bias`` (a :class:`~.decode.biasing.BiasTrie`, or a function that
    builds it at the first beam decode) biases every beam; the greedy
    modes decode unbiased."""

    def __init__(self, cfg: Config, model, cmvn: tuple, vocab,
                 device: torch.device, backend: str | None = None,
                 warn=_stderr, lm=None, bias=None):
        self.cfg, self.vocab, self.device = cfg, vocab, device
        self._bias = bias
        self.model = model.to(device).eval()
        self.lm = None if lm is None else lm.to(device).eval()
        self.mean = torch.as_tensor(np.asarray(cmvn[0]), dtype=torch.float32,
                                    device=device)
        self.inv_std = torch.as_tensor(np.asarray(cmvn[1]),
                                       dtype=torch.float32, device=device)
        self.backend = backend
        self.spec = make_bucket_spec(cfg.data, cfg.frontend,
                                     cfg.model.time_reduction)
        self.ctc_family = cfg.model.family == "ctc"
        self.transducer = cfg.model.family == "transducer"
        # the joint CTC-attention beam: the LAS family with its CTC head
        self.joint_ctc = None
        if cfg.decode.ctc_weight > 0.0:
            if self.transducer:
                warn("WARNING: decode.ctc_weight > 0 is LAS-only — ignored "
                     "for the transducer beam")
            elif self.ctc_family:
                warn("WARNING: decode.ctc_weight rescoring is LAS-only — the "
                     "CTC family's beam IS the CTC score")
            elif not hasattr(self.model, "ctc"):
                warn("WARNING: decode.ctc_weight > 0 but the model has no CTC "
                     "head (train with objective.lambda_ctc > 0) — CTC "
                     "rescoring DISABLED")
            else:
                self.joint_ctc = self.model.ctc

    @property
    def bias(self):
        """The biasing trie on the device, or None (built on first use)."""
        if callable(self._bias):
            self._bias = self._bias()
        return None if self._bias is None else self._bias.to(self.device)

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
                       backend, lm=solver.lm, bias=lambda: solver.bias)
        if not (load_dir / "params.npz").exists():
            raise SystemExit(
                f"{load_dir}: found neither {cfg.train.ckpt_dir}/ (a "
                "Solver's checkpoints) nor params.npz to decode with")
        vocab = build_vocab(cfg)
        cfg = finalize_config(cfg, vocab.size)
        model = build_model(cfg.model)
        weights.load_npz(model, load_dir / "params.npz")
        with np.load(load_dir / "cmvn.npz") as z:
            cmvn = (z["mean"], z["inv_std"])
        return cls(cfg, model, cmvn, vocab, torch.device(device), backend,
                   lm=decode_lm(cfg, vocab.size, device, _stderr),
                   bias=lambda: BZ.bias_from_config(cfg.decode, vocab,
                                                    device, _stderr))

    @torch.inference_mode()
    def encode(self, audio: torch.Tensor, lens: torch.Tensor):
        """Padded audio [B, S] -> (enc, enc_mask, the speller's decode
        cache) on the device; the CTC and transducer families' (enc,
        enc_mask)."""
        feats, flens = featurize(self.cfg, audio, lens,
                                 (self.mean, self.inv_std),
                                 backend=self.backend)
        return self.model.encode(feats, flens, self.backend)

    @torch.inference_mode()
    def decode(self, audio: np.ndarray, lens: np.ndarray, mode: str,
               nbest: bool = False):
        """[B, S] padded audio, [B] sample lengths -> (tokens, scores) as
        numpy.  ``mode`` ``greedy`` gives per-step log-probs (the CTC
        family: its best path and the path's log-prob; the transducer: its
        walk and the walk's log-prob), ``beam`` the normalized score (the
        CTC family: the prefix's log-marginal; the transducer: the path's
        log-prob; with ``nbest`` all K lattices and scores), ``ctc`` the
        CTC head's best path."""
        a = torch.as_tensor(audio, device=self.device)
        n = torch.as_tensor(lens, dtype=torch.int32, device=self.device)
        cfg = self.cfg
        if self.transducer:
            if mode == "ctc":       # the reference's refusal
                raise SystemExit(
                    "--beam 0 (CTC greedy) is LAS-only; the transducer "
                    "decodes greedy (--beam 1) or alignment-synchronous beam "
                    "(--beam K)")
            enc, enc_mask = self.encode(a, n)
            max_u = max_decode_steps(cfg, enc.shape[1])
            dcfg = cfg.decode
            if mode == "beam":
                out = transducer_beam_from_enc(
                    self.model, cfg.model, enc, enc_mask, max_u,
                    dcfg.beam_size, dcfg.max_symbols, return_nbest=nbest,
                    lm=self.lm, lm_weight=dcfg.lm_weight,
                    ilm_weight=dcfg.ilm_weight, bias=self.bias)
            else:
                out = transducer_greedy_from_enc(
                    self.model, cfg.model, enc, enc_mask, max_u,
                    dcfg.max_symbols)
            return out[0].cpu().numpy(), out[1].cpu().numpy()
        if self.ctc_family:
            enc, enc_mask = self.encode(a, n)
            if mode == "beam":
                out = ctc_beam_from_enc(
                    self.model.ctc, enc, enc_mask,
                    max_decode_steps(cfg, enc.shape[1]),
                    cfg.decode.beam_size, return_nbest=nbest, lm=self.lm,
                    lm_weight=cfg.decode.lm_weight, bias=self.bias)
            else:
                out = ctc_greedy_from_enc(self.model.ctc, enc, enc_mask)
            return out[0].cpu().numpy(), out[1].cpu().numpy()
        if mode == "ctc" and not hasattr(self.model, "ctc"):
            raise SystemExit("CTC decode needs a CTC head — train with "
                             "objective.lambda_ctc > 0 (or model.ctc_head: "
                             "true)")
        enc, enc_mask, keys = self.encode(a, n)
        max_u = max_decode_steps(cfg, enc.shape[1])
        speller = self.model.speller
        if mode == "ctc":
            out = ctc_greedy_from_enc(self.model.ctc, enc, enc_mask)
        elif mode == "greedy":
            out = greedy_decode_from_enc(speller, enc, enc_mask, keys, max_u)
        else:
            out = beam_decode_from_enc(speller, cfg.decode, enc, enc_mask,
                                       keys, max_u, return_nbest=nbest,
                                       ctc=self.joint_ctc, lm=self.lm,
                                       bias=self.bias)
        return out[0].cpu().numpy(), out[1].cpu().numpy()

    def align_head(self):
        """The CTC head forced alignment reads: the CTC family's, or a LAS
        model's joint-CTC head; the reference's refusals otherwise
        (ValueError)."""
        if self.transducer:
            raise ValueError(
                "forced alignment needs CTC frame posteriors; the transducer "
                "gets timestamps from its greedy decode (emission frames) — "
                "use _times_fn")
        if not hasattr(self.model, "ctc"):
            raise ValueError(
                "forced alignment needs a CTC head — the ctc family has one; "
                "LAS needs objective.lambda_ctc > 0 (or model.ctc_head: "
                "true) at train time")
        return self.model.ctc

    @torch.inference_mode()
    def align(self, audio: np.ndarray, lens: np.ndarray, tokens: np.ndarray,
              token_lens: np.ndarray):
        """CTC Viterbi forced alignment of ``tokens`` [B, U] (``token_lens``
        valid, no EOS) on the CTC head's frame posteriors of the padded
        audio -> (starts, ends [B, U] inclusive encoder frames, -1 past a
        row's tokens; the path's log-prob [B], -inf where the tokens do not
        fit the frames) as numpy."""
        ctc = self.align_head()
        a = torch.as_tensor(audio, device=self.device)
        n = torch.as_tensor(lens, dtype=torch.int32, device=self.device)
        enc, enc_mask = self.encode(a, n)[:2]
        logp = torch.log_softmax(ctc_head_logits(ctc, enc), dim=-1)
        out = ctc_viterbi_align(
            logp, enc_mask.sum(dim=1),
            torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(token_lens, device=self.device))
        return tuple(x.cpu().numpy() for x in out)

    @torch.inference_mode()
    def times(self, audio: np.ndarray, lens: np.ndarray):
        """The transducer's greedy walk with each token's emission frame ->
        (tokens [B, max_u], the path's log-prob [B], frames [B, max_u], -1
        past a row's tokens) as numpy."""
        a = torch.as_tensor(audio, device=self.device)
        n = torch.as_tensor(lens, dtype=torch.int32, device=self.device)
        enc, enc_mask = self.encode(a, n)
        out = transducer_greedy_from_enc(
            self.model, self.cfg.model, enc, enc_mask,
            max_decode_steps(self.cfg, enc.shape[1]),
            self.cfg.decode.max_symbols, track_frames=True)
        return tuple(x.cpu().numpy() for x in out)


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
               nbest: int = 1, timestamps: bool = False) -> list[dict]:
    """Bucket + batch the files, decode -> [{audio, text, score, ...}];
    ``timestamps`` adds each record's ``tokens`` (module docstring)."""
    if mode not in ("beam", "greedy", "ctc"):
        raise SystemExit(f"unknown decode mode {mode!r}")
    if nbest > 1 and mode != "beam":
        raise SystemExit(f"--nbest needs beam decoding (got mode={mode!r}); "
                         "drop --beam 0/1 or --nbest")
    use_nbest = nbest > 1
    if timestamps and use_nbest:
        raise SystemExit("--timestamps times the single best hypothesis; "
                         "drop --nbest")
    spec, cfg = rec.spec, rec.cfg
    if mode != "beam" and cfg.decode.bias_phrases:
        _stderr(GREEDY_UNBIASED)
    td_times = timestamps and rec.transducer
    if td_times and mode != "greedy":
        raise SystemExit("transducer --timestamps reads emission frames from "
                         "the greedy scan — add --beam 1")
    if timestamps and not td_times:
        try:
            rec.align_head()
        except ValueError as e:
            raise SystemExit(str(e)) from None
    # an encoder frame's seconds (the hop times the total reduction); the
    # times of a long file's chunk ci are offset by ci chunks' audio
    sec_per_frame = (cfg.frontend.hop_length * cfg.model.time_reduction
                     / cfg.frontend.sample_rate)
    max_bucket = spec.frame_buckets[-1]
    chunk_off_s = (spec.samples_for_frames(max_bucket)
                   / cfg.frontend.sample_rate)
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
    # the length cap cuts EOS-terminated (LAS) hypotheses only
    track_cap = cfg.model.family == "las" and mode != "ctc"
    cap_hits, n_hyps = 0, 0
    chunk_results: dict[tuple[str, int], dict] = {}
    for fb, items in sorted(by_bucket.items()):
        s_len = spec.samples_for_frames(fb)
        for start in range(0, len(items), batch_size):
            chunk = items[start: start + batch_size]
            audio, lens = pad_batch([a for _, a in chunk], s_len, cfg)
            starts = ends = plp = None
            if td_times:
                hyps, scores, starts = rec.times(audio, lens)
                ends, plp = starts, np.zeros(len(hyps))
            else:
                hyps, scores = rec.decode(audio, lens, mode, nbest=use_nbest)
            if timestamps and not td_times:
                tl = hyp_lengths(hyps)
                toks = np.where(np.arange(hyps.shape[1])[None, :]
                                < tl[:, None], hyps, PAD).astype(np.int32)
                starts, ends, plp = rec.align(audio, lens, toks, tl)
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
                if track_cap:
                    n_hyps += 1
                    if not bool((best == EOS).any()):
                        cap_hits += 1
                        res["no_eos"] = True
                if timestamps:
                    res["tokens"] = token_times(
                        rec.vocab, hyps[r], starts[r], ends[r], plp[r],
                        sec_per_frame, ci * chunk_off_s, f"{path} chunk {ci}")
                chunk_results[(str(path), ci)] = res

    results = []
    for f in files:
        key = str(f)
        parts = [chunk_results[(key, ci)] for ci in range(n_chunks[key])]
        if len(parts) == 1:
            results.append({"audio": key, **parts[0]})
        else:
            res = {"audio": key,
                   "text": " ".join(p["text"] for p in parts if p["text"]),
                   "score": float(sum(p["score"] for p in parts)),
                   "chunks": len(parts)}
            if timestamps:
                # each chunk's times already carry its offset
                res["tokens"] = [t for p in parts for t in p["tokens"]]
            results.append(res)
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


def token_times(vocab, hyp: np.ndarray, starts: np.ndarray,
                ends: np.ndarray, path_logp: float, sec_per_frame: float,
                offset_s: float, where: str) -> list[dict]:
    """One hypothesis' ``tokens`` records ``{"t", "start_s", "end_s"}``:
    its tokens before the first EOS / PAD, each spanning its encoder frames
    [start, end + 1) in seconds after ``offset_s``, rounded to the
    millisecond; none, with a warning naming ``where``, when the path's
    log-prob is not finite (the hypothesis does not CTC-align)."""
    if not np.isfinite(path_logp):
        print(f"WARNING: {where}: hypothesis does not CTC-align; no "
              "timestamps", file=sys.stderr)
        return []
    n_tok = int(hyp_lengths(hyp[None])[0])
    syms = vocab.decode([int(x) for x in hyp[:n_tok]], strip_specials=False)
    return [{"t": syms[j],
             "start_s": round(float(starts[j]) * sec_per_frame + offset_s, 3),
             "end_s": round((float(ends[j]) + 1) * sec_per_frame + offset_s,
                            3)}
            for j in range(n_tok) if starts[j] >= 0]


def transcribe_streaming(rec: Recognizer, files: list[Path],
                         beam_size: int = 1, chunk_ms: int = 320,
                         streams: int = 1,
                         timestamps: bool = False) -> list[dict]:
    """Decode each file through the exact streaming path, fed in
    ``chunk_ms`` pieces: one ``StreamingTranscriber`` a file, or with
    ``streams`` > 1 waves of that many files through one
    ``MultiStreamTranscriber`` (one chunk call advances every live stream
    a round; each file's tokens are those of a single stream).
    ``timestamps`` (greedy, one stream): each record's ``tokens`` from the
    walk's emission frames, a point emission at frame f spanning
    [f, f + 1) frames."""
    from semi_supervised_asr_tpu_torch.decode.streaming import (
        MultiStreamTranscriber, StreamingTranscriber,
    )

    if timestamps and beam_size > 1:
        raise SystemExit("--streaming --timestamps is greedy-only (beam "
                         "carries keep no frame slot); add --beam 1")
    if timestamps and streams > 1:
        raise SystemExit("--timestamps is single-stream; drop --streams")
    cfg = rec.cfg
    sr = cfg.frontend.sample_rate
    piece = max(int(sr * chunk_ms / 1000), 1)
    kw = dict(max_u=cfg.decode.max_decode_len,
              max_symbols=cfg.decode.max_symbols, beam_size=beam_size,
              backend=rec.backend, lm=rec.lm,
              lm_weight=cfg.decode.lm_weight,
              ilm_weight=cfg.decode.ilm_weight, bias=rec.bias)
    cmvn = (rec.mean, rec.inv_std)

    def record(f, toks, score):
        return {"audio": str(f),
                "text": rec.vocab.decode_text(np.asarray(toks, np.int32)),
                "score": score, "streaming": True}

    results = []
    if streams > 1:
        ms = MultiStreamTranscriber(rec.model, cfg, cmvn,
                                    n_streams=min(streams, len(files)), **kw)
        for start in range(0, len(files), ms.n_streams):
            wave = files[start: start + ms.n_streams]
            audios = [np.asarray(load_audio(f), np.float32) for f in wave]
            sids = [ms.open() for _ in wave]
            cursors = [0] * len(wave)
            while any(c < len(a) for c, a in zip(cursors, audios)):
                for i, (sid, a) in enumerate(zip(sids, audios)):
                    if cursors[i] < len(a):
                        ms.feed(sid, a[cursors[i]: cursors[i] + piece])
                        cursors[i] += piece
                ms.pump()          # one chunk call a round for the wave
            results.extend(record(f, *ms.finalize(sid))
                           for f, sid in zip(wave, sids))
        return results
    sec_per_frame = cfg.frontend.hop_length * cfg.model.time_reduction / sr
    for f in files:
        audio = np.asarray(load_audio(f), np.float32)
        st = StreamingTranscriber(rec.model, cfg, cmvn,
                                  track_frames=timestamps, **kw)
        for s in range(0, len(audio), piece):
            st.feed(audio[s: s + piece])
        toks, score = st.finalize()
        res = record(f, toks, score)
        if timestamps:
            frames = st.emission_frames()
            syms = rec.vocab.decode(toks, strip_specials=False)
            res["tokens"] = [
                {"t": syms[j],
                 "start_s": round(frames[j] * sec_per_frame, 3),
                 "end_s": round((frames[j] + 1) * sec_per_frame, 3)}
                for j in range(len(toks)) if frames[j] >= 0]
        results.append(res)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="semi_supervised_asr_tpu_torch.transcribe")
    p.add_argument("--config", required=True)
    p.add_argument("--load-dir", required=True,
                   help="a Solver's workdir (checkpoints/), or a directory "
                        "holding params.npz and cmvn.npz")
    p.add_argument("--beam", type=int, default=None,
                   help="beam size; 1 = greedy, 0 = the CTC head's best "
                        "path")
    p.add_argument("--nbest", type=int, default=1,
                   help="(beam) emit the top-N hypotheses per file")
    p.add_argument("--out", default=None, help="write jsonl here too")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--timestamps", action="store_true",
                   help="per-token times: the CTC family and LAS with the "
                        "joint-CTC head by Viterbi forced alignment on the "
                        "CTC head, the transducer by its greedy emission "
                        "frames (--beam 1); with --streaming (greedy only) "
                        "from the chunked walk's own emission frames"),
    p.add_argument("--streaming", action="store_true",
                   help="decode through the exact streaming path "
                        "(StreamingTranscriber) in --stream-chunk-ms pieces "
                        "-- needs a causal transducer or CTC config "
                        "(enc_bidirectional=false or enc_attn_chunk > 0, "
                        "frontend.center=false)")
    p.add_argument("--stream-chunk-ms", type=int, default=320,
                   help="simulated audio feed granularity (--streaming)")
    p.add_argument("--streams", type=int, default=1,
                   help="with --streaming: decode this many files at once "
                        "(one chunk call steps every live stream)")
    p.add_argument("inputs", nargs="+",
                   help="audio files (wav/npy/flac) and/or directories, "
                        "then section.key=value overrides")
    args, overrides = p.parse_known_args(argv)

    if args.streaming and args.nbest > 1:
        raise SystemExit("--streaming emits the single best path; drop "
                         "--nbest")
    # an EXISTING path wins even if it contains '='
    paths = [x for x in args.inputs if Path(x).exists() or "=" not in x]
    overrides += [x for x in args.inputs
                  if not Path(x).exists() and "=" in x]
    cfg = load_config(args.config, overrides)
    if args.beam is not None and args.beam > 1:
        cfg = cfg.replace(decode=dataclasses.replace(cfg.decode,
                                                     beam_size=args.beam))
    mode = {0: "ctc", 1: "greedy"}.get(args.beam, "beam")
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
        rec = Recognizer.from_dir(cfg, args.load_dir, device)
        if args.streaming:
            try:
                results = transcribe_streaming(
                    rec, files, cfg.decode.beam_size if mode == "beam" else 1,
                    args.stream_chunk_ms, args.streams, args.timestamps)
            except ValueError as e:      # the reference's streaming refusals
                raise SystemExit(str(e)) from None
        else:
            results = transcribe(rec, files, mode, nbest=args.nbest,
                                 timestamps=args.timestamps)
    except (NotImplementedError, LMNotFound, FileNotFoundError) as e:
        raise SystemExit(str(e)) from None
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
