"""Forced alignment CLI of the PyTorch port: known transcripts -> per-token
timestamps.

    python -m semi_supervised_asr_tpu_torch.align --config C --load-dir D \\
        --manifest M [--out F] [--device cuda] [section.key=value ...]

Counterpart of ``semi_supervised_asr_tpu/align.py``: each manifest entry's
reference text (``{"uid", "audio", "text"}``, the training schema) is
aligned against the CTC head's frame posteriors by Viterbi forced
alignment (``ops/ctc_align.py``).  It takes the CTC family, or a LAS model
trained with the joint-CTC head; the transducer has no frame posteriors
and is refused.  ``D`` is what ``transcribe --load-dir`` takes (a Solver's
workdir, or ``params.npz`` and ``cmvn.npz``).

Output: one JSON object an entry, ``{"uid", "audio", "text",
"logp_per_frame", "tokens": [{"t", "start_s", "end_s"}]}``.  An entry with
an empty transcript, a transcript longer than the largest token bucket,
audio longer than the largest frame bucket (the alignment is one global
path: no chunk stitching) or a transcript that its frames cannot hold as a
CTC path is written with ``"failed": reason`` and no tokens; the exit code
is 1 only if every entry failed.  The entries are batched by (frame
bucket, token bucket), ``train.batch_size`` rows a batch.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from semi_supervised_asr_tpu_torch import strict_fp32
from semi_supervised_asr_tpu_torch.config import load_config
from semi_supervised_asr_tpu_torch.data.corpus import load_audio
from semi_supervised_asr_tpu_torch.data.vocab import PAD
from semi_supervised_asr_tpu_torch.transcribe import Recognizer, pad_batch


def read_manifest(path: str | Path) -> list[dict]:
    """The entries of a JSON-lines manifest, blank lines skipped (the
    reference's ``selftrain.read_manifest``)."""
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(json.loads(line))
    return entries


def align_entries(rec: Recognizer, entries: list[dict],
                  manifest_root: Path) -> list[dict]:
    """Forced-align manifest entries -> one record each (module
    docstring); a relative audio path is taken from ``manifest_root``."""
    cfg, spec, vocab = rec.cfg, rec.spec, rec.vocab
    rec.align_head()        # the reference's refusals, before any decode
    sec_per_frame = (cfg.frontend.hop_length * cfg.model.time_reduction
                     / cfg.frontend.sample_rate)
    by_cell: dict[tuple[int, int], list] = {}
    records: list[dict] = []
    for i, e in enumerate(entries):
        p = Path(e["audio"])
        p = p if p.is_absolute() else manifest_root / p
        audio = np.asarray(load_audio(p), np.float32)
        ids = vocab.encode_text(e["text"])
        records.append({"uid": e.get("uid", str(p)), "audio": str(p),
                        "text": e["text"]})
        fb = spec.frame_bucket(spec.frames_for_samples(len(audio)))
        tb = next((t for t in cfg.data.token_buckets if t >= len(ids)), None)
        if fb is None:
            records[i]["failed"] = "audio exceeds the largest frame bucket"
        elif tb is None or not ids:
            records[i]["failed"] = (
                "empty transcript" if not ids
                else "transcript exceeds the largest token bucket")
        else:
            by_cell.setdefault((fb, tb), []).append((i, audio, ids))

    batch_size = cfg.train.batch_size
    for (fb, tb), items in sorted(by_cell.items()):
        s_len = spec.samples_for_frames(fb)
        for start in range(0, len(items), batch_size):
            chunk = items[start: start + batch_size]
            audio, lens = pad_batch([a for _, a, _ in chunk], s_len, cfg)
            toks = np.full((batch_size, tb), PAD, np.int32)
            tlens = np.zeros((batch_size,), np.int32)
            for r, (_, _, ids) in enumerate(chunk):
                toks[r, : len(ids)] = ids
                tlens[r] = len(ids)
            starts, ends, plp = rec.align(audio, lens, toks, tlens)
            for r, (i, _, ids) in enumerate(chunk):
                res = records[i]
                if not np.isfinite(plp[r]):
                    res["failed"] = ("transcript does not fit the audio as "
                                     "a CTC path")
                    continue
                syms = vocab.decode(ids, strip_specials=False)
                n_frames = max(int(ends[r, : len(ids)].max()) + 1, 1)
                res["logp_per_frame"] = round(float(plp[r]) / n_frames, 4)
                res["tokens"] = [
                    {"t": syms[j],
                     "start_s": round(float(starts[r, j]) * sec_per_frame,
                                      3),
                     "end_s": round((float(ends[r, j]) + 1) * sec_per_frame,
                                    3)}
                    for j in range(len(ids))]
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="semi_supervised_asr_tpu_torch.align")
    p.add_argument("--config", required=True)
    p.add_argument("--load-dir", required=True,
                   help="a Solver's workdir (checkpoints/), or a directory "
                        "holding params.npz and cmvn.npz")
    p.add_argument("--manifest", required=True,
                   help="labeled manifest jsonl ({uid, audio, text})")
    p.add_argument("--out", default=None, help="write jsonl here too")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    args, overrides = p.parse_known_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu to run "
                             "the plain PyTorch versions")
        strict_fp32()
    cfg = load_config(args.config, overrides)
    entries = read_manifest(args.manifest)
    if not entries:
        raise SystemExit(f"empty manifest: {args.manifest}")
    try:
        rec = Recognizer.from_dir(cfg, args.load_dir, device)
        records = align_entries(rec, entries,
                                Path(args.manifest).resolve().parent)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e)) from None
    n_fail = 0
    out_f = open(args.out, "w") if args.out else None
    try:
        for res in records:
            n_fail += "failed" in res
            line = json.dumps(res)
            print(line)
            if out_f:
                out_f.write(line + "\n")
    finally:
        if out_f:
            out_f.close()
    if n_fail:
        print(f"WARNING: {n_fail}/{len(records)} entries failed to align",
              file=sys.stderr)
    return 0 if n_fail < len(records) else 1


if __name__ == "__main__":
    sys.exit(main())
