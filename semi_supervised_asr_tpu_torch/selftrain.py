"""Offline self-training round (noisy student / iterative pseudo-labeling).

    python -m semi_supervised_asr_tpu_torch.selftrain --config C \\
        --load-dir runs/teacher --manifest data/unlabeled.jsonl \\
        --out data/pseudo.jsonl [--beam 5] [--min-score -1.0] \\
        [--keep-frac 0.8] [--union data/labeled.jsonl] [--device cpu] \\
        [section.key=value ...]

Counterpart of ``semi_supervised_asr_tpu/selftrain.py``: a trained teacher
(a Solver workdir, or a directory with ``params.npz`` and ``cmvn.npz``:
``transcribe.Recognizer.from_dir``) decodes an unlabeled manifest with
``transcribe.transcribe`` and writes a pseudo-labeled manifest in the
training schema (``{"uid", "audio", "n_samples", "text"}``) plus
``"pseudo_score"`` (the decode's length-normalized log-probability).  Point
``data.train_manifest`` at the output (or at ``--union``: the labeled
manifest, then the kept pseudo entries) to train the next student.

Filters: ``--min-score`` drops hypotheses below an absolute score,
``--keep-frac`` keeps the top fraction by score of what remains (at least
one), written back in uid order; empty hypotheses are always dropped.
``--device`` defaults to ``cuda`` and the CLI refuses to start without it;
``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from semi_supervised_asr_tpu_torch import transcribe as TR


def read_manifest(path: str | Path) -> list[dict]:
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(json.loads(line))
    return entries


def pseudo_label_entries(
    rec: TR.Recognizer,
    entries: list[dict],
    manifest_root: Path,
    mode: str = "beam",
    min_score: float | None = None,
    keep_frac: float | None = None,
) -> tuple[list[dict], dict]:
    """Decode the entries' audio with the teacher -> (pseudo entries,
    {"total", "decoded_nonempty", "after_min_score", "kept"}).  Entries keep
    uid / audio / n_samples and carry the hypothesis as "text" plus
    "pseudo_score"; an input "text" is ignored."""
    paths = []
    for e in entries:
        p = Path(e["audio"])
        paths.append(p if p.is_absolute() else manifest_root / p)
    results = TR.transcribe(rec, paths, mode)

    labeled = []
    for e, path, r in zip(entries, paths, results):
        if not r["text"]:
            continue
        labeled.append({"uid": e["uid"], "audio": str(path),
                        "n_samples": e["n_samples"], "text": r["text"],
                        "pseudo_score": r["score"]})
    n_decoded = len(labeled)

    if min_score is not None:
        labeled = [e for e in labeled if e["pseudo_score"] >= min_score]
    n_above = len(labeled)
    if keep_frac is not None and labeled:
        if not 0.0 < keep_frac <= 1.0:
            raise ValueError(f"--keep-frac {keep_frac} outside (0, 1]")
        labeled.sort(key=lambda e: e["pseudo_score"], reverse=True)
        labeled = labeled[: max(1, int(round(keep_frac * len(labeled))))]
        labeled.sort(key=lambda e: e["uid"])   # deterministic output order

    stats = {"total": len(entries), "decoded_nonempty": n_decoded,
             "after_min_score": n_above, "kept": len(labeled)}
    return labeled, stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="semi_supervised_asr_tpu_torch.selftrain")
    p.add_argument("--config", required=True)
    p.add_argument("--load-dir", required=True,
                   help="teacher workdir (checkpoint + cmvn.npz), or a "
                        "directory holding params.npz and cmvn.npz")
    p.add_argument("--manifest", required=True,
                   help="unlabeled jsonl manifest (audio paths + lengths)")
    p.add_argument("--out", required=True,
                   help="pseudo-labeled manifest to write")
    p.add_argument("--beam", type=int, default=None,
                   help="beam size; 1 = greedy, 0 = CTC greedy")
    p.add_argument("--min-score", type=float, default=None,
                   help="drop hyps below this normalized logprob")
    p.add_argument("--keep-frac", type=float, default=None,
                   help="keep only this top fraction by confidence")
    p.add_argument("--union", default=None,
                   help="also copy this labeled manifest into --out "
                        "(labeled ∪ pseudo, ready for data.train_manifest)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    args, overrides = p.parse_known_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu to run "
                             "the plain PyTorch versions")
        from semi_supervised_asr_tpu_torch import strict_fp32

        strict_fp32()
    from semi_supervised_asr_tpu_torch.config import load_config

    cfg = load_config(args.config, overrides)
    if args.beam is not None and args.beam > 1:
        cfg = cfg.replace(decode=dataclasses.replace(
            cfg.decode, beam_size=args.beam))
    mode = {0: "ctc", 1: "greedy"}.get(args.beam, "beam")

    entries = read_manifest(args.manifest)
    rec = TR.Recognizer.from_dir(cfg, args.load_dir, device)
    labeled, stats = pseudo_label_entries(
        rec, entries, Path(args.manifest).parent, mode, args.min_score,
        args.keep_frac)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        if args.union:
            for e in read_manifest(args.union):
                f.write(json.dumps(e) + "\n")
        for e in labeled:
            f.write(json.dumps(e) + "\n")
    print(json.dumps({"out": str(out), **stats, "union": bool(args.union)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
