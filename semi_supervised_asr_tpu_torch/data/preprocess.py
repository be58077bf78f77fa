"""Corpus preprocessing CLI of the PyTorch port: manifests, vocab and BPE.

    python -m semi_supervised_asr_tpu_torch.data.preprocess timit \\
        --root /data/TIMIT --out data/timit [--splits train,test] [--fold48]
    python -m semi_supervised_asr_tpu_torch.data.preprocess librispeech \\
        --root /data/LibriSpeech --out data/ls \\
        [--splits train-clean-100,dev-clean] [--bpe N]

The port's copy of ``semi_supervised_asr_tpu/data/preprocess.py``: it
writes one jsonl manifest per split (``{"uid", "audio", "n_samples",
"text"}``; ``test`` and ``dev-clean`` are named ``dev``) and
``vocab.json`` into ``--out``, byte for byte as the reference writes them,
and with ``--bpe N`` (LibriSpeech) a BPE model of N pieces trained on the
first split's transcripts, ``bpe.json``.  TIMIT transcripts come from the
``.PHN`` files (dialect sentences SA* skipped), LibriSpeech's from
``*.trans.txt``; audio may be WAV (NIST SPHERE included), NPY or FLAC, whose
length comes from its STREAMINFO header.  ``--features`` (the HDF5 feature
store) needs ``h5py`` and is refused, as ``data.use_feature_store`` is.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from semi_supervised_asr_tpu_torch.data.vocab import char_vocab, timit_vocab


def _wav_len(path: Path) -> int:
    from semi_supervised_asr_tpu_torch.utils.sphere import (
        is_sphere, sphere_sample_count,
    )

    if is_sphere(path):  # real TIMIT: NIST SPHERE named .WAV
        return sphere_sample_count(path)
    from scipy.io import wavfile

    _, data = wavfile.read(path, mmap=True)
    return int(data.shape[0])


def _audio_len(path: Path) -> int:
    if path.suffix.lower() == ".npy":
        return int(np.load(path, mmap_mode="r").shape[0])
    if path.suffix.lower() == ".flac":
        from semi_supervised_asr_tpu_torch.utils.flac import flac_num_samples

        return flac_num_samples(path)
    return _wav_len(path)


def read_phn(path: Path) -> list[str]:
    phones = []
    for line in path.read_text().splitlines():
        parts = line.split()
        if len(parts) >= 3:
            phones.append(parts[2].lower())
    return phones


def scan_timit(root: Path, split_dir: str) -> list[dict]:
    entries = []
    base = root / split_dir
    if not base.is_dir():
        # LDC TIMIT ships upper-case split directories (TRAIN/TEST)
        for cand in (split_dir.upper(), split_dir.lower()):
            if (root / cand).is_dir():
                base = root / cand
                break
    for wav in sorted(base.rglob("*.[wW][aA][vV]")):
        phn = wav.with_suffix(".PHN")
        if not phn.exists():
            phn = wav.with_suffix(".phn")
        if not phn.exists():
            continue
        # the dialect-calibration sentences are not trained on
        if wav.stem.upper().startswith("SA"):
            continue
        entries.append({
            "uid": f"{wav.parent.parent.name}-{wav.parent.name}-{wav.stem}",
            "audio": str(wav),
            "n_samples": _audio_len(wav),
            "text": " ".join(read_phn(phn)),
        })
    return entries


def scan_librispeech(root: Path, split: str) -> list[dict]:
    entries = []
    for trans in sorted((root / split).rglob("*.trans.txt")):
        for line in trans.read_text().splitlines():
            uid, _, text = line.partition(" ")
            if not text:
                continue
            for ext in (".wav", ".npy", ".flac"):
                audio = trans.parent / f"{uid}{ext}"
                if audio.exists():
                    break
            else:
                continue
            entries.append({
                "uid": uid,
                "audio": str(audio),
                "n_samples": _audio_len(audio),
                "text": text.lower().strip(),
            })
    return entries


def write_manifest(entries: list[dict], path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="semi_supervised_asr_tpu_torch.data.preprocess")
    p.add_argument("corpus", choices=["timit", "librispeech"])
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--splits", default=None,
                   help="comma-separated; defaults: timit=train,test; "
                        "librispeech=train-clean-100,dev-clean")
    p.add_argument("--features", action="store_true",
                   help="(not ported: the HDF5 feature store needs h5py)")
    p.add_argument("--bpe", type=int, default=0, metavar="N",
                   help="(librispeech) train an N-piece BPE model on the "
                        "first split's transcripts -> bpe.json (use with "
                        "data.unit=bpe + data.bpe_path)")
    p.add_argument("--fold48", action="store_true",
                   help="(timit) tokenize with the 48-class training fold "
                        "(data.timit_fold48 must match at train time)")
    args = p.parse_args(argv)
    if args.features:
        raise SystemExit("--features (the HDF5 feature store) is not ported "
                         "yet: it needs h5py, as data.use_feature_store does")
    if args.bpe > 0 and args.corpus != "librispeech":
        raise SystemExit("--bpe is for librispeech")

    root, out = Path(args.root), Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.corpus == "timit":
        vocab = timit_vocab(fold48=args.fold48)
        splits = (args.splits or "train,test").split(",")
        scan = lambda s: scan_timit(root, s)  # noqa: E731
    else:
        vocab = char_vocab()
        splits = (args.splits or "train-clean-100,dev-clean").split(",")
        scan = lambda s: scan_librispeech(root, s)  # noqa: E731

    vocab.save(out / "vocab.json")
    for i, split in enumerate(splits):
        entries = scan(split.strip())
        name = {"test": "dev", "dev-clean": "dev"}.get(split.strip(),
                                                       split.strip())
        write_manifest(entries, out / f"{name}.jsonl")
        print(f"{split}: {len(entries)} utterances -> {out}/{name}.jsonl")
        if i == 0 and args.bpe > 0:
            from semi_supervised_asr_tpu_torch.data.bpe import train_bpe

            bpe = train_bpe((e["text"] for e in entries), args.bpe)
            bpe.save(out / "bpe.json")
            print(f"BPE: {bpe.size} pieces ({len(bpe.merges)} merges) -> "
                  f"{out}/bpe.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
