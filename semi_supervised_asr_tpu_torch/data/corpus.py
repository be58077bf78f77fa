"""Manifest-backed corpora (TIMIT / LibriSpeech): audio loading.

The PyTorch port's copy of ``load_audio`` and ``ManifestDataset`` from
``semi_supervised_asr_tpu/data/corpus.py`` (the HDF5 feature store is not
ported).

Manifest format: one JSON object per line —
    {"uid": ..., "audio": "path.wav|path.npy", "n_samples": int,
     "text": "..."}           (unit-tokenized by the vocab)
or  {"uid": ..., "audio": ..., "n_samples": int, "tokens": [ids...]}
Audio loading: 16-bit PCM WAV via scipy.io.wavfile, NIST SPHERE
(``utils/sphere.py``), float32 .npy, or FLAC via the port's copy of the
native decoder (``native/flac_decoder.cpp``, ``utils/flac.py``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from semi_supervised_asr_tpu_torch.data.synthetic import Utterance
from semi_supervised_asr_tpu_torch.data.vocab import EOS, Vocab


def load_audio(path: str | Path, prefer_i16: bool = False) -> np.ndarray:
    """Decode one utterance, reading the file exactly ONCE.

    ``prefer_i16`` (the data.audio_i16_transfer host path): sources that
    are losslessly 16-bit — WAV/SPHERE/16-bit-mono-FLAC — return native
    **int16** so decode->pad->transfer is pure integer memcpy (a ~3x cut
    in host memory traffic vs int->f32->int); anything not exactly
    representable (float .npy, 24/32-bit PCM, multichannel FLAC whose
    mono mix is a float mean) returns float32 and gets clip+round at
    batch assembly.  FLAC eligibility is decided from the STREAMINFO
    header, not by decoding twice.
    """
    path = Path(path)
    suf = path.suffix.lower()
    if suf == ".npy":
        return np.load(path).astype(np.float32)
    if suf == ".wav":
        # real TIMIT's ".WAV" files are NIST SPHERE, not RIFF — sniff
        from semi_supervised_asr_tpu_torch.utils.sphere import (
            is_sphere, read_sphere_i16,
        )

        if is_sphere(path):
            samples, _ = read_sphere_i16(path)  # SPHERE is 16-bit at heart
            if prefer_i16:
                return samples
            return samples.astype(np.float32) / 32768.0
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
        if data.dtype == np.int16:
            if prefer_i16 and data.ndim == 1:
                return data
            return data.astype(np.float32) / 32768.0
        if data.dtype == np.int32:
            return data.astype(np.float32) / 2147483648.0
        return data.astype(np.float32)
    if suf == ".flac":
        from semi_supervised_asr_tpu_torch.utils.flac import (
            read_flac, read_flac_int, stream_info,
        )

        if prefer_i16:
            info = stream_info(path)    # header-only eligibility check
            if info["bits"] == 16 and info["channels"] == 1:
                return read_flac_int(path)[0][:, 0].astype(np.int16)
        wav, _ = read_flac(path)
        return wav
    raise ValueError(f"unsupported audio format: {path.suffix}")


class ManifestDataset:
    """Lazy corpus over a jsonl manifest; lengths come from the manifest so
    bucketing never touches audio files."""

    def __init__(self, manifest: str | Path, vocab: Vocab,
                 prefer_i16: bool = False):
        self.root = Path(manifest).parent
        self.vocab = vocab
        # int16-native decode for the audio_i16_transfer pipeline; falls
        # back to float per-file when a source isn't losslessly 16-bit
        self.prefer_i16 = prefer_i16
        self.entries = []
        with open(manifest) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.entries.append(json.loads(line))

    def __len__(self) -> int:
        return len(self.entries)

    def _tokens(self, e: dict) -> np.ndarray:
        if "tokens" in e:
            ids = list(e["tokens"])
        else:
            ids = self.vocab.encode_text(e["text"])
        if not ids or ids[-1] != EOS:
            ids = ids + [EOS]
        return np.asarray(ids, np.int32)

    def __getitem__(self, i: int) -> Utterance:
        e = self.entries[i]
        path = Path(e["audio"])
        if not path.is_absolute():
            path = self.root / path
        return Utterance(
            uid=e["uid"],
            audio=load_audio(path, prefer_i16=self.prefer_i16),
            tokens=self._tokens(e),
            text=e.get("text", ""),
        )

    def audio_len(self, i: int) -> int:
        return int(self.entries[i]["n_samples"])

    def token_len(self, i: int) -> int:
        return len(self._tokens(self.entries[i]))
