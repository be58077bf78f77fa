"""FLAC reading via the native decoder (``native/flac_decoder.cpp``).

The PyTorch port's copy of the reading half of
``semi_supervised_asr_tpu/utils/flac.py``, over its own copy of the C++
decoder.  LibriSpeech ships 16-bit mono FLAC and there is no
soundfile/ffmpeg, so audio loading goes through this decoder (ctypes C ABI,
compiled by ``g++`` at first use into the git-ignored ``_build/``).  There
is no Python fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "flac_decoder.cpp"
_SO = _PKG / "_build" / "libflac_decoder.so"

_lib = None
_build_err: str | None = None


def _load() -> ctypes.CDLL:
    global _lib, _build_err
    if _lib is not None:
        return _lib
    if _build_err is not None:
        raise RuntimeError(_build_err)
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _SO.parent.mkdir(parents=True, exist_ok=True)
            tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(str(_SO))
        lib.flac_stream_info.restype = ctypes.c_int
        lib.flac_stream_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.flac_decode_all.restype = ctypes.c_int64
        lib.flac_decode_all.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        _lib = lib
    except Exception as e:
        _build_err = f"native FLAC decoder unavailable: {e}"
        raise RuntimeError(_build_err) from e
    return _lib


def stream_info(path: str | Path) -> dict:
    """STREAMINFO -> {n_samples, sample_rate, channels, bits} (no decode)."""
    data = Path(path).read_bytes()
    info = (ctypes.c_int64 * 4)()
    rc = _load().flac_stream_info(data, len(data), info)
    if rc != 0:
        raise ValueError(f"{path}: not a valid FLAC stream (rc={rc})")
    return {
        "n_samples": int(info[0]), "sample_rate": int(info[1]),
        "channels": int(info[2]), "bits": int(info[3]),
    }


def read_flac_int(path: str | Path) -> tuple[np.ndarray, int, int]:
    """Decode a FLAC file -> (int32 samples [n, channels], sample_rate,
    bits_per_sample)."""
    data = Path(path).read_bytes()
    lib = _load()
    info = (ctypes.c_int64 * 4)()
    rc = lib.flac_stream_info(data, len(data), info)
    if rc != 0:
        raise ValueError(f"{path}: not a valid FLAC stream (rc={rc})")
    total, rate, channels, bits = (int(info[0]), int(info[1]),
                                   int(info[2]), int(info[3]))
    # STREAMINFO may legally report 0 total samples; fall back to a bound
    # from the compressed size (FLAC never expands 16-bit audio 4x).
    cap_per_ch = total if total > 0 else (len(data) * 4) // channels + 65536
    out = np.empty(cap_per_ch * channels, np.int32)
    got = lib.flac_decode_all(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.size,
    )
    if got < 0:
        raise ValueError(f"{path}: FLAC decode failed (rc={got})")
    return out[: got * channels].reshape(int(got), channels), rate, bits


def read_flac(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode FLAC -> (float32 mono waveform in [-1, 1), sample_rate).

    Multichannel audio is averaged to mono (LibriSpeech itself is mono).
    """
    samples, rate, bits = read_flac_int(path)
    wav = samples.astype(np.float32) / np.float32(2 ** (bits - 1))
    if wav.shape[1] > 1:
        wav = wav.mean(axis=1)
    else:
        wav = wav[:, 0]
    return wav, rate
