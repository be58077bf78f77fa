"""FLAC reading and writing via the native coders (``native/
flac_decoder.cpp``, ``native/flac_encoder.cpp``).

The PyTorch port's copy of ``semi_supervised_asr_tpu/utils/flac.py``, over
its own copies of the C++ decoder and VERBATIM encoder.  LibriSpeech ships
16-bit mono FLAC and there is no soundfile/ffmpeg, so audio loading goes
through this decoder, and corpus manifests read each file's length from
its STREAMINFO header (:func:`flac_num_samples`); tests write FLAC trees
with :func:`write_flac_verbatim`.  Both libraries (ctypes C ABI) are
compiled by ``g++`` at first use into the git-ignored ``_build/``.  There
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
_ENC_SRC = _PKG / "native" / "flac_encoder.cpp"
_ENC_SO = _PKG / "_build" / "libflac_encoder.so"

_lib = None
_enc_lib = None
_build_err: str | None = None


def _build(src: Path, so: Path) -> None:
    """Compile ``src`` into ``so`` with g++ unless ``so`` is newer (written
    to a temporary name, then renamed: a concurrent reader never loads a
    partial library)."""
    if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             str(src), "-o", str(tmp)],
            check=True, capture_output=True,
        )
        os.replace(tmp, so)


def _load() -> ctypes.CDLL:
    global _lib, _build_err
    if _lib is not None:
        return _lib
    if _build_err is not None:
        raise RuntimeError(_build_err)
    try:
        _build(_SRC, _SO)
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


def _load_encoder() -> ctypes.CDLL:
    """The VERBATIM encoder, built as the decoder is."""
    global _enc_lib
    if _enc_lib is not None:
        return _enc_lib
    _build(_ENC_SRC, _ENC_SO)
    lib = ctypes.CDLL(str(_ENC_SO))
    lib.flac_encode_verbatim_bound.restype = ctypes.c_int64
    lib.flac_encode_verbatim_bound.argtypes = [ctypes.c_int64,
                                               ctypes.c_int32]
    lib.flac_encode_verbatim.restype = ctypes.c_int64
    lib.flac_encode_verbatim.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    _enc_lib = lib
    return lib


def write_flac_verbatim(path: str | Path, samples: np.ndarray,
                        sample_rate: int = 16000,
                        blocksize: int = 4096) -> int:
    """Encode int16 mono ``samples`` as an uncompressed (VERBATIM) FLAC
    file -> bytes written; lossless (round-trips bit-exactly through
    :func:`read_flac_int`)."""
    samples = np.ascontiguousarray(samples, np.int16)
    if samples.ndim != 1:
        raise ValueError("write_flac_verbatim writes mono only")
    lib = _load_encoder()
    cap = int(lib.flac_encode_verbatim_bound(samples.size, blocksize))
    out = np.empty(cap, np.uint8)
    got = lib.flac_encode_verbatim(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        samples.size, sample_rate, blocksize,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    if got < 0:
        raise ValueError("flac_encode_verbatim failed")
    with open(path, "wb") as f:
        out[:got].tofile(f)
    return int(got)


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


def flac_num_samples(path: str | Path) -> int:
    """Per-channel sample count from STREAMINFO (header only); STREAMINFO
    may legally report 0 (unknown), and then the file is decoded, so that
    manifest lengths are always real."""
    n = stream_info(path)["n_samples"]
    if n == 0:
        n = int(read_flac_int(path)[0].shape[0])
    return n
