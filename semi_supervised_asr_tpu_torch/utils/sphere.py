"""NIST SPHERE audio reader (the format real TIMIT ships as).

LDC's TIMIT names its files ``.WAV`` but they are NIST SPHERE, not RIFF —
an ASCII header (``NIST_1A\\n   1024\\n`` then ``field -type value`` lines
until ``end_head``) followed by raw samples.  scipy's wavfile cannot read
them; this pure-numpy reader covers the encodings TIMIT-era corpora use:

* 16-bit linear PCM, little- or big-endian (``sample_byte_format`` 01/10),
* 8-bit G.711 mu-law (``sample_coding ulaw``).

Shorten-compressed SPHERE (``embedded-shorten``) is rejected with a clear
message (decompress with the NIST ``w_decode`` tool first).

The PyTorch port's own copy of ``semi_supervised_asr_tpu/utils/sphere.py``,
kept identical so that the port imports nothing of the JAX package
(tests hold the two against each other).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

MAGIC = b"NIST_1A"


def is_sphere(path: str | Path) -> bool:
    with open(path, "rb") as f:
        return f.read(7) == MAGIC


def _parse_header(raw: bytes) -> dict:
    text = raw.decode("ascii", errors="replace")
    fields: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if line == "end_head":
            break
        parts = line.split(None, 2)
        if len(parts) != 3 or not parts[1].startswith("-"):
            continue
        name, ftype, value = parts
        if ftype == "-i":
            fields[name] = int(value)
        elif ftype == "-r":
            fields[name] = float(value)
        else:  # -sN string
            fields[name] = value
    return fields


def _ulaw_expand(b: np.ndarray) -> np.ndarray:
    """G.711 mu-law bytes -> int16 linear."""
    u = (~b).astype(np.int32) & 0xFF
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    sample = (((mantissa << 3) + 0x84) << exponent) - 0x84
    return np.where(sign, -sample, sample).astype(np.int16)


def read_sphere(path: str | Path) -> tuple[np.ndarray, int]:
    """-> (float32 samples in [-1, 1] (mono: first channel), sample_rate)."""
    samples, sr = read_sphere_i16(path)
    return samples.astype(np.float32) / 32768.0, sr


def read_sphere_i16(path: str | Path) -> tuple[np.ndarray, int]:
    """-> (native int16 samples (mono: first channel), sample_rate).

    SPHERE audio is 16-bit linear at heart (2-byte PCM, or G.711 mu-law
    expanded to int16), so the integer form is the lossless native one —
    the int16 H2D transfer path (data.audio_i16_transfer) feeds on it
    directly, skipping the float round trip.
    """
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(MAGIC):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        header_size = int(f.readline().strip())
        f.seek(0)
        head = _parse_header(f.read(header_size))
        f.seek(header_size)
        data = f.read()

    coding = head.get("sample_coding", "pcm")
    if "shorten" in coding:
        raise ValueError(
            f"{path}: shorten-compressed SPHERE is not supported — "
            "decompress with NIST w_decode first"
        )
    n = head.get("sample_count")
    channels = head.get("channel_count", 1)
    sr = head.get("sample_rate", 16000)
    nbytes = head.get("sample_n_bytes", 2)

    if coding.startswith("ulaw") or nbytes == 1:
        samples = _ulaw_expand(np.frombuffer(data, np.uint8))
    elif nbytes == 2:
        # SPHERE-era corpora written on big-endian workstations commonly
        # OMIT sample_byte_format; defaulting to little-endian would
        # decode those to garbage with no error, so the historical
        # big-endian norm ('10') is the fallback (ADVICE r1)
        endian = "<" if head.get("sample_byte_format", "10") == "01" else ">"
        samples = np.frombuffer(data, dtype=np.dtype(f"{endian}i2"))
    else:
        raise ValueError(f"{path}: unsupported sample_n_bytes={nbytes}")

    if channels > 1:
        samples = samples[: (len(samples) // channels) * channels]
        samples = samples.reshape(-1, channels)[:, 0]
    if n is not None:
        samples = samples[:n]
    return samples.astype(np.int16), sr


def sphere_sample_count(path: str | Path) -> int:
    """Header-only length probe (for manifest building / bucketing)."""
    with open(path, "rb") as f:
        f.readline()
        header_size = int(f.readline().strip())
        f.seek(0)
        head = _parse_header(f.read(header_size))
    n = head.get("sample_count")
    if n is None:
        raise ValueError(f"{path}: SPHERE header lacks sample_count")
    return int(n)
