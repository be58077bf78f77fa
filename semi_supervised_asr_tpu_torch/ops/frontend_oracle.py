"""Float64 numpy oracle for the audio frontend (librosa/kaldi conventions).

librosa/soundfile are not dependencies (SURVEY.md §2.2), so the
parity target is re-derived from first principles and documented here:

* framing: ``center=True`` pads the signal by ``n_fft//2`` with reflection
  (librosa.stft default), frames every ``hop_length`` samples; the number of
  frames is ``1 + len(x)//hop``.
* window: periodic Hann of length ``win_length``, zero-padded symmetrically
  to ``n_fft`` (librosa ``pad_mode`` for windows).
* spectrum: ``|rfft(frame, n_fft)|**2`` (power).
* mel: Slaney-style filterbank (librosa ``htk=False`` default) — triangular
  filters equally spaced on the Slaney mel scale, with the 2/(band) area
  normalization; HTK variant selectable.
* log: natural log with an absolute floor (kaldi/espnet fbank convention).
* CMVN: per-utterance or global mean/variance normalization over valid frames.

Every function here is plain numpy float64 and is the ground truth for the
JAX and Pallas implementations (tests/test_frontend.py).

The PyTorch port's own copy of ``semi_supervised_asr_tpu/ops/frontend_oracle.py``,
kept identical so that the port imports nothing of the JAX package
(tests hold the two against each other).
"""

from __future__ import annotations

import numpy as np

from semi_supervised_asr_tpu_torch.config import FrontendConfig


def hz_to_mel(f, scale: str = "slaney"):
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    safe_f = np.maximum(f, 1e-30)  # avoid log(0) in the unused branch
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(safe_f / min_log_hz) / logstep,
        mel,
    )


def mel_to_hz(m, scale: str = "slaney"):
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freq = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freq
    )


def mel_filterbank(
    n_mels: int,
    n_fft: int,
    sample_rate: float,
    fmin: float = 0.0,
    fmax: float | None = None,
    scale: str = "slaney",
    norm: bool = True,
) -> np.ndarray:
    """[n_fft//2+1, n_mels] triangular filterbank (float64).

    Matches librosa.filters.mel(htk=False, norm="slaney") up to fp64 rounding.
    """
    fmax = sample_rate / 2.0 if fmax is None else fmax
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(
        hz_to_mel(fmin, scale), hz_to_mel(fmax, scale), n_mels + 2
    )
    hz_pts = mel_to_hz(mel_pts, scale)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)  # [n_mels+2, F]
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    fb = np.maximum(0.0, np.minimum(lower, upper))  # [n_mels, F]
    if norm:
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm.reshape(-1, 1)
    return fb.T.copy()  # [F, n_mels]


def periodic_hann(win_length: int) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def padded_window(cfg: FrontendConfig) -> np.ndarray:
    """Hann(win_length) centered in an n_fft-long buffer (librosa style)."""
    w = periodic_hann(cfg.win_length)
    if cfg.n_fft == cfg.win_length:
        return w
    assert cfg.n_fft > cfg.win_length
    lpad = (cfg.n_fft - cfg.win_length) // 2
    out = np.zeros(cfg.n_fft, dtype=np.float64)
    out[lpad : lpad + cfg.win_length] = w
    return out


def num_frames(n_samples: int, cfg: FrontendConfig) -> int:
    if cfg.center:
        return 1 + n_samples // cfg.hop_length
    return 1 + (n_samples - cfg.n_fft) // cfg.hop_length


def frame_signal(x: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """[T, n_fft] frames of a 1-D signal, reflect-centered when cfg.center."""
    x = np.asarray(x, dtype=np.float64)
    if cfg.preemphasis > 0.0:
        x = np.concatenate([x[:1], x[1:] - cfg.preemphasis * x[:-1]])
    if cfg.center:
        pad = cfg.n_fft // 2
        x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - cfg.n_fft) // cfg.hop_length
    idx = (
        np.arange(n_frames).reshape(-1, 1) * cfg.hop_length
        + np.arange(cfg.n_fft).reshape(1, -1)
    )
    return x[idx]


def power_spectrogram(x: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """[T, n_fft//2+1] power spectrum."""
    frames = frame_signal(x, cfg) * padded_window(cfg).reshape(1, -1)
    spec = np.fft.rfft(frames, n=cfg.n_fft, axis=-1)
    return np.abs(spec) ** 2


def log_mel(x: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """[T, n_mels] log-mel features (natural log, floored)."""
    pspec = power_spectrogram(x, cfg)
    fb = mel_filterbank(
        cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.fmin, cfg.fmax_hz,
        cfg.mel_scale,
    )
    mel = pspec @ fb
    return np.log(np.maximum(mel, cfg.log_floor))


def pad_for_batch(x: np.ndarray, target_len: int, cfg: FrontendConfig) -> np.ndarray:
    """Pad a 1-D utterance to ``target_len`` for zero-cost batched framing.

    The first ``n_fft//2`` padding samples are the reflection of the signal
    tail, so every *valid* frame of the batched frontend (windows may extend
    up to n_fft//2 samples past the utterance end under ``center=True``)
    is bit-identical to per-utterance extraction; the rest is zeros.
    Host-side numpy — called from the data pipeline collate.
    """
    x = np.asarray(x)
    n = len(x)
    assert target_len >= n
    out = np.zeros(target_len, dtype=x.dtype)
    out[:n] = x
    tail = min(cfg.n_fft // 2, target_len - n, n - 1)
    if tail > 0:
        out[n : n + tail] = x[n - 2 : n - 2 - tail : -1]
    return out


def cmvn_stats(feats: np.ndarray, lengths: np.ndarray | None = None):
    """(mean[F], inv_std[F]) over valid frames of [T,F] or [B,T,F]."""
    f = np.asarray(feats, dtype=np.float64)
    if f.ndim == 2:
        valid = f
    else:
        if lengths is None:
            valid = f.reshape(-1, f.shape[-1])
        else:
            rows = [f[b, : int(lengths[b])] for b in range(f.shape[0])]
            valid = np.concatenate(rows, axis=0)
    mean = valid.mean(axis=0)
    var = valid.var(axis=0)
    return mean, 1.0 / np.sqrt(var + 1e-8)


def apply_cmvn(feats: np.ndarray, mean: np.ndarray, inv_std: np.ndarray):
    return (feats - mean) * inv_std


def full_frontend(
    x: np.ndarray,
    cfg: FrontendConfig,
    mean: np.ndarray | None = None,
    inv_std: np.ndarray | None = None,
) -> np.ndarray:
    """log-mel + CMVN. Utterance CMVN if stats are None and cfg.cmvn!='none'."""
    lm = log_mel(x, cfg)
    if cfg.cmvn == "none":
        return lm
    if mean is None:
        mean, inv_std = cmvn_stats(lm)
    return apply_cmvn(lm, mean, inv_std)
