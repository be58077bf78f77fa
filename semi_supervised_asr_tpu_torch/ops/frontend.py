"""Batched audio frontend in PyTorch: framing -> power spectrum -> log-mel.

Counterpart of ``semi_supervised_asr_tpu/ops/frontend.py``.  Framing and
the DFT are plain tensor code (as in JAX, they stay outside the fused
kernel); the post-FFT chain has an unfused version here and the fused CUDA
kernel in ``fused_frontend.py``.  Everything is float32; the matmul DFT
must run at full float32 precision (call ``strict_fp32()`` on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn

from semi_supervised_asr_tpu.config import FrontendConfig
from semi_supervised_asr_tpu.ops import frontend_oracle as oracle


@functools.lru_cache(maxsize=8)
def host_constants(cfg: FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """(window [n_fft], mel bank [F, M]) as float32 numpy arrays."""
    window = oracle.padded_window(cfg).astype(np.float32)
    fb = oracle.mel_filterbank(
        cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.fmin, cfg.fmax_hz,
        cfg.mel_scale,
    ).astype(np.float32)
    return window, fb


def constants(cfg: FrontendConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(window [n_fft], mel bank [F, M]) float32 tensors on ``device``."""
    return _constants_on(cfg, str(device))


@functools.lru_cache(maxsize=16)
def _constants_on(cfg: FrontendConfig, device: str):
    window, fb = host_constants(cfg)
    return (torch.from_numpy(window).to(device),
            torch.from_numpy(fb).to(device))


@functools.lru_cache(maxsize=16)
def _dft_basis_on(n_fft: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_dft_basis_np(n_fft)).to(device)


@functools.lru_cache(maxsize=4)
def _dft_basis_np(n_fft: int) -> np.ndarray:
    """Real-DFT basis [n_fft, 2*(n_fft//2+1)]: cos columns, then sin."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.concatenate(
        [np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)],
        axis=1,
    )


def frame_lengths(sample_lengths: torch.Tensor,
                  cfg: FrontendConfig) -> torch.Tensor:
    """Valid frame count per utterance given sample lengths."""
    if cfg.center:
        return 1 + torch.div(sample_lengths, cfg.hop_length,
                             rounding_mode="floor")
    return 1 + torch.div(sample_lengths - cfg.n_fft, cfg.hop_length,
                         rounding_mode="floor")


def _frame(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[B, S] -> [B, T, n_fft] frames (reflect-centered when cfg.center)."""
    if cfg.preemphasis > 0.0:
        audio = torch.cat(
            [audio[:, :1], audio[:, 1:] - cfg.preemphasis * audio[:, :-1]],
            dim=1,
        )
    if cfg.center:
        pad = cfg.n_fft // 2
        # reflect does not repeat the edge sample, as jnp.pad "reflect"
        audio = Fn.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return audio.unfold(-1, cfg.n_fft, cfg.hop_length)


def power_spectrogram(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[B, S] -> [B, T, n_fft//2 + 1] power spectrum (float32)."""
    window, _ = constants(cfg, audio.device)
    frames = _frame(audio.float(), cfg) * window
    if cfg.fft_backend == "matmul":
        basis = _dft_basis_on(cfg.n_fft, str(audio.device))
        reim = torch.matmul(frames, basis)
        k = cfg.n_fft // 2 + 1
        return reim[..., :k] ** 2 + reim[..., k:] ** 2
    if cfg.fft_backend != "xla":
        raise ValueError(f"unknown fft_backend {cfg.fft_backend!r} "
                         "(expected 'xla' or 'matmul')")
    spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def log_mel_from_power(pspec: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[B, T, F] power -> [B, T, M] log-mel."""
    _, fb = constants(cfg, pspec.device)
    mel = torch.matmul(pspec, fb)
    return torch.log(torch.clamp_min(mel, cfg.log_floor))


def utterance_cmvn(feats: torch.Tensor, feat_lens: torch.Tensor,
                   eps: float = 1e-8) -> torch.Tensor:
    """Per-utterance mean/var normalization over valid frames only."""
    t = feats.shape[1]
    mask = (torch.arange(t, device=feats.device)[None, :]
            < feat_lens[:, None]).to(feats.dtype)[..., None]
    denom = torch.clamp_min(feat_lens.to(feats.dtype), 1.0)[:, None]
    mean = torch.sum(feats * mask, dim=1) / denom
    sq = torch.sum(feats ** 2 * mask, dim=1) / denom
    var = torch.clamp_min(sq - mean ** 2, 0.0)
    out = (feats - mean[:, None, :]) * torch.rsqrt(var + eps)[:, None, :]
    return out * mask


def apply_global_cmvn(feats: torch.Tensor, mean: torch.Tensor,
                      inv_std: torch.Tensor) -> torch.Tensor:
    return (feats - mean) * inv_std


def frame_mask(lens: torch.Tensor, t: int) -> torch.Tensor:
    """[B, t] bool, True on valid frames."""
    return torch.arange(t, device=lens.device)[None, :] < lens[:, None]


def log_mel_features(
    audio: torch.Tensor,
    sample_lens: torch.Tensor,
    cfg: FrontendConfig,
    cmvn_mean: torch.Tensor | None = None,
    cmvn_inv_std: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unfused frontend: [B, S] audio -> ([B, T, M] feats, [B] lens).

    Padding frames are zeroed after normalization."""
    pspec = power_spectrogram(audio, cfg)
    feats = log_mel_from_power(pspec, cfg)
    lens = torch.clamp_max(frame_lengths(sample_lens, cfg), feats.shape[1])
    if cfg.cmvn == "utterance":
        return utterance_cmvn(feats, lens), lens
    if cfg.cmvn == "global":
        if cmvn_mean is None or cmvn_inv_std is None:
            raise ValueError("global CMVN requires precomputed stats")
        feats = apply_global_cmvn(feats, cmvn_mean, cmvn_inv_std)
    mask = frame_mask(lens, feats.shape[1])
    return feats * mask[..., None].to(feats.dtype), lens
