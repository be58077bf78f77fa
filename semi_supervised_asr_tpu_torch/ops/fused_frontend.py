"""Fused post-FFT frontend: kernel K1 (``csrc/fused_post_fft.cu``).

Counterpart of ``semi_supervised_asr_tpu/ops/pallas_frontend.py``.  The
chain after the power spectrum -- mel product, log floor, global CMVN,
pad-frame zeroing and the SpecAugment band masks -- is one CUDA kernel
that reads the [B, T, F] power spectrum once and writes the [B, T, M]
features once.  Framing and the DFT stay outside (``frontend.py``).  The
kernel takes the mel bank packed by filter (each triangular filter's run
of non-zero bins), which skips only exact-zero terms of the product.

``fused_post_fft_reference`` is the same math in plain PyTorch.  The
wrapper runs it only for CPU tensors or when asked with
``backend="reference"``; a CUDA tensor otherwise launches the kernel or
raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from semi_supervised_asr_tpu.config import FrontendConfig
from semi_supervised_asr_tpu_torch import _native
from semi_supervised_asr_tpu_torch.ops import frontend as F

SpecAug = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@functools.lru_cache(maxsize=8)
def _mel_runs_np(cfg: FrontendConfig):
    """The mel bank packed by filter: each filter's run of non-zero FFT
    bins [lo, hi) -> (weights [nnz], lo [M], offsets [M+1])."""
    _, fb = F.host_constants(cfg)
    weights, lo, off = [], [], [0]
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        a, b = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        weights.append(fb[a:b, m])
        lo.append(a)
        off.append(off[-1] + b - a)
    return (np.concatenate(weights).astype(np.float32),
            np.asarray(lo, np.int32), np.asarray(off, np.int32))


@functools.lru_cache(maxsize=16)
def _mel_runs_on(cfg: FrontendConfig, device: str):
    return tuple(torch.from_numpy(a).to(device) for a in _mel_runs_np(cfg))


def _band_mask(pos: torch.Tensor, starts: torch.Tensor,
               widths: torch.Tensor) -> torch.Tensor:
    """[B, n] bands over positions [P] -> [B, P] bool, True inside a band."""
    s, w = starts[..., None], widths[..., None]
    return ((pos >= s) & (pos < s + w)).any(dim=1)


def fused_post_fft_reference(
    pspec: torch.Tensor,            # [B, T, F] float32
    feat_lens: torch.Tensor,        # [B] int
    cfg: FrontendConfig,
    cmvn_mean: torch.Tensor,        # [M]
    cmvn_inv_std: torch.Tensor,     # [M]
    specaug: SpecAug | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel -> [B, T, M] float32."""
    _, fb = F.constants(cfg, pspec.device)
    mel = torch.matmul(pspec.float(), fb)
    x = (torch.log(torch.clamp_min(mel, cfg.log_floor))
         - cmvn_mean.float()) * cmvn_inv_std.float()
    b, t, m = x.shape
    keep = F.frame_mask(feat_lens, t)[:, :, None].expand(b, t, m)
    if specaug is not None:
        fs, fw, ts, tw = specaug
        fmask = _band_mask(torch.arange(m, device=x.device), fs, fw)
        tmask = _band_mask(torch.arange(t, device=x.device), ts, tw)
        keep = keep & ~fmask[:, None, :] & ~tmask[:, :, None]
    return torch.where(keep, x, torch.zeros((), device=x.device))


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )


def fused_post_fft(
    pspec: torch.Tensor,
    feat_lens: torch.Tensor,
    cfg: FrontendConfig,
    cmvn_mean: torch.Tensor,
    cmvn_inv_std: torch.Tensor,
    specaug: SpecAug | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """-> [B, T, n_mels] features; ``specaug=None`` disables masking.

    ``specaug`` = (fstarts, fwidths, tstarts, twidths), int [B, n] each,
    sampled by the caller (as ``frontend.sample_specaug_params`` does for
    the JAX kernel).  See the module docstring for ``backend``.
    """
    if not _native.use_kernel(pspec, backend):
        return fused_post_fft_reference(pspec, feat_lens, cfg, cmvn_mean,
                                        cmvn_inv_std, specaug)
    b, t, f = pspec.shape
    m = cfg.n_mels
    dev = pspec.device
    band_w, band_lo, band_off = _mel_runs_on(cfg, str(dev))
    _check("pspec", pspec, torch.float32, (b, t, f), dev)
    if f != cfg.n_fft // 2 + 1:
        raise ValueError(f"pspec has {f} bins, the mel bank "
                         f"{cfg.n_fft // 2 + 1}")
    lens = feat_lens.to(torch.int32).contiguous()
    mean = cmvn_mean.to(torch.float32).contiguous()
    istd = cmvn_inv_std.to(torch.float32).contiguous()
    _check("feat_lens", lens, torch.int32, (b,), dev)
    _check("cmvn_mean", mean, torch.float32, (m,), dev)
    _check("cmvn_inv_std", istd, torch.float32, (m,), dev)
    if specaug is None:
        bands = (None, None, None, None)
        n_f = n_t = 0
    else:
        bands = tuple(x.to(torch.int32).contiguous() for x in specaug)
        n_f, n_t = bands[0].shape[1], bands[2].shape[1]
        for name, x, n in zip(("fstarts", "fwidths", "tstarts", "twidths"),
                              bands, (n_f, n_f, n_t, n_t)):
            _check(name, x, torch.int32, (b, n), dev)
    pspec = pspec.contiguous()
    out = torch.empty((b, t, m), dtype=torch.float32, device=dev)
    lib = _native.lib()
    code = lib.fused_post_fft(
        pspec.data_ptr(), band_w.data_ptr(), band_lo.data_ptr(),
        band_off.data_ptr(), band_w.numel(), mean.data_ptr(),
        istd.data_ptr(), lens.data_ptr(), *(_native.ptr(x) for x in bands),
        n_f, n_t,
        out.data_ptr(), b, t, f, m, float(cfg.log_floor),
        _native.stream_ptr(dev),
    )
    _native.check("fused_post_fft", code)
    _native.count("fused_post_fft")
    return out


def fused_log_mel_features(
    audio: torch.Tensor,
    sample_lens: torch.Tensor,
    cfg: FrontendConfig,
    cmvn_mean: torch.Tensor,
    cmvn_inv_std: torch.Tensor,
    specaug: SpecAug | None = None,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full fused frontend: raw audio -> (features, frame lengths).

    Global CMVN only (utterance CMVN needs a cross-tile statistics pass;
    the unfused path handles that mode)."""
    if cfg.cmvn != "global":
        raise ValueError("the fused frontend supports global CMVN only")
    pspec = F.power_spectrogram(audio, cfg)
    lens = torch.clamp_max(F.frame_lengths(sample_lens, cfg), pspec.shape[1])
    feats = fused_post_fft(pspec, lens, cfg, cmvn_mean, cmvn_inv_std,
                           specaug, backend)
    return feats, lens
