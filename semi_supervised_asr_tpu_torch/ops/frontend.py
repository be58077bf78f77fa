"""Batched audio frontend in PyTorch: framing -> power spectrum -> log-mel.

Counterpart of ``semi_supervised_asr_tpu/ops/frontend.py``.  Framing and
the DFT are plain tensor code (as in JAX, they stay outside the fused
kernel); the post-FFT chain has an unfused version here and the fused CUDA
kernel in ``fused_frontend.py``.  Everything is float32; the matmul DFT
must run at full float32 precision (call ``strict_fp32()`` on the card).
SpecAugment's band parameters are drawn here from a ``torch.Generator``
(same distributions as the JAX package's ``jax.random`` draws, other bits)
and applied by the fused kernel or by :func:`apply_specaug_masks`.  The
training augmentations around the kernel -- speed perturbation and
additive noise on the waveform, time warp on the features -- are split
the same way into a draw and an apply, and stay plain tensor code, as the
reference computes them outside any Pallas kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn

from semi_supervised_asr_tpu_torch.config import FrontendConfig
from semi_supervised_asr_tpu_torch.ops import frontend_oracle as oracle


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


# ---------------------------------------------------------------------------
# SpecAugment (Park et al. 2019, arXiv:1904.08779): band parameters and masks
# ---------------------------------------------------------------------------

def _rows(rows: tuple[int, int, int] | None, batch: int
          ) -> tuple[int, int, int]:
    """``rows=(r0, r1, n)``, checked to hold ``batch`` rows, or the whole
    batch's."""
    r0, r1, n = rows if rows is not None else (0, batch, batch)
    if r1 - r0 != batch:
        raise ValueError(f"rows {rows} do not hold a batch of {batch}")
    return r0, r1, n


def sample_specaug_params(
    gen: torch.Generator,
    batch: int,
    n_mels: int,
    feat_lens: torch.Tensor,
    cfg: FrontendConfig,
    rows: tuple[int, int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw the mask bands -> (fstarts [B,mF], fwidths [B,mF], tstarts
    [B,mT], twidths [B,mT]), int32 on ``feat_lens``'s device.

    Frequency masks: width U{0..min(F, M)}, start U[0, max(M - w, 1)).
    Time masks: width U[0, cap + 1) with cap = min(T_param, int(p * len)),
    start U[0, max(len - w, 1)): confined to the valid frames.  The
    uniforms come from ``gen`` (a CPU generator, so the draws do not depend
    on the device) and move to the device without a host sync.
    ``rows=(r0, r1, n)``: the batch is rows [r0, r1) of a global batch of
    n (a data-parallel rank's); the uniforms are drawn for all n rows and
    rows [r0, r1) kept, so that the ranks together draw what one process
    draws for the whole batch and every rank's ``gen`` moves alike.
    """
    m, dev = n_mels, feat_lens.device
    r0, r1, b = _rows(rows, batch)
    nf, nt = cfg.n_freq_masks, cfg.n_time_masks
    fw = torch.randint(0, min(cfg.freq_mask_param, m) + 1, (b, nf),
                       generator=gen)[r0:r1].to(dev)
    u_fs, u_tw, u_ts = (torch.rand(shape, generator=gen)[r0:r1].to(dev)
                        for shape in ((b, nf), (b, nt), (b, nt)))
    fs = (u_fs * torch.clamp_min(m - fw, 1)).to(torch.int32)
    lens_f = feat_lens.to(torch.float32)
    cap = torch.clamp_max((cfg.time_mask_max_ratio * lens_f).to(torch.int32),
                          cfg.time_mask_param)
    tw = (u_tw * (cap[:, None].float() + 1.0)).to(torch.int32)
    ts = (u_ts * torch.clamp_min(feat_lens[:, None] - tw, 1).float()
          ).to(torch.int32)
    return fs, fw.to(torch.int32), ts, tw


def _band_mask(pos: torch.Tensor, starts: torch.Tensor,
              widths: torch.Tensor) -> torch.Tensor:
    """[B, n] bands over positions [P] -> [B, P] bool, True inside a band."""
    s, w = starts[..., None], widths[..., None]
    return ((pos >= s) & (pos < s + w)).any(dim=1)


def apply_specaug_masks(
    feats: torch.Tensor,
    fstarts: torch.Tensor,
    fwidths: torch.Tensor,
    tstarts: torch.Tensor,
    twidths: torch.Tensor,
) -> torch.Tensor:
    """Zero the sampled frequency and time bands of [B, T, M] features."""
    _, t, m = feats.shape
    fmask = _band_mask(torch.arange(m, device=feats.device), fstarts, fwidths)
    tmask = _band_mask(torch.arange(t, device=feats.device), tstarts, twidths)
    drop = fmask[:, None, :] | tmask[:, :, None]
    return torch.where(drop, torch.zeros((), device=feats.device), feats)


# ---------------------------------------------------------------------------
# Waveform and feature augmentation: speed perturbation, additive noise,
# time warp.  Each is a draw (the per-row uniforms from a CPU generator, a
# large tensor from the device's) and an apply that takes the draws, so
# that a test can hand in the JAX package's.  ``rows=(r0, r1, n)`` draws
# for a global batch of n rows and keeps rows [r0, r1), as
# :func:`sample_specaug_params` does.
# ---------------------------------------------------------------------------

def sample_speed_index(gen: torch.Generator, batch: int, n_factors: int,
                       device, rows: tuple[int, int, int] | None = None
                       ) -> torch.Tensor:
    """The index of each row's speed factor, uniform over ``n_factors``
    -> [B] int64 on ``device``."""
    r0, r1, n = _rows(rows, batch)
    return torch.randint(0, n_factors, (n,), generator=gen)[r0:r1].to(device)


def apply_speed_perturb(
    audio: torch.Tensor,         # [B, S] float32, pads exactly 0
    sample_lens: torch.Tensor,   # [B]
    factors: tuple[float, ...],
    index: torch.Tensor,         # [B] factor index
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speed perturbation (Ko et al. 2015) by ``factors[index]`` per row,
    linear interpolation over the [B, S] buffer -> (audio, new lengths).
    A slow factor is raised to fit the buffer (``lens / S``); a factor of
    exactly 1.0 leaves the row's samples unchanged, and positions at or
    beyond the new length are exactly 0."""
    if not factors or any(f <= 0.0 for f in factors):
        raise ValueError(f"speed_perturb factors must be positive, "
                         f"got {factors!r}")
    b, s_cap = audio.shape
    dev = audio.device
    s = torch.tensor(factors, dtype=torch.float32, device=dev)[index]
    lens_f = sample_lens.float()
    s = torch.maximum(s, lens_f / s_cap)       # fit the bucket's buffer
    new_lens = torch.clamp_max(
        torch.floor(lens_f / torch.clamp_min(s, 1e-6)).to(sample_lens.dtype),
        s_cap)
    pos = torch.arange(s_cap, dtype=torch.float32, device=dev)[None, :] \
        * s[:, None]
    last = torch.clamp_min(sample_lens - 1, 0)[:, None].long()
    lo = torch.minimum(torch.clamp_min(torch.floor(pos).long(), 0), last)
    hi = torch.minimum(lo + 1, last)
    frac = torch.clamp(pos - lo.float(), 0.0, 1.0)
    out = (torch.gather(audio, 1, lo) * (1.0 - frac)
           + torch.gather(audio, 1, hi) * frac)
    valid = torch.arange(s_cap, device=dev)[None, :] < new_lens[:, None]
    return torch.where(valid, out, 0.0), new_lens


NoiseDraws = tuple  # (u_apply [B], u_snr [B], source [B] | None,
#                      white [B, S] | None)


def sample_noise_params(
    gen: torch.Generator,
    dgen: torch.Generator,
    shape: tuple[int, int],
    sources: tuple[str, ...],
    device,
    rows: tuple[int, int, int] | None = None,
) -> NoiseDraws:
    """The draws of :func:`apply_noise` for a [B, S] batch: per row the
    uniforms of the mix decision and of the SNR and, with two sources, the
    source index (from ``gen``); unit Gaussian noise [B, S] from ``dgen``
    (on ``device``) where a white source can be taken (babble in a batch
    of one row falls back to it)."""
    b, s_len = shape
    r0, r1, n = _rows(rows, b)
    u_apply, u_snr = (torch.rand((n,), generator=gen)[r0:r1].to(device)
                      for _ in range(2))
    src = None
    if len(sources) > 1:
        src = torch.randint(0, len(sources), (n,),
                            generator=gen)[r0:r1].to(device)
    white = None
    if "white" in sources or n == 1:
        white = torch.randn((n, s_len), generator=dgen,
                            device=device)[r0:r1]
    return u_apply, u_snr, src, white


def apply_noise(
    audio: torch.Tensor,         # [B, S] float32, pads exactly 0
    sample_lens: torch.Tensor,   # [B]
    prob: float,
    snr_db: tuple[float, float],
    sources: tuple[str, ...],
    draws: NoiseDraws,
    pool: torch.Tensor | None = None,
    row0: int = 0,
) -> torch.Tensor:
    """Additive noise at an exactly realized SNR, per row: mixed with
    probability ``prob``, the SNR uniform in ``snr_db``, the source
    uniform over ``sources``: ``white`` (unit Gaussian) or ``babble``
    (the mean of the rows 1, 2 and 3 before it in the batch, cyclically;
    white when the batch has one row).  ``pool`` is the whole batch that
    babble draws on when ``audio`` is its rows ``row0 ...`` (a
    data-parallel rank's; default ``audio`` itself).  The gain comes from
    the row's signal and noise power over its valid samples; rows where
    either is zero pass unchanged, as do pads (exactly 0) and lengths."""
    if not 0.0 <= prob <= 1.0:
        raise ValueError(f"noise_aug_prob must be in [0, 1], got {prob}")
    if snr_db[1] < snr_db[0]:
        raise ValueError(f"noise_snr_db must be (lo, hi) with lo <= hi, "
                         f"got {snr_db!r}")
    if not sources or set(sources) - {"white", "babble"}:
        raise ValueError(f"noise_sources must be a non-empty subset of "
                         f"{{'white', 'babble'}}, got {sources!r}")
    u_apply, u_snr, src, white = draws
    b, s_cap = audio.shape
    full = audio if pool is None else pool
    n = full.shape[0]
    valid = (torch.arange(s_cap, device=audio.device)[None, :]
             < sample_lens[:, None]).to(audio.dtype)

    def babble():
        shifts = [s for s in (1, 2, 3) if s < n]
        if not shifts:                 # a batch of one row
            return white
        mine = torch.arange(row0, row0 + b, device=audio.device)
        # rows of roll(full, s, axis 0), in the reference's summation order
        return sum(full[(mine - s) % n] for s in shifts) / len(shifts)

    cands = {"white": lambda: white, "babble": babble}
    noise = cands[sources[0]]()
    if len(sources) > 1:
        noise = torch.where((src == 1)[:, None], cands[sources[1]](), noise)
    denom = torch.clamp_min(sample_lens, 1).to(audio.dtype)
    p_sig = torch.sum(audio.square() * valid, dim=1) / denom
    p_noise = torch.sum(noise.square() * valid, dim=1) / denom
    lo_db, hi_db = snr_db
    snr = lo_db + u_snr * (hi_db - lo_db)
    ok = (p_sig > 0.0) & (p_noise > 0.0)
    gain = torch.sqrt(torch.where(ok, p_sig, 1.0)
                      / (torch.where(ok, p_noise, 1.0)
                         * torch.pow(10.0, snr / 10.0)))
    mix = (u_apply < prob) & ok
    scale = torch.where(mix, gain, 0.0)[:, None]
    return audio + scale * noise * valid


def sample_time_warp(gen: torch.Generator, feat_lens: torch.Tensor, W: int,
                     rows: tuple[int, int, int] | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """SpecAugment's warp draws -> (w, d) float32 [B] on ``feat_lens``'s
    device: the warped point w uniform in [W, L - W), its displacement d
    uniform in [-W, W], rounded half to even."""
    r0, r1, n = _rows(rows, feat_lens.shape[0])
    dev = feat_lens.device
    u_w, u_d = (torch.rand((n,), generator=gen)[r0:r1].to(dev)
                for _ in range(2))
    lens_f = feat_lens.float()
    w = torch.floor(W + u_w * torch.clamp_min(lens_f - 2 * W, 1.0))
    d = torch.round(u_d * (2 * W) - W)
    return w, d


def apply_time_warp(feats: torch.Tensor, feat_lens: torch.Tensor, W: int,
                    w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """SpecAugment time warping (Park et al. 2019): frame w moves to w + d
    and the valid region is resampled piecewise linearly around it, with
    linear interpolation between frames (endpoints fixed).  Rows of
    2W + 1 frames or fewer, and pads, pass unchanged."""
    _, t, m = feats.shape
    lens_f = feat_lens.float()
    ok = feat_lens > 2 * W + 1
    bnd = torch.minimum(torch.clamp_min(w + d, 1.0),
                        torch.clamp_min(lens_f - 2.0, 1.0))
    tpos = torch.arange(t, dtype=torch.float32, device=feats.device)[None, :]
    wb, lb, bb = w[:, None], lens_f[:, None], bnd[:, None]
    src = torch.where(
        tpos < bb, tpos * (wb / bb),
        wb + (tpos - bb) * ((lb - 1.0 - wb)
                            / torch.clamp_min(lb - 1.0 - bb, 1.0)))
    src = torch.minimum(torch.clamp_min(src, 0.0),
                        torch.clamp_min(lb - 1.0, 0.0))
    lo = torch.floor(src).long()
    hi = torch.minimum(lo + 1,
                       torch.clamp_min(feat_lens - 1, 0)[:, None].long())
    frac = (src - lo.float())[..., None]
    g = (torch.gather(feats, 1, lo[..., None].expand(-1, -1, m))
         * (1.0 - frac)
         + torch.gather(feats, 1, hi[..., None].expand(-1, -1, m)) * frac)
    valid = (tpos < lb) & ok[:, None]
    return torch.where(valid[..., None], g, feats)
