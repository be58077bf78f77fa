"""Fused post-FFT frontend: kernel K1 (``csrc/fused_post_fft.cu``).

Counterpart of ``semi_supervised_asr_tpu/ops/pallas_frontend.py``.  The
chain after the power spectrum -- mel product, log floor, global CMVN,
pad-frame zeroing and the SpecAugment band masks -- is one CUDA kernel
that reads the [B, T, F] power spectrum once and writes the [B, T, M]
features once.  Framing and the DFT stay outside (``frontend.py``).  The
kernel takes the mel bank packed by filter (each triangular filter's run
of non-zero bins), which skips only exact-zero terms of the product.  It
streams tiles of rows of the flattened [B*T, F] spectrum by bulk copies,
so ``pspec`` must be contiguous and 16-byte aligned (:func:`tile_spans`
is its tiling).

``fused_post_fft_reference`` is the same math in plain PyTorch.  The
wrapper calls the custom op ``ssasr_torch::fused_post_fft``
(``ops/library.py``), whose CUDA implementation launches the kernel
(:func:`launch_post_fft`) or raises and whose CPU implementation is the
plain version; ``backend="reference"`` runs the plain version on any
device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from semi_supervised_asr_tpu_torch.config import FrontendConfig
from semi_supervised_asr_tpu_torch import _native
from semi_supervised_asr_tpu_torch.ops import frontend as F
from semi_supervised_asr_tpu_torch.ops import library as LIB

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
    return post_fft_plain(pspec, feat_lens, fb, cmvn_mean, cmvn_inv_std,
                          cfg.log_floor, specaug)


def post_fft_plain(pspec: torch.Tensor, feat_lens: torch.Tensor,
                   fb: torch.Tensor, cmvn_mean: torch.Tensor,
                   cmvn_inv_std: torch.Tensor, log_floor: float,
                   specaug: SpecAug | None = None) -> torch.Tensor:
    """:func:`fused_post_fft_reference` given the dense mel bank ``fb`` [F,
    M] and the log floor (the custom op's CPU implementation)."""
    mel = torch.matmul(pspec.float(), fb)
    x = (torch.log(torch.clamp_min(mel, log_floor))
         - cmvn_mean.float()) * cmvn_inv_std.float()
    keep = F.frame_mask(feat_lens, x.shape[1])[:, :, None]
    x = torch.where(keep, x, torch.zeros((), device=x.device))
    if specaug is not None:
        x = F.apply_specaug_masks(x, *specaug)
    return x


# the kernel's launch plan: rows per tile, row groups (a thread owns one
# filter in rows/groups rows of a tile), stages in its ring of bulk
# copies, blocks per SM in its persistent grid (chip_smoke.py phase 5
# sweeps the alternatives on the card)
PLAN = (16, 4, 2, 2)


def tile_spans(n_rows: int, n_freq: int, rows: int) -> list[tuple]:
    """The kernel's tiles of ``rows`` (a multiple of 4) rows over
    ``n_rows`` rows of ``n_freq`` floats: (first row, rows, bulk-copied
    bytes, floats loaded one by one) each.  A tile starts on a multiple of
    16 bytes (4 rows are 16 * n_freq); only the last may end off one, and
    loads its tail plainly."""
    out = []
    for row0 in range(0, n_rows, rows):
        n = min(rows, n_rows - row0)
        bulk = n * n_freq * 4 // 16 * 16
        out.append((row0, n, bulk, n * n_freq - bulk // 4))
    return out


def require_aligned(name: str, x: torch.Tensor) -> None:
    """Raise unless ``x`` is contiguous and starts on 16 bytes, as the
    kernel's bulk copies need (no copy is made)."""
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(
            f"{name}: the fused frontend kernel needs a contiguous tensor "
            f"that starts on 16 bytes (storage offset {x.storage_offset()}, "
            f"contiguous {x.is_contiguous()})")


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
    _native.use_kernel(pspec, backend)      # refuses a bad backend or device
    if backend == "reference":
        return fused_post_fft_reference(pspec, feat_lens, cfg, cmvn_mean,
                                        cmvn_inv_std, specaug)
    if pspec.shape[-1] != cfg.n_fft // 2 + 1:
        raise ValueError(f"pspec has {pspec.shape[-1]} bins, the mel bank "
                         f"{cfg.n_fft // 2 + 1}")
    dev = str(pspec.device)
    _, fb = F.constants(cfg, dev)
    bands = (None,) * 4 if specaug is None else specaug
    return LIB.fused_post_fft(pspec, feat_lens, *_mel_runs_on(cfg, dev), fb,
                              cmvn_mean, cmvn_inv_std, *bands,
                              float(cfg.log_floor))


def launch_post_fft(pspec: torch.Tensor, feat_lens: torch.Tensor,
                    band_w: torch.Tensor, band_lo: torch.Tensor,
                    band_off: torch.Tensor, cmvn_mean: torch.Tensor,
                    cmvn_inv_std: torch.Tensor, specaug: SpecAug | None,
                    log_floor: float) -> torch.Tensor:
    """K1's launch on CUDA tensors (the custom op's CUDA implementation):
    the mel bank packed by filter (:func:`_mel_runs_np`) -> [B, T, M]."""
    b, t, f = pspec.shape
    m = band_lo.shape[0]
    dev = pspec.device
    _check("pspec", pspec, torch.float32, (b, t, f), dev)
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
    if m % 4 or m > 128:
        raise ValueError(f"the fused frontend kernel takes n_mels a multiple "
                         f"of 4 up to 128, got {m}")
    require_aligned("pspec", pspec)
    out = torch.empty((b, t, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    code = _native.lib().fused_post_fft(
        pspec.data_ptr(), band_w.data_ptr(), band_lo.data_ptr(),
        band_off.data_ptr(), band_w.numel(), mean.data_ptr(),
        istd.data_ptr(), lens.data_ptr(), *(_native.ptr(x) for x in bands),
        n_f, n_t,
        out.data_ptr(), b, t, f, m, float(log_floor), *PLAN,
        _native.stream_ptr(dev),
    )
    _native.check("fused_post_fft", code)
    _native.count("fused_post_fft")
    return out
