"""The hand-written forward kernels as ``torch.library`` custom ops.

Three ops in the namespace ``ssasr_torch``, one for each forward kernel on
the serving path, so that ``torch.export`` can trace a decode through them
(it traces with fake tensors: a ``ctypes`` launch, which reads
``data_ptr()``, cannot be traced) and an exported program launches them:

* ``ssasr_torch::fused_post_fft``: K1 (``csrc/fused_post_fft.cu``), the mel
  product, log, CMVN, length mask and SpecAugment bands;
* ``ssasr_torch::lstm_scan_fwd``: K2 (``csrc/lstm_scan_fwd.cu``), the
  masked LSTM scan of D directions, on the route ``lstm_scan.cluster_plan``
  picks from the shapes at run time; a grid route's exchange buffer and
  step counters are allocated and zeroed inside each call;
* ``ssasr_torch::flash_mhsa_fwd``: K5's forward (``csrc/flash_mhsa_fwd.cu``).

Each op has a fake implementation (the output shapes and dtypes), a CUDA
implementation (the kernel's ``ctypes`` launch, counted in
``_native.LAUNCHES``) and a CPU implementation (the kernel's plain
version).  It has no autograd formula: the training path's
``autograd.Function`` s call the op in their forward and launch the
backward kernels themselves.  The wrappers (``fused_frontend.fused_post_fft``,
``lstm_scan.lstm_scan``, ``flash_mhsa.mhsa``) call the ops; only
``backend="reference"`` calls a plain version directly, on any device.

Importing this module registers the ops: a process that loads an exported
program (``torch.export.load``) imports it first.  The launch code stays in
the kernels' modules, imported at the first call.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def _fresh(outs: list[Tensor], ins: tuple) -> list[Tensor]:
    """``outs`` with any tensor that shares storage with an input cloned (a
    custom op's outputs may not alias its inputs)."""
    held = {x.untyped_storage().data_ptr() for x in ins
            if isinstance(x, Tensor)}
    return [x.clone() if x.untyped_storage().data_ptr() in held else x
            for x in outs]


# ---- K1: the fused post-FFT frontend ----

@torch.library.custom_op("ssasr_torch::fused_post_fft", mutates_args=(),
                         device_types="cuda")
def fused_post_fft(pspec: Tensor, feat_lens: Tensor, band_w: Tensor,
                   band_lo: Tensor, band_off: Tensor, fb: Tensor,
                   mean: Tensor, inv_std: Tensor, fstarts: Optional[Tensor],
                   fwidths: Optional[Tensor], tstarts: Optional[Tensor],
                   twidths: Optional[Tensor], log_floor: float) -> Tensor:
    """[B, T, F] power spectrum -> [B, T, M] features.  The kernel reads
    the mel bank packed by filter (``band_*``), the plain version the dense
    bank ``fb`` [F, M]; the bands are all given or all None."""
    from semi_supervised_asr_tpu_torch.ops import fused_frontend as FF

    bands = (fstarts, fwidths, tstarts, twidths)
    return FF.launch_post_fft(pspec, feat_lens, band_w, band_lo, band_off,
                              mean, inv_std,
                              None if fstarts is None else bands, log_floor)


@fused_post_fft.register_kernel("cpu")
def _(pspec, feat_lens, band_w, band_lo, band_off, fb, mean, inv_std,
      fstarts, fwidths, tstarts, twidths, log_floor):
    from semi_supervised_asr_tpu_torch.ops import fused_frontend as FF

    bands = (fstarts, fwidths, tstarts, twidths)
    return FF.post_fft_plain(pspec, feat_lens, fb, mean, inv_std, log_floor,
                             None if fstarts is None else bands)


@fused_post_fft.register_fake
def _(pspec, feat_lens, band_w, band_lo, band_off, fb, mean, inv_std,
      fstarts, fwidths, tstarts, twidths, log_floor):
    b, t, _ = pspec.shape
    return pspec.new_empty((b, t, fb.shape[1]), dtype=torch.float32)


# ---- K2: the LSTM scan forward ----

@torch.library.custom_op("ssasr_torch::lstm_scan_fwd", mutates_args=(),
                         device_types="cuda")
def lstm_scan_fwd(gates_x: Tensor, w_hh: Tensor, valid: Tensor,
                  compute: torch.dtype, reverse_mask: int, residuals: bool,
                  h0: Optional[Tensor], c0: Optional[Tensor],
                  return_state: bool) -> list[Tensor]:
    """[D, T, B, 4H] gates_x, [D, H, 4H] w_hh, [T, B] valid -> [h_out [D,
    T, B, H]], then (hprev, cprev, acts) with ``residuals``, then the final
    (h, c) [D, B, H] with ``return_state``; direction d walks backward
    where bit d of ``reverse_mask`` is set."""
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    return K.launch_scan_fwd(gates_x, w_hh, valid, compute,
                             K.reverse_of(reverse_mask, gates_x.shape[0]),
                             residuals, h0, c0, return_state)


@lstm_scan_fwd.register_kernel("cpu")
def _(gates_x, w_hh, valid, compute, reverse_mask, residuals, h0, c0,
      return_state):
    from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

    out = K.lstm_scan_reference(
        gates_x, w_hh, valid, compute,
        K.reverse_of(reverse_mask, gates_x.shape[0]), residuals, h0, c0,
        return_state)
    if return_state:
        out, fin = out
    outs = list(out) if residuals else [out]
    if return_state:
        outs += list(fin)
    return _fresh(outs, (gates_x, w_hh, valid, h0, c0))


@lstm_scan_fwd.register_fake
def _(gates_x, w_hh, valid, compute, reverse_mask, residuals, h0, c0,
      return_state):
    d, t, b, h4 = gates_x.shape
    f32 = dict(dtype=torch.float32)
    outs = [gates_x.new_empty((d, t, b, h4 // 4), **f32)]
    if residuals:
        outs += [gates_x.new_empty((d, t, b, h4 // 4), **f32),
                 gates_x.new_empty((d, t, b, h4 // 4), **f32),
                 gates_x.new_empty((d, t, b, h4), **f32)]
    if return_state:
        outs += [gates_x.new_empty((d, b, h4 // 4), **f32) for _ in range(2)]
    return outs


# ---- K5: the flash attention forward ----

@torch.library.custom_op("ssasr_torch::flash_mhsa_fwd", mutates_args=(),
                         device_types="cuda")
def flash_mhsa_fwd(q: Tensor, k: Tensor, v: Tensor, key_mask: Tensor,
                   sm_scale: float) -> tuple[Tensor, Tensor, Tensor]:
    """[B, T, H, D] q, k, v in one compute dtype and a [B, T] bool key mask
    -> (o [B, T, H, D], each row's score max m and softmax sum l [B, H, T]
    float32)."""
    from semi_supervised_asr_tpu_torch.ops import flash_mhsa as FM

    return FM.mhsa_fwd(q, k, v, key_mask, sm_scale)


@flash_mhsa_fwd.register_kernel("cpu")
def _(q, k, v, key_mask, sm_scale):
    from semi_supervised_asr_tpu_torch.ops import flash_mhsa as FM

    return FM.mhsa_fwd_plain(q, k, v, key_mask, sm_scale)


@flash_mhsa_fwd.register_fake
def _(q, k, v, key_mask, sm_scale):
    b, t, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, t), dtype=torch.float32),
            q.new_empty((b, h, t), dtype=torch.float32))
