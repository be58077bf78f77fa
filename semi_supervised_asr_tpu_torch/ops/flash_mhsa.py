"""Masked multi-head self-attention: kernel K5, forward
(``csrc/flash_mhsa_fwd.cu``) and backward (``csrc/flash_mhsa_bwd.cu``).

Counterpart of ``semi_supervised_asr_tpu/ops/flash_mhsa.py``, which calls
jax's Pallas TPU flash attention for the transformer and conformer
listeners under ``model.attn_backend: flash``.  The public layout is the
JAX one, ``[B, T, H, D]``; the kernels read each head through its stride,
so nothing is transposed or padded (the TPU kernel's 128-row quantum is
its own constraint: the CUDA kernels mask their ragged tails).

* :func:`mhsa_reference` is the plain version, op for op the JAX
  ``mhsa_reference``: scores in the compute dtype, scaled in float32, pad
  keys replaced by -1e9, a float32 softmax cast to the compute dtype, then
  the context product.
* :func:`mhsa` is the wrapper: it casts q, k and v to the compute dtype,
  runs the plain version for CPU tensors (or ``backend="reference"``) and
  the kernels for CUDA tensors, through :class:`_FlashMHSA` when a
  gradient is wanted (forward kernel, then the backward kernel's two
  launches).

The kernels compute the plain version on every row.  The TPU kernel lets a
pad query attend pad keys (its segment ids); the listeners zero pad rows,
so this differs from the TPU only where nothing reads.  A row with no
valid key gets uniform weights over all T keys and, in the backward, dq =
0: a replaced score has no gradient.  Numerics follow the TPU kernel: f32
scores, f32 online softmax, the weights rounded to the compute dtype before
their product with v, f32 accumulators.  In float32 the kernels differ
from the plain version by summation order only; in bfloat16 also by the
plain version's rounding of the scores to bf16 (as XLA's einsum does).
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch import _native

MASKED = -1e9     # the score a pad key gets (replaced, not added)


def mhsa_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_mask: torch.Tensor, *, sm_scale: float, compute: torch.dtype,
) -> torch.Tensor:
    """[B, T, H, D] q, k, v and a [B, T] bool key mask -> [B, T, H, D] in
    ``compute``: the einsum path (scores, masked, float32 softmax, context).
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(compute),
                          k.to(compute)).float() * sm_scale
    scores = scores.masked_fill(~key_mask[:, None, None, :], MASKED)
    alpha = torch.softmax(scores, dim=-1).to(compute)
    return torch.einsum("bhqk,bkhd->bqhd", alpha, v.to(compute))


def _check(q, k, v, key_mask) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mhsa kernel: compute dtype {q.dtype} unsupported "
                         "(float32 or bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"mhsa: q must be [B, T, H, D], got "
                         f"{tuple(q.shape)}")
    b, t, _, d = q.shape
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"mhsa kernel: head dim {d} unsupported (a "
                         "multiple of 8 from 8 to 128)")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"mhsa: {name} {x.dtype} {tuple(x.shape)} on "
                             f"{x.device} does not match q {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}")
    if (key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, t)
            or key_mask.device != q.device):
        raise ValueError(f"mhsa: key_mask must be bool {(b, t)} on "
                         f"{q.device}, got {key_mask.dtype} "
                         f"{tuple(key_mask.shape)} on {key_mask.device}")


def mhsa_fwd(q, k, v, key_mask, sm_scale: float):
    """The forward kernel -> (o [B, T, H, D], row max m, row sum l [B, H,
    T] float32).  q, k, v in one compute dtype, on the card."""
    _check(q, k, v, key_mask)
    b, t, h, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = key_mask.to(torch.uint8).contiguous()
    o = torch.empty_like(q)
    m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    code = _native.lib().flash_mhsa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), b, t, h, d,
        float(sm_scale), int(q.dtype == torch.bfloat16),
        _native.stream_ptr(q.device))
    _native.check("flash_mhsa_fwd", code)
    _native.count("flash_mhsa_fwd")
    return o, m, l


def mhsa_bwd(q, k, v, key_mask, o, m, l, dout, sm_scale: float):
    """The backward kernel -> (dq, dk, dv), each [B, T, H, D] in the
    compute dtype, from the forward's inputs, output and statistics."""
    _check(q, k, v, key_mask)
    b, t, h, d = q.shape
    for name, x, dtype, shape in (("o", o, q.dtype, q.shape),
                                  ("dout", dout, dout.dtype, q.shape),
                                  ("m", m, torch.float32, (b, h, t)),
                                  ("l", l, torch.float32, (b, h, t))):
        if (x.dtype != dtype or tuple(x.shape) != tuple(shape)
                or x.device != q.device):
            raise ValueError(f"mhsa_bwd: {name} must be {dtype} "
                             f"{tuple(shape)} on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    o = o.contiguous()
    dout = dout.to(q.dtype).contiguous()
    mask = key_mask.to(torch.uint8).contiguous()
    delta = torch.empty_like(m)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    code = _native.lib().flash_mhsa_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        o.data_ptr(), dout.data_ptr(), m.data_ptr(), l.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, h, d, float(sm_scale), int(q.dtype == torch.bfloat16),
        _native.stream_ptr(q.device))
    _native.check("flash_mhsa_bwd", code)
    _native.count("flash_mhsa_bwd")
    return dq, dk, dv


class _FlashMHSA(torch.autograd.Function):
    """K5: the forward kernel, whose statistics feed the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, sm_scale):
        o, m, l = mhsa_fwd(q, k, v, key_mask, sm_scale)
        ctx.save_for_backward(q.contiguous(), k.contiguous(), v.contiguous(),
                              key_mask, o, m, l)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, o, m, l = ctx.saved_tensors
        dq, dk, dv = mhsa_bwd(q, k, v, key_mask, o, m, l, dout, ctx.sm_scale)
        return dq, dk, dv, None, None


def mhsa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_mask: torch.Tensor, *, sm_scale: float, compute: torch.dtype,
    backend: str | None = None,
) -> torch.Tensor:
    """Masked MHSA -> [B, T, H, D] in ``compute``.

    q, k, v: [B, T, H, D] in any float dtype (cast to ``compute``; autograd
    carries the cast); key_mask: [B, T] bool, True on valid frames;
    sm_scale: the softmax scale (the listeners pass 1/sqrt(D)).
    Differentiable in q, k and v on both routes.
    """
    q, k, v = q.to(compute), k.to(compute), v.to(compute)
    if not _native.use_kernel(q, backend):
        return mhsa_reference(q, k, v, key_mask, sm_scale=sm_scale,
                              compute=compute)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashMHSA.apply(q, k, v, key_mask, float(sm_scale))
    return mhsa_fwd(q, k, v, key_mask, sm_scale)[0]
