"""Masked LSTM scan: kernels K2 (``csrc/lstm_scan_fwd.cu``) and K3
(``csrc/lstm_scan_bwd.cu``).

Counterpart of ``semi_supervised_asr_tpu/ops/pallas_lstm.py``:
``lstm_scan`` takes input projections already computed for all steps (one
large product outside the kernel, as in JAX) and runs the serial
recurrence of D independent directions in one launch.  When its inputs
require grad it runs as an ``autograd.Function`` (the counterpart of
``lstm_scan_pallas``'s custom VJP): the forward keeps K2's residuals, the
backward runs K3 for the gate gradients and takes ``dW_hh = sum_t,b
hprev^T dgates`` as one float32 product outside the kernel.
``lstm_kernel`` / ``bilstm_kernel`` are the drop-ins for ``lstm_pallas`` /
``bilstm_pallas`` and for the reference's plain ``recurrent.lstm`` /
``bilstm`` (both directions of a BiLSTM share the launch here, which is
also what ``fuse_bilstm`` asks for).

Padded steps pass the (h, c) carry through and emit zeros, so the reverse
direction over a right-padded batch starts at each row's last valid frame.

``lstm_scan_reference`` / ``lstm_scan_bwd_reference`` are the same math in
plain PyTorch.  The wrappers run them only for CPU tensors or when asked
with ``backend="reference"``; a CUDA tensor otherwise launches the kernel
or raises.  Residuals and gate gradients are indexed in real time order
for every direction (the JAX kernels index a reverse direction's in
flipped order).
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch import _native
from semi_supervised_asr_tpu_torch.ops import recurrent as R


def lstm_scan_reference(
    gates_x: torch.Tensor,          # [D, T, B, 4H] float32
    w_hh: torch.Tensor,             # [D, H, 4H]
    valid: torch.Tensor,            # [T, B] float 0/1
    compute: torch.dtype,
    reverse: tuple[bool, ...],
    residuals: bool = False,
):
    """Plain version of the scan -> h_out [D, T, B, H] float32, plus
    (hprev, cprev, acts) when ``residuals``, all at the time index of the
    step that produced them (reverse directions included)."""
    d, t, b, h4 = gates_x.shape
    hidden = h4 // 4

    def flip(x, i):          # reverse directions walk time backward
        return x.flip(0) if reverse[i] else x

    gx = torch.stack([flip(gates_x[i].float(), i) for i in range(d)], dim=1)
    v = torch.stack([flip(valid.float(), i) for i in range(d)], dim=1)
    v = v[..., None]                                     # [T, D, B, 1]
    w = w_hh.to(compute).float()                         # [D, H, 4H]
    h = torch.zeros((d, b, hidden), dtype=torch.float32, device=gates_x.device)
    c = torch.zeros_like(h)
    outs, hps, cps, acts = [], [], [], []
    for s in range(t):
        gates = gx[s] + torch.bmm(h.to(compute).float(), w)
        i_, f_, g_, o_ = gates.chunk(4, dim=-1)
        i_, f_, o_ = torch.sigmoid(i_), torch.sigmoid(f_), torch.sigmoid(o_)
        g_ = torch.tanh(g_)
        c_new = f_ * c + i_ * g_
        h_new = o_ * torch.tanh(c_new)
        if residuals:
            hps.append(h)
            cps.append(c)
            acts.append(torch.cat([i_, f_, g_, o_], dim=-1))
        outs.append(v[s] * h_new)
        h = v[s] * h_new + (1.0 - v[s]) * h
        c = v[s] * c_new + (1.0 - v[s]) * c

    def unstack(xs):         # [T][D, B, X] -> [D, T, B, X] in real time
        y = torch.stack(xs, dim=1)
        return torch.stack([flip(y[i], i) for i in range(d)])

    if not residuals:
        return unstack(outs)
    return unstack(outs), unstack(hps), unstack(cps), unstack(acts)


def lstm_scan(
    gates_x: torch.Tensor,
    w_hh: torch.Tensor,
    valid: torch.Tensor,
    compute: torch.dtype,
    reverse: tuple[bool, ...],
    residuals: bool = False,
    backend: str | None = None,
):
    """[D, T, B, 4H] projected gates + [D, H, 4H] w_hh + [T, B] valid ->
    masked hidden states [D, T, B, H] (float32), in real time order for
    every direction.  ``reverse[d]`` walks direction d from T-1 down to 0.
    ``residuals`` also returns (hprev, cprev, acts) for a backward pass.
    Differentiable in ``gates_x`` and ``w_hh`` (through K3) when
    ``residuals`` is off.
    """
    if torch.is_grad_enabled() and (gates_x.requires_grad
                                    or w_hh.requires_grad):
        if residuals:
            raise ValueError("lstm_scan: residuals are for a backward pass "
                             "of its own; ask for them without autograd")
        return _LSTMScan.apply(gates_x, w_hh, valid, compute, tuple(reverse),
                               backend)
    d, t, b, h4 = gates_x.shape
    if len(reverse) != d:
        raise ValueError(f"reverse has {len(reverse)} entries for D={d}")
    if not _native.use_kernel(gates_x, backend):
        return lstm_scan_reference(gates_x, w_hh, valid, compute, reverse,
                                   residuals)
    hidden = h4 // 4
    dev = gates_x.device
    if compute not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lstm_scan kernel: compute dtype {compute} "
                         "unsupported (float32 or bfloat16)")
    if h4 % 4 or (compute == torch.bfloat16 and hidden % 2):
        raise ValueError(f"lstm_scan kernel: bad gate width {h4} (needs 4H, "
                         "with H even in bfloat16)")
    if gates_x.dtype != torch.float32:
        raise ValueError(f"gates_x must be float32, got {gates_x.dtype}")
    if tuple(w_hh.shape) != (d, hidden, h4) or w_hh.device != dev:
        raise ValueError(f"w_hh: expected {(d, hidden, h4)} on {dev}, got "
                         f"{tuple(w_hh.shape)} on {w_hh.device}")
    if tuple(valid.shape) != (t, b) or valid.device != dev:
        raise ValueError(f"valid: expected {(t, b)} on {dev}, got "
                         f"{tuple(valid.shape)} on {valid.device}")
    gx = gates_x.contiguous()
    w = w_hh.to(compute).contiguous()
    v = valid.to(torch.float32).contiguous()
    h_out = torch.empty((d, t, b, hidden), dtype=torch.float32, device=dev)
    res = (None, None, None)
    if residuals:
        res = (torch.empty_like(h_out), torch.empty_like(h_out),
               torch.empty((d, t, b, h4), dtype=torch.float32, device=dev))
    mask = sum(1 << i for i, r in enumerate(reverse) if r)
    code = _native.lib().lstm_scan_fwd(
        gx.data_ptr(), w.data_ptr(), v.data_ptr(), h_out.data_ptr(),
        *(_native.ptr(x) for x in res), d, t, b, hidden, mask,
        int(compute == torch.bfloat16), _native.stream_ptr(dev),
    )
    _native.check("lstm_scan_fwd", code)
    _native.count("lstm_scan_fwd")
    return (h_out, *res) if residuals else h_out


def lstm_scan_bwd_reference(
    w_hh: torch.Tensor,             # [D, H, 4H]
    valid: torch.Tensor,            # [T, B] float 0/1
    acts: torch.Tensor,             # [D, T, B, 4H] float32
    cprev: torch.Tensor,            # [D, T, B, H] float32
    dh_out: torch.Tensor,           # [D, T, B, H] float32
    compute: torch.dtype,
    reverse: tuple[bool, ...],
) -> torch.Tensor:
    """Plain version of the backward scan -> dgates [D, T, B, 4H]
    float32: the gradient of the loss with respect to each step's gate
    pre-activations, given dh_out = dL/dh_out, in real time order."""
    d, t, b, h4 = acts.shape
    hidden = h4 // 4

    def walk(x, i):          # real time -> the forward's walk order
        return x.flip(0) if reverse[i] else x

    a = torch.stack([walk(acts[i].float(), i) for i in range(d)], dim=1)
    cp = torch.stack([walk(cprev[i].float(), i) for i in range(d)], dim=1)
    dho = torch.stack([walk(dh_out[i].float(), i) for i in range(d)], dim=1)
    v = torch.stack([walk(valid.float(), i) for i in range(d)], dim=1)
    v = v[..., None]                                     # [T, D, B, 1]
    wt = w_hh.to(compute).float().transpose(1, 2)        # [D, 4H, H]
    dh = torch.zeros((d, b, hidden), dtype=torch.float32, device=acts.device)
    dc = torch.zeros_like(dh)
    out = [None] * t
    for s in reversed(range(t)):
        i_, f_, g_, o_ = a[s].chunk(4, dim=-1)
        tanh_c = torch.tanh(f_ * cp[s] + i_ * g_)
        dh_new = v[s] * (dh + dho[s])
        dc_new = dh_new * o_ * (1.0 - tanh_c * tanh_c) + v[s] * dc
        dgates = torch.cat([dc_new * g_ * i_ * (1.0 - i_),
                            dc_new * cp[s] * f_ * (1.0 - f_),
                            dc_new * i_ * (1.0 - g_ * g_),
                            dh_new * tanh_c * o_ * (1.0 - o_)], dim=-1)
        out[s] = dgates
        dh = (1.0 - v[s]) * dh + torch.bmm(dgates.to(compute).float(), wt)
        dc = (1.0 - v[s]) * dc + dc_new * f_
    y = torch.stack(out, dim=1)                          # [D, T, B, 4H]
    return torch.stack([walk(y[i], i) for i in range(d)])


def lstm_scan_bwd(
    w_hh: torch.Tensor,
    valid: torch.Tensor,
    acts: torch.Tensor,
    cprev: torch.Tensor,
    dh_out: torch.Tensor,
    compute: torch.dtype,
    reverse: tuple[bool, ...],
    backend: str | None = None,
) -> torch.Tensor:
    """Backward scan on K3 -> dgates [D, T, B, 4H] float32 (see
    :func:`lstm_scan_bwd_reference` for the math).  Residuals as
    ``lstm_scan(..., residuals=True)`` returns them."""
    d, t, b, h4 = acts.shape
    if len(reverse) != d:
        raise ValueError(f"reverse has {len(reverse)} entries for D={d}")
    if not _native.use_kernel(acts, backend):
        return lstm_scan_bwd_reference(w_hh, valid, acts, cprev, dh_out,
                                       compute, reverse)
    hidden = h4 // 4
    dev = acts.device
    if compute not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lstm_scan_bwd kernel: compute dtype {compute} "
                         "unsupported (float32 or bfloat16)")
    vec = 8 if compute == torch.bfloat16 else 4
    if h4 % 4 or hidden % vec:
        raise ValueError(f"lstm_scan_bwd kernel: bad gate width {h4} (needs "
                         f"4H with H a multiple of {vec})")
    for name, x, shape in (("acts", acts, (d, t, b, h4)),
                           ("cprev", cprev, (d, t, b, hidden)),
                           ("dh_out", dh_out, (d, t, b, hidden))):
        if (x.dtype != torch.float32 or tuple(x.shape) != shape
                or x.device != dev):
            raise ValueError(f"{name}: expected float32 {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if tuple(w_hh.shape) != (d, hidden, h4) or w_hh.device != dev:
        raise ValueError(f"w_hh: expected {(d, hidden, h4)} on {dev}, got "
                         f"{tuple(w_hh.shape)} on {w_hh.device}")
    if tuple(valid.shape) != (t, b) or valid.device != dev:
        raise ValueError(f"valid: expected {(t, b)} on {dev}, got "
                         f"{tuple(valid.shape)} on {valid.device}")
    # [D, 4H, H]: the product's reduction then runs over rows (see the
    # kernel's source note)
    w_t = w_hh.to(compute).transpose(1, 2).contiguous()
    v = valid.to(torch.float32).contiguous()
    a, cp, dho = acts.contiguous(), cprev.contiguous(), dh_out.contiguous()
    dgates = torch.empty((d, t, b, h4), dtype=torch.float32, device=dev)
    mask = sum(1 << i for i, r in enumerate(reverse) if r)
    code = _native.lib().lstm_scan_bwd(
        w_t.data_ptr(), v.data_ptr(), a.data_ptr(), cp.data_ptr(),
        dho.data_ptr(), dgates.data_ptr(), d, t, b, hidden, mask,
        int(compute == torch.bfloat16), _native.stream_ptr(dev),
    )
    _native.check("lstm_scan_bwd", code)
    _native.count("lstm_scan_bwd")
    return dgates


class _LSTMScan(torch.autograd.Function):
    """The scan with K2 forward (residuals kept) and K3 backward."""

    @staticmethod
    def forward(ctx, gates_x, w_hh, valid, compute, reverse, backend):
        h_out, hprev, cprev, acts = lstm_scan(
            gates_x, w_hh, valid, compute, reverse, residuals=True,
            backend=backend)
        ctx.save_for_backward(w_hh, valid, hprev, cprev, acts)
        ctx.args = (compute, reverse, backend)
        return h_out

    @staticmethod
    def backward(ctx, dh_out):
        w_hh, valid, hprev, cprev, acts = ctx.saved_tensors
        compute, reverse, backend = ctx.args
        dgates = lstm_scan_bwd(w_hh, valid, acts, cprev, dh_out.float(),
                               compute, reverse, backend)
        # weight gradient: one float32 product per direction outside the
        # kernel (pallas_lstm.py's einsum at preferred_element_type=f32)
        dw = torch.einsum("dtbh,dtbg->dhg", hprev, dgates)
        return dgates, dw.to(w_hh.dtype), None, None, None, None


def lstm_kernel(
    params: dict,
    x: torch.Tensor,
    lengths: torch.Tensor | None = None,
    reverse: bool = False,
    compute: torch.dtype = torch.float32,
    backend: str | None = None,
) -> torch.Tensor:
    """Drop-in for ``recurrent.lstm`` on the scan kernel: [B, T, I] ->
    [B, T, H]."""
    b, t, _ = x.shape
    gx = R.project(params, x, compute).transpose(0, 1)[None]
    valid = R.valid_mask(lengths, b, t, x.device)
    ys = lstm_scan(gx, params["w_hh"][None], valid, compute, (reverse,),
                   backend=backend)
    return ys[0].transpose(0, 1)


def bilstm_kernel(
    params: dict,
    x: torch.Tensor,
    lengths: torch.Tensor | None = None,
    compute: torch.dtype = torch.float32,
    backend: str | None = None,
) -> torch.Tensor:
    """Drop-in for ``recurrent.bilstm``: both directions' input
    projections as one product, both recurrences in one launch ->
    [B, T, 2H] = concat(fwd, bwd)."""
    b, t, _ = x.shape
    fwd, bwd = params["fwd"], params["bwd"]
    hidden = fwd["w_hh"].shape[0]
    w_ih = torch.cat([fwd["w_ih"], bwd["w_ih"]], dim=1)          # [I, 8H]
    bias = torch.cat([fwd["b"], bwd["b"]])
    gx = R.mm(x, w_ih, compute) + bias.float()                   # [B, T, 8H]
    gx = gx.view(b, t, 2, 4 * hidden).permute(2, 1, 0, 3)        # [2, T, B, 4H]
    w_hh = torch.stack([fwd["w_hh"], bwd["w_hh"]])
    valid = R.valid_mask(lengths, b, t, x.device)
    ys = lstm_scan(gx, w_hh, valid, compute, (False, True), backend=backend)
    return ys.permute(2, 1, 0, 3).reshape(b, t, 2 * hidden)
