"""Masked LSTM forward scan: kernel K2 (``csrc/lstm_scan_fwd.cu``).

Counterpart of the forward half of ``semi_supervised_asr_tpu/ops/
pallas_lstm.py``: ``lstm_scan`` takes input projections already computed
for all steps (one large product outside the kernel, as in JAX) and runs
the serial recurrence of D independent directions in one launch.
``lstm_kernel`` / ``bilstm_kernel`` are the drop-ins for ``lstm_pallas`` /
``bilstm_pallas`` and for the reference's plain ``recurrent.lstm`` /
``bilstm`` (both directions of a BiLSTM share the launch here, which is
also what ``fuse_bilstm`` asks for).

Padded steps pass the (h, c) carry through and emit zeros, so the reverse
direction over a right-padded batch starts at each row's last valid frame.

``lstm_scan_reference`` is the same math in plain PyTorch.  The wrappers
run it only for CPU tensors or when asked with ``backend="reference"``; a
CUDA tensor otherwise launches the kernel or raises.  There is no
backward yet: the wrapper refuses inputs that require grad.
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
    """
    if torch.is_grad_enabled() and (gates_x.requires_grad
                                    or w_hh.requires_grad):
        raise RuntimeError(
            "lstm_scan has no backward yet: run it under torch.no_grad() "
            "or torch.inference_mode()"
        )
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
