"""LSTM primitives in plain PyTorch: cell step, projections, masks, fold.

Counterpart of ``semi_supervised_asr_tpu/ops/recurrent.py``, keeping its
layout at every public function: ``w_ih`` [I, 4H], ``w_hh`` [H, 4H], one
bias ``b`` [4H], gates packed i, f, g, o.  (``nn.LSTM`` stores the
transpose with two biases; that layout never appears here.)

Numerics follow the reference: products take operands rounded to
``compute_dtype`` and multiply and sum in float32 (JAX's
``preferred_element_type=float32``); a bf16 x bf16 product is exact in
float32.  Gate math and the (h, c) carry stay float32.

The masked scans (the reference's ``lstm`` / ``bilstm``) live beside
their CUDA kernel in ``lstm_scan.py``: ``lstm_kernel`` / ``bilstm_kernel``
on CPU tensors run the scan's plain version, the one plain recurrence of
the package.
"""

from __future__ import annotations

import torch


def dtype_of(name: str | torch.dtype) -> torch.dtype:
    """'bfloat16' / 'float32' (config strings) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def mm(a: torch.Tensor, w: torch.Tensor, compute: torch.dtype) -> torch.Tensor:
    """a @ w with both operands rounded to ``compute``, product in float32."""
    return torch.matmul(a.to(compute).float(), w.to(compute).float())


def project(params: dict, x: torch.Tensor, compute: torch.dtype) -> torch.Tensor:
    """Input projection x . w_ih + b -> float32 [..., 4H]."""
    return mm(x, params["w_ih"], compute) + params["b"].float()


def lstm_cell_step(
    h: torch.Tensor, c: torch.Tensor, gates_x: torch.Tensor,
    w_hh: torch.Tensor, compute: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One step: float32 (h, c) [B, H], gates_x [B, 4H] -> (h', c')."""
    gates = gates_x + mm(h, w_hh, compute)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_single_step(
    params: dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    compute: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step with its input projection (decoder cells)."""
    return lstm_cell_step(h, c, project(params, x, compute), params["w_hh"],
                          compute)


def valid_mask(lengths: torch.Tensor | None, b: int, t: int,
               device) -> torch.Tensor:
    """[T, B] float 0/1 valid-step mask (all ones when lengths is None)."""
    if lengths is None:
        return torch.ones((t, b), dtype=torch.float32, device=device)
    steps = torch.arange(t, device=device)[:, None]
    return (steps < lengths.to(device)[None, :]).float()


def pyramid_fold(
    x: torch.Tensor, lengths: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """LAS pyramid reduction: [B, T, H] -> [B, T//2, 2H], lens -> ceil/2."""
    b, t, h = x.shape
    if t % 2:
        raise ValueError(f"pyramid_fold needs even T, got {t}")
    folded = x.reshape(b, t // 2, 2 * h)
    if lengths is None:
        return folded, None
    return folded, torch.div(lengths + 1, 2, rounding_mode="floor")
