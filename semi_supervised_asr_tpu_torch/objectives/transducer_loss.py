"""The RNN-T (transducer) loss: -log P(labels | encoder) over every
blank / emit alignment (Graves 2012).

Counterpart of ``semi_supervised_asr_tpu/objectives/transducer_loss.py``:
``transducer_loss``, ``lattice_terms`` and ``transducer_loss_from_parts``,
with the reference's details: blank at PAD (0), ``NEG_INF`` = -1e30 for
log 0, emitting past the last label impossible, the mean over the real
rows.  The callers clamp the encoder lengths to at least 1.

The lattice recursion

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + emit[t, u-1])

runs, as in the reference, over the T+U anti-diagonals d = t + u of the
skewed layout (every cell of a diagonal at once, [B, U+1] a step).  It is
one ``torch.autograd.Function`` over the two V-free lattice terms: the
forward runs the alpha pass with no autograd graph and keeps the alphas;
the backward runs the beta pass (the log-probability of finishing from
each cell) the same way and forms each term's gradient elementwise,
-exp(alpha + term + beta_next - ll) times the upstream gradient of the
row's NLL.  Nothing in it gathers into a sum or scatters with atomics:
the skew and its inverse are plain gathers, the terminal cell is read
through one-hot masks, and ``lattice_terms`` selects the label log-probs
by a product with one-hot rows, so that a step's gradient has the same
bits on every run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

NEG_INF = -1e30


def transducer_loss(
    logits: torch.Tensor,       # [B, T, U+1, V] joint outputs (pre-softmax)
    enc_lens: torch.Tensor,     # [B] valid encoder frames T_b >= 1
    labels: torch.Tensor,       # [B, U] label ids (no blank, no EOS needed)
    label_lens: torch.Tensor,   # [B] valid labels U_b <= U
    blank: int = 0,
    real: torch.Tensor | None = None,   # [B] bool, False on filler rows
    denom: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (mean NLL over the real rows, per-row NLL [B])."""
    b, _, u1, _ = logits.shape
    if tuple(labels.shape) != (b, u1 - 1):
        raise ValueError(f"labels {tuple(labels.shape)} for logits "
                         f"{tuple(logits.shape)}")
    blank_lp, emit_lp = lattice_terms(logits, labels, blank)
    return transducer_loss_from_parts(blank_lp, emit_lp, enc_lens,
                                      label_lens, real, denom)


def lattice_terms(logits: torch.Tensor, labels: torch.Tensor,
                  blank: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint logits [B, T, U+1, V] -> (blank_lp, emit_lp) [B, T, U+1]
    float32: log P(blank | t, u) and log P(y_{u+1} | t, u), the last
    column of emit_lp NEG_INF.  The label's log-prob is selected by a
    product with its one-hot row (exact for finite log-probs)."""
    b, t, u1, v = logits.shape
    lp = torch.log_softmax(logits.float(), dim=-1)
    blank_lp = lp[..., blank]
    one_hot = Fn.one_hot(labels.long(), v).float()               # [B, U, V]
    emit_lp = (lp[:, :, :u1 - 1] * one_hot[:, None]).sum(dim=-1)
    emit_lp = torch.cat([emit_lp, emit_lp.new_full((b, t, 1), NEG_INF)],
                        dim=2)
    return blank_lp, emit_lp


def transducer_loss_from_parts(
    blank_lp: torch.Tensor,     # [B, T, U+1]
    emit_lp: torch.Tensor,      # [B, T, U+1], last column NEG_INF
    enc_lens: torch.Tensor,
    label_lens: torch.Tensor,
    real: torch.Tensor | None = None,
    denom: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The lattice NLL on precomputed terms -> (mean over the real rows,
    per-row NLL [B]).  ``denom`` replaces the real-row count (a
    data-parallel rank's global one)."""
    nll = _Lattice.apply(blank_lp.float(), emit_lp.float(), enc_lens,
                         label_lens)
    w = (torch.ones_like(nll) if real is None else real.float())
    if denom is None:
        denom = torch.clamp_min(w.sum(), 1.0)
    return (nll * w).sum() / denom, nll


def _skew_index(t: int, u1: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """For the D = T + U diagonals: the frame t = d - u of each (d, u),
    clipped into [0, T) -> [D, U+1], and whether it lies on the grid."""
    d = torch.arange(t + u1 - 1, device=device)[:, None]
    u = torch.arange(u1, device=device)[None, :]
    tt = d - u
    return tt.clamp(0, t - 1), (tt >= 0) & (tt < t)


def _skew(x: torch.Tensor, idx: torch.Tensor,
          on_grid: torch.Tensor) -> torch.Tensor:
    """[B, T, U+1] -> [B, D, U+1], x[b, d - u, u] on the grid, else
    NEG_INF."""
    b = x.shape[0]
    g = torch.gather(x, 1, idx[None].expand(b, -1, -1))
    return torch.where(on_grid[None], g, NEG_INF)


def _unskew(y: torch.Tensor, t: int) -> torch.Tensor:
    """[B, D, U+1] -> [B, T, U+1], y[b, t + u, u]."""
    b, _, u1 = y.shape
    d = (torch.arange(t, device=y.device)[:, None]
         + torch.arange(u1, device=y.device)[None, :])
    return torch.gather(y, 1, d[None].expand(b, -1, -1))


class _Lattice(torch.autograd.Function):
    """Per-row NLL of the lattice: explicit alpha (forward) and beta
    (backward) passes over the anti-diagonals."""

    @staticmethod
    def forward(ctx, blank_lp, emit_lp, enc_lens, label_lens):
        b, t, u1 = blank_lp.shape
        dev = blank_lp.device
        idx, on_grid = _skew_index(t, u1, dev)
        # [D, B, U+1]: one diagonal a contiguous row
        bs = _skew(blank_lp, idx, on_grid).transpose(0, 1).contiguous()
        es = _skew(emit_lp, idx, on_grid).transpose(0, 1).contiguous()
        n_diag = t + u1 - 1
        alphas = blank_lp.new_empty((n_diag, b, u1))
        alphas[0] = NEG_INF
        alphas[0, :, 0] = 0.0
        move = blank_lp.new_full((b, u1), NEG_INF)
        for d in range(1, n_diag):
            prev = alphas[d - 1]
            move[:, 1:] = prev[:, :-1] + es[d - 1, :, :-1]
            torch.logaddexp(prev + bs[d - 1], move, out=alphas[d])
        # the terminal cell (T_b - 1, U_b), read through one-hot masks
        enc_lens = enc_lens.to(dev).long()
        label_lens = label_lens.to(dev).long()
        d_fin = enc_lens - 1 + label_lens
        at_u = Fn.one_hot(label_lens, u1).bool()                  # [B, U+1]
        at_d = Fn.one_hot(d_fin, n_diag).bool().t()               # [D, B]
        fin = at_d[:, :, None] & at_u[None]
        alpha_fin = torch.where(fin, alphas, 0.0).sum(dim=(0, 2))
        at_t = Fn.one_hot(enc_lens - 1, t).bool()                 # [B, T]
        term = at_t[:, :, None] & at_u[:, None, :]                # [B, T, U+1]
        last_blank = torch.where(term, blank_lp, 0.0).sum(dim=(1, 2))
        ll = alpha_fin + last_blank
        ctx.save_for_backward(bs, es, alphas, ll, enc_lens, label_lens)
        ctx.t = t
        return -ll

    @staticmethod
    def backward(ctx, g):
        bs, es, alphas, ll, enc_lens, label_lens = ctx.saved_tensors
        t = ctx.t
        n_diag, b, u1 = alphas.shape
        dev = alphas.device
        d = torch.arange(n_diag, device=dev)[:, None, None]
        u = torch.arange(u1, device=dev)[None, None, :]
        tt = d - u                                                 # [D, 1, U+1]
        # cells of each row's lattice, and its terminal cell, [D, B, U+1]
        valid = ((tt >= 0) & (tt < enc_lens[None, :, None])
                 & (u <= label_lens[None, :, None]))
        terminal = (tt == enc_lens[None, :, None] - 1) & \
            (u == label_lens[None, :, None])
        # beta[d] at (t, u): blank to (t + 1, u) on diagonal d + 1 at u,
        # emit to (t, u + 1) on diagonal d + 1 at u + 1; the terminal
        # cell's blank ends the path (its successor's beta is 0)
        betas = alphas.new_empty((n_diag, b, u1))
        nxt_blank = alphas.new_full((b, u1), NEG_INF)             # beta(t+1, u)
        nxt_emit = alphas.new_full((b, u1), NEG_INF)              # beta(t, u+1)
        for di in range(n_diag - 1, -1, -1):
            if di + 1 < n_diag:
                nxt_blank = torch.where(terminal[di], 0.0, betas[di + 1])
                nxt_emit[:, :-1] = betas[di + 1][:, 1:]
            else:
                nxt_blank = torch.where(terminal[di], 0.0, NEG_INF)
            val = torch.logaddexp(bs[di] + nxt_blank, es[di] + nxt_emit)
            betas[di] = torch.where(valid[di], val, NEG_INF)
        # the successors' betas of every cell, for both terms
        beta_blank = torch.where(terminal, 0.0, torch.cat(
            [betas[1:], betas.new_full((1, b, u1), NEG_INF)]))
        beta_emit = torch.cat(
            [betas[1:, :, 1:], betas.new_full((n_diag - 1, b, 1), NEG_INF)],
            dim=2)
        beta_emit = torch.cat([beta_emit,
                               betas.new_full((1, b, u1), NEG_INF)])
        base = alphas - ll[None, :, None]
        scale = -g[None, :, None]
        g_blank = torch.where(valid, scale * torch.exp(
            base + bs + beta_blank), 0.0)
        g_emit = torch.where(valid, scale * torch.exp(
            base + es + beta_emit), 0.0)
        return (_unskew(g_blank.transpose(0, 1), t),
                _unskew(g_emit.transpose(0, 1), t), None, None)
