"""CTC prefix scores for one-pass joint CTC/attention beam search.

Counterpart of ``semi_supervised_asr_tpu/decode/ctc_prefix.py`` (Watanabe
et al. 2017): while the attention beam expands, every candidate
continuation g.c is also scored by the CTC head's prefix probability, and
the beam ranks by ``(1 - w) logp_att + w delta logp_ctc`` at every step
(``decode/beam.py``, ``decode.ctc_one_pass``).  The per-frame forward
variables of a prefix are advanced in closed form over cumulative
log-sum-exps (no loop over frames):

    gn_t(g.c) = cum_c[t] + logcumsumexp_t(phi_t - cum_c[t-1])
    gb_t(h)   = cum_b[t] + logcumsumexp_{tau<=t-1}(gn_tau(h) - cum_b[tau])

with ``phi_t`` the "g just finished" mass; the candidate's prefix score is
``logsumexp_t(phi_t + logp_t(c))`` and the finish (EOS) score
``gn_{T-1}(g) + gb_{T-1}(g)``.  Padded frames emit blank with probability
1 and every other label at a large finite penalty, not -inf: the closed
forms subtract cumulative sums.  Blank is PAD.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import PAD

NEG = -1.0e30      # score-level "impossible" (the beam's convention)
PAD_NEG = -1.0e4   # a padded frame's non-blank log-prob


def masked_ctc_logp(logits: torch.Tensor,
                    enc_mask: torch.Tensor) -> torch.Tensor:
    """Log-softmax of the CTC head's logits with padded frames rewritten to
    emit blank -> [B, T, V] float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    pad_row = torch.full((logp.shape[-1],), PAD_NEG, device=logp.device)
    pad_row[PAD] = 0.0
    return torch.where(enc_mask[..., None], logp, pad_row)


def prefix_init(logp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward variables of the empty prefix -> (gn [R, T], gb [R, T])."""
    r, t, _ = logp.shape
    gb = torch.cumsum(logp[:, :, PAD], dim=1)
    return torch.full((r, t), NEG, device=logp.device), gb


def _shift1(x: torch.Tensor, fill: float) -> torch.Tensor:
    """[R, T] -> the value at t - 1 (column 0 <- ``fill``)."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _prev(gn, gb, empty):
    gb_prev = _shift1(gb, NEG)
    gb_prev[:, 0] = torch.where(empty, 0.0, NEG)
    return _shift1(gn, NEG), gb_prev


def candidate_scores(
    gn: torch.Tensor,       # [R, T] parent gamma^n
    gb: torch.Tensor,       # [R, T] parent gamma^b
    logp: torch.Tensor,     # [R, T, V] masked_ctc_logp
    last: torch.Tensor,     # [R] the parent prefix's last token
    empty: torch.Tensor,    # [R] bool: the parent prefix is empty
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (psi [R, V]: the prefix score of every extension g.c (blank's
    column NEG), eos [R]: the score of finishing at g)."""
    gn_prev, gb_prev = _prev(gn, gb, empty)
    v = logp.shape[-1]
    same = last[:, None] == torch.arange(v, device=logp.device)[None, :]
    phi = torch.where(same[:, None, :], gb_prev[:, :, None],
                      torch.logaddexp(gb_prev[:, :, None],
                                      gn_prev[:, :, None]))
    psi = torch.logsumexp(phi + logp, dim=1)
    psi[:, PAD] = NEG
    return psi, torch.logaddexp(gn[:, -1], gb[:, -1])


def advance(
    gn: torch.Tensor,       # [R, T] parent gamma^n (post-gather)
    gb: torch.Tensor,       # [R, T] parent gamma^b (post-gather)
    logp: torch.Tensor,     # [R, T, V]
    last: torch.Tensor,     # [R] the parent's last token (post-gather)
    empty: torch.Tensor,    # [R] the parent prefix is empty
    chosen: torch.Tensor,   # [R] the token appended this step
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward variables of g.chosen -> (gn' [R, T], gb' [R, T])."""
    gn_prev, gb_prev = _prev(gn, gb, empty)
    phi = torch.where((chosen == last)[:, None], gb_prev,
                      torch.logaddexp(gb_prev, gn_prev))
    lp_c = torch.gather(logp, 2, chosen.long()[:, None, None].expand(
        -1, logp.shape[1], 1))[:, :, 0]
    cum_c = torch.cumsum(lp_c, dim=1)
    gn_new = cum_c + torch.logcumsumexp(phi - _shift1(cum_c, 0.0), dim=1)
    cum_b = torch.cumsum(logp[:, :, PAD], dim=1)
    z = torch.logcumsumexp(gn_new - cum_b, dim=1)
    return gn_new, cum_b + _shift1(z, NEG)
