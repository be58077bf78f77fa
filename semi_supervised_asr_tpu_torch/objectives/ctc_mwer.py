"""MWER (minimum word error rate) sequence training for the CTC family.

Counterpart of ``semi_supervised_asr_tpu/objectives/ctc_mwer.py``
(``mwer_loss_from_enc``): the prefix beam (``decode/ctc_beam.py``)
proposes ``objective.mwer_beam`` label sequences on the supervised pass's
encoder output under no gradient; each is rescored by its differentiable
CTC log-marginal (``objectives/losses.py::ctc_nll``, optax's recursion)
over the B*K repeated head logits; an empty hypothesis takes the all-blank
path's log-prob (the recursion is not defined at zero labels); beam rows
that never became live (fewer than K reachable prefixes) leave the
renormalization; the risks are label edit distances to the gold tokens
(EOS stripped), and the loss is the n-best expected risk
(``losses.expected_risk``).
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import PAD
from semi_supervised_asr_tpu_torch.decode.ctc import ctc_head_logits
from semi_supervised_asr_tpu_torch.decode.ctc_beam import (
    NEG_INF, ctc_beam_from_enc,
)
from semi_supervised_asr_tpu_torch.objectives.losses import (
    ctc_nll, expected_risk, nbest_risks,
)


@torch.no_grad()
def mwer_nbest(model, obj, enc: torch.Tensor, enc_mask: torch.Tensor,
               max_u: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The n-best the term rescores: the prefix beam of ``obj.mwer_beam``
    -> (labels [B, K, max_u], scores [B, K]), best first."""
    return ctc_beam_from_enc(model.ctc, enc, enc_mask, max_u, obj.mwer_beam,
                             return_nbest=True)


def mwer_loss_from_enc(
    model,
    obj,
    enc: torch.Tensor,          # [B, T', E] (the supervised pass's)
    enc_mask: torch.Tensor,     # [B, T'] bool
    tokens: torch.Tensor,       # [B, U] gold (EOS-terminated, PAD-padded)
    denom: torch.Tensor | None = None,
    nbest: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (expected-risk loss, mean n-best risk); ``model`` is a
    ``CTCModel``, ``denom`` as in ``losses.expected_risk``, ``nbest`` gives
    the prefix beam's (labels [B, K, U], scores [B, K]) instead of running
    it (:func:`mwer_nbest`'s; a score at NEG_INF marks a row that never
    became live)."""
    b, u = tokens.shape
    k = obj.mwer_beam
    if nbest is None:
        nbest = mwer_nbest(model, obj, enc.detach(), enc_mask, u)
    hyps, beam_scores = nbest
    hyps = hyps.to(tokens.dtype)
    live = beam_scores > NEG_INF / 2
    logits = ctc_head_logits(model.ctc, enc)              # [B, T', V]
    flat = hyps.reshape(b * k, u)
    nll = ctc_nll(logits.repeat_interleave(k, dim=0),
                  enc_mask.repeat_interleave(k, dim=0), flat)
    logp = torch.log_softmax(logits, dim=-1)
    empty_lp = (logp[..., PAD] * enc_mask.float()).sum(dim=-1)   # [B]
    n_labels = (flat != PAD).sum(dim=1).reshape(b, k)
    seq_logp = torch.where(n_labels > 0, -nll.reshape(b, k),
                           empty_lp[:, None])
    seq_logp = torch.where(live, seq_logp, NEG_INF)
    risks, row_weight = nbest_risks(hyps, tokens)
    return expected_risk(seq_logp, risks, row_weight, denom)
