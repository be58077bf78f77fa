"""MWER (minimum word error rate) sequence training for the RNN-T family.

Counterpart of ``semi_supervised_asr_tpu/objectives/transducer_mwer.py``
(``mwer_loss_from_enc``): the alignment-synchronous beam
(``decode/transducer_beam.py``) proposes ``objective.mwer_beam`` label
sequences on the supervised pass's encoder output under no gradient; each
is rescored by its differentiable lattice NLL (the full marginal over
alignments: the predictor over the B*K hypotheses on the LSTM scan
kernels, then the joint grid, or its chunks under
``model.joint_chunk_frames``, which bounds the B*K grids' memory as it
bounds the supervised loss's); the risks are label edit distances to the
gold tokens (EOS stripped), and the loss is the n-best expected risk
(``losses.expected_risk``).
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import PAD
from semi_supervised_asr_tpu_torch.decode.transducer_beam import (
    transducer_beam_from_enc,
)
from semi_supervised_asr_tpu_torch.objectives.losses import (
    expected_risk, nbest_risks,
)
from semi_supervised_asr_tpu_torch.objectives.transducer_semi import (
    lattice_nll,
)


@torch.no_grad()
def mwer_nbest(model, obj, enc: torch.Tensor, enc_mask: torch.Tensor,
               max_u: int, max_symbols: int = 4
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The n-best the term rescores: the beam of ``obj.mwer_beam``,
    ``max_symbols`` emissions a frame -> (labels [B, K, max_u], scores
    [B, K]), best first."""
    return transducer_beam_from_enc(model, model.cfg, enc, enc_mask, max_u,
                                    obj.mwer_beam, max_symbols,
                                    return_nbest=True)


def mwer_loss_from_enc(
    model,
    obj,
    enc: torch.Tensor,          # [B, T', E] (the supervised pass's)
    enc_mask: torch.Tensor,     # [B, T'] bool
    tokens: torch.Tensor,       # [B, U] gold (EOS-terminated, PAD-padded)
    max_symbols: int = 4,
    denom: torch.Tensor | None = None,
    nbest: tuple | None = None,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (expected-risk loss, mean n-best risk); ``model`` is a
    ``Transducer``, ``max_symbols`` the beam's emissions a frame,
    ``denom`` as in ``losses.expected_risk``, ``nbest`` gives the beam's
    (labels [B, K, U], scores [B, K]) instead of running it
    (:func:`mwer_nbest`'s)."""
    b, u = tokens.shape
    k = obj.mwer_beam
    cfg = model.cfg
    if nbest is None:
        nbest = mwer_nbest(model, obj, enc.detach(), enc_mask, u,
                           max_symbols)
    hyps = nbest[0].to(tokens.dtype)
    flat = hyps.reshape(b * k, u)
    _, nll = lattice_nll(model, cfg, enc.repeat_interleave(k, dim=0),
                         enc_mask.repeat_interleave(k, dim=0), flat,
                         (flat != PAD).sum(dim=1), backend=backend)
    risks, row_weight = nbest_risks(hyps, tokens)
    return expected_risk(-nll.reshape(b, k), risks, row_weight, denom)
