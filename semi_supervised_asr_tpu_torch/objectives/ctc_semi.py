"""The CTC family's semi-supervised term, and its view for the train step.

Counterpart of ``semi_supervised_asr_tpu/objectives/ctc_semi.py``
(``ctc_pseudo_label_loss``, unlabeled audio, ``objective.lambda_pseudo``):
the teacher (the EMA buffer or the current weights, no gradient either
way) encodes the clean view and decodes it by best path
(``decode/ctc.py::ctc_greedy_from_enc``) without a graph; the student's
CTC NLL of those hypotheses on the augmented view is the term.  A row is
kept when the teacher's mean per-frame best-path log-prob (over every
valid encoder frame, blanks included) reaches log(``pseudo_confidence``)
(0 keeps every row), its hypothesis holds a label and it is real; the sum
is normalized by the kept labels.  The family has no text term: it has no
decoder for unlabeled text to train (``objective.lambda_text_ae`` is
refused with the reference's message).

The train step's view of the family's terms (``TEXT_KEY``,
``step_counts``, ``step_supervised``, ``step_mwer``, ``step_mwer_nbest``,
``step_teacher_labels``, ``kept_count``, ``step_pseudo``) is the one
``losses.py`` and ``transducer_semi.py`` give for theirs.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import PAD
from semi_supervised_asr_tpu_torch.decode.ctc import ctc_greedy_from_enc
from semi_supervised_asr_tpu_torch.objectives.losses import (
    ctc_family_loss, ctc_label_count, ctc_per_utt_nll,
)


@torch.no_grad()
def teacher_labels(teacher, feats: torch.Tensor, feat_lens: torch.Tensor,
                   backend: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The teacher's best paths on the clean view, without a graph (so K2
    keeps no residuals) -> (tokens [B, T'] int32: labels, EOS, PADs; the
    path's log-prob [B]; the encoder lengths [B])."""
    enc, enc_mask = teacher.encode(feats, feat_lens, backend)
    hyps, path_lp = ctc_greedy_from_enc(teacher.ctc, enc, enc_mask)
    return hyps, path_lp, enc_mask.sum(dim=1)


def label_counts(hyps: torch.Tensor) -> torch.Tensor:
    """Labels of best-path rows (labels, EOS, PADs): every token but the
    EOS, float32."""
    return torch.clamp_min((hyps != PAD).sum(dim=1) - 1, 0).float()


def pseudo_keep(labels: tuple, pseudo_confidence: float,
                row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The rows of the teacher's ``labels`` (:func:`teacher_labels`) the
    term keeps -> [B] bool."""
    hyps, path_lp, t_lens = labels
    conf = path_lp / torch.clamp_min(t_lens, 1).float()
    if pseudo_confidence > 0.0:
        # the threshold in float32, as the reference computes it
        floor = torch.log(torch.tensor(max(pseudo_confidence, 1e-8),
                                       dtype=torch.float32))
        keep = conf >= floor.to(conf.device)
    else:
        keep = torch.ones_like(conf, dtype=torch.bool)
    # an empty pseudo-label carries no signal (it would push every frame
    # to the blank)
    keep = keep & (label_counts(hyps) > 0)
    if row_mask is not None:
        keep = keep & row_mask
    return keep


def kept_count(labels: tuple, pseudo_confidence: float,
               row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The term's denominator before the clamp: the labels of the kept
    rows."""
    keep = pseudo_keep(labels, pseudo_confidence, row_mask)
    return (label_counts(labels[0]) * keep.float()).sum()


def ctc_pseudo_label_loss(
    model,
    teacher,
    pseudo_confidence: float,
    feats_clean: torch.Tensor,
    feats_aug: torch.Tensor,
    feat_lens: torch.Tensor,
    row_mask: torch.Tensor | None = None,
    backend: str | None = None,
    labels: tuple | None = None,
    denom: torch.Tensor | None = None,
    masks: tuple | None = None,
) -> torch.Tensor:
    """Teacher best path on the clean view -> the student's CTC NLL on the
    augmented view, over the kept rows, per kept label.  ``labels``
    replaces the teacher's decode (:func:`teacher_labels`' triple),
    ``denom`` the kept-label count (a data-parallel rank's global one),
    ``masks`` the student's dropout masks (its encode runs without remat,
    as in the reference)."""
    if labels is None:
        labels = teacher_labels(teacher, feats_clean, feat_lens, backend)
    keep_f = pseudo_keep(labels, pseudo_confidence, row_mask).float()
    enc_masks = masks[0] if masks is not None else None
    enc, enc_mask = model.encode(feats_aug, feat_lens, backend, False,
                                 enc_masks)
    nll, _ = ctc_per_utt_nll(model.ctc, enc, enc_mask, labels[0])
    if denom is None:
        denom = torch.clamp_min((label_counts(labels[0]) * keep_f).sum(),
                                1.0)
    return (nll * keep_f).sum() / denom


# The train step's view of the family's terms (see the module docstring).
# ``den`` holds the step's clamped counts: labels, text (unused), kept
# pseudo labels, the joint CTC term's (unused), MWER rows.
TEXT_KEY = None


def step_counts(cfg, tokens: torch.Tensor, real: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The labeled batch's counts -> (CTC labels; 0: the family has no
    second supervised term); ``tokens`` has its unreal rows masked."""
    return ctc_label_count(tokens), torch.zeros((), device=tokens.device)


def step_supervised(model, cfg, feats, feat_lens, tokens, real, tf_rate,
                    gen, backend, den, remat, rows, masks) -> tuple:
    """The supervised term of a step: ``losses.ctc_family_loss`` -> (loss,
    aux, enc, enc_mask) (``tf_rate``, ``gen`` and ``rows`` serve the LAS
    family only)."""
    return ctc_family_loss(model, feats, feat_lens, tokens, real, backend,
                           den[0], remat, masks)


def step_mwer(model, cfg, enc, enc_mask, tokens, denom, backend=None,
              nbest=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The MWER term of a step: ``ctc_mwer.mwer_loss_from_enc``."""
    from semi_supervised_asr_tpu_torch.objectives import ctc_mwer

    return ctc_mwer.mwer_loss_from_enc(model, cfg.objective, enc, enc_mask,
                                       tokens, denom, nbest)


def step_mwer_nbest(model, cfg, enc, enc_mask, max_len: int) -> tuple:
    """The n-best :func:`step_mwer` rescores."""
    from semi_supervised_asr_tpu_torch.objectives import ctc_mwer

    return ctc_mwer.mwer_nbest(model, cfg.objective, enc, enc_mask, max_len)


def step_teacher_labels(teacher, cfg, feats, feat_lens, max_len: int,
                        backend: str | None = None) -> tuple:
    """:func:`teacher_labels` of a step (``max_len`` unused: best paths
    are as wide as the encoder's frames, as in the reference)."""
    return teacher_labels(teacher, feats, feat_lens, backend)


def step_pseudo(model, cfg, feats_clean, feats_aug, feat_lens, max_len,
                row_mask, backend, labels, denom, masks) -> torch.Tensor:
    """The pseudo-label term of a step: :func:`ctc_pseudo_label_loss` on
    the given ``labels``."""
    return ctc_pseudo_label_loss(model, None, cfg.objective.pseudo_confidence,
                                 feats_clean, feats_aug, feat_lens, row_mask,
                                 backend, labels, denom, masks)
