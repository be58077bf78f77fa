"""The transducer family's semi-supervised terms.

Counterpart of ``semi_supervised_asr_tpu/objectives/transducer_semi.py``:

* ``pseudo_label_loss`` (unlabeled audio, ``objective.lambda_pseudo``):
  the teacher (the EMA buffer or the current weights, no gradient either
  way) encodes the clean view and decodes it greedily; the student's
  lattice NLL of those hypotheses on the augmented view is the term.  A
  row is kept when the teacher's mean per-step path log-prob, over
  ``enc_len + label_len`` steps, reaches log(``pseudo_confidence``) (0
  keeps every row), its hypothesis is not empty and it is real; the sum is
  normalized per label, (label_len + 1) a kept row.
* ``ilm_text_loss`` (unlabeled text, ``objective.lambda_text_ae``): the
  next-label cross-entropy of the internal LM, the predictor and the joint
  with the acoustic term zeroed (``ilm_logits``), blank excluded from its
  softmax and the EOS from its targets.  Its gradient reaches the
  predictor and the joint's ``w_pred``, ``b``, ``w_out`` and ``b_out``
  only.

Label log-probs are selected by products with one-hot rows, so that their
backward scatters nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.data.vocab import PAD
from semi_supervised_asr_tpu_torch.decode.transducer_greedy import (
    transducer_greedy_from_enc,
)
from semi_supervised_asr_tpu_torch.models import transducer as TD
from semi_supervised_asr_tpu_torch.objectives.transducer_loss import (
    transducer_loss, transducer_loss_from_parts,
)


def label_lengths(tokens: torch.Tensor) -> torch.Tensor:
    """Labels of EOS-terminated, PAD-padded rows: every token before the
    EOS (blank ends a transducer path, so the EOS is no label)."""
    return torch.clamp_min((tokens != PAD).sum(dim=1) - 1, 0)


def lattice_nll(model, cfg: ModelConfig, enc: torch.Tensor,
                enc_mask: torch.Tensor, labels: torch.Tensor,
                label_lens: torch.Tensor, real: torch.Tensor | None = None,
                denom: torch.Tensor | None = None,
                backend: str | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The lattice NLL of ``labels`` [B, U] (PAD-padded, ``label_lens``
    valid) over the encoder's output -> (mean over the real rows, per-row
    NLL): the predictor over the labels, then the full joint grid, or its
    chunks under ``model.joint_chunk_frames``."""
    pred = TD.predictor_train(model.predictor, labels, cfg, backend)
    enc_lens = torch.clamp_min(enc_mask.sum(dim=1), 1)
    if cfg.joint_chunk_frames > 0:
        blank_lp, emit_lp = TD.joint_lattice_terms(
            model.joint, enc, pred, labels, cfg, PAD, cfg.joint_chunk_frames)
        return transducer_loss_from_parts(blank_lp, emit_lp, enc_lens,
                                          label_lens, real, denom)
    logits = TD.joint_logits(model.joint, enc, pred, cfg)
    return transducer_loss(logits, enc_lens, labels, label_lens, PAD, real,
                           denom)


def supervised_loss(model, feats: torch.Tensor, feat_lens: torch.Tensor,
                    tokens: torch.Tensor, real: torch.Tensor,
                    backend: str | None = None,
                    denom: torch.Tensor | None = None,
                    label_denom: torch.Tensor | None = None,
                    remat: bool = False, masks: tuple | None = None
                    ) -> tuple:
    """The supervised term: the lattice NLL of the EOS-terminated
    ``tokens``, its mean over the real rows (``denom`` replaces their
    count) -> (loss, {"nll_per_label"}: the NLL per label + 1 of the real
    rows, ``label_denom`` replacing that count; enc, enc_mask: the pass's
    encoder output, which MWER reads); ``remat`` and ``masks`` (the
    listener's) as in ``seq2seq.run_listener``."""
    cfg = model.cfg
    enc_masks = masks[0] if masks is not None else None
    enc, enc_mask = model.encode(feats, feat_lens, backend, remat, enc_masks)
    label_lens = label_lengths(tokens)
    loss, nll = lattice_nll(model, cfg, enc, enc_mask, tokens, label_lens,
                            real, denom, backend)
    w = real.float()
    if label_denom is None:
        label_denom = torch.clamp_min(((label_lens + 1) * w).sum(), 1.0)
    aux = {"nll_per_label": (nll.detach() * w).sum() / label_denom}
    return loss, aux, enc, enc_mask


@torch.no_grad()
def teacher_labels(teacher, feats: torch.Tensor, feat_lens: torch.Tensor,
                   max_u: int, max_symbols: int = 4,
                   backend: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The teacher's greedy hypotheses on the clean view, without a graph
    -> (tokens [B, max_u] int32, PAD-padded; the path's log-prob [B]; the
    encoder lengths [B])."""
    enc, enc_mask = teacher.encode(feats, feat_lens, backend)
    hyps, path_lp = transducer_greedy_from_enc(
        teacher, teacher.cfg, enc, enc_mask, max_u, max_symbols)
    return hyps, path_lp, enc_mask.sum(dim=1)


def pseudo_keep(labels: tuple, pseudo_confidence: float,
                row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The rows of the teacher's ``labels`` (:func:`teacher_labels`) the
    term keeps -> [B] bool."""
    hyps, path_lp, t_lens = labels
    label_lens = (hyps != PAD).sum(dim=1)
    steps = torch.clamp_min(t_lens.float() + label_lens.float(), 1.0)
    conf = path_lp / steps
    if pseudo_confidence > 0.0:
        # the threshold in float32, as the reference computes it
        floor = torch.log(torch.tensor(max(pseudo_confidence, 1e-8),
                                       dtype=torch.float32))
        keep = conf >= floor.to(conf.device)
    else:
        keep = torch.ones_like(conf, dtype=torch.bool)
    keep = keep & (label_lens > 0)
    if row_mask is not None:
        keep = keep & row_mask
    return keep


def pseudo_count(labels: tuple, keep: torch.Tensor) -> torch.Tensor:
    """The term's denominator before the clamp: (label_len + 1) summed over
    the kept rows."""
    label_lens = (labels[0] != PAD).sum(dim=1)
    return ((label_lens + 1) * keep).sum()


def pseudo_label_loss(
    model,
    teacher,
    pseudo_confidence: float,
    feats_clean: torch.Tensor,
    feats_aug: torch.Tensor,
    feat_lens: torch.Tensor,
    max_u: int,
    row_mask: torch.Tensor | None = None,
    max_symbols: int = 4,
    backend: str | None = None,
    labels: tuple | None = None,
    denom: torch.Tensor | None = None,
    masks: tuple | None = None,
) -> torch.Tensor:
    """Teacher greedy on the clean view -> the student's lattice NLL on the
    augmented view, over the kept rows, per label.  ``labels`` replaces the
    teacher's decode (:func:`teacher_labels`' triple), ``denom`` the
    kept-label count (a data-parallel rank's global one), ``masks`` the
    student's dropout masks (its encode runs without remat, as in the
    reference)."""
    if labels is None:
        labels = teacher_labels(teacher, feats_clean, feat_lens, max_u,
                                max_symbols, backend)
    hyps = labels[0]
    keep = pseudo_keep(labels, pseudo_confidence, row_mask)
    enc_masks = masks[0] if masks is not None else None
    enc, enc_mask = model.encode(feats_aug, feat_lens, backend, False,
                                 enc_masks)
    label_lens = (hyps != PAD).sum(dim=1)
    _, nll = lattice_nll(model, model.cfg, enc, enc_mask, hyps, label_lens,
                         backend=backend)
    keep_f = keep.float()
    if denom is None:
        denom = torch.clamp_min(pseudo_count(labels, keep).float(), 1.0)
    return (nll * keep_f).sum() / denom


def ilm_logits(joint, pred: torch.Tensor) -> torch.Tensor:
    """Internal-LM logits of predictor states [B, U1, P] -> [B, U1, V]:
    ``tanh(pred . w_pred + b) . w_out + b_out`` in float32."""
    h = torch.tanh(pred.float() @ joint.w_pred.float() + joint.b.float())
    return h @ joint.w_out.float() + joint.b_out.float()


def ilm_text_loss(model, text: torch.Tensor,
                  denom: torch.Tensor | None = None,
                  backend: str | None = None) -> torch.Tensor:
    """Next-label CE of the internal LM on unlabeled text [B, U]
    (EOS-terminated, PAD-padded): the blank column masked to -1e30, the EOS
    out of the targets; ``denom`` replaces the target count."""
    label_lens = label_lengths(text)
    pred = TD.predictor_train(model.predictor, text, model.cfg, backend)
    logits = ilm_logits(model.joint, pred)[:, :-1]            # rows 0 .. U-1
    v = logits.shape[-1]
    is_blank = torch.arange(v, device=logits.device) == PAD
    logits = torch.where(is_blank, -1e30, logits)
    logp = torch.log_softmax(logits, dim=-1)
    gold = (logp * Fn.one_hot(text.long(), v).float()).sum(dim=-1)
    u = text.shape[1]
    mask = (torch.arange(u, device=text.device)[None, :]
            < label_lens[:, None]).float()
    if denom is None:
        denom = torch.clamp_min(mask.sum(), 1.0)
    return -(gold * mask).sum() / denom


def text_count(text: torch.Tensor) -> torch.Tensor:
    """The ILM term's target count: the labels of every row."""
    return label_lengths(text).sum()


# The train step's view of the family's terms, shared with
# ``losses.py`` (the LAS family's) and ``ctc_semi.py``:
# ``training/train_step.py`` picks the family's module once.  ``den`` holds
# the step's clamped counts: real rows, text labels, kept pseudo labels + 1
# a row, labels + 1 of the real rows, MWER rows.
TEXT_KEY = "text_ilm"


def step_counts(cfg, tokens: torch.Tensor, real: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The labeled batch's counts -> (real rows; label_len + 1 summed over
    them)."""
    return real.sum(), ((label_lengths(tokens) + 1) * real).sum()


def step_supervised(model, cfg, feats, feat_lens, tokens, real, tf_rate,
                    gen, backend, den, remat, rows, masks) -> tuple:
    """The supervised term of a step: :func:`supervised_loss` -> (loss,
    aux, enc, enc_mask) (``tf_rate``, ``gen`` and ``rows`` serve the LAS
    family only)."""
    return supervised_loss(model, feats, feat_lens, tokens, real, backend,
                           den[0], den[3], remat, masks)


def step_mwer(model, cfg, enc, enc_mask, tokens, denom, backend=None,
              nbest=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The MWER term of a step: ``transducer_mwer.mwer_loss_from_enc``,
    ``decode.max_symbols`` emissions a frame."""
    from semi_supervised_asr_tpu_torch.objectives import transducer_mwer

    return transducer_mwer.mwer_loss_from_enc(
        model, cfg.objective, enc, enc_mask, tokens, cfg.decode.max_symbols,
        denom, nbest, backend)


def step_mwer_nbest(model, cfg, enc, enc_mask, max_len: int) -> tuple:
    """The n-best :func:`step_mwer` rescores."""
    from semi_supervised_asr_tpu_torch.objectives import transducer_mwer

    return transducer_mwer.mwer_nbest(model, cfg.objective, enc, enc_mask,
                                      max_len, cfg.decode.max_symbols)


def step_text(model, cfg, text: torch.Tensor, denom: torch.Tensor,
              backend: str | None = None) -> torch.Tensor:
    """The text term of a step: :func:`ilm_text_loss`."""
    return ilm_text_loss(model, text, denom, backend)


def step_teacher_labels(teacher, cfg, feats, feat_lens, max_len: int,
                        backend: str | None = None) -> tuple:
    """:func:`teacher_labels` of a step, ``decode.max_symbols`` a frame."""
    return teacher_labels(teacher, feats, feat_lens, max_len,
                          cfg.decode.max_symbols, backend)


def kept_count(labels: tuple, pseudo_confidence: float,
               row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The pseudo term's count before the clamp (:func:`pseudo_count` of
    the rows :func:`pseudo_keep` keeps)."""
    return pseudo_count(labels, pseudo_keep(labels, pseudo_confidence,
                                            row_mask))


def step_pseudo(model, cfg, feats_clean, feats_aug, feat_lens, max_len,
                row_mask, backend, labels, denom, masks) -> torch.Tensor:
    """The pseudo-label term of a step: :func:`pseudo_label_loss` on the
    given ``labels``."""
    return pseudo_label_loss(model, None, cfg.objective.pseudo_confidence,
                             feats_clean, feats_aug, feat_lens, max_len,
                             row_mask, cfg.decode.max_symbols, backend,
                             labels, denom, masks)
