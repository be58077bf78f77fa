"""Objectives: masked cross-entropy with label smoothing, token accuracy,
the supervised LAS loss and the two semi-supervised terms.

Counterpart of ``semi_supervised_asr_tpu/objectives/losses.py`` for the LAS
family: ``shift_targets``, ``token_mask``, ``masked_ce``,
``token_accuracy``, the LAS branch of ``supervised_loss``, ``text_ae_loss``
(unlabeled text through the shared speller) and ``pseudo_label_loss`` (the
teacher's greedy hypotheses on the clean view of unlabeled audio as the
student's targets on the augmented view).  The CTC auxiliary head and MWER
are not ported yet; ``objective.lambda_ctc`` and ``lambda_mwer`` other than
zero are refused by the train step.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import PAD, SOS
from semi_supervised_asr_tpu_torch.decode.greedy import (
    greedy_decode_from_enc,
)


def shift_targets(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, U] gold tokens (ending with EOS, PAD-padded) -> (decoder inputs
    [B, U] = <sos> + tokens[:-1], targets [B, U] = tokens)."""
    sos = torch.full((tokens.shape[0], 1), SOS, dtype=tokens.dtype,
                     device=tokens.device)
    return torch.cat([sos, tokens[:, :-1]], dim=1), tokens


def token_mask(targets: torch.Tensor) -> torch.Tensor:
    """Valid positions: everything up to and including the EOS."""
    return (targets != PAD).float()


def masked_ce(
    logits: torch.Tensor,       # [B, U, V]
    targets: torch.Tensor,      # [B, U]
    label_smoothing: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (mean CE over valid tokens, per-token gold log-prob [B, U]).
    Smoothing spreads ``label_smoothing`` uniformly over the whole vocab."""
    mask = token_mask(targets)
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold_lp = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (-(1.0 - label_smoothing) * gold_lp
               - label_smoothing * logp.mean(dim=-1))
    else:
        nll = -gold_lp
    denom = torch.clamp_min(mask.sum(), 1.0)
    return (nll * mask).sum() / denom, gold_lp


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    mask = token_mask(targets)
    correct = (torch.argmax(logits, dim=-1) == targets).float() * mask
    return correct.sum() / torch.clamp_min(mask.sum(), 1.0)


def supervised_loss(
    model,
    label_smoothing: float,
    feats: torch.Tensor,
    feat_lens: torch.Tensor,
    tokens: torch.Tensor,
    tf_rate: float,
    gen: torch.Generator | None = None,
    backend: str | None = None,
) -> tuple[torch.Tensor, dict]:
    """Supervised CE on labeled (audio, text) pairs -> (loss, {"ce",
    "acc"}); ``model`` is a ``Seq2Seq``."""
    tokens_in, targets = shift_targets(tokens)
    logits, _ = model.forward_teacher(feats, feat_lens, tokens_in, tf_rate,
                                      gen, backend)
    loss, _ = masked_ce(logits, targets, label_smoothing)
    return loss, {"ce": loss.detach(),
                  "acc": token_accuracy(logits.detach(), targets)}


def text_ae_loss(speller, label_smoothing: float,
                 text_tokens: torch.Tensor) -> torch.Tensor:
    """Text autoencoder: label-smoothed CE of unlabeled text ``[B, U]``
    (EOS-terminated, PAD-padded) reconstructed by the shared ``speller``
    over a zero context."""
    tokens_in, targets = shift_targets(text_tokens)
    logits = speller.text_autoencoder_logits(tokens_in)
    loss, _ = masked_ce(logits, targets, label_smoothing)
    return loss


@torch.no_grad()
def teacher_labels(teacher, feats: torch.Tensor, feat_lens: torch.Tensor,
                   max_len: int, backend: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The teacher's greedy hypotheses on the clean view, without a graph
    (so K2 keeps no residuals) -> (tokens [B, max_len] int32, EOS then
    PADs; per-token log-prob [B, max_len])."""
    enc, enc_mask, keys = teacher.encode(feats, feat_lens, backend)
    return greedy_decode_from_enc(teacher.speller, enc, enc_mask, keys,
                                  max_len)


def pseudo_label_loss(
    model,
    teacher,
    pseudo_confidence: float,
    feats_clean: torch.Tensor,
    feats_aug: torch.Tensor,
    feat_lens: torch.Tensor,
    max_len: int,
    row_mask: torch.Tensor | None = None,
    backend: str | None = None,
    labels: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Pseudo-label consistency on unlabeled audio: the student ``model``
    at teacher-forcing rate 1 on the augmented view, CE against the
    ``teacher``'s greedy hypotheses on the clean view (no gradient reaches
    the teacher).  ``pseudo_confidence`` is an absolute probability
    threshold: an utterance is kept when the mean of its hypothesis'
    per-token log-prob is >= log(pseudo_confidence); 0 keeps every row.
    ``row_mask`` drops filler rows.  ``labels`` replaces the teacher's
    decode with given (hypotheses, log-probs), so that two runs of the
    student can be compared on the same targets."""
    hyps, hyp_logp = labels if labels is not None else teacher_labels(
        teacher, feats_clean, feat_lens, max_len, backend)
    tokens_in, targets = shift_targets(hyps)
    logits, _ = model.forward_teacher(feats_aug, feat_lens, tokens_in, 1.0,
                                      None, backend)
    mask = token_mask(targets)
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold_lp = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    nll = -gold_lp * mask
    conf = (hyp_logp * mask).sum(dim=1) / torch.clamp_min(mask.sum(dim=1),
                                                          1.0)
    if pseudo_confidence > 0.0:
        # the threshold in float32, as the reference computes it
        floor = torch.log(torch.tensor(max(pseudo_confidence, 1e-8),
                                       dtype=torch.float32))
        keep = conf >= floor.to(conf.device)
    else:
        keep = torch.ones_like(conf, dtype=torch.bool)
    if row_mask is not None:
        keep = keep & row_mask
    keep_f = keep.float()[:, None]
    denom = torch.clamp_min((mask * keep_f).sum(), 1.0)
    return (nll * keep_f).sum() / denom
