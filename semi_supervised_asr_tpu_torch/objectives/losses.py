"""Objectives: masked cross-entropy with label smoothing, token accuracy,
and the supervised LAS loss.

Counterpart of the supervised part of ``semi_supervised_asr_tpu/objectives/
losses.py`` (``shift_targets``, ``token_mask``, ``masked_ce``,
``token_accuracy`` and the LAS branch of ``supervised_loss``).  The CTC
auxiliary head, the text autoencoder, pseudo-labels and MWER are not ported
yet; ``objective.lambda_*`` other than zero is refused by the train step.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import PAD, SOS


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
