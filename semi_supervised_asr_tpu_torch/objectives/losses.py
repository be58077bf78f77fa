"""Objectives: masked cross-entropy with label smoothing, token accuracy,
the supervised LAS loss and the two semi-supervised terms.

Counterpart of ``semi_supervised_asr_tpu/objectives/losses.py`` for the LAS
family: ``shift_targets``, ``token_mask``, ``masked_ce``,
``token_accuracy``, ``supervised_loss`` (with the joint CTC-attention
term, ``objective.lambda_ctc``), ``text_ae_loss`` (unlabeled text through
the shared speller), ``pseudo_label_loss`` (the teacher's greedy hypotheses
on the clean view of unlabeled audio as the student's targets on the
augmented view), the CTC NLL: ``ctc_per_utt_nll``, ``ctc_loss`` and the
CTC family's ``ctc_family_loss``, and MWER (``objective.lambda_mwer``):
``expected_risk`` and the LAS family's ``mwer_loss_from_enc`` (the CTC and
transducer families' are ``ctc_mwer.py`` and ``transducer_mwer.py``).

The CTC NLL is optax's ``ctc_loss`` (0.2.6) step for step: blank at PAD,
EOS mapped to PAD, ``log_epsilon`` -1e5 for log 0 (so a row whose frames
cannot hold its labels gives a large finite loss, not inf), float32.  Its
backward has no atomic sums: the label log-probs are selected by a product
with one-hot [N, V] rows (exact for finite log-probs with TF32 off), and
the recursion is elementwise, so that a step's gradient is the same bits on
every run (exact resume, ``chip_smoke.py`` phase 17); ``F.ctc_loss``'s CUDA
backward and a ``gather`` at the extended labels both sum with atomics.
"""

from __future__ import annotations

import torch

import torch.nn.functional as Fn

from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD, SOS
from semi_supervised_asr_tpu_torch.decode.ctc import ctc_head_logits
from semi_supervised_asr_tpu_torch.decode.greedy import (
    greedy_decode_from_enc,
)
from semi_supervised_asr_tpu_torch.models.speller import (
    text_autoencoder_logits,
)
from semi_supervised_asr_tpu_torch.ops.edit_distance import (
    batched_edit_distance,
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
    denom: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (mean CE over valid tokens, per-token gold log-prob [B, U]).
    Smoothing spreads ``label_smoothing`` uniformly over the whole vocab.
    ``denom`` replaces the batch's own token count (a data-parallel rank
    divides its sum by the global batch's count)."""
    mask = token_mask(targets)
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold_lp = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (-(1.0 - label_smoothing) * gold_lp
               - label_smoothing * logp.mean(dim=-1))
    else:
        nll = -gold_lp
    if denom is None:
        denom = torch.clamp_min(mask.sum(), 1.0)
    return (nll * mask).sum() / denom, gold_lp


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                   denom: torch.Tensor | None = None) -> torch.Tensor:
    mask = token_mask(targets)
    correct = (torch.argmax(logits, dim=-1) == targets).float() * mask
    if denom is None:
        denom = torch.clamp_min(mask.sum(), 1.0)
    return correct.sum() / denom


# optax's numerically stable stand-in for log 0
LOG_EPSILON = -1e5


class _LogAddExp(torch.autograd.Function):
    """``torch.logaddexp`` whose gradient is JAX's: d out / d a =
    exp(a - out), so that a row whose loss sits near 1e5 (its frames
    cannot hold its labels) gets the reference's gradient too, not one
    rounded another way at that magnitude."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_nll(logits: torch.Tensor, valid: torch.Tensor, labels: torch.Tensor
            ) -> torch.Tensor:
    """optax's ``ctc_loss`` with blank PAD: logits [B, T, V] (float32),
    ``valid`` [B, T] bool frames, ``labels`` [B, N] right-padded with PAD
    -> per-row NLL [B]."""
    b, t, v = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    label_pad = labels == PAD
    labellens = n - label_pad.sum(dim=1)
    repeat = Fn.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    lp_phi = logprobs[:, :, PAD:PAD + 1].transpose(0, 1)        # [T, B, 1]
    one_hot = Fn.one_hot(labels.long(), v).float()               # [B, N, V]
    lp_emit = torch.bmm(logprobs, one_hot.transpose(1, 2)
                        ).transpose(0, 1)                        # [T, B, N]
    pad = (~valid).t()[:, :, None]                               # [T, B, 1]
    emit_eps = LOG_EPSILON * repeat
    phi_eps = LOG_EPSILON * (1.0 - repeat)
    phi = torch.full((b, n + 1), LOG_EPSILON, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), LOG_EPSILON, device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], _LogAddExp.apply(p[:, 1:], added)], dim=-1)

    for i in range(t):
        phi_in = update_phi(phi, emit + emit_eps)
        e, p = lp_emit[i], lp_phi[i]
        next_emit = _LogAddExp.apply(phi_in[:, :-1] + e, emit + e)
        next_phi = update_phi(phi_in + p, emit + p + phi_eps)
        emit = torch.where(pad[i], emit, next_emit)
        phi = torch.where(pad[i], phi, next_phi)
    last = update_phi(phi, emit)
    return -(last * Fn.one_hot(labellens, n + 1).float()).sum(dim=-1)


def ctc_labels(tokens: torch.Tensor) -> torch.Tensor:
    """EOS-terminated, PAD-padded tokens -> CTC labels (EOS is no acoustic
    unit: it becomes PAD)."""
    return torch.where(tokens == EOS, PAD, tokens)


def ctc_per_utt_nll(ctc, enc: torch.Tensor, enc_mask: torch.Tensor,
                    tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The CTC head's per-utterance NLL of ``tokens`` [B, U]
    (EOS-terminated, PAD-padded) over ``enc`` -> (nll [B], n_labels [B]
    float32); rows without labels report n_labels 0 and are weighted out by
    the callers."""
    labels = ctc_labels(tokens)
    nll = ctc_nll(ctc_head_logits(ctc, enc), enc_mask, labels)
    return nll, (labels != PAD).float().sum(dim=1)


def ctc_label_count(tokens: torch.Tensor) -> torch.Tensor:
    """The CTC labels of ``tokens`` (every token but EOS and PAD)."""
    return (ctc_labels(tokens) != PAD).float().sum()


def ctc_loss(ctc, enc: torch.Tensor, enc_mask: torch.Tensor,
             tokens: torch.Tensor,
             denom: torch.Tensor | None = None) -> torch.Tensor:
    """The joint CTC-attention term, token-normalized like the CE: rows
    without labels contribute nothing; ``denom`` replaces the batch's
    label count (a data-parallel rank's global one)."""
    nll, n_labels = ctc_per_utt_nll(ctc, enc, enc_mask, tokens)
    if denom is None:
        denom = torch.clamp_min(n_labels.sum(), 1.0)
    return (nll * (n_labels > 0).float()).sum() / denom


def ctc_family_loss(
    model,
    feats: torch.Tensor,
    feat_lens: torch.Tensor,
    tokens: torch.Tensor,
    real: torch.Tensor,
    backend: str | None = None,
    denom: torch.Tensor | None = None,
    remat: bool = False,
    masks: tuple | None = None,
) -> tuple:
    """The CTC family's supervised term: the label-normalized NLL of the
    real rows -> (loss, {"nll_per_label"}, enc, enc_mask: the pass's
    encoder output, which MWER reads); ``model`` is a ``CTCModel``,
    ``denom`` replaces the batch's label count, ``remat`` and ``masks``
    (the listener's) as in ``Seq2Seq.forward_teacher``."""
    enc_masks = masks[0] if masks is not None else None
    enc, enc_mask = model.encode(feats, feat_lens, backend, remat, enc_masks)
    nll, n_labels = ctc_per_utt_nll(model.ctc, enc, enc_mask, tokens)
    w = real.float() * (n_labels > 0).float()
    if denom is None:
        denom = torch.clamp_min((n_labels * w).sum(), 1.0)
    loss = (nll * w).sum() / denom
    return loss, {"nll_per_label": loss.detach()}, enc, enc_mask


def supervised_loss(
    model,
    label_smoothing: float,
    feats: torch.Tensor,
    feat_lens: torch.Tensor,
    tokens: torch.Tensor,
    tf_rate: float,
    gen: torch.Generator | None = None,
    backend: str | None = None,
    denom: torch.Tensor | None = None,
    remat: bool = False,
    rows: tuple[int, int, int] | None = None,
    masks: tuple | None = None,
    lambda_ctc: float = 0.0,
    ctc_denom: torch.Tensor | None = None,
) -> tuple:
    """Supervised CE on labeled (audio, text) pairs -> (loss, {"ce",
    "acc"}, and "ctc" with the joint CTC-attention term; enc, enc_mask: the
    pass's encoder output, which MWER reads); ``model`` is a
    ``Seq2Seq``.  ``denom`` replaces the batch's token count in the CE and
    the accuracy, ``remat`` recomputes the listener in the backward,
    ``rows`` places the batch in a global one, ``masks`` are the pass's
    dropout masks (``Seq2Seq.forward_teacher``: this pass trains, so it
    drops).  ``lambda_ctc`` > 0 adds that weight times :func:`ctc_loss` of
    the model's CTC head on the same encoder pass (``ctc_denom`` replacing
    the batch's label count)."""
    tokens_in, targets = shift_targets(tokens)
    logits, _, enc, enc_mask = model.forward_teacher(
        feats, feat_lens, tokens_in, tf_rate, gen, backend, remat, rows,
        masks, return_enc=True)
    loss, _ = masked_ce(logits, targets, label_smoothing, denom)
    aux = {"ce": loss.detach(),
           "acc": token_accuracy(logits.detach(), targets, denom)}
    if lambda_ctc > 0.0:
        if not hasattr(model, "ctc"):
            raise ValueError(
                "objective.lambda_ctc > 0 needs the CTC head (model.ctc_head; "
                "the Solver enables it automatically)")
        ctc = ctc_loss(model.ctc, enc, enc_mask, targets, ctc_denom)
        loss = loss + lambda_ctc * ctc
        aux["ctc"] = ctc.detach()
    return loss, aux, enc, enc_mask


def text_ae_loss(speller, label_smoothing: float,
                 text_tokens: torch.Tensor,
                 denom: torch.Tensor | None = None) -> torch.Tensor:
    """Text autoencoder: label-smoothed CE of unlabeled text ``[B, U]``
    (EOS-terminated, PAD-padded) reconstructed by the shared ``speller``
    over a zero context (``denom`` as in :func:`masked_ce`), without
    dropout, as the reference's pass runs."""
    tokens_in, targets = shift_targets(text_tokens)
    logits = text_autoencoder_logits(speller, tokens_in)
    loss, _ = masked_ce(logits, targets, label_smoothing, denom)
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


def pseudo_keep(hyps: torch.Tensor, hyp_logp: torch.Tensor,
                pseudo_confidence: float,
                row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The rows of the teacher's hypotheses the pseudo-label term keeps ->
    [B] bool: the mean of a hypothesis' per-token log-prob is >=
    log(``pseudo_confidence``) (0 keeps every row), and ``row_mask`` (the
    real rows) holds."""
    mask = token_mask(hyps)
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
    return keep


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
    denom: torch.Tensor | None = None,
    masks: tuple | None = None,
) -> torch.Tensor:
    """Pseudo-label consistency on unlabeled audio: the student ``model``
    at teacher-forcing rate 1 on the augmented view, CE against the
    ``teacher``'s greedy hypotheses on the clean view (no gradient reaches
    the teacher).  ``pseudo_confidence`` is an absolute probability
    threshold: an utterance is kept when the mean of its hypothesis'
    per-token log-prob is >= log(pseudo_confidence); 0 keeps every row.
    ``row_mask`` drops filler rows.  ``labels`` replaces the teacher's
    decode with given (hypotheses, log-probs), so that two runs of the
    student can be compared on the same targets.  ``denom`` replaces the
    kept-token count (a data-parallel rank's global one).  ``masks`` are
    the student's dropout masks (it trains; the teacher's decode never
    drops)."""
    hyps, hyp_logp = labels if labels is not None else teacher_labels(
        teacher, feats_clean, feat_lens, max_len, backend)
    tokens_in, targets = shift_targets(hyps)
    logits, _ = model.forward_teacher(feats_aug, feat_lens, tokens_in, 1.0,
                                      None, backend, masks=masks)
    mask = token_mask(targets)
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold_lp = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    nll = -gold_lp * mask
    keep_f = pseudo_keep(hyps, hyp_logp, pseudo_confidence,
                         row_mask).float()[:, None]
    if denom is None:
        denom = torch.clamp_min((mask * keep_f).sum(), 1.0)
    return (nll * keep_f).sum() / denom


def expected_risk(
    seq_logp: torch.Tensor,     # [B, K] total log-prob of each n-best hyp
    risks: torch.Tensor,        # [B, K] per-hypothesis risk
    row_weight: torch.Tensor,   # [B] 1.0 for live rows, 0.0 for the others
    denom: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MWER's expected risk (Prabhavalkar et al. 2018, arXiv:1712.01818)
    -> (loss, mean risk): ``E_p[risk - mean risk]`` under the n-best's
    renormalized posteriors p, the uniform mean subtracted (so equal risks
    give exactly 0); the gradient flows through ``seq_logp`` only.  Both
    are sums over the weighted rows divided by ``denom`` (default their
    weight, at least 1; a data-parallel rank's global count)."""
    p = torch.softmax(seq_logp.float(), dim=-1)
    risks = risks.detach().float()
    baseline = risks.mean(dim=-1, keepdim=True)
    per_row = (p * (risks - baseline)).sum(dim=-1)
    if denom is None:
        denom = torch.clamp_min(row_weight.sum(), 1.0)
    loss = (per_row * row_weight).sum() / denom
    mean_risk = ((p * risks).sum(dim=-1) * row_weight).sum() / denom
    return loss, mean_risk


def mwer_content(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tokens with the EOS made PAD (the EOS is no error unit) -> (those,
    their content lengths)."""
    content = torch.where(tokens == EOS, PAD, tokens)
    return content, (content != PAD).sum(dim=-1)


def mwer_count(tokens: torch.Tensor) -> torch.Tensor:
    """MWER's count before the clamp: the rows whose reference holds a
    token other than EOS and PAD (``mask_unreal`` empties the filler
    rows)."""
    return (mwer_content(tokens)[1] > 0).float().sum()


def nbest_risks(hyps: torch.Tensor, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The edit distance of each hypothesis [B, K, U] (its tokens before
    the PAD padding) to its row's reference ``tokens`` [B, U] with the EOS
    stripped -> (risks [B, K] int32, the rows' weights [B]: 1 where the
    reference is not empty)."""
    ref, ref_lens = mwer_content(tokens)
    risks = batched_edit_distance(hyps, (hyps != PAD).sum(dim=-1),
                                  ref[:, None, :], ref_lens[:, None])
    return risks, (ref_lens > 0).float()


@torch.no_grad()
def mwer_nbest(model, obj, enc: torch.Tensor, enc_mask: torch.Tensor,
               max_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The n-best the LAS family's MWER term rescores: the attention beam
    of ``obj.mwer_beam`` with length penalty 1 -> (tokens [B, K, max_len],
    scores [B, K]), best first."""
    from semi_supervised_asr_tpu_torch.config import DecodeConfig
    from semi_supervised_asr_tpu_torch.decode.beam import (
        beam_decode_from_enc,
    )

    speller = model.speller
    return beam_decode_from_enc(
        speller, DecodeConfig(beam_size=obj.mwer_beam, length_penalty=1.0),
        enc, enc_mask, speller.precompute_decode_cache(enc), max_len,
        return_nbest=True)


def mwer_loss_from_enc(
    model,
    obj,
    enc: torch.Tensor,          # [B, T', enc_out] (the supervised pass's)
    enc_mask: torch.Tensor,     # [B, T'] bool
    tokens: torch.Tensor,       # [B, U] gold (EOS-terminated, PAD-padded)
    denom: torch.Tensor | None = None,
    nbest: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimum-WER sequence training of the LAS family -> (expected-risk
    loss, mean n-best risk).  :func:`mwer_nbest` proposes the n-best on
    ``enc`` (``max_len`` U) under no gradient; one teacher-forced pass of
    the speller over the B*K rows (teacher forcing 1, no dropout) rescores
    them; the risks are edit distances to the gold tokens with EOS and PAD
    stripped.  ``model`` is a ``Seq2Seq``; ``denom`` as in
    :func:`expected_risk`; ``nbest`` gives the beam's (tokens [B, K, U],
    scores [B, K]) instead of running it."""
    b, u = tokens.shape
    k = obj.mwer_beam
    if nbest is None:
        nbest = mwer_nbest(model, obj, enc.detach(), enc_mask, u)
    hyps = nbest[0].to(tokens.dtype)
    tokens_in, targets = shift_targets(hyps.reshape(b * k, u))
    logits, _ = model.speller.forward_teacher(
        enc.repeat_interleave(k, dim=0), enc_mask.repeat_interleave(k, dim=0),
        tokens_in, 1.0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold_lp = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    seq_logp = (gold_lp * token_mask(targets)).sum(dim=1).reshape(b, k)
    # the EOS is no error unit
    risks, row_weight = nbest_risks(mwer_content(hyps)[0], tokens)
    return expected_risk(seq_logp, risks, row_weight, denom)


# The train step's view of the LAS family's terms, shared with
# ``ctc_semi.py`` and ``transducer_semi.py``: ``training/train_step.py``
# picks the family's module once.  ``den`` holds the step's clamped
# counts: supervised, text, pseudo, CTC labels, MWER rows.
TEXT_KEY = "text_ae"


def step_counts(cfg, tokens: torch.Tensor, real: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The labeled batch's counts -> (target tokens; CTC labels, 0 without
    the joint CTC term); ``tokens`` has its unreal rows masked."""
    aux = (ctc_label_count(tokens) if cfg.objective.lambda_ctc > 0.0
           else torch.zeros((), device=tokens.device))
    return token_mask(tokens).sum(), aux


def step_supervised(model, cfg, feats, feat_lens, tokens, real, tf_rate,
                    gen, backend, den, remat, rows, masks) -> tuple:
    """The supervised term of a step: :func:`supervised_loss` -> (loss,
    aux, enc, enc_mask)."""
    obj = cfg.objective
    return supervised_loss(model, obj.label_smoothing, feats, feat_lens,
                           tokens, tf_rate, gen, backend, den[0], remat,
                           rows, masks, obj.lambda_ctc, den[3])


def step_mwer(model, cfg, enc, enc_mask, tokens, denom, backend=None,
              nbest=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The MWER term of a step: :func:`mwer_loss_from_enc`."""
    return mwer_loss_from_enc(model, cfg.objective, enc, enc_mask, tokens,
                              denom, nbest)


def step_mwer_nbest(model, cfg, enc, enc_mask, max_len: int) -> tuple:
    """The n-best :func:`step_mwer` rescores: :func:`mwer_nbest`."""
    return mwer_nbest(model, cfg.objective, enc, enc_mask, max_len)


def text_count(text: torch.Tensor) -> torch.Tensor:
    """The text term's target count."""
    return token_mask(text).sum()


def step_text(model, cfg, text: torch.Tensor, denom: torch.Tensor,
              backend: str | None = None) -> torch.Tensor:
    """The text term of a step: :func:`text_ae_loss`."""
    return text_ae_loss(model.speller, cfg.objective.label_smoothing, text,
                        denom)


def step_teacher_labels(teacher, cfg, feats, feat_lens, max_len: int,
                        backend: str | None = None) -> tuple:
    """:func:`teacher_labels` of a step."""
    return teacher_labels(teacher, feats, feat_lens, max_len, backend)


def kept_count(labels: tuple, pseudo_confidence: float,
               row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The pseudo term's count before the clamp: the tokens of the rows
    :func:`pseudo_keep` keeps."""
    hyps, hyp_logp = labels
    keep = pseudo_keep(hyps, hyp_logp, pseudo_confidence, row_mask)
    return (token_mask(hyps) * keep[:, None]).sum()


def step_pseudo(model, cfg, feats_clean, feats_aug, feat_lens, max_len,
                row_mask, backend, labels, denom, masks) -> torch.Tensor:
    """The pseudo-label term of a step: :func:`pseudo_label_loss` on the
    given ``labels``."""
    return pseudo_label_loss(model, None, cfg.objective.pseudo_confidence,
                             feats_clean, feats_aug, feat_lens, max_len,
                             row_mask, backend, labels, denom, masks)
