"""RNN-T greedy decoding.

Counterpart of ``semi_supervised_asr_tpu/decode/transducer_greedy.py``
(``transducer_greedy_init``, ``transducer_greedy_from_enc``): the encoder
frames are walked in order, and at each frame up to ``max_symbols`` argmax
emissions are taken as masked [B] updates, so that every row finishes on
its own.  A row stops emitting at a blank, past its encoder length or when
its output buffer is full; slots never written stay PAD (the blank), which
scoring trims.  The score is the chosen path's log-probability, every
frame ending in its blank.  ``carry`` / ``return_carry`` resume and
return the walk's state, so that chunked streaming (``decode/streaming.py``)
walks the same path as the whole utterance.  ``track_frames`` also
records each token's emission frame (the family's timestamps, offline and
across streamed chunks).  ``bias`` (a :class:`~.biasing.BiasTrie`) biases
each emission decision, the reference's greedy biasing.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.data.vocab import PAD, SOS
from semi_supervised_asr_tpu_torch.decode import biasing as BZ
from semi_supervised_asr_tpu_torch.models import transducer as TD


def transducer_greedy_init(model, cfg: ModelConfig, b: int, max_u: int,
                           device, blank: int = PAD,
                           track_frames: bool = False,
                           bias: bool = False) -> tuple:
    """A fresh walk's state: (pred [B, P] after SOS, the predictor's state,
    tokens [B, max_u] all ``blank``, count [B], score [B]), with
    ``track_frames`` each token's emission frame [B, max_u] (-1 until
    written), and with ``bias`` a trailing automaton state [B] (the score
    slot then holds model + bias, the pending part not retracted, so that
    the walk resumes exactly)."""
    pred0, state0 = TD.predictor_step(
        model.predictor, torch.full((b,), SOS, dtype=torch.int32,
                                    device=device),
        TD.predictor_init_state(cfg, b, device), cfg)
    base = (pred0, state0,
            torch.full((b, max_u), blank, dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.float32, device=device))
    if track_frames:
        base = base + (torch.full((b, max_u), -1, dtype=torch.int32,
                                  device=device),)
    if bias:
        base = base + (torch.zeros((b,), dtype=torch.int32, device=device),)
    return base


def transducer_greedy_from_enc(
    model,
    cfg: ModelConfig,
    enc: torch.Tensor,          # [B, T', E]
    enc_mask: torch.Tensor,     # [B, T'] bool
    max_u: int,
    max_symbols: int = 4,
    blank: int = PAD,
    carry: tuple | None = None,
    return_carry: bool = False,
    track_frames: bool = False,
    frame_base: int = 0,
    bias=None,
):
    """-> (tokens [B, max_u] int32, PAD-padded; the path's total log-prob
    [B]), and with ``return_carry`` the walk's state (pred, the predictor's
    state, tokens, count, score) that a later call resumes from
    (``carry``, :func:`transducer_greedy_init`'s layout).
    ``track_frames`` also returns each token's emission frame ([B, max_u]
    int32, -1 past the count) in the third place, or with
    ``return_carry`` records them in the carry's sixth slot instead;
    ``frame_base`` (the encoder frames already walked) keeps them the
    utterance's across chunks.  Tokens and scores are bitwise those of
    the walk without frames.

    ``bias`` (with the carry of ``transducer_greedy_init(bias=True)``):
    each emission argmaxes the logits plus the automaton's delta, the blank
    column held at 0; the carried score sums model and bias, and the
    returned score subtracts the final pending bonus."""
    b, t, _ = enc.shape
    dev = enc.device
    n_bias = 1 if bias is not None else 0
    if carry is None:
        carry = transducer_greedy_init(model, cfg, b, max_u, dev, blank,
                                       track_frames, bias is not None)
    if track_frames and len(carry) != 6 + n_bias:
        raise ValueError("track_frames streaming needs the 6-tuple carry "
                         "from transducer_greedy_init(track_frames=True)"
                         + (" (+ the bias slot)" if n_bias else ""))
    if not track_frames and len(carry) != 5 + n_bias:
        raise ValueError("carry arity does not match (track_frames, bias) — "
                         "build it with transducer_greedy_init("
                         "track_frames=..., bias=...)")
    pred, state, out, count, score = carry[:5]
    frames = carry[5] if track_frames else None
    node = carry[-1] if n_bias else None
    slots = torch.arange(max_u, device=dev)[None, :]
    for ti in range(t):
        enc_t = enc[:, ti]
        emitting = enc_mask[:, ti]
        for _ in range(max_symbols):
            logits = TD.joint_row(model.joint, enc_t, pred, cfg)
            lp = torch.log_softmax(logits, dim=-1)
            if bias is not None:
                eff = BZ.bias_delta(bias, node)
                eff[:, blank] = 0.0
                tok = torch.argmax(logits + eff, dim=-1).to(torch.int32)
            else:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            emit = emitting & (tok != blank) & (count < max_u)
            chosen = torch.where(emit, tok, blank).long()
            score = score + torch.where(
                emitting, torch.gather(lp, 1, chosen[:, None])[:, 0], 0.0)
            if bias is not None:
                score = score + torch.where(
                    emit, torch.gather(eff, 1, tok.long()[:, None])[:, 0],
                    0.0)
                node = torch.where(emit, BZ.bias_advance(bias, node, tok),
                                   node)
            slot = (slots == count[:, None]) & emit[:, None]
            out = torch.where(slot, tok[:, None], out)
            if track_frames:
                frames = torch.where(slot, int(frame_base) + ti, frames)
            new_pred, new_state = TD.predictor_step(model.predictor, tok,
                                                    state, cfg)
            e2 = emit[:, None]
            pred = torch.where(e2, new_pred, pred)
            state = tuple((torch.where(e2, nh, h), torch.where(e2, nc, c))
                          for (nh, nc), (h, c) in zip(new_state, state))
            count = count + emit.to(torch.int32)
            emitting = emitting & emit
        # a row that spent every emission of the frame still owes its blank
        lp = torch.log_softmax(TD.joint_row(model.joint, enc_t, pred, cfg),
                               dim=-1)
        score = score + torch.where(emitting, lp[:, blank], 0.0)
    # the returned score retracts the pending bonus; the carry keeps it
    ret = score if bias is None else score - BZ.bias_pending(bias, node)
    if return_carry:
        return out, ret, (pred, state, out, count, score) + (
            (frames,) if track_frames else ()) + (
            (node,) if n_bias else ())
    if track_frames:
        return out, ret, frames
    return out, ret
