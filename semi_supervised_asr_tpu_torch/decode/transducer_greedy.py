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
across streamed chunks).  The reference's biasing (``bias``) is not
ported; its callers refuse it by name.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.data.vocab import PAD, SOS
from semi_supervised_asr_tpu_torch.models import transducer as TD


def transducer_greedy_init(model, cfg: ModelConfig, b: int, max_u: int,
                           device, blank: int = PAD,
                           track_frames: bool = False) -> tuple:
    """A fresh walk's state: (pred [B, P] after SOS, the predictor's state,
    tokens [B, max_u] all ``blank``, count [B], score [B]), and with
    ``track_frames`` each token's emission frame [B, max_u] (-1 until
    written)."""
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
    the walk without frames."""
    b, t, _ = enc.shape
    dev = enc.device
    if carry is None:
        carry = transducer_greedy_init(model, cfg, b, max_u, dev, blank,
                                       track_frames)
    if track_frames and len(carry) != 6:
        raise ValueError("track_frames streaming needs the 6-tuple carry "
                         "from transducer_greedy_init(track_frames=True)")
    if not track_frames and len(carry) != 5:
        raise ValueError("carry arity does not match (track_frames, bias) — "
                         "build it with transducer_greedy_init("
                         "track_frames=..., bias=...)")
    pred, state, out, count, score = carry[:5]
    frames = carry[5] if track_frames else None
    slots = torch.arange(max_u, device=dev)[None, :]
    for ti in range(t):
        enc_t = enc[:, ti]
        emitting = enc_mask[:, ti]
        for _ in range(max_symbols):
            logits = TD.joint_row(model.joint, enc_t, pred, cfg)
            lp = torch.log_softmax(logits, dim=-1)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            emit = emitting & (tok != blank) & (count < max_u)
            chosen = torch.where(emit, tok, blank).long()
            score = score + torch.where(
                emitting, torch.gather(lp, 1, chosen[:, None])[:, 0], 0.0)
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
    if return_carry:
        return out, score, (pred, state, out, count, score) + (
            (frames,) if track_frames else ())
    if track_frames:
        return out, score, frames
    return out, score
