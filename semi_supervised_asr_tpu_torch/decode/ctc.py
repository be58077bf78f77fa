"""The CTC head and best-path decoding.

Counterpart of ``semi_supervised_asr_tpu/decode/ctc.py``
(``ctc_head_logits``, ``ctc_greedy_from_enc``, and the streaming
``ctc_greedy_stream_init`` / ``ctc_greedy_stream`` with the reference's
timestamps, ``track_frames``; its biasing is not ported).
:func:`ctc_head_logits` is the one definition of the head's logits, shared by the loss, greedy decoding, the prefix beam and the
joint CTC-attention beam.  Best path: per-frame argmax, repeats collapsed,
blanks (PAD) dropped; the rows come out as the attention decoders' do,
tokens then EOS then PADs.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD


def ctc_head_logits(ctc, enc: torch.Tensor) -> torch.Tensor:
    """The CTC head (``ctc.w`` [e, V], ``ctc.b`` [V]) on ``enc`` [B, T', e]
    -> float32 logits [B, T', V], whatever the compute dtype."""
    return enc.float() @ ctc.w.float() + ctc.b.float()


def ctc_greedy_from_enc(ctc, enc: torch.Tensor, enc_mask: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens [B, T'] int32: the best path collapsed, then EOS, then
    PADs (no EOS when the path fills every frame), the best path's log-prob
    [B])."""
    logits = ctc_head_logits(ctc, enc)
    logp = torch.log_softmax(logits, dim=-1)
    path = torch.argmax(logits, dim=-1)                   # [B, T']
    path = torch.where(enc_mask, path, PAD)
    best_lp = (logp.max(dim=-1).values * enc_mask.float()).sum(dim=-1)
    b, t = path.shape
    prev = torch.cat([torch.full((b, 1), -1, dtype=path.dtype,
                                 device=path.device), path[:, :-1]], dim=1)
    keep = (path != PAD) & (path != prev)
    # compaction by a stable partition: kept frames first, in order
    pos = torch.arange(t, device=path.device)[None, :]
    order = torch.argsort(torch.where(keep, pos, t + pos), dim=1,
                          stable=True)
    compacted = torch.gather(torch.where(keep, path, PAD), 1, order)
    n_out = keep.sum(dim=1)
    widened = torch.cat([compacted, torch.full((b, 1), PAD, dtype=path.dtype,
                                               device=path.device)], dim=1)
    cols = torch.arange(t + 1, device=path.device)[None, :]
    out = torch.where(cols == n_out[:, None], EOS, widened)
    return out[:, :t].to(torch.int32), best_lp


def ctc_greedy_stream_init(b: int, max_u: int, device,
                           track_frames: bool = False) -> tuple:
    """The carry of :func:`ctc_greedy_stream`: (the previous path id [B],
    tokens [B, max_u], count [B], score [B]), and with ``track_frames``
    each token's first path frame [B, max_u] (-1 until written: streaming
    timestamps).  The previous id starts at PAD, which the collapse never
    keeps, so a real first token is never taken for a repeat."""
    base = (torch.zeros((b,), dtype=torch.int32, device=device),
            torch.full((b, max_u), PAD, dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.float32, device=device))
    if track_frames:
        base = base + (torch.full((b, max_u), -1, dtype=torch.int32,
                                  device=device),)
    return base


def ctc_greedy_stream(ctc, enc: torch.Tensor, enc_mask: torch.Tensor,
                      max_u: int, carry: tuple, frame_base: int = 0) -> tuple:
    """Best-path greedy as a resumable walk over the frames -> the new
    carry: the previous chunk's last path id decides whether this chunk's
    first frame repeats it, so chunked decoding is the whole utterance's.
    Emits at most ``max_u`` tokens.  A 5-tuple ``carry``
    (``ctc_greedy_stream_init(track_frames=True)``) also records each
    kept token's first path frame, ``frame_base`` (the encoder frames
    already walked) + its index in the chunk, so that the frames are the
    utterance's across chunks; the other slots are bitwise those of the
    4-tuple walk."""
    if len(carry) not in (4, 5):
        raise ValueError("carry arity does not match (track_frames, bias) — "
                         "build it with ctc_greedy_stream_init("
                         "track_frames=..., bias=...)")
    track = len(carry) == 5
    logits = ctc_head_logits(ctc, enc)
    path = torch.argmax(logits, dim=-1).to(torch.int32)     # [B, T']
    lp_max = torch.log_softmax(logits, dim=-1).max(dim=-1).values
    prev, out, count, score = carry[:4]
    frames = carry[4] if track else None
    slots = torch.arange(max_u, device=enc.device)[None, :]
    for i in range(enc.shape[1]):
        p, valid = path[:, i], enc_mask[:, i]
        emit = valid & (p != PAD) & (p != prev) & (count < max_u)
        slot = (slots == count[:, None]) & emit[:, None]
        out = torch.where(slot, p[:, None], out)
        if track:
            frames = torch.where(slot, int(frame_base) + i, frames)
        count = count + emit.to(torch.int32)
        prev = torch.where(valid, p, prev)
        score = score + torch.where(valid, lp_max[:, i], 0.0)
    return (prev, out, count, score) + ((frames,) if track else ())
