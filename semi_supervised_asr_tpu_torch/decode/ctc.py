"""The CTC head and best-path decoding.

Counterpart of ``semi_supervised_asr_tpu/decode/ctc.py``
(``ctc_head_logits``, ``ctc_greedy_from_enc``, and the streaming
``ctc_greedy_stream_init`` / ``ctc_greedy_stream`` with the reference's
timestamps, ``track_frames``, and its biasing, ``bias``).
:func:`ctc_head_logits` is the one definition of the head's logits, shared by the loss, greedy decoding, the prefix beam and the
joint CTC-attention beam.  Best path: per-frame argmax, repeats collapsed,
blanks (PAD) dropped; the rows come out as the attention decoders' do,
tokens then EOS then PADs.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD
from semi_supervised_asr_tpu_torch.decode import biasing as BZ


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
                           track_frames: bool = False,
                           bias: bool = False) -> tuple:
    """The carry of :func:`ctc_greedy_stream`: (the previous path id [B],
    tokens [B, max_u], count [B], score [B]), and with ``track_frames``
    each token's first path frame [B, max_u] (-1 until written: streaming
    timestamps); with ``bias`` two trailing slots, the automaton state [B]
    and the running bias score [B] (committed + pending).  The previous id
    starts at PAD, which the collapse never keeps, so a real first token is
    never taken for a repeat."""
    base = (torch.zeros((b,), dtype=torch.int32, device=device),
            torch.full((b, max_u), PAD, dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.float32, device=device))
    if track_frames:
        base = base + (torch.full((b, max_u), -1, dtype=torch.int32,
                                  device=device),)
    if bias:
        base = base + (torch.zeros((b,), dtype=torch.int32, device=device),
                       torch.zeros((b,), dtype=torch.float32, device=device))
    return base


def ctc_greedy_stream(ctc, enc: torch.Tensor, enc_mask: torch.Tensor,
                      max_u: int, carry: tuple, frame_base: int = 0,
                      bias=None) -> tuple:
    """Best-path greedy as a resumable walk over the frames -> the new
    carry: the previous chunk's last path id decides whether this chunk's
    first frame repeats it, so chunked decoding is the whole utterance's.
    Emits at most ``max_u`` tokens.  A 5-tuple ``carry``
    (``ctc_greedy_stream_init(track_frames=True)``) also records each
    kept token's first path frame, ``frame_base`` (the encoder frames
    already walked) + its index in the chunk, so that the frames are the
    utterance's across chunks; the other slots are bitwise those of the
    4-tuple walk.

    ``bias`` (a :class:`~.biasing.BiasTrie`, with the carry of
    ``ctc_greedy_stream_init(bias=True)``): each frame's path id argmaxes
    the log-probs plus the automaton's delta on the emitting columns (the
    blank and the repeat stay 0: no emission, no transition).  The score
    slot keeps the model's log-prob of the chosen path, the bias slot sums
    the emitted tokens' deltas, and the final ranking subtracts the
    pending bonus, as the prefix beam does at K = 1."""
    n_bias = 2 if bias is not None else 0
    if len(carry) - n_bias not in (4, 5):
        raise ValueError("carry arity does not match (track_frames, bias) — "
                         "build it with ctc_greedy_stream_init("
                         "track_frames=..., bias=...)")
    track = len(carry) - n_bias == 5
    logits = ctc_head_logits(ctc, enc)
    logp = torch.log_softmax(logits, dim=-1)
    if bias is None:
        path = torch.argmax(logits, dim=-1).to(torch.int32)     # [B, T']
        lp_max = logp.max(dim=-1).values
    prev, out, count, score = carry[:4]
    frames = carry[4] if track else None
    if bias is not None:
        node, bsc = carry[-2:]
        cols = torch.arange(logp.shape[-1], device=enc.device)[None, :]
    slots = torch.arange(max_u, device=enc.device)[None, :]
    for i in range(enc.shape[1]):
        valid = enc_mask[:, i]
        if bias is None:
            p, lp_p = path[:, i], lp_max[:, i]
        else:
            lp = logp[:, i]
            no_emit = (cols == PAD) | (cols == prev[:, None])
            eff = torch.where(no_emit, 0.0, BZ.bias_delta(bias, node))
            p = torch.argmax(lp + eff, dim=-1).to(torch.int32)
            lp_p = torch.gather(lp, 1, p.long()[:, None])[:, 0]
            d_p = torch.gather(eff, 1, p.long()[:, None])[:, 0]
        emit = valid & (p != PAD) & (p != prev) & (count < max_u)
        slot = (slots == count[:, None]) & emit[:, None]
        out = torch.where(slot, p[:, None], out)
        if track:
            frames = torch.where(slot, int(frame_base) + i, frames)
        count = count + emit.to(torch.int32)
        prev = torch.where(valid, p, prev)
        score = score + torch.where(valid, lp_p, 0.0)
        if bias is not None:
            bsc = bsc + torch.where(emit, d_p, 0.0)
            node = torch.where(emit, BZ.bias_advance(bias, node, p), node)
    return ((prev, out, count, score) + ((frames,) if track else ())
            + ((node, bsc) if bias is not None else ()))
