"""CTC Viterbi forced alignment: token-level timestamps.

Counterpart of ``semi_supervised_asr_tpu/ops/ctc_align.py``
(``ctc_viterbi_align``): given the CTC head's frame log-posteriors and a
token sequence (a hypothesis or a reference), the best CTC path that
realizes the sequence, and each token's first and last occupied encoder
frame on it -- the timing behind ``transcribe --timestamps`` and
``align.py``.

The path runs over the blank-interleaved state graph (states s = 0..2U;
even: blank, odd: token (s-1)//2), one frame at a time with [B, S]
transitions: stay, advance one state, or skip a blank into a token that
differs from the one before it (CTC's repeated-token rule).  Each frame
keeps int8 backpointers [T, B, S]; ties among (stay, from1, from2) take the
first, as ``jnp.argmax`` does.  Frames at and after ``frame_lens`` freeze
the lattice (backpointer: stay), states past ``2 * token_lens`` stay at
-1e30.  A walk back from the end state (the better of the last blank and
the last token; state 0 for a row of no tokens) reads each frame's state.

A row whose frames cannot hold its path (the tokens plus the blanks forced
between repeats) comes back with ``path_logp = -inf`` and meaningless
frames; callers gate on finiteness.  Plain torch: the reference is an XLA
scan, not a Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from semi_supervised_asr_tpu_torch.data.vocab import PAD

NEG = -1e30      # -inf's stand-in, which survives sums without NaN


def ctc_viterbi_align(
    logp: torch.Tensor,         # [B, T, V] log-softmax CTC frame posteriors
    frame_lens: torch.Tensor,   # [B] valid encoder frames
    tokens: torch.Tensor,       # [B, U] token ids (no blank, no EOS)
    token_lens: torch.Tensor,   # [B] real token counts (<= U)
    blank: int = PAD,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (starts [B, U], ends [B, U] int32, path_logp [B] float32).

    ``starts`` / ``ends`` are the inclusive encoder frames each token
    occupies on the Viterbi path, -1 at and after ``token_lens`` (and for
    a token the path never enters)."""
    b, t_cap, _ = logp.shape
    u_cap = tokens.shape[1]
    dev = logp.device
    frame_lens = frame_lens.to(dev).long()
    token_lens = token_lens.to(dev).long()
    tokens = tokens.to(dev).long()
    if u_cap == 0:          # one PAD column: every row has U = 0
        tokens = torch.full((b, 1), PAD, dtype=torch.long, device=dev)
    uu = tokens.shape[1]
    s_cap = 2 * uu + 1
    s_idx = torch.arange(s_cap, device=dev)
    odd = (s_idx % 2) == 1
    tok_of_state = torch.clamp(torch.div(s_idx - 1, 2, rounding_mode="floor"),
                               0, uu - 1)
    # the label each state emits (the blank for even states)
    labels = torch.where(odd[None, :],
                         tokens[:, tok_of_state], blank)              # [B, S]
    prev_tok = tokens[:, torch.clamp(tok_of_state - 1, 0, uu - 1)]
    can_skip = (odd & (s_idx >= 2) & (tok_of_state >= 1))[None, :] \
        & (labels != prev_tok)
    state_ok = s_idx[None, :] <= 2 * token_lens[:, None]              # [B, S]
    emit = torch.gather(logp.float(), 2,
                        labels[:, None, :].expand(b, t_cap, s_cap))
    emit = emit.transpose(0, 1)                                       # [T, B, S]
    neg = torch.full((), NEG, device=dev)

    # frame 0: only state 0 (blank) and state 1 (the first token) start
    alpha = torch.where(
        (s_idx[None, :] <= torch.clamp_max(2 * token_lens, 1)[:, None])
        & state_ok, emit[0], neg)

    def shift(a: torch.Tensor, k: int) -> torch.Tensor:
        return Fn.pad(a, (k, 0), value=NEG)[:, :s_cap]

    zero_bp = torch.zeros((b, s_cap), dtype=torch.int8, device=dev)
    bps = [zero_bp]         # frame 0 has no backpointer
    for t in range(1, t_cap):
        stay = alpha
        from1 = shift(alpha, 1)
        from2 = torch.where(can_skip, shift(alpha, 2), neg)
        best = torch.maximum(stay, torch.maximum(from1, from2))
        # the first maximum of (stay, from1, from2)
        bp = torch.where((stay >= from1) & (stay >= from2), 0,
                         torch.where(from1 >= from2, 1, 2)).to(torch.int8)
        new = torch.where(state_ok, best + emit[t], neg)
        active = (t < frame_lens)[:, None]
        alpha = torch.where(active, new, alpha)
        bps.append(torch.where(active, bp, zero_bp))

    # the end state: the better of the last blank (2U) and the last token
    # (2U - 1); a row of no tokens ends (and starts) at state 0
    last_blank = 2 * token_lens
    last_tok = torch.clamp_min(last_blank - 1, 0)
    ab = torch.gather(alpha, 1, last_blank[:, None])[:, 0]
    at = torch.gather(alpha, 1, last_tok[:, None])[:, 0]
    has = token_lens > 0
    cur = torch.where(has & (at > ab), last_tok, last_blank)
    path_logp = torch.maximum(ab, torch.where(has, at, neg))
    path_logp = torch.where(path_logp <= NEG / 2, -torch.inf, path_logp)

    # the walk back: the state occupied at frame t, then t - 1's
    states = [None] * t_cap
    for t in range(t_cap - 1, -1, -1):
        states[t] = cur
        cur = cur - torch.gather(bps[t], 1, cur[:, None])[:, 0].long()
    states = torch.stack(states, dim=1)                   # [B, T]

    # token u occupies the frames where the path sits in state 2u + 1
    # (frozen frames at and after frame_lens replay the end state: out)
    frame = torch.arange(t_cap, device=dev)
    valid_t = frame[None, :] < frame_lens[:, None]
    occ = (states[:, :, None]
           == (2 * torch.arange(uu, device=dev) + 1)[None, None, :]) \
        & valid_t[:, :, None]                                 # [B, T, U]
    starts = torch.where(occ, frame[None, :, None], t_cap).amin(dim=1)
    ends = torch.where(occ, frame[None, :, None], -1).amax(dim=1)
    tok_valid = (torch.arange(uu, device=dev)[None, :] < token_lens[:, None]) \
        & occ.any(dim=1)
    starts = torch.where(tok_valid, starts, -1).to(torch.int32)[:, :u_cap]
    ends = torch.where(tok_valid, ends, -1).to(torch.int32)[:, :u_cap]
    return starts, ends, path_logp
