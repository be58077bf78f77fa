"""Greedy decoding for either speller.

Counterpart of ``semi_supervised_asr_tpu/decode/greedy.py``: a fixed
``max_len`` loop with a done mask; finished rows emit PAD.  ``keys`` is the
speller's decode cache (``precompute_decode_cache``).
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD, SOS


def greedy_decode_from_enc(
    speller,
    enc: torch.Tensor,        # [B, T, enc_out]
    enc_mask: torch.Tensor,   # [B, T] bool
    keys,                     # the speller's decode cache
    max_len: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens [B, max_len] int32 (EOS then PADs), logp [B, max_len])."""
    b, dev = enc.shape[0], enc.device
    state = speller.init_state(b, enc_mask, max_len)
    tok = torch.full((b,), SOS, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    toks, lps = [], []
    for _ in range(max_len):
        state, logits, _ = speller.step(state, tok, keys, enc, enc_mask)
        # PAD never continues a live hypothesis (same rule as the beam)
        logits[:, PAD] = -torch.inf
        logp = torch.log_softmax(logits.float(), dim=-1)
        nxt = torch.argmax(logits, dim=-1)
        nxt_lp = torch.gather(logp, 1, nxt[:, None])[:, 0]
        emit = torch.where(done, PAD, nxt).to(torch.int32)
        toks.append(emit)
        lps.append(torch.where(done, 0.0, nxt_lp))
        done = done | (nxt == EOS)
        tok = emit
    return torch.stack(toks, dim=1), torch.stack(lps, dim=1)
