"""Batched attention beam search over a [B, K] lattice.

Counterpart of ``semi_supervised_asr_tpu/decode/beam.py`` without LM
fusion, CTC scoring or biasing (those raise).  Encoder outputs and key
projections are tiled to the K lattice rows once; each step scores all
K*V continuations with one batched speller step, keeps the top K per
utterance, and gather-reorders every decoder-state leaf and the token
history.  Finished rows are frozen: their only continuation is PAD at
log-probability 0.  The final pick is length-normalized, with optional
GNMT coverage.

Ties are broken as ``lax.top_k`` does (lower flat index first) through a
stable descending sort; dead beams sit at exactly -1e30, so ties occur.
"""

from __future__ import annotations

import math

import torch

from semi_supervised_asr_tpu.config import DecodeConfig
from semi_supervised_asr_tpu.data.vocab import EOS, PAD, SOS
from semi_supervised_asr_tpu_torch.models.speller import Speller

NEG_INF = -1e30


def check_supported(dcfg: DecodeConfig) -> None:
    """Refuse decode options outside this slice with a clear message."""
    if dcfg.lm_weight != 0.0 or dcfg.lm_ckpt:
        raise NotImplementedError("shallow LM fusion is not ported yet")
    if dcfg.ctc_weight != 0.0:
        raise NotImplementedError("CTC rescoring is not ported yet")
    if dcfg.bias_phrases:
        raise NotImplementedError("contextual biasing is not ported yet")


def beam_decode_from_enc(
    speller: Speller,
    dcfg: DecodeConfig,
    enc: torch.Tensor,        # [B, T, enc_out]
    enc_mask: torch.Tensor,   # [B, T] bool
    keys: torch.Tensor,       # [B, T, A]
    max_len: int,
    return_nbest: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (best tokens [B, max_len] int32 (EOS then PADs), best score [B]);
    with ``return_nbest``: (all K lattices [B, K, max_len] sorted by
    normalized score, best first, and their scores [B, K])."""
    check_supported(dcfg)
    b, t = enc_mask.shape
    k = dcfg.beam_size
    dev = enc.device

    enc_k = enc.repeat_interleave(k, dim=0)
    mask_k = enc_mask.repeat_interleave(k, dim=0)
    keys_k = keys.repeat_interleave(k, dim=0)

    state = speller.init_state(b * k, mask_k)
    # only beam 0 is live at step 0 (identical rows would duplicate)
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    tok = torch.full((b * k,), SOS, dtype=torch.int32, device=dev)
    done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    hyps = torch.full((b, k, max_len), PAD, dtype=torch.int32, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    use_coverage = dcfg.coverage_weight != 0.0
    cum = torch.zeros((b * k, t), device=dev) if use_coverage else None
    row_base = (torch.arange(b, device=dev) * k)[:, None]        # [B, 1]
    # frozen rows: only PAD continues, at zero cost; live rows never PAD
    vsz = speller.cfg.vocab_size
    pad_only = torch.full((vsz,), NEG_INF, device=dev)
    pad_only[PAD] = 0.0
    live_block = torch.zeros((vsz,), device=dev)
    live_block[PAD] = NEG_INF

    for u in range(max_len):
        state_new, logits, alpha_new = speller.step(
            state, tok, keys_k, enc_k, mask_k
        )
        logp = torch.log_softmax(logits.float(), dim=-1).view(b, k, vsz)
        logp = torch.where(done[..., None], pad_only, logp + live_block)

        flat = (scores[..., None] + logp).view(b, k * vsz)
        sorted_scores, order = torch.sort(flat, dim=1, descending=True,
                                          stable=True)
        new_scores, flat_idx = sorted_scores[:, :k], order[:, :k]
        beam_idx = torch.div(flat_idx, vsz, rounding_mode="floor")  # [B, K]
        new_tok = (flat_idx % vsz).to(torch.int32)

        rows = (row_base + beam_idx).reshape(-1)                    # [B*K]
        state = {
            name: leaf.index_select(1 if name in ("h", "c") else 0, rows)
            for name, leaf in state_new.items()
        }
        done_g = torch.gather(done, 1, beam_idx)
        lens_g = torch.gather(lens, 1, beam_idx)
        hyps = hyps.view(b * k, max_len).index_select(0, rows).view(
            b, k, max_len)
        if use_coverage:
            live = (~done).reshape(b * k, 1).to(alpha_new.dtype)
            cum = (cum + alpha_new * live).index_select(0, rows)

        emit = torch.where(done_g, PAD, new_tok).to(torch.int32)
        hyps[:, :, u] = emit
        lens = torch.where(done_g, lens_g, lens_g + 1)    # counts incl. EOS
        done = done_g | (new_tok == EOS)
        scores = new_scores
        tok = emit.reshape(b * k)

    # length-normalized selection; a finished hypothesis wins whenever any
    # row finished
    norm_raw = scores / torch.clamp_min(lens.float(), 1.0) ** dcfg.length_penalty
    if use_coverage:
        capped = torch.clamp(cum.view(b, k, t), math.exp(-10.0), 1.0)
        cov = torch.sum(torch.log(capped) * enc_mask[:, None, :].float(), dim=-1)
        norm_raw = norm_raw + dcfg.coverage_weight * cov
    any_done = done.any(dim=1, keepdim=True)
    norm = torch.where(done | ~any_done, norm_raw,
                       torch.full((), NEG_INF, device=dev))
    if return_nbest:
        order = torch.sort(-norm, dim=1, stable=True).indices
        nbest = torch.gather(hyps, 1, order[..., None].expand(-1, -1, max_len))
        return nbest, torch.gather(norm, 1, order)
    best = torch.argmax(norm, dim=1)
    best_hyp = hyps[torch.arange(b, device=dev), best]
    return best_hyp, norm[torch.arange(b, device=dev), best]
