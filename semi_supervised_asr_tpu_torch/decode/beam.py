"""Batched attention beam search over a [B, K] lattice.

Counterpart of ``semi_supervised_asr_tpu/decode/beam.py``.  Encoder
outputs and the speller's decode
cache (the LSTM speller's key projections, the transformer speller's
cross K/V: a tensor or a dict of tensors, lattice row on axis 0) are tiled
to the K lattice rows once; each step scores all K*V continuations with
one batched speller step, keeps the top K per utterance, and
gather-reorders every decoder-state leaf and the token history.  Finished
rows are frozen: their only continuation is PAD at log-probability 0.  The
final pick is length-normalized, with optional GNMT coverage.

Joint CTC-attention decoding (``decode.ctc_weight`` w > 0 with the model's
CTC head): by default the K finished hypotheses are rescored, the final
pick maximizing the normalized ``(1 - w) att + w ctc`` (the CTC head's
log-likelihood of the hypothesis, ``objectives/losses.py::ctc_nll``);
with ``decode.ctc_one_pass`` every step mixes ``w`` times the change of
each candidate's CTC prefix score (``decode/ctc_prefix.py``) into its
score, the forward variables riding the lattice like any state leaf.

Shallow LM fusion (``lm``, an external LM of ``models/lm.py``): every step
adds ``decode.lm_weight`` times the LM's log-probabilities to the
continuation scores (Toshniwal et al. 2018), before the one-pass CTC mix;
the LM's state leaves (lattice row on axis 1) reorder with the beam, as
the speller's own ``lm_h`` / ``lm_c`` do under deep or cold fusion.  The
length normalization of the final pick is not scaled.

Contextual biasing (``bias``, a :class:`~.biasing.BiasTrie`): every step
adds the automaton's delta to each candidate, unscaled, after the LM and
the one-pass CTC mix; each hypothesis's trie node (one int32 a row) rides
the lattice like a state leaf and freezes when the row finishes.  EOS
retracts a mid-phrase hypothesis's pending bonus through the delta's EOS
column, and rows the step cap cut off retract theirs before the final
pick.  Under CTC rescoring the accumulated bias rides the attention
total, scaled by ``1 - w`` in the blend, as in the reference.

Ties are broken as ``lax.top_k`` does (lower flat index first) through a
stable descending sort; dead beams sit at exactly -1e30, so ties occur.
"""

from __future__ import annotations

import math

import torch

from semi_supervised_asr_tpu_torch.config import DecodeConfig
from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD, SOS
from semi_supervised_asr_tpu_torch.decode import biasing as BZ
from semi_supervised_asr_tpu_torch.decode import ctc_prefix as CP
from semi_supervised_asr_tpu_torch.decode.ctc import ctc_head_logits
from semi_supervised_asr_tpu_torch.models import lm as LM
from semi_supervised_asr_tpu_torch.objectives.losses import (
    ctc_labels, ctc_nll,
)

NEG_INF = -1e30


def tile_rows(x, k: int):
    """[B, ...] -> [B*K, ...], each row repeated K times; a dict of such
    tensors leaf by leaf."""
    if isinstance(x, dict):
        return {n: v.repeat_interleave(k, dim=0) for n, v in x.items()}
    return x.repeat_interleave(k, dim=0)


def ctc_rescore(ctc, enc: torch.Tensor, enc_mask: torch.Tensor,
                hyps: torch.Tensor) -> torch.Tensor:
    """The CTC head's log-likelihood of each hypothesis [B, K, U] (EOS then
    PADs) -> [B, K]: optax's CTC forward pass over the B*K rows."""
    b, k, u = hyps.shape
    logits = ctc_head_logits(ctc, enc)
    return -ctc_nll(tile_rows(logits, k), tile_rows(enc_mask, k),
                    ctc_labels(hyps).reshape(b * k, u)).reshape(b, k)


def beam_decode_from_enc(
    speller,
    dcfg: DecodeConfig,
    enc: torch.Tensor,        # [B, T, enc_out]
    enc_mask: torch.Tensor,   # [B, T] bool
    keys,                     # the speller's decode cache
    max_len: int,
    return_nbest: bool = False,
    ctc=None,
    lm=None,
    bias=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (best tokens [B, max_len] int32 (EOS then PADs), best score [B]);
    with ``return_nbest``: (all K lattices [B, K, max_len] sorted by
    normalized score, best first, and their scores [B, K]).  ``ctc`` (the
    model's CTC head) with ``dcfg.ctc_weight`` > 0 decodes jointly; ``lm``
    fuses shallowly at ``dcfg.lm_weight``; ``bias`` (a
    :class:`~.biasing.BiasTrie`) biases every step."""
    b, t = enc_mask.shape
    k = dcfg.beam_size
    dev = enc.device

    enc_k = enc.repeat_interleave(k, dim=0)
    mask_k = enc_mask.repeat_interleave(k, dim=0)
    keys_k = tile_rows(keys, k)

    use_ctc = ctc is not None and dcfg.ctc_weight > 0.0
    one_pass = use_ctc and dcfg.ctc_one_pass
    w = dcfg.ctc_weight
    if one_pass:
        ctc_logp_k = tile_rows(CP.masked_ctc_logp(
            ctc_head_logits(ctc, enc), enc_mask), k)        # [B*K, T, V]
        gn, gb = CP.prefix_init(ctc_logp_k)
        psi = torch.zeros((b, k), device=dev)              # log P(empty)
        empty = torch.ones((b * k,), dtype=torch.bool, device=dev)

    state = speller.init_state(b * k, mask_k, max_len)
    lm_state = None if lm is None else LM.lm_step(lm, None, None,
                                                  init_batch=b * k)[0]
    # only beam 0 is live at step 0 (identical rows would duplicate)
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    tok = torch.full((b * k,), SOS, dtype=torch.int32, device=dev)
    done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    hyps = torch.full((b, k, max_len), PAD, dtype=torch.int32, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    use_coverage = dcfg.coverage_weight != 0.0
    cum = torch.zeros((b * k, t), device=dev) if use_coverage else None
    if bias is not None:
        bias_state = torch.zeros((b * k,), dtype=torch.int32, device=dev)
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
        logp = torch.log_softmax(logits.float(), dim=-1)
        if lm is not None:
            lm_state, lm_logits = LM.lm_step(lm, lm_state, tok)
            logp = logp + dcfg.lm_weight * torch.log_softmax(
                lm_logits.float(), dim=-1)
        if one_pass:
            # every candidate mixes the change of its CTC prefix score; the
            # EOS column takes the finish score, PAD (frozen rows) 0
            psi_cand, eos_sc = CP.candidate_scores(gn, gb, ctc_logp_k, tok,
                                                   empty)
            psi_flat = psi.reshape(b * k)
            delta = psi_cand - psi_flat[:, None]
            delta[:, EOS] = eos_sc - psi_flat
            delta[:, PAD] = 0.0
            logp = (1.0 - w) * logp + w * delta
        if bias is not None:
            logp = logp + BZ.bias_delta(bias, bias_state)
        logp = logp.view(b, k, vsz)
        logp = torch.where(done[..., None], pad_only, logp + live_block)

        flat = (scores[..., None] + logp).view(b, k * vsz)
        sorted_scores, order = torch.sort(flat, dim=1, descending=True,
                                          stable=True)
        new_scores, flat_idx = sorted_scores[:, :k], order[:, :k]
        beam_idx = torch.div(flat_idx, vsz, rounding_mode="floor")  # [B, K]
        new_tok = (flat_idx % vsz).to(torch.int32)

        rows = (row_base + beam_idx).reshape(-1)                    # [B*K]
        state = {
            name: leaf.index_select(
                1 if name in speller.ROW_AXIS1 else 0, rows)
            for name, leaf in state_new.items()
        }
        if lm is not None:
            lm_state = LM.reorder_rows(lm_state, rows)
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
        done_new = done_g | (new_tok == EOS)

        if one_pass:
            # the parents' forward variables advanced by the chosen token;
            # rows frozen or just finished keep the parent's
            gn_g, gb_g = gn.index_select(0, rows), gb.index_select(0, rows)
            last_g, empty_g = tok.index_select(0, rows), \
                empty.index_select(0, rows)
            flat_tok = new_tok.reshape(b * k)
            gn_a, gb_a = CP.advance(gn_g, gb_g, ctc_logp_k, last_g, empty_g,
                                    flat_tok)
            adv = ~done_new.reshape(b * k) & (flat_tok != EOS)
            gn = torch.where(adv[:, None], gn_a, gn_g)
            gb = torch.where(adv[:, None], gb_a, gb_g)
            empty = empty_g & ~adv
            parent_cand = torch.gather(
                psi_cand.view(b, k, vsz), 1,
                beam_idx[..., None].expand(b, k, vsz))
            psi_sel = torch.gather(parent_cand, 2,
                                   new_tok.long()[..., None])[..., 0]
            psi = torch.where(adv.view(b, k), psi_sel,
                              torch.gather(psi, 1, beam_idx))

        if bias is not None:
            # the node follows the surviving row's token; finished rows
            # keep theirs (their score is final)
            bst_g = bias_state.index_select(0, rows)
            bias_state = torch.where(
                ~done_new.reshape(b * k),
                BZ.bias_advance(bias, bst_g, new_tok.reshape(b * k)), bst_g)

        done = done_new
        scores = new_scores
        tok = emit.reshape(b * k)

    if bias is not None:
        # rows the step cap cut off mid-phrase never met the EOS column's
        # retraction
        scores = scores - torch.where(
            done, 0.0, BZ.bias_pending(bias, bias_state).view(b, k))
    if use_ctc and not one_pass:
        scores = (1.0 - w) * scores + w * ctc_rescore(ctc, enc, enc_mask,
                                                      hyps)

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
