"""CTC prefix beam search (Hannun et al. 2014), batched over a [B, K] lattice.

Counterpart of ``semi_supervised_asr_tpu/decode/ctc_beam.py``'s
``ctc_beam_from_enc``; ``carry`` / ``return_carry`` resume and return the
lattice, so that chunked streaming searches as the whole utterance does.
Frame-synchronous: every row of the lattice holds a label prefix with two
log-probabilities, ``pb`` (its paths ending in blank) and ``pnb`` (ending
in its last label), and each frame scores, for every live prefix, one STAY
candidate (blank, or its last label repeated) and V - 1 EXTEND candidates.
Exact prefix merging: where a row equals another row extended by v, that
extension's mass is merged into the row's stay and dropped from the extend
pool (Hannun's dict update restricted to the beam's prefixes).  The top K
of the stays and extends survive; ties go to the lower index, as
``lax.top_k`` breaks them.

Shallow LM fusion (``lm``, ``lm_weight`` > 0): a prefix ranks by ``log
P_ctc(prefix) + lm_weight * log P_lm(prefix)``.  The LM scores labels, not
alignments, so its score, state and next-label log-probabilities advance
only where a prefix is extended (blanks and repeats carry them); its state
leaves (lattice row on axis 1) reorder with the beam.  No EOS or length
term: every candidate of a frame has consumed the same audio.

Contextual biasing (``bias``, a :class:`~.biasing.BiasTrie`): each prefix
carries its trie node and running bias score (committed + pending), which
ride every candidate and advance only on extensions, as the LM does; the
final ranking subtracts each prefix's pending bonus.  The carry then grows
two trailing slots (node, bias score).

The rows come out PAD-padded with no EOS (the labels never hold PAD, and
EOS is a legal label class), so metrics read them to their first PAD.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import PAD, SOS
from semi_supervised_asr_tpu_torch.decode import biasing as BZ
from semi_supervised_asr_tpu_torch.decode.ctc import ctc_head_logits
from semi_supervised_asr_tpu_torch.models import lm as LM

NEG_INF = -1e30


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's log-add: -inf - -inf kept finite."""
    mx = torch.clamp_min(torch.maximum(a, b), NEG_INF)
    return mx + torch.log1p(torch.exp(torch.minimum(a, b) - mx))


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def ctc_beam_from_enc(
    ctc,
    enc: torch.Tensor,          # [B, T', e]
    enc_mask: torch.Tensor,     # [B, T'] bool
    max_u: int,
    beam_size: int = 4,
    return_nbest: bool = False,
    carry: tuple | None = None,
    return_carry: bool = False,
    lm=None,
    lm_weight: float = 0.0,
    bias=None,
):
    """-> (tokens [B, max_u] int32, PAD-padded, score [B]: the prefix's CTC
    log-marginal, every alignment pooled, plus ``lm_weight`` times its LM
    log-probability when ``lm`` fuses); ``return_nbest``: ([B, K, max_u],
    [B, K]) sorted by score; ``return_carry`` adds the lattice that
    ``carry`` resumes: (tokens, count, last, pb, pnb), with the LM
    (lm_score, lm_state, lm_lp), as the reference's carry, and with
    ``bias`` (its node, its bias score) last.  The score of a biased decode
    adds each prefix's bias, its pending part retracted."""
    b, t, _ = enc.shape
    k, blank, dev = beam_size, PAD, enc.device
    logp = torch.log_softmax(ctc_head_logits(ctc, enc), dim=-1)
    v = logp.shape[-1]
    use_lm = lm is not None and lm_weight > 0.0
    if use_lm:
        LM.check_depth(lm, max_u, "CTC beam")

    def unflat(x):
        return x.reshape((b, k) + x.shape[1:])

    if carry is not None:
        toks, count, last, pb, pnb = carry[:5]
        if use_lm:
            lm_score, lm_state, lm_lp = carry[5:8]
        if bias is not None:
            bias_node, bias_score = carry[-2:]
    else:
        toks = torch.full((b, k, max_u), PAD, dtype=torch.int32, device=dev)
        count = torch.zeros((b, k), dtype=torch.int32, device=dev)
        last = torch.full((b, k), blank, dtype=torch.int32, device=dev)
        # only row 0 is live: the empty prefix, all its mass ending in blank
        pb = torch.full((b, k), NEG_INF, device=dev)
        pb[:, 0] = 0.0
        pnb = torch.full((b, k), NEG_INF, device=dev)
        if use_lm:
            lm_score = torch.zeros((b, k), device=dev)
            lm_state, lm_logits = LM.lm_step(
                lm, LM.lm_step(lm, None, None, init_batch=b * k)[0],
                torch.full((b * k,), SOS, dtype=torch.int32, device=dev))
            lm_lp = unflat(torch.log_softmax(lm_logits.float(), dim=-1))
        if bias is not None:
            bias_node = torch.zeros((b, k), dtype=torch.int32, device=dev)
            bias_score = torch.zeros((b, k), device=dev)
    vocab = torch.arange(v, device=dev)
    upos = torch.arange(max_u, device=dev)
    row_base = (torch.arange(b, device=dev) * k)[:, None]        # [B, 1]

    def gather_k(x, idx):
        ix = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).long()
        return torch.gather(x, 1, ix.expand((b, k) + x.shape[2:]))

    for i in range(t):
        lp, valid_t = logp[:, i], enc_mask[:, i]          # [B, V], [B]
        live = (pb > NEG_INF / 2) | (pnb > NEG_INF / 2)
        tot = _logaddexp(pb, pnb)
        # stay: blank, or the last label repeated into the same labeling
        pb_stay = tot + lp[:, None, blank]
        lp_last = torch.gather(lp, 1, last.long())
        pnb_stay = torch.where(count > 0, pnb + lp_last, NEG_INF)
        # extend: prefix + v (a repeated label must cross a blank)
        la = torch.where(vocab[None, None, :] == last[..., None],
                         pb[..., None], tot[..., None])
        ext = lp[:, None, :] + la                          # [B, K, V]
        # exact prefix merge: parent[b, j, kk] = row j is row kk + last[j]
        eq = toks[:, :, None, :] == toks[:, None, :, :]    # [B, J, K, U]
        prefix_eq = (eq | (upos[None, None, None, :]
                           >= count[:, None, :, None])).all(dim=-1)
        parent = (prefix_eq
                  & (count[:, :, None] == count[:, None, :] + 1)
                  & live[:, :, None] & live[:, None, :])   # [B, J, K]
        ext_at_lastj = torch.gather(
            ext[:, None, :, :].expand(b, k, k, v), 3,
            last.long()[:, :, None, None].expand(b, k, k, 1))[..., 0]
        merged = torch.where(parent, ext_at_lastj, NEG_INF).max(dim=2).values
        pnb_stay = _logaddexp(pnb_stay, merged)
        onehot_last = vocab[None, None, :] == last[..., None]   # [B, J, V]
        remove = (parent[..., None]
                  & onehot_last[:, :, None, :]).any(dim=1)      # [B, K, V]
        # ranking totals
        stay_total = _logaddexp(pb_stay, pnb_stay)
        ext_total = ext
        if use_lm:
            stay_total = stay_total + lm_weight * lm_score
            ext_total = (ext_total + lm_weight * lm_score[..., None]
                         + lm_weight * lm_lp)
        stay_total = torch.where(live, stay_total, NEG_INF)
        if bias is not None:
            # the running bias rides every candidate; an extension adds the
            # delta of its label (blanks and repeats are alignment moves)
            bias_ext = BZ.bias_delta(bias, bias_node.reshape(-1)).view(b, k,
                                                                       v)
            stay_total = torch.where(live, stay_total + bias_score,
                                     stay_total)
            ext_total = ext_total + bias_score[..., None] + bias_ext
        ext_total = torch.where(
            live[..., None] & ~remove & (count[..., None] < max_u),
            ext_total, NEG_INF)
        ext_total[..., blank] = NEG_INF
        pool = torch.cat([stay_total, ext_total.reshape(b, k * v)], dim=1)
        _, top_idx = _top_k(pool, k)
        is_ext = top_idx >= k
        src = torch.where(is_ext, torch.div(top_idx - k, v,
                                            rounding_mode="floor"), top_idx)
        tok = torch.where(is_ext, (top_idx - k) % v, blank).to(torch.int32)

        toks_g = gather_k(toks, src)
        count_g = torch.gather(count, 1, src)
        last_g = torch.gather(last, 1, src)
        pb_g = torch.gather(pb_stay, 1, src)
        pnb_g = torch.gather(pnb_stay, 1, src)
        ext_mass_g = torch.gather(gather_k(ext, src), 2,
                                  tok.long()[..., None])[..., 0]
        toks_n = torch.where((upos[None, None, :] == count_g[..., None])
                             & is_ext[..., None], tok[..., None], toks_g)
        count_n = count_g + is_ext.to(torch.int32)
        last_n = torch.where(is_ext, tok, last_g)
        pb_n = torch.where(is_ext, NEG_INF, pb_g)
        pnb_n = torch.where(is_ext, ext_mass_g, pnb_g)
        if bias is not None:
            node_g = torch.gather(bias_node, 1, src)
            bsc_g = torch.gather(bias_score, 1, src)
            bias_tok = torch.gather(gather_k(bias_ext, src), 2,
                                    tok.long()[..., None])[..., 0]
            bias_score_n = torch.where(is_ext, bsc_g + bias_tok, bsc_g)
            bias_node_n = torch.where(
                is_ext, BZ.bias_advance(bias, node_g.reshape(-1),
                                        tok.reshape(-1)).view(b, k), node_g)
        if use_lm:
            # the LM advances on extensions only: the parents' state takes
            # the chosen label, kept where the row was extended
            lm_lp_g = gather_k(lm_lp, src)
            lm_score_g = torch.gather(lm_score, 1, src)
            lm_tok = torch.gather(lm_lp_g, 2, tok.long()[..., None])[..., 0]
            lm_score_n = torch.where(is_ext, lm_score_g + lm_tok, lm_score_g)
            lm_state_g = LM.reorder_rows(lm_state,
                                         (row_base + src).reshape(-1))
            new_lm_state, new_logits = LM.lm_step(lm, lm_state_g,
                                                  tok.reshape(-1))
            lm_lp_n = torch.where(
                is_ext[..., None],
                unflat(torch.log_softmax(new_logits.float(), dim=-1)),
                lm_lp_g)
            lm_state_n = LM.where_rows(is_ext, new_lm_state, lm_state_g)
        # padded frames leave every row as it was
        upd = valid_t[:, None]
        toks = torch.where(upd[..., None], toks_n, toks)
        count = torch.where(upd, count_n, count)
        last = torch.where(upd, last_n, last)
        pb = torch.where(upd, pb_n, pb)
        pnb = torch.where(upd, pnb_n, pnb)
        if use_lm:
            lm_score = torch.where(upd, lm_score_n, lm_score)
            lm_lp = torch.where(upd[..., None], lm_lp_n, lm_lp)
            lm_state = LM.where_rows(upd.expand(b, k), lm_state_n, lm_state)
        if bias is not None:
            bias_node = torch.where(upd, bias_node_n, bias_node)
            bias_score = torch.where(upd, bias_score_n, bias_score)

    scores = _logaddexp(pb, pnb)
    lattice = (toks, count, last, pb, pnb)
    if use_lm:
        scores = scores + lm_weight * lm_score
        lattice += (lm_score, lm_state, lm_lp)
    if bias is not None:
        # completed phrases keep their boost; a prefix mid-phrase at the
        # last frame gives the transient bonus back
        scores = scores + bias_score - BZ.bias_pending(
            bias, bias_node.reshape(-1)).view(b, k)
        lattice += (bias_node, bias_score)
    if return_nbest and not return_carry:
        order_scores, order = _top_k(scores, k)
        return gather_k(toks, order), order_scores
    best = torch.argmax(scores, dim=1)
    rows = torch.arange(b, device=dev)
    if return_carry:
        return toks[rows, best], scores[rows, best], lattice
    return toks[rows, best], scores[rows, best]
