"""CTC prefix beam search (Hannun et al. 2014), batched over a [B, K] lattice.

Counterpart of ``semi_supervised_asr_tpu/decode/ctc_beam.py``'s
``ctc_beam_from_enc`` without LM fusion or biasing; ``carry`` /
``return_carry`` resume and return the lattice, so that chunked streaming
searches as the whole utterance does.
Frame-synchronous: every row of the lattice holds a label prefix with two
log-probabilities, ``pb`` (its paths ending in blank) and ``pnb`` (ending
in its last label), and each frame scores, for every live prefix, one STAY
candidate (blank, or its last label repeated) and V - 1 EXTEND candidates.
Exact prefix merging: where a row equals another row extended by v, that
extension's mass is merged into the row's stay and dropped from the extend
pool (Hannun's dict update restricted to the beam's prefixes).  The top K
of the stays and extends survive; ties go to the lower index, as
``lax.top_k`` breaks them.

The rows come out PAD-padded with no EOS (the labels never hold PAD, and
EOS is a legal label class), so metrics read them to their first PAD.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import PAD
from semi_supervised_asr_tpu_torch.decode.ctc import ctc_head_logits

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
):
    """-> (tokens [B, max_u] int32, PAD-padded, score [B]: the prefix's CTC
    log-marginal, every alignment pooled); ``return_nbest``: ([B, K,
    max_u], [B, K]) sorted by score; ``return_carry`` adds the lattice
    (tokens, count, last, pb, pnb: the reference's carry without its LM
    slots) that ``carry`` resumes."""
    b, t, _ = enc.shape
    k, blank, dev = beam_size, PAD, enc.device
    logp = torch.log_softmax(ctc_head_logits(ctc, enc), dim=-1)
    v = logp.shape[-1]
    if carry is not None:
        toks, count, last, pb, pnb = carry
    else:
        toks = torch.full((b, k, max_u), PAD, dtype=torch.int32, device=dev)
        count = torch.zeros((b, k), dtype=torch.int32, device=dev)
        last = torch.full((b, k), blank, dtype=torch.int32, device=dev)
        # only row 0 is live: the empty prefix, all its mass ending in blank
        pb = torch.full((b, k), NEG_INF, device=dev)
        pb[:, 0] = 0.0
        pnb = torch.full((b, k), NEG_INF, device=dev)
    vocab = torch.arange(v, device=dev)
    upos = torch.arange(max_u, device=dev)

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
        stay_total = torch.where(live, _logaddexp(pb_stay, pnb_stay),
                                 NEG_INF)
        ext_total = torch.where(
            live[..., None] & ~remove & (count[..., None] < max_u), ext,
            NEG_INF)
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
        # padded frames leave every row as it was
        upd = valid_t[:, None]
        toks = torch.where(upd[..., None], toks_n, toks)
        count = torch.where(upd, count_n, count)
        last = torch.where(upd, last_n, last)
        pb = torch.where(upd, pb_n, pb)
        pnb = torch.where(upd, pnb_n, pnb)

    scores = _logaddexp(pb, pnb)
    if return_nbest and not return_carry:
        order_scores, order = _top_k(scores, k)
        return gather_k(toks, order), order_scores
    best = torch.argmax(scores, dim=1)
    rows = torch.arange(b, device=dev)
    if return_carry:
        return toks[rows, best], scores[rows, best], (toks, count, last, pb,
                                                       pnb)
    return toks[rows, best], scores[rows, best]
