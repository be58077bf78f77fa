"""RNN-T beam search, alignment-synchronous with a fixed width.

Counterpart of ``semi_supervised_asr_tpu/decode/transducer_beam.py``
(``transducer_beam_from_enc``): the K hypotheses of a row consume the
encoder frames in lockstep, as dense [B, K] state.  Within a frame each
hypothesis may emit up to ``max_symbols`` labels; after each emission
round the K best of {the hypotheses as they stand, ending the frame on a
blank} and {every hypothesis extended by a label} survive (a top-k over
K + K*V candidates, ties to the lower index, as ``jax.lax.top_k`` breaks
them).  A frame ends by adding the blank's log-prob to every hypothesis
that never froze, so that complete paths all hold T' blanks and their raw
scores compare.  Equal prefixes reached along different alignments are not
merged (the reference's documented simplification); K=1 is the greedy
walk.  ``carry`` / ``return_carry`` resume and return the lattice (pred,
the predictor's state, tokens, count, scores: the reference's carry
without its LM slots), so that chunked streaming searches as the whole
utterance does.  LM fusion (``decode.lm_weight``, ``decode.ilm_weight``)
and biasing are not ported: the callers refuse them by name.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.data.vocab import PAD, SOS
from semi_supervised_asr_tpu_torch.models import transducer as TD

NEG_INF = -1e30


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of ``x`` [B, N] in descending
    order, equal values by ascending index (``jax.lax.top_k``'s order)
    -> (values [B, k], indices [B, k])."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def transducer_beam_from_enc(
    model,
    cfg: ModelConfig,
    enc: torch.Tensor,          # [B, T', E]
    enc_mask: torch.Tensor,     # [B, T'] bool
    max_u: int,
    beam_size: int = 4,
    max_symbols: int = 4,
    blank: int = PAD,
    return_nbest: bool = False,
    carry: tuple | None = None,
    return_carry: bool = False,
):
    """-> (the best hypothesis' tokens [B, max_u] int32, PAD-padded, and
    its score [B]); with ``return_nbest`` ([B, K, max_u], [B, K]) every
    hypothesis, best first; with ``return_carry`` also the lattice that
    ``carry`` resumes (the best hypothesis may change between chunks)."""
    b, t, e = enc.shape
    k, v = beam_size, cfg.vocab_size
    dev = enc.device

    def flat(x):                       # [B, K, ...] -> [B*K, ...]
        return x.reshape((b * k,) + x.shape[2:])

    def unflat(x):
        return x.reshape((b, k) + x.shape[1:])

    def gather_k(x, idx):
        """Reorder [B, K, ...] by per-row source indices [B, K]."""
        ix = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
        return torch.gather(x, 1, ix.expand((b, k) + x.shape[2:]))

    if carry is not None:
        pred, state, toks, count, scores = carry
    else:
        pred0, state0 = TD.predictor_step(
            model.predictor, torch.full((b * k,), SOS, dtype=torch.int32,
                                        device=dev),
            TD.predictor_init_state(cfg, b * k, dev), cfg)
        pred = unflat(pred0)                               # [B, K, P]
        state = tuple((unflat(h), unflat(c)) for h, c in state0)
        toks = torch.full((b, k, max_u), blank, dtype=torch.int32,
                          device=dev)
        count = torch.zeros((b, k), dtype=torch.int32, device=dev)
        # only hypothesis 0 is live at the start: K copies of the empty
        # prefix would fill the beam with duplicates
        scores = torch.full((b, k), NEG_INF, device=dev)
        scores[:, 0] = 0.0
    slots = torch.arange(max_u, device=dev)[None, None, :]

    def lp_now(pred, enc_tk):
        logits = TD.joint_row(model.joint, flat(enc_tk), flat(pred), cfg)
        return unflat(torch.log_softmax(logits, dim=-1))   # [B, K, V]

    for ti in range(t):
        enc_tk = enc[:, ti, None, :].expand(b, k, e)
        valid_t = enc_mask[:, ti]
        can_emit = torch.ones((b, k), dtype=torch.bool, device=dev)
        for _ in range(max_symbols):
            lp = lp_now(pred, enc_tk)
            freeze = torch.where(can_emit, scores + lp[..., blank], scores)
            emit_cand = scores[..., None] + lp                 # [B, K, V]
            emit_cand = torch.where(
                can_emit[..., None] & (count[..., None] < max_u),
                emit_cand, NEG_INF)
            emit_cand[..., blank] = NEG_INF
            pool = torch.cat([freeze, emit_cand.reshape(b, k * v)], dim=1)
            top_scores, top_idx = top_k(pool, k)
            is_emit = top_idx >= k
            src = torch.where(is_emit, torch.div(top_idx - k, v,
                                                 rounding_mode="floor"),
                              top_idx)
            tok = torch.where(is_emit, (top_idx - k) % v,
                              blank).to(torch.int32)
            pred_g = gather_k(pred, src)
            state_g = tuple((gather_k(h, src), gather_k(c, src))
                            for h, c in state)
            toks_g = gather_k(toks, src)
            count_g = torch.gather(count, 1, src)
            new_pred, new_state = TD.predictor_step(
                model.predictor, flat(tok),
                tuple((flat(h), flat(c)) for h, c in state_g), cfg)
            emit3 = is_emit[..., None]
            pred_n = torch.where(emit3, unflat(new_pred), pred_g)
            state_n = tuple(
                (torch.where(emit3, unflat(nh), h),
                 torch.where(emit3, unflat(nc), c))
                for (nh, nc), (h, c) in zip(new_state, state_g))
            toks_n = torch.where((slots == count_g[..., None]) & emit3,
                                 tok[..., None], toks_g)
            count_n = count_g + is_emit.to(torch.int32)
            upd = valid_t[:, None]
            upd3 = upd[..., None]
            scores = torch.where(upd, top_scores, scores)
            # a hypothesis that emitted may emit again; one that froze is
            # done with the frame
            can_emit = torch.where(upd, is_emit, can_emit)
            count = torch.where(upd, count_n, count)
            pred = torch.where(upd3, pred_n, pred)
            toks = torch.where(upd3, toks_n, toks)
            state = tuple((torch.where(upd3, hn, h), torch.where(upd3, cn, c))
                          for (hn, cn), (h, c) in zip(state_n, state))
        # frame exit: the blank on every hypothesis that never froze
        lp = lp_now(pred, enc_tk)
        scores = torch.where(valid_t[:, None] & can_emit,
                             scores + lp[..., blank], scores)
    if return_nbest and not return_carry:
        order_scores, order = top_k(scores, k)
        return gather_k(toks, order), order_scores
    best = torch.argmax(scores, dim=1)
    best_toks = torch.gather(
        toks, 1, best[:, None, None].expand(b, 1, max_u))[:, 0]
    best_score = torch.gather(scores, 1, best[:, None])[:, 0]
    if return_carry:
        return best_toks, best_score, (pred, state, toks, count, scores)
    return best_toks, best_score
