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
the predictor's state, tokens, count, scores, and under LM fusion the
LM's state and next-label log-probabilities: the reference's carry), so
that chunked streaming searches as the whole utterance does.

Shallow LM fusion (``lm``, ``lm_weight`` > 0): a label emission also
scores ``lm_weight * log P_lm(label | prefix)``; a blank carries no LM term
(the LM models labels, not the alignment).  Each hypothesis' LM state and
next-label log-probabilities reorder with the beam and advance only where
it emits (the transformer LM's cache tracks each row's own depth).
``ilm_weight`` > 0 subtracts ``ilm_weight`` times the model's internal LM
(the predictor through the joint with the acoustics zeroed,
``objectives/transducer_semi.py::ilm_logits``, blank excluded) from every
label emission: the HAT / density-ratio correction.

Contextual biasing (``bias``, a :class:`~.biasing.BiasTrie`) rides label
emissions only (a blank is alignment, not a label): each hypothesis's trie
node reorders with the beam, the carried scores hold the bias with its
pending part, and the returned ranking subtracts that part.  The carry
then grows a trailing node slot.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.data.vocab import PAD, SOS
from semi_supervised_asr_tpu_torch.decode import biasing as BZ
from semi_supervised_asr_tpu_torch.models import lm as LM
from semi_supervised_asr_tpu_torch.models import transducer as TD
from semi_supervised_asr_tpu_torch.objectives.transducer_semi import (
    ilm_logits,
)

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
    lm=None,
    lm_weight: float = 0.0,
    ilm_weight: float = 0.0,
    bias=None,
):
    """-> (the best hypothesis' tokens [B, max_u] int32, PAD-padded, and
    its score [B]); with ``return_nbest`` ([B, K, max_u], [B, K]) every
    hypothesis, best first; with ``return_carry`` also the lattice that
    ``carry`` resumes (the best hypothesis may change between chunks):
    (pred, the predictor's state, tokens, count, scores), with the LM
    (lm_state, lm_lp), as the reference's carry, and with ``bias`` the
    trie nodes [B, K] last (its scores keep the pending bonus, which the
    returned scores retract)."""
    b, t, e = enc.shape
    k, v = beam_size, cfg.vocab_size
    dev = enc.device
    use_lm = lm is not None and lm_weight > 0.0
    if use_lm:
        LM.check_depth(lm, max_u, "transducer beam")

    def flat(x):                       # [B, K, ...] -> [B*K, ...]
        return x.reshape((b * k,) + x.shape[2:])

    def unflat(x):
        return x.reshape((b, k) + x.shape[1:])

    def gather_k(x, idx):
        """Reorder [B, K, ...] by per-row source indices [B, K]."""
        ix = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
        return torch.gather(x, 1, ix.expand((b, k) + x.shape[2:]))

    if carry is not None:
        pred, state, toks, count, scores = carry[:5]
        if use_lm:
            lm_state, lm_lp = carry[5:7]
        if bias is not None:
            bias_node = carry[-1]
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
        if use_lm:
            lm_state, lm_logits = LM.lm_step(
                lm, LM.lm_step(lm, None, None, init_batch=b * k)[0],
                torch.full((b * k,), SOS, dtype=torch.int32, device=dev))
            lm_lp = unflat(torch.log_softmax(lm_logits.float(), dim=-1))
        if bias is not None:
            bias_node = torch.zeros((b, k), dtype=torch.int32, device=dev)
    slots = torch.arange(max_u, device=dev)[None, None, :]
    row_base = (torch.arange(b, device=dev) * k)[:, None]        # [B, 1]

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
            if use_lm:
                emit_cand = emit_cand + lm_weight * lm_lp
            if ilm_weight > 0.0:
                il = ilm_logits(model.joint, flat(pred)[:, None, :])[:, 0]
                il[..., blank] = -1e30
                emit_cand = emit_cand - ilm_weight * unflat(
                    torch.log_softmax(il, dim=-1))
            if bias is not None:
                emit_cand = emit_cand + BZ.bias_delta(
                    bias, flat(bias_node)).view(b, k, v)
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
            if bias is not None:
                node_g = torch.gather(bias_node, 1, src)
                bias_node_n = torch.where(
                    is_emit, BZ.bias_advance(bias, flat(node_g),
                                             flat(tok)).view(b, k), node_g)
            if use_lm:
                lm_state_g = LM.reorder_rows(lm_state,
                                             (row_base + src).reshape(-1))
                new_lm_state, new_logits = LM.lm_step(lm, lm_state_g,
                                                      flat(tok))
                lm_lp_n = torch.where(
                    emit3,
                    unflat(torch.log_softmax(new_logits.float(), dim=-1)),
                    gather_k(lm_lp, src))
                lm_state_n = LM.where_rows(is_emit, new_lm_state,
                                           lm_state_g)
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
            if use_lm:
                lm_lp = torch.where(upd3, lm_lp_n, lm_lp)
                lm_state = LM.where_rows(upd.expand(b, k), lm_state_n,
                                         lm_state)
            if bias is not None:
                bias_node = torch.where(upd, bias_node_n, bias_node)
        # frame exit: the blank on every hypothesis that never froze
        lp = lp_now(pred, enc_tk)
        scores = torch.where(valid_t[:, None] & can_emit,
                             scores + lp[..., blank], scores)
    lattice = (pred, state, toks, count, scores)
    if use_lm:
        lattice += (lm_state, lm_lp)
    if bias is not None:
        lattice += (bias_node,)
        # hypotheses mid-phrase at the last frame give the bonus back
        scores = scores - BZ.bias_pending(bias, flat(bias_node)).view(b, k)
    if return_nbest and not return_carry:
        order_scores, order = top_k(scores, k)
        return gather_k(toks, order), order_scores
    best = torch.argmax(scores, dim=1)
    best_toks = torch.gather(
        toks, 1, best[:, None, None].expand(b, 1, max_u))[:, 0]
    best_score = torch.gather(scores, 1, best[:, None])[:, 0]
    if return_carry:
        return best_toks, best_score, lattice
    return best_toks, best_score
