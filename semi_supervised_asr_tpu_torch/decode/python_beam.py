"""Slow, plainly correct Python beam search: the test oracle of
``decode/beam.py``.

Counterpart of ``semi_supervised_asr_tpu/decode/python_beam.py`` over the
port's speller step: one utterance at a time, a list of hypotheses, one
speller call a hypothesis a step.  Tests hold the batched beam against it
(identical hypotheses and scores); nothing on the serving or training path
calls it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from semi_supervised_asr_tpu_torch.config import DecodeConfig
from semi_supervised_asr_tpu_torch.data.vocab import EOS, SOS


@dataclasses.dataclass
class Hyp:
    tokens: list
    score: float
    state: dict          # the speller's state, batch 1
    done: bool
    bias_node: int = 0   # the contextual-biasing trie node (root 0)

    @property
    def length(self) -> int:
        return len(self.tokens)


def ctc_prefix_oracle(logp: np.ndarray, y: list) -> tuple[float, float]:
    """The textbook per-frame CTC prefix dynamic program -> (psi, eos):
    ``psi`` the log-mass of the alignments whose collapse starts with
    ``y``, ``eos`` of those collapsing to exactly ``y``.  ``logp`` is [T, V]
    with the blank at 0 (pad frames already emitting the blank)."""
    neg = -1.0e30
    t_frames = logp.shape[0]

    def lse(a, b):
        return float(np.logaddexp(a, b))

    gn = [neg] * t_frames
    gb = []
    run = 0.0
    for t in range(t_frames):
        run += float(logp[t, 0])
        gb.append(run)
    psi = 0.0
    last = -1
    for c in y:
        gn_new, gb_new = [neg] * t_frames, [neg] * t_frames
        psi_c = neg
        for t in range(t_frames):
            gb_prev = gb[t - 1] if t else (0.0 if last == -1 else neg)
            gn_prev = gn[t - 1] if t else neg
            phi = gb_prev if c == last else lse(gb_prev, gn_prev)
            gn_new[t] = float(logp[t, c]) + (
                lse(phi, gn_new[t - 1]) if t else phi)
            gb_new[t] = float(logp[t, 0]) + (
                lse(gb_new[t - 1], gn_new[t - 1]) if t else neg)
            psi_c = lse(psi_c, phi + float(logp[t, c]))
        gn, gb, psi, last = gn_new, gb_new, psi_c, c
    return psi, lse(gn[-1], gb[-1])


@torch.inference_mode()
def beam_decode_python(
    speller,
    dcfg: DecodeConfig,
    enc: torch.Tensor,          # [1, T, enc_out]: one utterance
    enc_mask: torch.Tensor,     # [1, T] bool
    keys,                       # the speller's decode cache
    max_len: int,
    ctc_logp: np.ndarray | None = None,   # [1, T, V] masked CTC log-probs
    bias=None,                  # a biasing.BiasTrie, walked on the host
) -> tuple[list, float]:
    """-> (the best token list, EOS included; its normalized score) for
    one utterance.  ``ctc_logp`` with ``dcfg.ctc_weight`` > 0 and
    ``dcfg.ctc_one_pass`` mixes ``w`` times each candidate's change of
    :func:`ctc_prefix_oracle`'s score; one-pass decoding and ``bias``
    expand all V candidates (the exact search the batched beam's top-k over
    the mixed totals prunes), plain decoding the best K + 1."""
    k = dcfg.beam_size
    joint = (ctc_logp is not None and dcfg.ctc_weight > 0.0
             and dcfg.ctc_one_pass)
    w = dcfg.ctc_weight
    if bias is not None:
        bias_nxt = bias.next_node.cpu().numpy()
        bias_ret = bias.retract.cpu().numpy()
        bias_gain = bias.gain.cpu().numpy()

    def bias_step(node: int, tok: int) -> tuple[float, int]:
        nn = int(bias_nxt[node, tok])
        return float(bias_gain[nn]) - float(bias_ret[node]), nn

    state0 = speller.init_state(1, enc_mask, max_len)
    beams = [Hyp(tokens=[], score=0.0, state=state0, done=False)]
    for _ in range(max_len):
        candidates = []
        for hyp in beams:
            if hyp.done:
                candidates.append(hyp)       # frozen: carried unchanged
                continue
            prev = hyp.tokens[-1] if hyp.tokens else SOS
            state, logits, _ = speller.step(
                hyp.state, torch.tensor([prev], dtype=torch.int32,
                                        device=enc.device),
                keys, enc, enc_mask)
            logp = torch.log_softmax(logits.float(), dim=-1)[0].cpu().numpy()
            if joint:
                expand = range(1, logp.shape[-1])
                psi_parent, eos_parent = ctc_prefix_oracle(ctc_logp[0],
                                                           hyp.tokens)
            elif bias is not None:
                expand = range(1, logp.shape[-1])
            else:
                expand = (int(t) for t in np.argsort(-logp)[: k + 1])
            for tok in expand:
                tok = int(tok)
                if tok == 0:                 # PAD never extends a live hyp
                    continue
                gain = float(logp[tok])
                if joint:
                    if tok == EOS:
                        delta = eos_parent - psi_parent
                    else:
                        delta = ctc_prefix_oracle(
                            ctc_logp[0], hyp.tokens + [tok])[0] - psi_parent
                    gain = (1.0 - w) * gain + w * delta
                node = hyp.bias_node
                if bias is not None:
                    b_gain, adv = bias_step(hyp.bias_node, tok)
                    gain += b_gain
                    if tok != EOS:
                        node = adv
                candidates.append(Hyp(tokens=hyp.tokens + [tok],
                                      score=hyp.score + gain, state=state,
                                      done=tok == EOS, bias_node=node))
        candidates.sort(key=lambda h: -h.score)
        beams = candidates[:k]
        if all(h.done for h in beams):
            break
    if bias is not None:
        # as the batched beam: rows the step cap cut off retract their
        # pending bonus before the pick
        for h in beams:
            if not h.done:
                h.score -= float(bias_ret[h.bias_node])

    def norm(h: Hyp) -> float:
        return h.score / max(h.length, 1) ** dcfg.length_penalty

    finished = [h for h in beams if h.done] or beams
    best = max(finished, key=norm)
    return best.tokens, norm(best)
