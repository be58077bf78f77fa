"""Contextual biasing (hotword / phrase boosting) for the decoders.

Counterpart of ``semi_supervised_asr_tpu/decode/biasing.py``: shallow-fusion
biasing with failure retraction (Zhao et al. 2019).  A phrase list earns a
per-token bonus while a hypothesis extends a prefix of some phrase; a
hypothesis that falls off the phrase trie before completing a phrase gives
back every bonus its partial match earned, so only completed phrases keep
their boost, while the transient bonus keeps their prefixes alive through
the beam's pruning.

The phrase set compiles on the host into dense arrays, and the decoders'
per-step work is two gathers:

* ``next_node [N, V] int32``: the Aho-Corasick-closed transitions (the
  fail links resolved at build time; root 0 is "no live match"), so a
  failed longer match falls to the longest suffix that is still a phrase
  prefix;
* ``retract [N] float32``: the pending (retractable) bonus at each state,
  ``bonus`` times the tokens since the match window's last completed
  phrase; 0 at the root and wherever a phrase completes (also through a
  suffix: a completion commits the whole window);
* ``gain [N] float32``: what entering a state is worth, ``bonus`` times
  (the parent's pending depth + 1), 0 for the root.

A candidate's delta is ``gain[next_node[s, y]] - retract[s]``: ``+bonus``
while the match extends, the retraction on a miss.  A hypothesis's
accumulated bias is its committed total plus ``retract[state]``, and the
final ranking subtracts ``retract[state]`` (:func:`bias_pending`).  PAD,
SOS and EOS fall to the root (no phrase holds them), so their column is
``-retract``: the EOS column retracts a hypothesis still mid-phrase.  The
reference's two documented deviations from per-occurrence accounting (an
overlap re-granted as pending, the window-scoped commit) hold here too.

``next_node`` is [N, V] int32 on the device, built once and shared by
every call and every stream.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD, SOS


class BiasTrie(NamedTuple):
    """The compiled phrase set, as tensors on one device."""

    next_node: torch.Tensor   # [N, V] int32, Aho-Corasick-closed
    retract: torch.Tensor     # [N] float32, pending (retractable) bonus
    gain: torch.Tensor        # [N] float32, score on entering a state
    bonus: torch.Tensor       # [] float32, the per-matched-token bonus

    def to(self, device) -> "BiasTrie":
        return BiasTrie(*(x.to(device) for x in self))


def build_bias_trie(phrases: Sequence[Sequence[int]], vocab_size: int,
                    bonus: float, device="cpu") -> BiasTrie:
    """Compile token-id phrases into the automaton's arrays on the host, as
    the reference's ``build_bias_trie`` builds them, then onto ``device``.
    Empty phrases are dropped and duplicates collapse; PAD, SOS, EOS or an
    id outside the vocabulary in a phrase raises ``ValueError``, as does a
    list left empty."""
    clean: list[tuple[int, ...]] = []
    seen: set[tuple[int, ...]] = set()
    for p in phrases:
        p = tuple(int(t) for t in p)
        if not p:
            continue
        for t in p:
            if t in (PAD, SOS, EOS) or not (0 <= t < vocab_size):
                raise ValueError(
                    f"bias phrase token {t} is not a decodable label "
                    f"(vocab_size={vocab_size}, specials "
                    f"PAD={PAD}/SOS={SOS}/EOS={EOS})")
        if p not in seen:
            seen.add(p)
            clean.append(p)
    if not clean:
        raise ValueError("bias phrase list is empty after filtering")

    # the trie
    nodes: list[dict[int, int]] = [{}]
    is_end, parent = [False], [0]
    for p in clean:
        cur = 0
        for t in p:
            if t not in nodes[cur]:
                nodes[cur][t] = len(nodes)
                nodes.append({})
                is_end.append(False)
                parent.append(cur)
            cur = nodes[cur][t]
        is_end[cur] = True

    # breadth first: fail links, suffix-closed phrase ends, pending depths
    n_nodes = len(nodes)
    fail = [0] * n_nodes
    out_closed = [False] * n_nodes
    pend = [0] * n_nodes
    order = [0]
    for s in order:
        for t, child in nodes[s].items():
            if s != 0:
                f = fail[s]
                while f != 0 and t not in nodes[f]:
                    f = fail[f]
                fail[child] = nodes[f].get(t, 0)
            out_closed[child] = is_end[child] or out_closed[fail[child]]
            pend[child] = 0 if out_closed[child] else pend[s] + 1
            order.append(child)

    # dense closed transitions (goto and fail resolved)
    nxt = np.zeros((n_nodes, vocab_size), np.int32)
    for t, child in nodes[0].items():
        nxt[0, t] = child
    for s in order[1:]:
        nxt[s] = nxt[fail[s]]
        for t, child in nodes[s].items():
            nxt[s, t] = child

    retract = np.asarray(pend, np.float32) * float(bonus)
    gain = np.zeros(n_nodes, np.float32)
    for s in order[1:]:
        gain[s] = (pend[parent[s]] + 1) * float(bonus)
    return BiasTrie(*(torch.from_numpy(a).to(device) for a in (
        nxt, retract, gain, np.asarray(float(bonus), np.float32))))


def load_bias_phrases(path: str, vocab) -> list[list[int]]:
    """A phrase file (one phrase a line, blank and ``#`` lines skipped),
    each line encoded with the run's vocab or BPE tokenizer."""
    out: list[list[int]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            out.append(vocab.encode_text(line, add_sos_eos=False))
    return out


def bias_delta(trie: BiasTrie, states: torch.Tensor) -> torch.Tensor:
    """``states [R]`` -> ``delta [R, V]`` float32: the bias term of each
    next token, ``gain[next_node[s, y]] - retract[s]``."""
    s = states.long()
    return trie.gain[trie.next_node[s].long()] - trie.retract[s][:, None]


def bias_advance(trie: BiasTrie, states: torch.Tensor,
                 toks: torch.Tensor) -> torch.Tensor:
    """The state after emitting ``toks [R]`` from ``states [R]``."""
    return trie.next_node[states.long(), toks.long()]


def bias_pending(trie: BiasTrie, states: torch.Tensor) -> torch.Tensor:
    """The pending bonus of each state: what the final ranking subtracts so
    that incomplete matches stay score-neutral."""
    return trie.retract[states.long()]


def bias_from_config(dcfg, vocab, device, log=print) -> BiasTrie | None:
    """The trie of ``decode.bias_phrases`` / ``decode.bias_bonus`` on
    ``device``, or None: the reference Solver's ``_bias``.  One key without
    the other logs that biasing is disabled; ``log`` takes the report of
    the phrases and trie nodes.  A phrase file that cannot be read raises
    ``FileNotFoundError`` naming the key."""
    if bool(dcfg.bias_phrases) != (dcfg.bias_bonus != 0.0):
        log("WARNING: contextual biasing needs BOTH decode.bias_phrases and "
            "a nonzero decode.bias_bonus — biasing DISABLED")
        return None
    if not dcfg.bias_phrases:
        return None
    try:
        phrases = load_bias_phrases(dcfg.bias_phrases, vocab)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"contextual biasing: decode.bias_phrases={dcfg.bias_phrases!r} "
            "is not a readable phrase file") from None
    trie = build_bias_trie(phrases, vocab.size, dcfg.bias_bonus, device)
    log(f"contextual biasing: {len(phrases)} phrases from "
        f"{dcfg.bias_phrases}, bonus {dcfg.bias_bonus} "
        f"({trie.next_node.shape[0]} trie nodes)")
    return trie
