"""Subword (BPE) units: ``data.unit: bpe``.

Host copy of ``semi_supervised_asr_tpu/data/bpe.py``: byte-pair merges
learned over word types with incremental pair-count updates
(:func:`train_bpe`, ties broken lexicographically), a rank-greedy encoder,
and :class:`BPEVocab` with the surface of ``data.vocab.Vocab`` (``size``,
``encode_text``, ``decode_text``, ``decode``, ``save`` / ``load``, the
special ids first), so the corpora, the losses, the decoders and the
scoring take it as they take the char vocab.  Words carry the
sentencepiece marker "▁" on their first character.
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass
from pathlib import Path

from semi_supervised_asr_tpu_torch.data.vocab import (
    EOS, LIBRISPEECH_CHARS, SOS, SPECIALS, UNK,
)

WORD_MARK = "▁"  # "▁": glued to a word's first character


def _word_symbols(word: str) -> tuple[str, ...]:
    chars = list(word)
    chars[0] = WORD_MARK + chars[0]
    return tuple(chars)


def _pair_counts(words: dict[tuple[str, ...], int]) -> Counter:
    counts: Counter = Counter()
    for sym, freq in words.items():
        for a, b in zip(sym, sym[1:]):
            counts[(a, b)] += freq
    return counts


def _merge_word(sym: tuple[str, ...], pair: tuple[str, str]
                ) -> tuple[str, ...]:
    out, i = [], 0
    while i < len(sym):
        if i + 1 < len(sym) and (sym[i], sym[i + 1]) == pair:
            out.append(sym[i] + sym[i + 1])
            i += 2
        else:
            out.append(sym[i])
            i += 1
    return tuple(out)


def train_bpe(texts, vocab_size: int) -> "BPEVocab":
    """Learn merges until the vocab holds ``vocab_size`` units (specials,
    base symbols and merge products) or no pair repeats.  Deterministic:
    ties on count break lexicographically (the larger pair wins)."""
    word_freq: Counter = Counter()
    for text in texts:
        for w in text.lower().split():
            word_freq[w] += 1
    words = {_word_symbols(w): f for w, f in word_freq.items()}
    base = sorted({s for sym in words for s in sym})
    merges: list[tuple[str, str]] = []
    counts = _pair_counts(words)
    for _ in range(max(vocab_size - len(SPECIALS) - len(base), 0)):
        counts = +counts  # drop zero and negative entries
        if not counts:
            break
        pair, n = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
        if n < 2:
            break
        merges.append(pair)
        # only the word types holding the pair change
        affected = [(sym, f) for sym, f in words.items()
                    if pair in zip(sym, sym[1:])]
        for sym, f in affected:
            for a, b in zip(sym, sym[1:]):
                counts[(a, b)] -= f
            new = _merge_word(sym, pair)
            del words[sym]
            words[new] = words.get(new, 0) + f
            for a, b in zip(new, new[1:]):
                counts[(a, b)] += f
    pieces = base + ["".join(p) for p in merges]
    return BPEVocab(tokens=tuple(SPECIALS) + tuple(pieces),
                    merges=tuple(merges))


@dataclass(frozen=True)
class BPEVocab:
    """Subword vocab (``unit = "bpe"``): the specials, then the pieces."""

    tokens: tuple[str, ...]
    merges: tuple[tuple[str, str], ...]        # in learned rank order

    unit = "bpe"

    def __post_init__(self):
        if tuple(self.tokens[:4]) != tuple(SPECIALS):
            raise ValueError("specials must lead the BPE tokens")
        # every corpus read and every bucketing probe re-encodes: the
        # lookup tables are built once (the dataclass is frozen)
        object.__setattr__(self, "_stoi",
                           {t: i for i, t in enumerate(self.tokens)})
        object.__setattr__(self, "_rank",
                           {p: r for r, p in enumerate(self.merges)})

    @property
    def size(self) -> int:
        return len(self.tokens)

    def stoi(self) -> dict[str, int]:
        return self._stoi

    def encode_word(self, word: str) -> list[str]:
        """The word's pieces: the lowest-ranked merge first, repeatedly."""
        sym = list(_word_symbols(word))
        while len(sym) > 1:
            ranked = [(self._rank[p], i)
                      for i, p in enumerate(zip(sym, sym[1:]))
                      if p in self._rank]
            if not ranked:
                break
            _, i = min(ranked)
            sym[i:i + 2] = [sym[i] + sym[i + 1]]
        return sym

    def encode_text(self, text: str, add_sos_eos: bool = False) -> list[int]:
        ids = [self._stoi.get(piece, UNK) for w in text.lower().split()
               for piece in self.encode_word(w)]
        return [SOS, *ids, EOS] if add_sos_eos else ids

    def encode(self, units: list[str], add_sos_eos: bool = False
               ) -> list[int]:
        ids = [self._stoi.get(u, UNK) for u in units]
        return [SOS, *ids, EOS] if add_sos_eos else ids

    def decode(self, ids, strip_specials: bool = True) -> list[str]:
        out = []
        for i in ids:
            i = int(i)
            if i == EOS:
                break
            if strip_specials and i < len(SPECIALS):
                continue
            out.append(self.tokens[i])
        return out

    def decode_text(self, ids) -> str:
        return "".join(self.decode(ids)).replace(WORD_MARK, " ").strip()

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps({
            "tokens": list(self.tokens),
            "merges": [list(m) for m in self.merges],
            "unit": "bpe",
        }))

    @staticmethod
    def load(path: str | Path) -> "BPEVocab":
        d = json.loads(Path(path).read_text())
        if d.get("unit") != "bpe":
            raise ValueError(f"{path} is not a BPE vocab")
        return BPEVocab(tokens=tuple(d["tokens"]),
                        merges=tuple(tuple(m) for m in d["merges"]))


def default_bpe() -> BPEVocab:
    """The merge-free vocab of a run without a trained model (synthetic
    data): every LibriSpeech character and its word-initial form."""
    chars = [c for c in LIBRISPEECH_CHARS if c != " "]
    pieces = sorted(chars) + sorted(WORD_MARK + c for c in chars)
    return BPEVocab(tokens=tuple(SPECIALS) + tuple(pieces), merges=())
