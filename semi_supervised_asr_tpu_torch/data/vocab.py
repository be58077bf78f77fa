"""Vocabulary / tokenizer: TIMIT phone sets (61->48->39 maps) and char vocab.

The reference scores TIMIT with the standard 61->39 phone collapse
(Lee & Hon 1989), applied at scoring time only; training uses the full
(possibly 48-phone-folded) inventory.  LibriSpeech uses a character vocab.
Special ids are fixed: <pad>=0, <sos>=1, <eos>=2, <unk>=3.

The PyTorch port's own copy of ``semi_supervised_asr_tpu/data/vocab.py``,
kept identical so that the port imports nothing of the JAX package
(tests hold the two against each other).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

PAD, SOS, EOS, UNK = 0, 1, 2, 3
SPECIALS = ["<pad>", "<sos>", "<eos>", "<unk>"]

# The 61 TIMIT phones (TIMITBET).
TIMIT_61 = [
    "aa", "ae", "ah", "ao", "aw", "ax", "ax-h", "axr", "ay", "b", "bcl",
    "ch", "d", "dcl", "dh", "dx", "eh", "el", "em", "en", "eng", "epi",
    "er", "ey", "f", "g", "gcl", "h#", "hh", "hv", "ih", "ix", "iy", "jh",
    "k", "kcl", "l", "m", "n", "ng", "nx", "ow", "oy", "p", "pau", "pcl",
    "q", "r", "s", "sh", "t", "tcl", "th", "uh", "uw", "ux", "v", "w",
    "y", "z", "zh",
]

# Standard 61 -> 39 scoring collapse (Lee & Hon 1989; 'q' is deleted).
TIMIT_61_TO_39 = {
    "aa": "aa", "ao": "aa",
    "ah": "ah", "ax": "ah", "ax-h": "ah",
    "er": "er", "axr": "er",
    "hh": "hh", "hv": "hh",
    "ih": "ih", "ix": "ih",
    "l": "l", "el": "l",
    "m": "m", "em": "m",
    "n": "n", "en": "n", "nx": "n",
    "ng": "ng", "eng": "ng",
    "sh": "sh", "zh": "sh",
    "uw": "uw", "ux": "uw",
    "sil": "sil", "pcl": "sil", "tcl": "sil", "kcl": "sil", "bcl": "sil",
    "dcl": "sil", "gcl": "sil", "h#": "sil", "pau": "sil", "epi": "sil",
    "q": None,  # deleted at scoring time
    # identity for the rest
    "ae": "ae", "aw": "aw", "ay": "ay", "b": "b", "ch": "ch", "d": "d",
    "dh": "dh", "dx": "dx", "eh": "eh", "ey": "ey", "f": "f", "g": "g",
    "iy": "iy", "jh": "jh", "k": "k", "ow": "ow", "oy": "oy", "p": "p",
    "r": "r", "s": "s", "t": "t", "th": "th", "uh": "uh", "v": "v",
    "w": "w", "y": "y", "z": "z",
}

TIMIT_39 = sorted({p for p in TIMIT_61_TO_39.values() if p is not None})

# Standard 61 -> 48 TRAINING fold (Lee & Hon 1989; the common recipe keeps
# ix/ax/el/en etc. as classes, unifies unvoiced/voiced closures into
# cl/vcl, folds h#/pau into sil, and deletes 'q').  Identity for phones
# not listed.
TIMIT_61_TO_48 = {
    "ao": "ao", "ax-h": "ax", "axr": "er", "ux": "uw",
    "em": "m", "nx": "n", "eng": "ng", "hv": "hh",
    "pcl": "cl", "tcl": "cl", "kcl": "cl",
    "bcl": "vcl", "dcl": "vcl", "gcl": "vcl",
    "h#": "sil", "pau": "sil",
    "q": None,  # deleted
}

TIMIT_48 = sorted({
    TIMIT_61_TO_48.get(p, p) for p in TIMIT_61
    if TIMIT_61_TO_48.get(p, p) is not None
})

# 48-class names that the 61->39 scoring map doesn't know (the unified
# closures score as silence).
_48_TO_39_EXTRA = {"cl": "sil", "vcl": "sil"}

LIBRISPEECH_CHARS = list("abcdefghijklmnopqrstuvwxyz' ")


@dataclass(frozen=True)
class Vocab:
    """Immutable token<->id map with fixed special ids.

    ``fold``: (src, dst|None) pairs applied at encode_text time (phone
    units) — the TIMIT 61->48 training fold; None deletes the phone.
    """

    tokens: tuple[str, ...]            # includes SPECIALS at the front
    unit: str                          # "phone" | "char"
    fold: tuple[tuple[str, str | None], ...] = ()

    def __post_init__(self):
        assert tuple(self.tokens[:4]) == tuple(SPECIALS), "specials must lead"

    @property
    def size(self) -> int:
        return len(self.tokens)

    def stoi(self) -> dict[str, int]:
        return {t: i for i, t in enumerate(self.tokens)}

    def encode(self, units: list[str], add_sos_eos: bool = False) -> list[int]:
        s = self.stoi()
        ids = [s.get(u, UNK) for u in units]
        return [SOS, *ids, EOS] if add_sos_eos else ids

    def encode_text(self, text: str, add_sos_eos: bool = False) -> list[int]:
        if self.unit == "char":
            return self.encode(list(text.lower()), add_sos_eos)
        units = text.split()
        if self.fold:
            fold = dict(self.fold)
            units = [
                m for u in units
                if (m := fold.get(u, u)) is not None
            ]
        return self.encode(units, add_sos_eos)

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
        toks = self.decode(ids)
        return "".join(toks) if self.unit == "char" else " ".join(toks)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps({
            "tokens": list(self.tokens), "unit": self.unit,
            "fold": [list(f) for f in self.fold],
        }))

    @staticmethod
    def load(path: str | Path) -> "Vocab":
        d = json.loads(Path(path).read_text())
        return Vocab(
            tokens=tuple(d["tokens"]), unit=d["unit"],
            fold=tuple(tuple(f) for f in d.get("fold", [])),
        )


def timit_vocab(fold48: bool = False) -> Vocab:
    """Training vocab: the full 61-phone inventory, or the standard
    48-class training fold (data.timit_fold48) — scoring is 39-class
    either way (timit_39_id_map)."""
    if fold48:
        return Vocab(
            tokens=tuple(SPECIALS + TIMIT_48), unit="phone",
            fold=tuple(sorted(TIMIT_61_TO_48.items())),
        )
    return Vocab(tokens=tuple(SPECIALS + TIMIT_61), unit="phone")


def char_vocab() -> Vocab:
    """LibriSpeech-style character vocab."""
    return Vocab(tokens=tuple(SPECIALS + LIBRISPEECH_CHARS), unit="char")


def collapse_timit_39(phones: list[str]) -> list[str]:
    """Apply the 61->39 scoring map; 'q' (and unknowns) are dropped."""
    out = []
    for p in phones:
        m = TIMIT_61_TO_39.get(p, p)
        if m is not None:
            out.append(m)
    return out


def timit_39_id_map(vocab: Vocab) -> list[int]:
    """Per-id map: train-vocab id -> 39-class id (-1 = delete at scoring).

    Used by the host-side scorer and by the vectorized C++ edit distance.
    """
    cls = {p: i for i, p in enumerate(TIMIT_39)}
    table = []
    for i, tok in enumerate(vocab.tokens):
        if i < len(SPECIALS):
            table.append(-1)
            continue
        m = TIMIT_61_TO_39.get(tok, _48_TO_39_EXTRA.get(tok, tok))
        table.append(-1 if m is None else cls[m])
    return table
