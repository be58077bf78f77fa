"""Scoring: edit-distance PER / CER / WER.

The PyTorch port's copy of ``semi_supervised_asr_tpu/utils/metrics.py``.
TIMIT PER applies the 61->39 fold (vocab.timit_39_id_map) before the DP;
LibriSpeech WER splits characters into words.  The batched path goes
through the native C++ kernel (utils/native_ops.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from semi_supervised_asr_tpu_torch.data.vocab import (
    EOS, PAD, Vocab, timit_39_id_map,
)
from semi_supervised_asr_tpu_torch.utils import native_ops


def hyp_lengths(tokens: np.ndarray) -> np.ndarray:
    """Valid length of decoded rows: tokens before the first EOS/PAD."""
    tokens = np.asarray(tokens)
    b, u = tokens.shape
    lens = np.full(b, u, np.int32)
    for i in range(b):
        for j in range(u):
            if tokens[i, j] == EOS or tokens[i, j] == PAD:
                lens[i] = j
                break
    return lens


@dataclass
class ErrorRate:
    errors: int = 0
    total: int = 0

    def update(self, errors, total) -> None:
        self.errors += int(np.sum(errors))
        self.total += int(np.sum(total))

    @property
    def rate(self) -> float:
        return self.errors / max(self.total, 1)


def per_batch(
    hyps: np.ndarray, refs: np.ndarray, vocab: Vocab,
    hyp_lens: np.ndarray | None = None, ref_lens: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """TIMIT phone error counts with the 61->39 scoring fold.

    -> (edit distances [B], folded reference lengths [B]).
    """
    hyps, refs = np.asarray(hyps), np.asarray(refs)
    if hyp_lens is None:
        hyp_lens = hyp_lengths(hyps)
    if ref_lens is None:
        ref_lens = hyp_lengths(refs)
    table = np.asarray(timit_39_id_map(vocab), np.int32)
    return native_ops.batch_edit_distance(hyps, hyp_lens, refs, ref_lens, table)


def cer_batch(
    hyps: np.ndarray, refs: np.ndarray,
    hyp_lens: np.ndarray | None = None, ref_lens: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Character error counts (no fold; specials excluded via fold table
    that deletes ids < 4 and maps the rest to themselves)."""
    hyps, refs = np.asarray(hyps), np.asarray(refs)
    if hyp_lens is None:
        hyp_lens = hyp_lengths(hyps)
    if ref_lens is None:
        ref_lens = hyp_lengths(refs)
    vmax = int(max(hyps.max(initial=0), refs.max(initial=0))) + 1
    table = np.arange(max(vmax, 4), dtype=np.int32)
    table[:4] = -1
    return native_ops.batch_edit_distance(hyps, hyp_lens, refs, ref_lens, table)


def wer_strings(hyp_text: str, ref_text: str) -> tuple[int, int]:
    """Word-level edit distance on decoded text -> (errors, n_ref_words)."""
    h = hyp_text.split()
    r = ref_text.split()
    joint = {w: i for i, w in enumerate(dict.fromkeys(h + r))}
    a = np.asarray([joint[w] for w in h], np.int32).reshape(1, -1)
    b = np.asarray([joint[w] for w in r], np.int32).reshape(1, -1)
    if a.size == 0:
        return len(r), len(r)
    if b.size == 0:
        return len(h), 0
    d, _ = native_ops.batch_edit_distance(
        a, np.asarray([a.shape[1]], np.int32),
        b, np.asarray([b.shape[1]], np.int32),
    )
    return int(d[0]), len(r)


def wer_batch(
    hyps: np.ndarray, refs: np.ndarray, vocab: Vocab
) -> tuple[int, int]:
    """Decode char ids -> text -> word error counts. -> (errors, words)."""
    errs = words = 0
    for h, r in zip(np.asarray(hyps), np.asarray(refs)):
        e, w = wer_strings(vocab.decode_text(h), vocab.decode_text(r))
        errs += e
        words += w
    return errs, words
