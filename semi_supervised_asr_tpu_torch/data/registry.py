"""Dataset registry: name -> the training corpora and the vocab.

The PyTorch port's counterpart of ``semi_supervised_asr_tpu/data/
registry.py`` for what the train step reads: the labeled corpus and the
unlabeled audio and text, from ``synthetic`` (always available, seeded:
the unlabeled audio at ``synthetic_seed + 2``, the text at ``+ 3``) or
from the manifest corpora ``timit`` / ``librispeech`` that
``data/preprocess.py`` writes (``data.unlabeled_audio_split`` /
``unlabeled_text_split``, when set).  The dev and test splits (read by the
Solver's evaluation), the HDF5 feature store and BPE units are not ported
yet; the last two are refused with a message naming the key.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from semi_supervised_asr_tpu_torch.config import Config
from semi_supervised_asr_tpu_torch.data.synthetic import SyntheticDataset
from semi_supervised_asr_tpu_torch.data.vocab import (
    Vocab, char_vocab, timit_vocab,
)


@dataclass
class DataBundle:
    vocab: Vocab
    train: object
    unlabeled_audio: object | None = None
    unlabeled_text: object | None = None


def build_vocab(cfg: Config) -> Vocab:
    if cfg.data.unit == "phone":
        return timit_vocab(fold48=cfg.data.timit_fold48)
    if cfg.data.unit == "bpe":
        raise NotImplementedError(
            "data.unit='bpe' is not ported yet (the PyTorch port has the "
            "phone and char vocabs)"
        )
    return char_vocab()


def build_datasets(cfg: Config) -> DataBundle:
    d = cfg.data
    vocab = build_vocab(cfg)
    if d.dataset == "synthetic":
        n = d.num_synthetic_utts

        def seeded(offset):
            return dataclasses.replace(d, synthetic_seed=d.synthetic_seed
                                       + offset)

        return DataBundle(
            vocab=vocab,
            train=SyntheticDataset(vocab, d, cfg.frontend, n_utts=n),
            unlabeled_audio=SyntheticDataset(vocab, seeded(2), cfg.frontend,
                                             n_utts=n, labeled=False),
            unlabeled_text=SyntheticDataset(vocab, seeded(3), cfg.frontend,
                                            n_utts=n))
    if d.dataset in ("timit", "librispeech"):
        if d.use_feature_store:
            raise NotImplementedError(
                "data.use_feature_store=true is not ported yet (the PyTorch "
                "port reads raw audio through manifests)"
            )
        from semi_supervised_asr_tpu_torch.data.corpus import ManifestDataset

        def load(split):
            return ManifestDataset(f"{d.data_dir}/{split}.jsonl", vocab,
                                   prefer_i16=d.audio_i16_transfer)

        return DataBundle(
            vocab=vocab,
            train=load(d.labeled_split),
            unlabeled_audio=(load(d.unlabeled_audio_split)
                             if d.unlabeled_audio_split else None),
            unlabeled_text=(load(d.unlabeled_text_split)
                            if d.unlabeled_text_split else None))
    raise ValueError(f"unknown dataset {d.dataset!r}")
