"""Dataset registry: name -> the labeled training corpus and the vocab.

The PyTorch port's counterpart of ``semi_supervised_asr_tpu/data/
registry.py`` for what the supervised train step reads: ``synthetic``
(always available, seeded) and the manifest corpora ``timit`` /
``librispeech`` that ``data/preprocess.py`` writes.  The dev and test
splits (read by the Solver's evaluation), the unlabeled streams, the HDF5
feature store and BPE units are not ported yet; the last two are refused
with a message naming the key.
"""

from __future__ import annotations

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
        return DataBundle(vocab=vocab, train=SyntheticDataset(
            vocab, d, cfg.frontend, n_utts=d.num_synthetic_utts))
    if d.dataset in ("timit", "librispeech"):
        if d.use_feature_store:
            raise NotImplementedError(
                "data.use_feature_store=true is not ported yet (the PyTorch "
                "port reads raw audio through manifests)"
            )
        from semi_supervised_asr_tpu_torch.data.corpus import ManifestDataset

        return DataBundle(vocab=vocab, train=ManifestDataset(
            f"{d.data_dir}/{d.labeled_split}.jsonl", vocab,
            prefer_i16=d.audio_i16_transfer))
    raise ValueError(f"unknown dataset {d.dataset!r}")
