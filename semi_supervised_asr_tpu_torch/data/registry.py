"""Dataset registry: name -> the corpora and the vocab.

The PyTorch port's counterpart of ``semi_supervised_asr_tpu/data/
registry.py``: the labeled training corpus, the dev split (read by the
Solver's validation), the test split (``--test``; None scores dev) and the
unlabeled audio and text, from ``synthetic`` (always available, seeded:
dev at ``synthetic_seed + 1`` with ``max(n // 4, 4)`` utterances, the
unlabeled audio at ``+ 2``, the text at ``+ 3``) or from the manifest
corpora ``timit`` / ``librispeech`` that ``data/preprocess.py`` writes
(``dev.jsonl``, ``data.test_split`` with a warning when its manifest is
missing, ``data.unlabeled_audio_split`` / ``unlabeled_text_split`` when
set).  The HDF5 feature store and BPE units are not ported yet and are
refused with a message naming the key.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path

from semi_supervised_asr_tpu_torch.config import Config
from semi_supervised_asr_tpu_torch.data.synthetic import SyntheticDataset
from semi_supervised_asr_tpu_torch.data.vocab import (
    Vocab, char_vocab, timit_vocab,
)


@dataclass
class DataBundle:
    vocab: Vocab
    train: object
    dev: object
    unlabeled_audio: object | None = None
    unlabeled_text: object | None = None
    test: object | None = None        # scored by --test; None -> dev


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
            dev=SyntheticDataset(vocab, seeded(1), cfg.frontend,
                                 n_utts=max(n // 4, 4)),
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

        def load_test():
            """data.test_split is read only by --test: a missing manifest
            warns instead of stopping a training run."""
            if not d.test_split:
                return None
            path = Path(d.data_dir) / f"{d.test_split}.jsonl"
            if not path.exists():
                print(f"WARNING: data.test_split={d.test_split!r} but "
                      f"{path} does not exist — --test will score dev; "
                      "add the split to preprocess --splits to fix")
                return None
            return load(d.test_split)

        return DataBundle(
            vocab=vocab,
            train=load(d.labeled_split),
            dev=load("dev"),
            test=load_test(),
            unlabeled_audio=(load(d.unlabeled_audio_split)
                             if d.unlabeled_audio_split else None),
            unlabeled_text=(load(d.unlabeled_text_split)
                            if d.unlabeled_text_split else None))
    raise ValueError(f"unknown dataset {d.dataset!r}")
