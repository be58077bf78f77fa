"""Bucketed training batches, the unlabeled streams and global CMVN
statistics.

The PyTorch port's counterpart of the parts of ``semi_supervised_asr_tpu/
data/pipeline.py`` that the train step needs: ``assemble_batch`` (audio
padded to the frame bucket -- int16 PCM when ``data.audio_i16_transfer``
is set -- tokens PAD-padded to the token bucket, a ``real`` mask for
filler rows), ``repeating_batches`` (the endless seeded audio stream over
``bucketing.plan_epoch``, labeled or not), ``text_batches`` (the unlabeled
text stream) and ``compute_global_cmvn``.  Prefetch threads, resumable
positions (``skip_batches``) and sharding wait for the Solver and
data-parallel slices; the streams refuse those arguments.
"""

from __future__ import annotations

import itertools
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np

from semi_supervised_asr_tpu_torch.config import FrontendConfig
from semi_supervised_asr_tpu_torch.data.bucketing import (
    BucketSpec, plan_epoch,
)
from semi_supervised_asr_tpu_torch.data.vocab import PAD
from semi_supervised_asr_tpu_torch.ops import frontend_oracle as oracle


@dataclass
class Batch:
    """One fixed-shape training batch (host numpy)."""

    audio: np.ndarray          # [B, S] float32, or int16 PCM samples
    audio_lens: np.ndarray     # [B] int32
    tokens: np.ndarray         # [B, U] int32 (EOS-terminated, PAD-padded)
    real: np.ndarray           # [B] bool: False on filler rows
    bucket: tuple[int, int]    # (frame_bucket, token_bucket)


def assemble_batch(dataset, idxs: list[int], n_real: int,
                   bucket: tuple[int, int], spec: BucketSpec,
                   fcfg: FrontendConfig) -> Batch:
    """Rows ``idxs`` of ``dataset`` padded to ``bucket``, as the JAX
    pipeline pads them (float sources clip and round to the int16 grid when
    ``spec.audio_i16``)."""
    fb, tb = bucket
    s_len = spec.samples_for_frames(fb)
    b = len(idxs)
    audio = np.zeros((b, s_len), np.int16 if spec.audio_i16 else np.float32)
    audio_lens = np.zeros((b,), np.int32)
    tokens = np.full((b, tb), PAD, np.int32)
    for r, i in enumerate(idxs):
        utt = dataset[i]
        n = min(len(utt.audio), s_len)
        a = utt.audio[:n]
        if spec.audio_i16:
            if a.dtype != np.int16:
                a = np.clip(a.astype(np.float32), -1.0, 32767.0 / 32768.0)
                a = np.rint(a * 32768.0).astype(np.int16)
        elif a.dtype == np.int16:
            a = a.astype(np.float32) / 32768.0
        else:
            a = a.astype(np.float32)
        audio[r] = oracle.pad_for_batch(a, s_len, fcfg)
        audio_lens[r] = n
        u = min(len(utt.tokens), tb)
        tokens[r, :u] = utt.tokens[:u]
    return Batch(audio, audio_lens, tokens, np.arange(b) < n_real, bucket)


def _refuse_unported(skip_batches: int, shard_index: int, num_shards: int,
                     row_shard) -> None:
    if skip_batches or shard_index or num_shards != 1 or row_shard:
        raise NotImplementedError(
            "resumed or sharded streams (skip_batches, shard_index, "
            "num_shards, row_shard) are not ported yet: they wait for the "
            "Solver and data-parallel slices")


def repeating_batches(
    dataset,
    spec: BucketSpec,
    fcfg: FrontendConfig,
    batch_size: int,
    seed: int,
    shard_index: int = 0,
    num_shards: int = 1,
    drop_remainder: bool = True,
    skip_batches: int = 0,
    row_shard: tuple[int, int, int] | None = None,
) -> Iterator[Batch]:
    """Endless bucketed batches, epoch after epoch, each epoch shuffled from
    (seed, epoch).  Without ``drop_remainder`` a bucket's last partial
    batch is filled by repeating its rows, which ``real`` marks as
    filler."""
    _refuse_unported(skip_batches, shard_index, num_shards, row_shard)
    lengths = [(dataset.audio_len(i), dataset.token_len(i))
               for i in range(len(dataset))]
    for epoch in itertools.count():
        plan, _ = plan_epoch(lengths, spec, batch_size, seed, epoch,
                             drop_remainder)
        if not plan:
            raise ValueError(
                f"epoch {epoch} produced no batch: no utterance fits the "
                "bucket grid (raise data.frame_buckets / "
                "data.token_buckets), or fewer rows than the batch size "
                "remain with drop_remainder")
        for key, idxs, n_real in plan:
            yield assemble_batch(dataset, idxs, n_real, key, spec, fcfg)


def text_batches(
    dataset,
    token_bucket: int,
    batch_size: int,
    seed: int,
    shard_index: int = 0,
    num_shards: int = 1,
    skip_batches: int = 0,
    row_shard: tuple[int, int, int] | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Endless unlabeled-text stream: (tokens [B, U] int32, EOS-terminated
    and PAD-padded to ``token_bucket``; real [B] bool), each epoch a
    permutation from (seed, epoch); the last batch of an epoch is padded
    with all-PAD filler rows."""
    _refuse_unported(skip_batches, shard_index, num_shards, row_shard)
    if len(dataset) == 0:
        raise ValueError("text_batches: the dataset is empty")
    for epoch in itertools.count():
        order = np.random.default_rng((seed, epoch, 17)).permutation(
            len(dataset))
        for s in range(0, len(order), batch_size):
            tokens = np.full((batch_size, token_bucket), PAD, np.int32)
            real = np.zeros((batch_size,), bool)
            for r, i in enumerate(order[s:s + batch_size]):
                t = dataset[int(i)].tokens
                u = min(len(t), token_bucket)
                tokens[r, :u] = t[:u]
                real[r] = True
            yield tokens, real


def compute_global_cmvn(dataset, fcfg: FrontendConfig,
                        max_utts: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Global CMVN statistics of up to ``max_utts`` utterances (float64 on
    the host) -> (mean, inv_std) float32, as the JAX Solver computes them."""
    n = min(len(dataset), max_utts)
    count = 0
    s1 = s2 = 0.0
    for i in range(n):
        a = dataset[i].audio
        scale = 32768.0 if a.dtype == np.int16 else 1.0
        lm = oracle.log_mel(a.astype(np.float64) / scale, fcfg)
        s1 = s1 + lm.sum(axis=0)
        s2 = s2 + (lm ** 2).sum(axis=0)
        count += lm.shape[0]
    mean = s1 / count
    var = np.maximum(s2 / count - mean ** 2, 0.0)
    return (mean.astype(np.float32),
            (1.0 / np.sqrt(var + 1e-8)).astype(np.float32))
