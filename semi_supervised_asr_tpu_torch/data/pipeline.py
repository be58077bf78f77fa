"""Bucketed training batches and global CMVN statistics.

The PyTorch port's counterpart of the parts of ``semi_supervised_asr_tpu/
data/pipeline.py`` that the supervised train step needs: ``assemble_batch``
(audio padded to the frame bucket -- int16 PCM when
``data.audio_i16_transfer`` is set -- tokens PAD-padded to the token
bucket, a ``real`` mask for filler rows), ``compute_global_cmvn`` and a
simple seeded batcher over ``bucketing.plan_epoch``.  Prefetch threads,
resumable positions and the unlabeled streams wait for the Solver slice.
"""

from __future__ import annotations

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


def batches(dataset, spec: BucketSpec, batch_size: int, fcfg: FrontendConfig,
            seed: int) -> Iterator[Batch]:
    """Endless bucketed batches, epoch after epoch, each epoch shuffled from
    (seed, epoch); a bucket's last partial batch is filled by repeating its
    rows, which ``real`` marks as filler."""
    lengths = [(dataset.audio_len(i), dataset.token_len(i))
               for i in range(len(dataset))]
    epoch = 0
    while True:
        plan, _ = plan_epoch(lengths, spec, batch_size, seed, epoch,
                             drop_remainder=False)
        if not plan:
            raise ValueError(
                "no utterance fits the bucket grid: raise "
                "data.frame_buckets / data.token_buckets")
        for key, idxs, n_real in plan:
            yield assemble_batch(dataset, idxs, n_real, key, spec, fcfg)
        epoch += 1


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
