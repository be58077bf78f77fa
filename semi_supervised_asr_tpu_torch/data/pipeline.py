"""Bucketed batches, the resumable streams and global CMVN statistics.

The PyTorch port's counterpart of ``semi_supervised_asr_tpu/data/
pipeline.py`` for the raw-audio path: ``assemble_batch`` (audio padded to
the frame bucket -- int16 PCM when ``data.audio_i16_transfer`` is set --
tokens PAD-padded to the token bucket, a ``real`` mask for filler rows),
``epoch_batches`` (one epoch of the seeded plan, fast-forwarded past
``start_batch`` batches at plan cost), ``repeating_batches`` (the endless
stream, labeled or not, with ``skip_batches``), ``text_batches`` (the
unlabeled text stream, with ``skip_batches``), ``epoch_batch_count`` and
``compute_global_cmvn``.  The streams shard as the reference's do:
``shard_index`` / ``num_shards`` stride the seeded plan (each rank takes
batches p, p + n, ...: the sharded evaluation), and ``row_shard=(r0, r1,
n_rows)`` keeps every batch of the global plan and assembles only the
rank's block of its rows (``_slice_rows``: the data-parallel training
streams, where every rank must see the same buckets at the same step).
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
    token_lens: np.ndarray     # [B] int32 (incl. EOS)
    real: np.ndarray           # [B] bool: False on filler rows
    bucket: tuple[int, int]    # (frame_bucket, token_bucket)
    uids: list


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
    token_lens = np.zeros((b,), np.int32)
    uids = []
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
        token_lens[r] = u
        uids.append(utt.uid)
    return Batch(audio, audio_lens, tokens, token_lens, np.arange(b) < n_real,
                 bucket, uids)


def rank_rows(b: int, row_shard: tuple[int, int, int],
              micro: int = 1) -> np.ndarray:
    """The positions of a rank's rows in a global batch of ``b`` rows.
    ``row_shard=(r0, r1, n_rows)`` is the rank's block of the data axis
    (``parallel.mesh.host_data_rows``); the batch is ``micro`` contiguous
    microbatches (``train.grad_accum``), and the rank holds its block of
    each, in blocks of ceil(m / n_rows) rows of a microbatch of m as GSPMD
    shards a batch axis (``parallel/dp.py::ceil_block``: the last blocks
    short, or empty), so that its i-th microbatch is its rows of the
    global i-th."""
    r0, r1, n_rows = row_shard
    if b % micro:
        raise ValueError(
            f"batch of {b} rows does not split into {micro} microbatches: "
            "train.batch_size (and each data.batch_frames batch) must divide "
            "by train.grad_accum")
    m = b // micro
    c = -(-m // n_rows)
    lo, hi = min(r0 * c, m), min(r1 * c, m)
    return np.concatenate([np.arange(i * m + lo, i * m + hi, dtype=np.int64)
                           for i in range(micro)])


def _slice_rows(
    idxs: list[int], n_real: int, row_shard: tuple[int, int, int] | None,
    micro: int = 1,
) -> tuple[list[int], np.ndarray]:
    """A rank's rows of a global plan batch (:func:`rank_rows`; all of them
    without ``row_shard``) -> (their dataset indices, their real mask).
    Real rows lead the global batch."""
    pos = (np.arange(len(idxs)) if row_shard is None
           else rank_rows(len(idxs), row_shard, micro))
    return [idxs[j] for j in pos], pos < n_real


_WARNED_DATASETS: set[int] = set()


def _warn_skipped(skipped: list[int], dataset) -> None:
    """Utterances longer than the largest (frame, token) bucket are
    skipped, not truncated: say so once per dataset per process."""
    if skipped and id(dataset) not in _WARNED_DATASETS:
        _WARNED_DATASETS.add(id(dataset))
        print(
            f"WARNING: {len(skipped)}/{len(dataset)} utterances exceed the "
            "largest bucket and are skipped every epoch — raise "
            "data.frame_buckets/token_buckets to cover them"
        )


def _audio_lengths(dataset) -> list[tuple[int, int]]:
    return [(dataset.audio_len(i), dataset.token_len(i))
            for i in range(len(dataset))]


def epoch_batch_count(
    lengths,
    spec: BucketSpec,
    batch_size: int,
    seed: int,
    epoch: int,
    shard_index: int = 0,
    num_shards: int = 1,
    drop_remainder: bool = True,
    sort_by_length: bool = False,
) -> int:
    """This shard's batches this epoch: the plan only, nothing assembled
    (how a resumed stream skips whole epochs)."""
    plan, _ = plan_epoch(lengths, spec, batch_size, seed, epoch,
                         drop_remainder, sort_by_length)
    return len(plan[shard_index::num_shards])


def epoch_batches(
    dataset,
    spec: BucketSpec,
    fcfg: FrontendConfig,
    batch_size: int,
    seed: int,
    epoch: int,
    shard_index: int = 0,
    num_shards: int = 1,
    drop_remainder: bool = True,
    sort_by_length: bool = False,
    start_batch: int = 0,
    row_shard: tuple[int, int, int] | None = None,
    micro: int = 1,
) -> Iterator[Batch]:
    """One epoch of bucketed batches, shuffled from (seed, epoch), or in
    ascending length with ``sort_by_length`` (SortaGrad).  ``batch_size``
    is an int or a bucket -> int function (``data.batch_frames``).
    ``start_batch`` skips the shard's first N batches without assembling
    them (exact mid-epoch resume).  Without ``drop_remainder`` a bucket's
    last partial batch is filled by repeating its rows, which ``real``
    marks as filler.  ``shard_index`` / ``num_shards`` take every n-th
    batch of the plan, ``row_shard`` the rank's rows of each, in ``micro``
    microbatches (``_slice_rows``)."""
    plan, skipped = plan_epoch(_audio_lengths(dataset), spec, batch_size,
                               seed, epoch, drop_remainder, sort_by_length)
    _warn_skipped(skipped, dataset)
    for bucket, idxs, n_real in plan[shard_index::num_shards][start_batch:]:
        idxs, real = _slice_rows(idxs, n_real, row_shard, micro)
        b = assemble_batch(dataset, idxs, len(idxs), bucket, spec, fcfg)
        b.real = real
        yield b


def _raise_empty_epoch(epoch: int) -> None:
    raise RuntimeError(
        f"epoch {epoch} produced ZERO batches: every utterance exceeds "
        "the bucket grid (data.frame_buckets/token_buckets) and/or fewer "
        "eligible rows than the batch size remain with "
        "data.drop_remainder=true — fix the bucket/batch config for this "
        "corpus"
    )


def repeating_batches(
    dataset,
    spec: BucketSpec,
    fcfg: FrontendConfig,
    batch_size: int,
    seed: int,
    shard_index: int = 0,
    num_shards: int = 1,
    drop_remainder: bool = True,
    start_epoch: int = 0,
    skip_batches: int = 0,
    row_shard: tuple[int, int, int] | None = None,
    micro: int = 1,
) -> Iterator[Batch]:
    """Endless stream: a new seeded shuffle every epoch.  ``skip_batches``
    fast-forwards past the first N yields at plan cost (a resumed
    semi-supervised run advances each unlabeled stream by the steps
    already taken).  Sharding as :func:`epoch_batches`."""
    skip = skip_batches
    lengths = _audio_lengths(dataset) if skip > 0 else None
    for epoch in itertools.count(start_epoch):
        if skip > 0:
            n = epoch_batch_count(lengths, spec, batch_size, seed, epoch,
                                  shard_index, num_shards, drop_remainder)
            if skip >= n:
                skip -= n
                continue
        yielded = False
        for b in epoch_batches(dataset, spec, fcfg, batch_size, seed, epoch,
                               shard_index, num_shards, drop_remainder,
                               start_batch=skip, row_shard=row_shard,
                               micro=micro):
            yielded = True
            yield b
        if not yielded:
            # skip < the epoch's batch count here, so an empty epoch means
            # the corpus / bucket / batch setting can never give a batch
            _raise_empty_epoch(epoch)
        skip = 0


def text_batches(
    dataset,
    token_bucket: int,
    batch_size: int,
    seed: int,
    shard_index: int = 0,
    num_shards: int = 1,
    skip_batches: int = 0,
    row_shard: tuple[int, int, int] | None = None,
    micro: int = 1,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Endless unlabeled-text stream: (tokens [B, U] int32, EOS-terminated
    and PAD-padded to ``token_bucket``; real [B] bool), each epoch a
    permutation from (seed, epoch); the last batch of an epoch is padded
    with all-PAD filler rows.  ``skip_batches`` fast-forwards without
    assembling; ``shard_index`` / ``num_shards`` stride the permutation,
    ``row_shard`` keeps the rank's rows of each batch (in ``micro``
    microbatches, :func:`rank_rows`)."""
    if len(dataset) == 0:
        raise ValueError("text_batches: the dataset is empty")
    skip = skip_batches
    for epoch in itertools.count():
        order = np.random.default_rng((seed, epoch, 17)).permutation(
            len(dataset))[shard_index::num_shards]
        if len(order) == 0:
            raise ValueError(
                "text_batches: dataset shard is empty (size "
                f"{len(dataset)}, shard {shard_index}/{num_shards})")
        n_epoch = (len(order) + batch_size - 1) // batch_size
        if skip >= n_epoch:
            skip -= n_epoch
            continue
        for s in range(skip * batch_size, len(order), batch_size):
            tokens = np.full((batch_size, token_bucket), PAD, np.int32)
            real = np.zeros((batch_size,), bool)
            for r, i in enumerate(order[s:s + batch_size]):
                t = dataset[int(i)].tokens
                u = min(len(t), token_bucket)
                tokens[r, :u] = t[:u]
                real[r] = True
            if row_shard is not None:
                pos = rank_rows(batch_size, row_shard, micro)
                tokens, real = tokens[pos], real[pos]
            yield tokens, real
        skip = 0


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
