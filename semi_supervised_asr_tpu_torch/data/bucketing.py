"""Length bucketing: static (frames, tokens) buckets -> jit-stable shapes.

The reference pads each batch to its max length (dynamic shapes — fine for
torch, fatal for jit: SURVEY.md §3 #5, §8.3 risk 1).  Here every batch is
padded to one of a small static bucket grid, so the number of compiled
train/decode variants is bounded by ``len(frame_buckets) *
len(token_buckets)`` and the pyramid's divisibility constraint is enforced
at bucket-construction time.

The PyTorch port's own copy of ``semi_supervised_asr_tpu/data/bucketing.py``,
kept identical so that the port imports nothing of the JAX package
(tests hold the two against each other).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from semi_supervised_asr_tpu_torch.config import DataConfig, FrontendConfig


@dataclass(frozen=True)
class BucketSpec:
    frame_buckets: tuple[int, ...]     # ascending, divisible by time_reduction
    token_buckets: tuple[int, ...]     # ascending
    hop_length: int
    time_reduction: int
    # batches carry int16 audio (data.audio_i16_transfer): half the H2D
    # bytes; the device upcasts (train_step.featurize)
    audio_i16: bool = False
    # framing mode (frontend.center / n_fft): decides the exact
    # samples<->frames correspondence below
    center: bool = True
    n_fft: int = 512

    def samples_for_frames(self, frames: int) -> int:
        """Audio samples that produce exactly ``frames`` frames under the
        ACTIVE framing.  Centered (reflect-pad) framing yields
        ``1 + s//hop`` frames; VALID framing (frontend.center=false, the
        streaming configs) yields ``1 + (s - n_fft)//hop`` — ignoring
        the difference would make device T = bucket - ceil((n_fft-hop)/
        hop), which breaks the fused Pallas frontend's T%8 tiling and
        the pyramid's divisibility on real hardware."""
        if self.center:
            return (frames - 1) * self.hop_length
        return (frames - 1) * self.hop_length + self.n_fft

    def frames_for_samples(self, n_samples: int) -> int:
        if self.center:
            return 1 + n_samples // self.hop_length
        return max(1, 1 + (n_samples - self.n_fft) // self.hop_length)

    def frame_bucket(self, frames: int) -> int | None:
        for b in self.frame_buckets:
            if frames <= b:
                return b
        return None

    def token_bucket(self, n_tokens: int) -> int | None:
        for b in self.token_buckets:
            if n_tokens <= b:
                return b
        return None

    def assign(self, n_samples: int, n_tokens: int) -> tuple[int, int] | None:
        """-> (frame_bucket, token_bucket) or None if the utt is too long."""
        fb = self.frame_bucket(self.frames_for_samples(n_samples))
        tb = self.token_bucket(n_tokens)
        if fb is None or tb is None:
            return None
        return fb, tb


def make_bucket_spec(
    dcfg: DataConfig, fcfg: FrontendConfig, time_reduction: int
) -> BucketSpec:
    """Validate + round the configured buckets to the pyramid constraint."""
    rounded = []
    for b in dcfg.frame_buckets:
        r = ((b + time_reduction - 1) // time_reduction) * time_reduction
        rounded.append(r)
    assert list(rounded) == sorted(set(rounded)), (
        f"frame buckets must be strictly ascending after rounding: {rounded}"
    )
    toks = tuple(sorted(set(dcfg.token_buckets)))
    return BucketSpec(
        frame_buckets=tuple(rounded),
        token_buckets=toks,
        hop_length=fcfg.hop_length,
        time_reduction=time_reduction,
        audio_i16=dcfg.audio_i16_transfer,
        center=fcfg.center,
        n_fft=fcfg.n_fft,
    )


def bucket_batch_size(
    key: tuple[int, int], batch_size: int, batch_frames: int,
    granule: int = 1,
) -> int:
    """Per-bucket batch size under constant-frames batching
    (``data.batch_frames``): ~batch_frames // frame_bucket, rounded DOWN
    to a multiple of ``granule`` (the mesh's data-axis size, so every
    bucket's batch still shards evenly), min one granule.  With
    batch_frames <= 0 the fixed ``batch_size`` applies everywhere."""
    if batch_frames <= 0:
        return batch_size
    b = max(batch_frames // key[0], granule)
    return max((b // granule) * granule, granule)


def make_batch_sizer(batch_size: int, batch_frames: int, granule: int = 1):
    """int (fixed) or callable key->int (constant-frames) for plan_epoch."""
    if batch_frames <= 0:
        return batch_size
    return lambda key: bucket_batch_size(key, batch_size, batch_frames,
                                         granule)


def plan_epoch(
    lengths: list[tuple[int, int]],     # per-utt (n_samples, n_tokens)
    spec: BucketSpec,
    batch_size,                         # int | callable bucket_key -> int
    seed: int,
    epoch: int,
    drop_remainder: bool = True,
    sort_by_length: bool = False,
) -> tuple[list[tuple[tuple[int, int], list[int], int]], list[int]]:
    """Deterministic epoch plan.

    -> (list of (bucket_key, utt_indices, n_real) batches in randomized
        order, list of skipped utt indices).
    Every non-skipped utterance appears in exactly one batch as a *real*
    row (tested: no sample dropped or duplicated, SURVEY.md §5.2).  With
    ``drop_remainder=False`` short final chunks are padded by repeating
    their first rows; ``n_real`` marks how many leading rows are genuine.

    ``batch_size`` may be a callable ``bucket_key -> int`` (constant-
    frames batching, ``data.batch_frames`` — see make_batch_sizer); an
    int applies to every bucket.

    ``sort_by_length`` (SortaGrad, Amodei et al. 2015 — the era's warmup
    trick, ``data.sortagrad_epochs``): utterances visit ascending by audio
    length and batches run short-bucket-first instead of shuffled.
    """
    rng = np.random.default_rng((seed, epoch))
    by_bucket: dict[tuple[int, int], list[int]] = {}
    skipped: list[int] = []
    if sort_by_length:
        order = np.argsort([s for s, _ in lengths], kind="stable")
    else:
        order = rng.permutation(len(lengths))
    for i in order:
        key = spec.assign(*lengths[int(i)])
        if key is None:
            skipped.append(int(i))
            continue
        by_bucket.setdefault(key, []).append(int(i))

    batches: list[tuple[tuple[int, int], list[int], int]] = []
    for key, idxs in by_bucket.items():
        bs = batch_size(key) if callable(batch_size) else batch_size
        for s in range(0, len(idxs), bs):
            chunk = idxs[s : s + bs]
            n_real = len(chunk)
            if n_real < bs:
                if drop_remainder:
                    continue
                chunk = (chunk * ((bs // n_real) + 1))[:bs]
            batches.append((key, chunk, n_real))
    if sort_by_length:
        batches.sort(key=lambda b: b[0])   # short buckets first
        return batches, skipped
    # interleave buckets in random order (stable shuffling)
    perm = rng.permutation(len(batches))
    return [batches[int(p)] for p in perm], skipped
