"""Synthetic speech corpus with a learnable audio<->token mapping.

Where no real corpus is at hand (SURVEY.md §8.3 risk 6), every
acceptance gate has a synthetic variant: each vocabulary token is assigned a
unique two-tone signature, an utterance's audio is the concatenation of its
tokens' signatures (plus noise), and the transcript is the token sequence.
A seq2seq model can drive this to ~0 PER by attending to the tone segments —
the C1 overfit gate (BASELINE.json:7) runs on exactly this.

Deterministic under (seed, index): safe to re-generate identically across
hosts and epochs.

The PyTorch port's own copy of ``semi_supervised_asr_tpu/data/synthetic.py``,
kept identical so that the port imports nothing of the JAX package
(tests hold the two against each other).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from semi_supervised_asr_tpu_torch.config import DataConfig, FrontendConfig
from semi_supervised_asr_tpu_torch.data.vocab import SPECIALS, EOS, Vocab


@dataclass(frozen=True)
class Utterance:
    uid: str
    audio: np.ndarray          # float32 [S]
    tokens: np.ndarray         # int32 [U] — gold ids WITHOUT sos, WITH eos
    text: str


def _token_signature(
    token_id: int, n_samples: int, sample_rate: int
) -> np.ndarray:
    """Deterministic two-tone signature for a token id."""
    rng = np.random.default_rng(1000 + token_id)
    f1 = rng.uniform(200.0, 3800.0)
    f2 = rng.uniform(200.0, 3800.0)
    t = np.arange(n_samples) / sample_rate
    env = np.hanning(n_samples)
    return (0.5 * np.sin(2 * np.pi * f1 * t) + 0.3 * np.sin(2 * np.pi * f2 * t)) * env


# --------------------------------------------------------------------- #
# hard mode: a calibrated, NONZERO error floor (VERDICT r4 next #1)
#
# The deterministic per-char signatures above are acoustically trivial —
# every at-scale quality metric on corpora built from them saturates at
# 0.0000 (the r4 soak solved 104h of audio to dev WER 0.0 inside the
# first sixth of the run), so no at-scale quality claim is testable.
# ``difficulty`` in (0, 1] makes the acoustics genuinely ambiguous while
# keeping the task learnable and language-informative:
#
#   * CONFUSABLE LAYOUT: content chars are partitioned into groups of 3
#     sharing a base tone pair; within-group frequency offsets shrink
#     with difficulty (260 Hz at d→0 down to ~14 Hz at d=1 — inside one
#     mel bin of the 80-bin frontend).
#   * SPEAKER WARP: one multiplicative frequency factor per utterance
#     (log-sd 0.10·d).  At d≳0.7 the warp's wander exceeds the
#     within-group spacing, so a char's identity within its group is
#     not decidable from its own segment — the listener must jointly
#     infer the speaker and lean on LANGUAGE context, exactly the
#     structure semi-supervised objectives exploit on real speech.
#   * RATE JITTER: per-char duration factor U[1±0.35·d] — boundary
#     uncertainty, no fixed alignment grid.
#   * CHANNEL: per-utterance spectral tilt (amplitude ∝ (f/1kHz)^t,
#     t ~ U(±0.5·d)) and per-char amplitude jitter (log-sd 0.25·d).
#   * NOISE: white noise at a controlled SNR, 30 dB at d=0 down to
#     8 dB at d=1 (replaces the fixed tiny ``noise`` amplitude).
#
# All draws are deterministic under (seed, index); durations come from a
# SEPARATE stream so ``audio_len`` stays a cheap exact probe.  The
# difficulty→dev-WER calibration curve lives in experiments/README
# (experiments/calibrate_difficulty.py).
# --------------------------------------------------------------------- #

def hard_params(difficulty: float) -> dict:
    """The difficulty knob's derived acoustic parameters (documented so
    the calibration curve can cite exact values)."""
    d = float(difficulty)
    return {
        "group": 3,
        "spacing_hz": 260.0 * (1.0 - d) + 14.0,
        "warp_sd": 0.10 * d,
        "rate_jitter": 0.35 * d,
        "tilt_max": 0.5 * d,
        "amp_sd": 0.25 * d,
        "snr_db": 30.0 - 22.0 * d,
    }


@functools.lru_cache(maxsize=8)
def confusable_freqs(
    vocab_size: int, difficulty: float, group: int = 3
) -> np.ndarray:
    """[V, 2] per-char (f1, f2): groups of ``group`` consecutive content
    chars share a base pair; within-group offsets are ``spacing_hz``
    apart (0.65× on f2 so the pair does not collapse to one axis).
    Deterministic in (vocab_size, difficulty) only — every split speaks
    the same confusable language."""
    p = hard_params(difficulty)
    rng = np.random.default_rng((4242, vocab_size, group))
    freqs = np.zeros((vocab_size, 2))
    content = np.arange(len(SPECIALS), vocab_size)
    for g0 in range(0, len(content), group):
        base = rng.uniform(400.0, 3000.0, 2)
        for k, c in enumerate(content[g0:g0 + group]):
            freqs[c, 0] = base[0] + k * p["spacing_hz"]
            freqs[c, 1] = base[1] + k * p["spacing_hz"] * 0.65
    return freqs


def hard_audio_len(
    n_tok: int, dur_rng: np.random.Generator, base_seg: int,
    difficulty: float,
) -> int:
    """Exact sample count of :func:`hard_utterance_audio` for ``n_tok``
    chars — consumes the SAME dur_rng draws, so length probes never
    synthesize audio."""
    jit = hard_params(difficulty)["rate_jitter"]
    rates = dur_rng.uniform(1.0 - jit, 1.0 + jit, n_tok)
    return int(np.round(base_seg * rates).astype(np.int64).sum())


def hard_utterance_audio(
    content_ids: np.ndarray,
    acoustic_rng: np.random.Generator,
    dur_rng: np.random.Generator,
    sample_rate: int,
    base_seg: int,
    difficulty: float,
    vocab_size: int,
) -> np.ndarray:
    """One utterance's hard-mode waveform (float32, noise included)."""
    p = hard_params(difficulty)
    freqs = confusable_freqs(vocab_size, float(difficulty), p["group"])
    n_tok = len(content_ids)
    rates = dur_rng.uniform(1.0 - p["rate_jitter"], 1.0 + p["rate_jitter"],
                            n_tok)
    segs = np.round(base_seg * rates).astype(np.int64)
    warp = float(np.exp(acoustic_rng.normal(0.0, p["warp_sd"])))
    tilt = float(acoustic_rng.uniform(-p["tilt_max"], p["tilt_max"]))
    amps = np.exp(acoustic_rng.normal(0.0, p["amp_sd"], n_tok))
    pieces = []
    for cid, seg, amp in zip(content_ids, segs, amps):
        f1, f2 = freqs[int(cid)] * warp
        t = np.arange(seg) / sample_rate
        env = np.hanning(seg)
        a1 = 0.5 * (max(f1, 1.0) / 1000.0) ** tilt
        a2 = 0.3 * (max(f2, 1.0) / 1000.0) ** tilt
        pieces.append(amp * env * (
            a1 * np.sin(2 * np.pi * f1 * t)
            + a2 * np.sin(2 * np.pi * f2 * t)))
    audio = np.concatenate(pieces)
    rms = float(np.sqrt(np.mean(audio ** 2))) or 1.0
    noise_scale = rms * 10.0 ** (-p["snr_db"] / 20.0)
    audio = audio + noise_scale * acoustic_rng.standard_normal(len(audio))
    return audio.astype(np.float32)


@functools.lru_cache(maxsize=8)
def grammar_successors(vocab_size: int, branching: int) -> np.ndarray:
    """[V, branching] allowed-successor table of the sparse Markov grammar.

    Deterministic in (vocab_size, branching) only — labeled, unlabeled,
    and dev streams all speak the SAME language regardless of their
    per-stream seeds (that is the point: structure shared across streams
    is what semi-supervised terms can exploit).  Cached: rebuilding the
    table per utterance is V rng.choice calls (ADVICE r1); callers must
    not mutate the returned array."""
    rng = np.random.default_rng((97, vocab_size, branching))
    content = np.arange(len(SPECIALS), vocab_size)
    return np.stack([
        rng.choice(content, size=branching, replace=False)
        for _ in range(vocab_size)
    ])


def _sample_tokens(
    rng: np.random.Generator, vocab_size: int, n_tok: int, branching: int
) -> np.ndarray:
    if branching <= 0:
        return rng.integers(len(SPECIALS), vocab_size, n_tok).astype(np.int32)
    succ = grammar_successors(vocab_size, branching)
    ids = np.empty(n_tok, np.int32)
    ids[0] = rng.integers(len(SPECIALS), vocab_size)
    for i in range(1, n_tok):
        ids[i] = succ[ids[i - 1], rng.integers(branching)]
    return ids


def make_utterance(
    index: int,
    vocab: Vocab,
    cfg: DataConfig,
    fcfg: FrontendConfig,
    min_tokens: int = 3,
    max_tokens: int = 10,
    token_dur_s: float = 0.12,
    noise: float = 0.01,
) -> Utterance:
    rng = np.random.default_rng((cfg.synthetic_seed, index))
    n_tok = int(rng.integers(min_tokens, max_tokens + 1))
    content_ids = _sample_tokens(
        rng, vocab.size, n_tok, cfg.synthetic_grammar
    )
    seg = int(token_dur_s * fcfg.sample_rate)
    if cfg.synthetic_difficulty > 0.0:
        audio = hard_utterance_audio(
            content_ids,
            acoustic_rng=np.random.default_rng(
                (cfg.synthetic_seed, index, 1002)),
            dur_rng=np.random.default_rng((cfg.synthetic_seed, index, 1001)),
            sample_rate=fcfg.sample_rate, base_seg=seg,
            difficulty=cfg.synthetic_difficulty, vocab_size=vocab.size,
        )
    else:
        audio = np.concatenate(
            [_token_signature(int(i), seg, fcfg.sample_rate)
             for i in content_ids]
        )
        audio = audio + noise * rng.standard_normal(len(audio))
    tokens = np.concatenate([content_ids, [EOS]]).astype(np.int32)
    text = " ".join(vocab.tokens[i] for i in content_ids)
    return Utterance(
        uid=f"synth-{cfg.synthetic_seed}-{index}",
        audio=audio.astype(np.float32),
        tokens=tokens,
        text=text,
    )


class SyntheticDataset:
    """In-memory synthetic corpus; the `Dataset` of the build (L1/B1)."""

    def __init__(
        self,
        vocab: Vocab,
        cfg: DataConfig,
        fcfg: FrontendConfig,
        n_utts: int | None = None,
        labeled: bool = True,
        **utt_kwargs,
    ):
        self.vocab = vocab
        self.cfg = cfg
        self.fcfg = fcfg
        self.labeled = labeled
        self.n = n_utts if n_utts is not None else cfg.num_synthetic_utts
        self._kw = utt_kwargs

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Utterance:
        if not 0 <= i < self.n:
            raise IndexError(i)
        return make_utterance(i, self.vocab, self.cfg, self.fcfg, **self._kw)

    def audio_len(self, i: int) -> int:
        """Cheap length probe without generating audio (for bucketing)."""
        rng = np.random.default_rng((self.cfg.synthetic_seed, i))
        n_tok = int(rng.integers(self._kw.get("min_tokens", 3),
                                 self._kw.get("max_tokens", 10) + 1))
        seg = int(self._kw.get("token_dur_s", 0.12) * self.fcfg.sample_rate)
        if self.cfg.synthetic_difficulty > 0.0:
            # per-char rate jitter: replay the dedicated duration stream
            return hard_audio_len(
                n_tok,
                np.random.default_rng((self.cfg.synthetic_seed, i, 1001)),
                seg, self.cfg.synthetic_difficulty,
            )
        return n_tok * seg

    def token_len(self, i: int) -> int:
        rng = np.random.default_rng((self.cfg.synthetic_seed, i))
        n_tok = int(rng.integers(self._kw.get("min_tokens", 3),
                                 self._kw.get("max_tokens", 10) + 1))
        return n_tok + 1  # + EOS
