"""A model directory and a few WAV files made from a seed.

For running the serving path where there is neither a trained checkpoint
nor a corpus (the on-card smoke test, the slice's tests).  ``write_wavs``
writes utterances of the synthetic corpus as 16-bit PCM WAVs;
``write_model_dir`` writes the two files ``transcribe --load-dir`` reads:
``params.npz`` (``weights.init_numpy``) and ``cmvn.npz`` (global
statistics of the files' log-mel features, in the format the reference's
Solver writes).
"""

from __future__ import annotations

from collections.abc import Sequence
from pathlib import Path

import numpy as np
from scipy.io import wavfile

from semi_supervised_asr_tpu_torch.config import Config
from semi_supervised_asr_tpu_torch.data.corpus import load_audio
from semi_supervised_asr_tpu_torch.data.synthetic import make_utterance
from semi_supervised_asr_tpu_torch.data.vocab import Vocab
from semi_supervised_asr_tpu_torch.ops import frontend_oracle as oracle
from semi_supervised_asr_tpu_torch import weights


def write_wavs(d: Path, cfg: Config, vocab: Vocab, n: int,
               max_samples: Sequence[int] | None = None,
               **utterance) -> list[Path]:
    """Utterances 0..n-1 of the synthetic corpus as ``d/utt{i}.wav``,
    utterance i cut to ``max_samples[i]`` samples when given.
    ``utterance`` goes to ``make_utterance`` (token counts, durations)."""
    files = []
    for i in range(n):
        audio = make_utterance(i, vocab, cfg.data, cfg.frontend,
                               **utterance).audio
        if max_samples is not None:
            audio = audio[:max_samples[i]]
        pcm = np.clip(np.rint(audio * 32768), -32768, 32767)
        f = d / f"utt{i}.wav"
        wavfile.write(f, cfg.frontend.sample_rate, pcm.astype(np.int16))
        files.append(f)
    return files


def write_model_dir(d: Path, cfg: Config, files: Sequence[Path],
                    seed: int) -> None:
    """``d/params.npz``, random weights from ``seed`` for ``cfg.model``
    (vocab size and n_mels filled in), and ``d/cmvn.npz``, the CMVN
    statistics of ``files``."""
    lm = np.concatenate([oracle.log_mel(load_audio(f).astype(np.float64),
                                        cfg.frontend) for f in files])
    mean, inv_std = oracle.cmvn_stats(lm)
    np.savez(d / "cmvn.npz", mean=mean.astype(np.float32),
             inv_std=inv_std.astype(np.float32))
    np.savez(d / "params.npz", **weights.init_numpy(cfg.model, seed=seed))
