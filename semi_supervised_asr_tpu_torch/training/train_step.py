"""Featurization for the serving path.

Counterpart of ``featurize`` in ``semi_supervised_asr_tpu/training/
train_step.py`` (inference branch).  The rest of the train step --
augmentation, losses, the optimizer -- comes with the training slice.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu.config import Config
from semi_supervised_asr_tpu_torch.ops import frontend as F
from semi_supervised_asr_tpu_torch.ops.fused_frontend import (
    fused_log_mel_features,
)


def featurize(
    cfg: Config,
    audio: torch.Tensor,
    audio_lens: torch.Tensor,
    cmvn: tuple[torch.Tensor, torch.Tensor] | None,
    augment: bool = False,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio [B, S] (float, or int16 PCM) -> (features, frame lengths).

    With ``frontend.fused_pallas`` and global CMVN the post-FFT chain runs
    on the fused CUDA kernel; otherwise on the unfused plain path.
    """
    if augment:
        raise NotImplementedError(
            "training-time augmentation is not ported yet (serving path only)"
        )
    if audio.dtype == torch.int16:
        audio = audio.float() * (1.0 / 32768.0)
    fcfg = cfg.frontend
    mean, inv_std = cmvn if cmvn is not None else (None, None)
    if fcfg.fused_pallas and fcfg.cmvn == "global" and mean is not None:
        return fused_log_mel_features(audio, audio_lens, fcfg, mean, inv_std,
                                      backend=backend)
    return F.log_mel_features(audio, audio_lens, fcfg, mean, inv_std)
