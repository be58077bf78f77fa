"""Featurization and the supervised train step.

Counterpart of ``semi_supervised_asr_tpu/training/train_step.py``:
``featurize`` (inference and augmenting branches) and, for the LAS family,
the supervised part of ``supervised_step_fn``: features under no-grad,
teacher-forced CE with label smoothing, backward (through K3 for the
listener), global-norm clip, Adam and the step counter.  The metrics keep
the JAX keys (``loss``, ``ce``, ``acc``, ``grad_norm``, ``tf_rate``,
``frames``).  What the step does not run yet -- dropout, CTC, the
semi-supervised terms, speed perturbation, noise, time warp, gradient
accumulation, the bf16 weight stream -- is refused by
:func:`check_train_supported` with a message naming the key.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from semi_supervised_asr_tpu_torch.config import Config
from semi_supervised_asr_tpu_torch.data.vocab import PAD
from semi_supervised_asr_tpu_torch.objectives import losses as LO
from semi_supervised_asr_tpu_torch.ops import frontend as F
from semi_supervised_asr_tpu_torch.ops.fused_frontend import fused_post_fft
from semi_supervised_asr_tpu_torch.training import schedules

SpecAug = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def check_augment_supported(cfg: Config) -> None:
    fcfg = cfg.frontend
    unsupported = {
        "speed_perturb": bool(fcfg.speed_perturb),
        "noise_aug_prob": fcfg.noise_aug_prob > 0.0,
        "time_warp_param": fcfg.spec_augment and fcfg.time_warp_param > 0,
    }
    for key, on in unsupported.items():
        if on:
            raise NotImplementedError(
                f"frontend.{key}={getattr(fcfg, key)!r} is not ported yet "
                "(the PyTorch port augments with SpecAugment bands only)")


def check_train_supported(cfg: Config) -> None:
    """Refuse training options outside this slice with a clear message
    (model options are checked by the model's constructor)."""
    m, o, t = cfg.model, cfg.objective, cfg.train
    unsupported = {
        "model.enc_dropout": (m.enc_dropout, 0.0),
        "model.dec_dropout": (m.dec_dropout, 0.0),
        "model.param_dtype": (m.param_dtype, "float32"),
        "objective.lambda_ctc": (o.lambda_ctc, 0.0),
        "objective.lambda_text_ae": (o.lambda_text_ae, 0.0),
        "objective.lambda_pseudo": (o.lambda_pseudo, 0.0),
        "objective.lambda_mwer": (o.lambda_mwer, 0.0),
        "train.optimizer": (t.optimizer, "adam"),
        "train.grad_accum": (max(int(t.grad_accum), 1), 1),
        "train.bf16_weight_stream": (t.bf16_weight_stream, False),
        "train.polyak_decay": (t.polyak_decay, 0.0),
        "train.freeze": (tuple(t.freeze), ()),
        "train.init_encoder_from": (t.init_encoder_from, ""),
        "train.remat_encoder": (t.remat_encoder, False),
        "train.checkify_errors": (t.checkify_errors, ""),
        "data.use_feature_store": (cfg.data.use_feature_store, False),
        "data.batch_frames": (cfg.data.batch_frames, 0),
        "data.sortagrad_epochs": (cfg.data.sortagrad_epochs, 0),
    }
    for key, (got, want) in unsupported.items():
        if got != want:
            raise NotImplementedError(
                f"{key}={got!r} is not ported yet (the PyTorch port trains "
                f"with {key}={want!r})")
    check_augment_supported(cfg)


def featurize(
    cfg: Config,
    audio: torch.Tensor,
    audio_lens: torch.Tensor,
    cmvn: tuple[torch.Tensor, torch.Tensor] | None,
    augment: bool = False,
    backend: str | None = None,
    specaug: SpecAug | None = None,
    gen: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio [B, S] (float, or int16 PCM) -> (features, frame lengths).

    With ``frontend.fused_pallas`` and global CMVN the post-FFT chain runs
    on the fused CUDA kernel K1; otherwise on the unfused plain path.
    ``augment`` (training) applies SpecAugment when ``frontend.spec_augment``
    is on: the bands are ``specaug`` when given (how a test passes the JAX
    package's draws), else drawn from ``gen``.
    """
    if audio.dtype == torch.int16:
        audio = audio.float() * (1.0 / 32768.0)
    fcfg = cfg.frontend
    if augment:
        check_augment_supported(cfg)
    mean, inv_std = cmvn if cmvn is not None else (None, None)
    fused = fcfg.fused_pallas and fcfg.cmvn == "global" and mean is not None
    if fused:
        pspec = F.power_spectrogram(audio, fcfg)
        lens = torch.clamp_max(F.frame_lengths(audio_lens, fcfg),
                               pspec.shape[1])
    else:
        feats, lens = F.log_mel_features(audio, audio_lens, fcfg, mean,
                                         inv_std)
    bands = None
    if augment and fcfg.spec_augment:
        bands = specaug if specaug is not None else F.sample_specaug_params(
            gen, audio.shape[0], fcfg.n_mels, lens, fcfg)
    if fused:
        return fused_post_fft(pspec, lens, fcfg, mean, inv_std, bands,
                              backend), lens
    if bands is not None:
        feats = F.apply_specaug_masks(feats, *bands)
    return feats, lens


@dataclass
class TrainState:
    """What one training run carries from step to step."""

    model: torch.nn.Module        # Seq2Seq, float32 parameters
    opt: schedules.Adam
    step: int
    gen: torch.Generator          # SpecAugment bands and scheduled sampling


def init_train_state(cfg: Config, model: torch.nn.Module,
                     seed: int) -> TrainState:
    check_train_supported(cfg)
    return TrainState(model=model,
                      opt=schedules.Adam(list(model.parameters()), cfg.train),
                      step=0, gen=torch.Generator().manual_seed(seed))


def loss_and_grads(
    cfg: Config,
    state: TrainState,
    audio: torch.Tensor,          # [B, S] float32 or int16
    audio_lens: torch.Tensor,     # [B] samples
    tokens: torch.Tensor,         # [B, U] EOS-terminated, PAD-padded
    real: torch.Tensor,           # [B] bool, False on filler rows
    cmvn: tuple[torch.Tensor, torch.Tensor] | None,
    specaug: SpecAug | None = None,
    backend: str | None = None,
) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """The loss of one batch at ``state`` and its gradient with respect to
    every parameter (in ``state.opt.params`` order) -> (loss, {"ce",
    "acc", "tf_rate"}, grads).  Draws from ``state.gen``."""
    tf_rate = schedules.tf_rate_at(state.step, cfg.objective)
    # filler rows contribute nothing: their targets become all-PAD
    tokens = torch.where(real[:, None], tokens, PAD)
    with torch.no_grad():
        feats, flens = featurize(cfg, audio, audio_lens, cmvn, True, backend,
                                 specaug, state.gen)
    loss, aux = LO.supervised_loss(
        state.model, cfg.objective.label_smoothing, feats, flens, tokens,
        tf_rate, state.gen, backend)
    grads = list(torch.autograd.grad(loss, state.opt.params))
    return loss.detach(), dict(aux, tf_rate=tf_rate), grads


def supervised_step(
    cfg: Config,
    state: TrainState,
    audio: torch.Tensor,
    audio_lens: torch.Tensor,
    tokens: torch.Tensor,
    real: torch.Tensor,
    cmvn: tuple[torch.Tensor, torch.Tensor] | None,
    specaug: SpecAug | None = None,
    backend: str | None = None,
) -> dict:
    """One supervised update of ``state`` in place (arguments as for
    :func:`loss_and_grads`) -> metrics: 0-dim tensors on the device, plus
    the floats ``tf_rate`` and ``lr``."""
    loss, aux, grads = loss_and_grads(cfg, state, audio, audio_lens, tokens,
                                      real, cmvn, specaug, backend)
    gnorm = schedules.global_norm(grads)
    if cfg.train.grad_clip_norm > 0:
        schedules.clip_by_global_norm(grads, cfg.train.grad_clip_norm, gnorm)
    lr = state.opt.step(grads)
    state.step += 1
    frames = (torch.where(real, audio_lens, 0).sum()
              // cfg.frontend.hop_length)
    return dict(aux, loss=loss, grad_norm=gnorm, frames=frames, lr=lr)
