"""Featurization and the train step, supervised and semi-supervised.

Counterpart of ``semi_supervised_asr_tpu/training/train_step.py`` for the
LAS family: ``featurize`` (inference and augmenting branches) and
``supervised_step_fn``: features under no-grad, teacher-forced CE with
label smoothing, and, when the objective weighs them and the step is given
the unlabeled batches, the text autoencoder on unlabeled text and the
pseudo-label term on unlabeled audio (the teacher's greedy decode of the
clean view, the student's CE on the augmented view, gated by
``objective.pseudo_warmup_steps``); then backward (through K3 for the
listener), global-norm clip, Adam, the EMA update and the step counter.
The metrics keep the JAX keys (``loss``, ``ce``, ``acc``, ``grad_norm``,
``tf_rate``, ``frames``, and ``text_ae``, ``pseudo``, ``pseudo_gate``
where the step runs those terms).  What the step does not run yet --
dropout, CTC, MWER, speed perturbation, noise, time warp, gradient
accumulation, the bf16 weight stream -- is refused by
:func:`check_train_supported` with a message naming the key.
"""

from __future__ import annotations

import copy
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
        "objective.lambda_mwer": (o.lambda_mwer, 0.0),
        "train.optimizer": (t.optimizer, "adam"),
        "train.grad_accum": (max(int(t.grad_accum), 1), 1),
        "train.bf16_weight_stream": (t.bf16_weight_stream, False),
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


def module_state(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Named parameters as CPU copies (exact bits)."""
    return {n: p.detach().cpu().clone() for n, p in module.named_parameters()}


@torch.no_grad()
def load_module_state(module: torch.nn.Module,
                      sd: dict[str, torch.Tensor]) -> None:
    """Copy :func:`module_state` into ``module``'s own parameters in place
    (the optimizer holds references to them); names and shapes must
    match."""
    params = dict(module.named_parameters())
    if set(params) != set(sd):
        raise KeyError("parameter names differ: missing "
                       f"{sorted(set(params) - set(sd))}, unexpected "
                       f"{sorted(set(sd) - set(params))}")
    for n, p in params.items():
        if tuple(p.shape) != tuple(sd[n].shape):
            raise ValueError(f"{n}: shape {tuple(sd[n].shape)} does not "
                             f"match the model's {tuple(p.shape)}")
        p.copy_(sd[n])


@dataclass
class TrainState:
    """What one training run carries from step to step."""

    model: torch.nn.Module        # Seq2Seq, float32 parameters
    ema: torch.nn.Module          # Seq2Seq: the EMA of ``model``, no grad
    opt: schedules.Adam
    step: int
    gen: torch.Generator          # SpecAugment bands and scheduled sampling

    def state_dict(self) -> dict:
        """Everything an exact resume needs, as CPU tensors: the
        parameters, the EMA buffer, Adam's moments and count, the step and
        the generator's state."""
        return {"model": module_state(self.model),
                "ema": module_state(self.ema),
                "opt": self.opt.state_dict(),
                "step": int(self.step),
                "gen": self.gen.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict` into this state's own tensors."""
        load_module_state(self.model, sd["model"])
        load_module_state(self.ema, sd["ema"])
        self.opt.load_state_dict(sd["opt"])
        self.step = int(sd["step"])
        self.gen.set_state(sd["gen"])


def init_train_state(cfg: Config, model: torch.nn.Module,
                     seed: int) -> TrainState:
    check_train_supported(cfg)
    return TrainState(model=model,
                      ema=copy.deepcopy(model).requires_grad_(False),
                      opt=schedules.Adam(list(model.parameters()), cfg.train),
                      step=0, gen=torch.Generator().manual_seed(seed))


def ema_decay(cfg: Config) -> float | None:
    """The decay of the one EMA buffer: ``train.polyak_decay`` when set,
    else ``objective.ema_decay`` while an EMA teacher feeds the
    pseudo-label term; None (no update) otherwise."""
    obj = cfg.objective
    if cfg.train.polyak_decay > 0.0:
        return cfg.train.polyak_decay
    if obj.use_ema_teacher and obj.lambda_pseudo > 0.0:
        return obj.ema_decay
    return None


def mask_unreal(tokens: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Filler rows contribute nothing: their targets become all-PAD."""
    return torch.where(real[:, None], tokens, PAD)


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
    unlab_audio: torch.Tensor | None = None,       # [B', S'] as ``audio``
    unlab_audio_lens: torch.Tensor | None = None,  # [B'] samples
    unlab_real: torch.Tensor | None = None,        # [B'] bool
    unlab_text: torch.Tensor | None = None,        # [B'', U''] as ``tokens``
    unlab_text_real: torch.Tensor | None = None,   # [B''] bool
    unlab_specaug: SpecAug | None = None,
    pseudo_labels: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """The loss of one batch at ``state`` and its gradient with respect to
    every parameter (in ``state.opt.params`` order) -> (loss, {"ce",
    "acc", "tf_rate"} and, where the step runs them, {"text_ae", "pseudo",
    "pseudo_gate"}, grads).  The text term runs when
    ``objective.lambda_text_ae`` > 0 and ``unlab_text`` is given, the
    pseudo-label term when ``objective.lambda_pseudo`` > 0 and
    ``unlab_audio`` is given.  ``specaug`` / ``unlab_specaug`` fix the
    bands of the labeled and of the augmented unlabeled view (else they
    are drawn from ``state.gen``); ``pseudo_labels`` fixes the teacher's
    hypotheses (see :func:`LO.pseudo_label_loss`)."""
    obj = cfg.objective
    tf_rate = schedules.tf_rate_at(state.step, obj)
    tokens = mask_unreal(tokens, real)
    with torch.no_grad():
        feats, flens = featurize(cfg, audio, audio_lens, cmvn, True, backend,
                                 specaug, state.gen)
    loss, aux = LO.supervised_loss(
        state.model, obj.label_smoothing, feats, flens, tokens,
        tf_rate, state.gen, backend)
    aux["tf_rate"] = tf_rate
    if obj.lambda_text_ae > 0.0 and unlab_text is not None:
        text = mask_unreal(unlab_text, unlab_text_real)
        ae = LO.text_ae_loss(state.model.speller, obj.label_smoothing, text)
        loss = loss + obj.lambda_text_ae * ae
        aux["text_ae"] = ae.detach()
    if obj.lambda_pseudo > 0.0 and unlab_audio is not None:
        teacher = state.ema if obj.use_ema_teacher else state.model
        with torch.no_grad():
            clean, clens = featurize(cfg, unlab_audio, unlab_audio_lens,
                                     cmvn, False, backend)
            augmented, _ = featurize(cfg, unlab_audio, unlab_audio_lens,
                                     cmvn, True, backend, unlab_specaug,
                                     state.gen)
        # hypotheses capped by the labeled stream's token bucket
        max_len = min(cfg.decode.max_decode_len, tokens.shape[1])
        pl = LO.pseudo_label_loss(state.model, teacher, obj.pseudo_confidence,
                                  clean, augmented, clens, max_len,
                                  unlab_real, backend, pseudo_labels)
        # the gate multiplies the term, which runs from step 0 (a NaN in
        # it poisons the loss even while the gate is closed, as in JAX)
        gate = float(state.step >= obj.pseudo_warmup_steps)
        loss = loss + obj.lambda_pseudo * gate * pl
        aux.update(pseudo=pl.detach(), pseudo_gate=gate)
    params = state.opt.params
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    # a leaf no term reaches gets an exact zero
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return loss.detach(), aux, grads


@torch.no_grad()
def apply_grads(cfg: Config, state: TrainState,
                grads: list[torch.Tensor]) -> tuple[torch.Tensor, float]:
    """Clip ``grads`` by their global norm, take one Adam step, update the
    EMA buffer and count the step -> (the norm before clipping, the
    learning rate used)."""
    gnorm = schedules.global_norm(grads)
    if cfg.train.grad_clip_norm > 0:
        schedules.clip_by_global_norm(grads, cfg.train.grad_clip_norm, gnorm)
    lr = state.opt.step(grads)
    d = ema_decay(cfg)
    if d is not None:
        for e, p in zip(state.ema.parameters(), state.model.parameters()):
            e.copy_(d * e + (1.0 - d) * p)
    state.step += 1
    return gnorm, lr


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
    **unlab,
) -> dict:
    """One update of ``state`` in place (arguments as for
    :func:`loss_and_grads`, the unlabeled batches by keyword) -> metrics:
    0-dim tensors on the device, plus the floats ``tf_rate``, ``lr`` and,
    with the pseudo-label term, ``pseudo_gate``."""
    loss, aux, grads = loss_and_grads(cfg, state, audio, audio_lens, tokens,
                                      real, cmvn, specaug, backend, **unlab)
    gnorm, lr = apply_grads(cfg, state, grads)
    frames = (torch.where(real, audio_lens, 0).sum()
              // cfg.frontend.hop_length)
    return dict(aux, loss=loss, grad_norm=gnorm, frames=frames, lr=lr)
