"""Featurization and the train step, supervised and semi-supervised.

Counterpart of ``semi_supervised_asr_tpu/training/train_step.py`` for the
LAS family (either speller), the CTC family and the transducer family:
``featurize`` (inference and augmenting branches: speed perturbation,
additive noise, SpecAugment bands and time warp) and ``supervised_step``:
features under no-grad, teacher-forced CE with label smoothing (plus
``objective.lambda_ctc`` times the joint CTC head's loss on the same
encoder pass), the CTC family's label-normalized NLL, or the transducer's
lattice NLL (its mean over the real rows); ``objective.lambda_mwer`` times
the family's MWER term on the same encoder pass (the n-best beam, its
rescoring and edit-distance risks; exactly 0, and no beam run, before
``objective.mwer_warmup_steps``); and, when the objective weighs them and
the step is given the unlabeled batches, the text term on unlabeled text
(the LAS text autoencoder; the transducer's internal-LM CE) and the
pseudo-label term on unlabeled audio (the teacher's greedy or best-path
decode of the clean view, the student's CE, lattice NLL or CTC NLL on the
augmented view, gated by ``objective.pseudo_warmup_steps``); then backward
(through K3 for the listener and the predictor), the optimizer chain
(``train.freeze``, global-norm clip, ``train.optimizer``: adam, adamw or
sgd; ``training/schedules.py``), the EMA update and the step counter.  The metrics keep the JAX keys
(``loss``, ``ce``, ``acc``, ``ctc``, ``nll_per_label``, ``grad_norm``,
``tf_rate``, ``frames``, and ``mwer``, ``mwer_risk``, ``text_ae`` or
``text_ilm``, ``pseudo``, ``pseudo_gate`` where the step runs those
terms).

The training passes drop out (``model.enc_dropout`` after the listener's
sites, ``model.dec_dropout`` before the speller's output projection): the
supervised pass and the pseudo-label student; the text autoencoder and the
teacher's decode do not.  ``train.grad_accum`` = A splits every field of
the step's batches into A equal microbatches, each normalized by its own
counts and with its own draws; loss, metrics and gradients are the mean
over them (float32), then one clip, one Adam update and one EMA update.

Random draws: the per-row ones (SpecAugment bands, time warp, the speed
factor, the noise decisions, scheduled sampling) come from the state's CPU
generator ``gen``, the large ones (dropout masks, white noise) from its
device generator ``dgen``; both are in the checkpoint.  :class:`Draws`
hands given draws in instead (how a test passes the JAX package's).

``train.remat_encoder`` runs the listener again in the backward
(``Seq2Seq.forward_teacher``, its dropout masks passed in);
``train.bf16_weight_stream`` rounds every float32 parameter (and the EMA
teacher's, for its decode) to bf16 once inside the loss, as the reference
does, while the float32 masters take the gradients.  Under data
parallelism (``parallel/dp.py``) each rank runs its rows of the global
batch (its ceil-sized block of each global microbatch under accumulation;
an empty block runs one unreal stand-in row): the random draws are
made at the global (micro)batch's shape and the rank's rows kept, babble
noise mixes rows gathered from every rank, every term is divided by the
global microbatch's count (summed over the ranks before the forward), and
the gradients and metrics are summed over the ranks, so that N ranks
compute what one process computes on the concatenated batch.  What the
step does not run yet -- another optimizer, frozen or transplanted
weights, checkify -- is refused by :func:`check_train_supported` with a
message naming the key, as are the reference's own refusals for the CTC
family and the transformer speller.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch
from torch import nn

from semi_supervised_asr_tpu_torch.config import Config
from semi_supervised_asr_tpu_torch.data.vocab import PAD
from semi_supervised_asr_tpu_torch.objectives import ctc_semi as CSEMI
from semi_supervised_asr_tpu_torch.objectives import losses as LO
from semi_supervised_asr_tpu_torch.objectives import transducer_semi as TSEMI
from semi_supervised_asr_tpu_torch.ops import frontend as F
from semi_supervised_asr_tpu_torch.ops.fused_frontend import fused_post_fft
from semi_supervised_asr_tpu_torch.parallel import dp as DP
from semi_supervised_asr_tpu_torch.training import schedules

SpecAug = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def check_train_supported(cfg: Config) -> None:
    """Refuse training options outside the ported slices with a clear
    message (model options are checked by the model's constructor), and
    what the reference's step refuses for the CTC family and the
    transformer speller, with its messages."""
    m, o, t = cfg.model, cfg.objective, cfg.train
    unsupported = {
        "model.param_dtype": (m.param_dtype, "float32"),
        "train.checkify_errors": (t.checkify_errors, ""),
        "data.use_feature_store": (cfg.data.use_feature_store, False),
    }
    for key, (got, want) in unsupported.items():
        if got != want:
            raise NotImplementedError(
                f"{key}={got!r} is not ported yet (the PyTorch port trains "
                f"with {key}={want!r})")
    if t.optimizer not in schedules.OPTIMIZERS:
        raise ValueError(f"unknown optimizer {t.optimizer!r}")
    if m.family == "transducer":
        # the reference's refusal (its LM-fusion one is the model's)
        if o.lambda_ctc:
            raise ValueError(
                "model.family=transducer: disable objective.lambda_ctc (the "
                "CTC aux head targets the attention stack); the semi terms "
                "(transducer_semi.py) are supported")
    if m.family == "ctc":
        if o.lambda_ctc:
            raise ValueError(
                "model.family=ctc: the CTC head IS the model — leave "
                "objective.lambda_ctc at 0 (it is the joint CTC-ATTENTION "
                "aux weight for the LAS family)")
        if o.lambda_text_ae:
            raise ValueError(
                "model.family=ctc has no decoder to train on unlabeled text "
                "— use lambda_pseudo for unlabeled audio, and unlabeled text "
                "via an external LM (lm_trainer + decode.lm_weight fusion)")
        if m.lm_fusion != "none":
            raise ValueError(
                "deep/cold LM fusion is LAS-only; the CTC family fuses "
                "SHALLOW at decode time (decode.lm_weight)")
    if m.family == "las" and m.decoder_arch == "transformer":
        if o.tf_rate_start != 1.0 or o.tf_rate_end != 1.0:
            raise ValueError(
                "decoder_arch=transformer trains with ONE parallel causal "
                "pass — scheduled sampling (tf_rate < 1.0) needs the serial "
                "LSTM scan; pin objective.tf_rate_start/end at 1.0")
        if m.speller_grad != "scan":
            raise ValueError(
                "model.speller_grad=stacked reroutes the LSTM scan's dW "
                "accumulators; the transformer speller has no decode-step "
                "scan to reroute — leave speller_grad at 'scan'")


@dataclass
class Draws:
    """Given random draws of one augmented view and its training pass; a
    field left None is drawn from the state's generators (how a test hands
    in the JAX package's draws)."""

    specaug: SpecAug | None = None
    warp: tuple[torch.Tensor, torch.Tensor] | None = None  # (w, d) [B]
    speed: torch.Tensor | None = None           # [B] speed factor index
    noise: F.NoiseDraws | None = None
    masks: tuple | None = None      # (listener masks, speller masks)


@dataclass
class StepDraws:
    """Given draws of one (micro)batch of a step: its labeled view, the
    augmented view of its unlabeled audio, the teacher's hypotheses in
    place of its decode (``LO.teacher_labels``' pair; the transducer's
    ``TSEMI.teacher_labels`` and the CTC family's ``CSEMI.teacher_labels``
    triples), and the MWER beam's (n-best [B, K, U], scores [B, K]) in
    place of its search."""

    labeled: Draws = field(default_factory=Draws)
    unlabeled: Draws = field(default_factory=Draws)
    pseudo_labels: tuple | None = None
    mwer_nbest: tuple | None = None


def featurize(
    cfg: Config,
    audio: torch.Tensor,
    audio_lens: torch.Tensor,
    cmvn: tuple[torch.Tensor, torch.Tensor] | None,
    augment: bool = False,
    backend: str | None = None,
    draws: Draws | None = None,
    gen: torch.Generator | None = None,
    rows: tuple[int, int, int] | None = None,
    speed: bool = False,
    dgen: torch.Generator | None = None,
    dp: DP.DataParallel | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio [B, S] (float, or int16 PCM) -> (features, frame lengths).

    With ``frontend.fused_pallas`` and global CMVN the post-FFT chain runs
    on the fused CUDA kernel K1; otherwise on the unfused plain path.
    ``augment`` (training) applies, in the reference's order: speed
    perturbation (``frontend.speed_perturb``, only with ``speed``: the
    labeled view, since it changes the frame lengths), additive noise
    (``frontend.noise_aug_prob``), the SpecAugment bands (in K1 or after
    the plain chain) and time warp (``frontend.time_warp_param``, after
    CMVN and the bands).  The draws are ``draws``' where given, else drawn
    from ``gen`` (per row) and ``dgen`` (white noise) for ``rows`` of a
    global batch; ``dp`` gathers that global batch's audio for babble.
    """
    if audio.dtype == torch.int16:
        audio = audio.float() * (1.0 / 32768.0)
    fcfg = cfg.frontend
    d = draws if draws is not None else Draws()
    dev = audio.device
    if speed and augment and fcfg.speed_perturb:
        idx = d.speed if d.speed is not None else F.sample_speed_index(
            gen, audio.shape[0], len(fcfg.speed_perturb), dev, rows)
        audio, audio_lens = F.apply_speed_perturb(
            audio, audio_lens, tuple(fcfg.speed_perturb), idx)
    if augment and fcfg.noise_aug_prob > 0.0:
        sources = tuple(fcfg.noise_sources)
        noise = d.noise if d.noise is not None else F.sample_noise_params(
            gen, dgen, tuple(audio.shape), sources, dev, rows)
        pool, row0 = None, 0
        if dp is not None and "babble" in sources:
            # babble mixes rows of the whole (micro)batch
            pool, row0 = DP.all_gather_rows(audio, rows[2]), rows[0]
        audio = F.apply_noise(audio, audio_lens, fcfg.noise_aug_prob,
                              tuple(fcfg.noise_snr_db), sources, noise,
                              pool, row0)
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
        bands = d.specaug if d.specaug is not None else \
            F.sample_specaug_params(gen, audio.shape[0], fcfg.n_mels, lens,
                                    fcfg, rows)
    if fused:
        feats = fused_post_fft(pspec, lens, fcfg, mean, inv_std, bands,
                               backend)
    elif bands is not None:
        feats = F.apply_specaug_masks(feats, *bands)
    if augment and fcfg.spec_augment and fcfg.time_warp_param > 0:
        w, dd = d.warp if d.warp is not None else F.sample_time_warp(
            gen, lens, fcfg.time_warp_param, rows)
        feats = F.apply_time_warp(feats, lens, fcfg.time_warp_param, w, dd)
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
    opt: schedules.Adam | schedules.SGD   # train.optimizer's
    step: int
    gen: torch.Generator          # per-row draws (CPU)
    dgen: torch.Generator         # dropout masks, white noise (the device's)

    def state_dict(self) -> dict:
        """Everything an exact resume needs, as CPU tensors: the
        parameters, the EMA buffer, the optimizer's moments and count, the
        step and both generators' states."""
        return {"model": module_state(self.model),
                "ema": module_state(self.ema),
                "opt": self.opt.state_dict(),
                "step": int(self.step),
                "gen": self.gen.get_state(),
                "dgen": self.dgen.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict` into this state's own tensors."""
        load_module_state(self.model, sd["model"])
        load_module_state(self.ema, sd["ema"])
        self.opt.load_state_dict(sd["opt"])
        self.step = int(sd["step"])
        self.gen.set_state(sd["gen"])
        self.dgen.set_state(sd["dgen"])


def init_train_state(cfg: Config, model: torch.nn.Module,
                     seed: int) -> TrainState:
    """The state of step 0 around ``model`` (its device holds ``dgen``);
    both generators are seeded with ``seed``."""
    check_train_supported(cfg)
    dev = next(model.parameters()).device
    return TrainState(model=model,
                      ema=copy.deepcopy(model).requires_grad_(False),
                      opt=schedules.make_optimizer(
                          list(model.named_parameters()), cfg.train),
                      step=0, gen=torch.Generator().manual_seed(seed),
                      dgen=torch.Generator(dev).manual_seed(seed))


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


class _Call(nn.Module):
    """``fn(module, *args)`` as a module's forward, for
    ``torch.func.functional_call``."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.m = module

    def forward(self, fn, *args):
        return fn(self.m, *args)


def weight_view(module: nn.Module, bf16: bool):
    """-> ``run(fn, *args)`` = ``fn(module, *args)``; with ``bf16``
    (``train.bf16_weight_stream``) every float32 parameter is cast to bf16
    once, here, and ``fn`` sees the bf16 copies in its place
    (``torch.func.functional_call``), as the reference casts its parameter
    tree inside the loss: products take them as they are, float32 operands
    widen them (JAX's type promotion), and a weight used at every decoder
    step sums its gradient in bf16, as the reference's scan transpose
    does.  Autograd returns the gradients through the cast, in float32, to
    the float32 masters."""
    if not bf16:
        return lambda fn, *args: fn(module, *args)
    rounded = {f"m.{n}": (p.to(torch.bfloat16)
                          if p.dtype == torch.float32 else p)
               for n, p in module.named_parameters()}
    call = _Call(module)
    return lambda fn, *args: torch.func.functional_call(call, rounded,
                                                        (fn, *args))


def microbatches(accum: int, **fields) -> list[dict]:
    """Split every given tensor (None skipped) into ``accum`` equal
    microbatches along axis 0 (empty ones where the tensor is) -> one dict
    of fields per microbatch."""
    out = [{} for _ in range(accum)]
    for k, x in fields.items():
        if x is None:
            continue
        if x.shape[0] % accum:
            raise ValueError(f"{k}: batch {x.shape[0]} not divisible by "
                             f"train.grad_accum {accum}")
        for mb, part in zip(out, x.tensor_split(accum)):
            mb[k] = part
    return out


# the fields of each stream of a step's batches
STREAMS = (("audio", "audio_lens", "tokens", "real"),
           ("unlab_audio", "unlab_audio_lens", "unlab_real"),
           ("unlab_text", "unlab_text_real"))


def _stand_in(mb: dict, fields: tuple[str, ...]) -> None:
    """Give a stream that holds no row of this microbatch one unreal row of
    zeros (silence over the whole buffer, all-PAD tokens), which every term
    weighs out: a rank whose block is empty still runs the step's draws and
    joins its reductions."""
    for f in fields:
        x = mb[f]
        mb[f] = x.new_zeros((1, *x.shape[1:]))
    if "audio_lens" in fields or "unlab_audio_lens" in fields:
        a, n = fields[:2]
        mb[n] = torch.full_like(mb[n], mb[a].shape[1])


def loss_and_grads(
    cfg: Config,
    state: TrainState,
    audio: torch.Tensor,          # [B, S] float32 or int16
    audio_lens: torch.Tensor,     # [B] samples
    tokens: torch.Tensor,         # [B, U] EOS-terminated, PAD-padded
    real: torch.Tensor,           # [B] bool, False on filler rows
    cmvn: tuple[torch.Tensor, torch.Tensor] | None,
    draws: list[StepDraws] | None = None,
    backend: str | None = None,
    unlab_audio: torch.Tensor | None = None,       # [B', S'] as ``audio``
    unlab_audio_lens: torch.Tensor | None = None,  # [B'] samples
    unlab_real: torch.Tensor | None = None,        # [B'] bool
    unlab_text: torch.Tensor | None = None,        # [B'', U''] as ``tokens``
    unlab_text_real: torch.Tensor | None = None,   # [B''] bool
    dp: DP.DataParallel | None = None,
    global_rows: tuple[int, int, int] | None = None,
) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """The loss of one batch at ``state`` and its gradient with respect to
    every parameter (in ``state.opt.params`` order) -> (loss, {"ce",
    "acc", "tf_rate", "frames"} and, where the step runs them, {"text_ae",
    "pseudo", "pseudo_gate"}, grads).  The text term runs when
    ``objective.lambda_text_ae`` > 0 and ``unlab_text`` is given, the
    pseudo-label term when ``objective.lambda_pseudo`` > 0 and
    ``unlab_audio`` is given.  ``train.grad_accum`` splits every batch
    into microbatches (:func:`microbatches`); loss, metrics and gradients
    are their means.  ``draws`` (one :class:`StepDraws` per microbatch)
    fixes what it gives of each microbatch's random draws.

    ``dp``: this rank's place in a data-parallel group; the batches are its
    rows of the global ones (its ceil-sized block of each global
    microbatch, ``parallel/dp.py::ceil_block``; an empty block runs one
    unreal stand-in row).  ``global_rows``, required with ``dp``, are the
    global labeled, unlabeled-audio and text batches' sizes
    (``Solver.step_inputs`` gives them).  Each term's denominator is the
    global microbatch's count, summed over the ranks before the forward
    (the pseudo-label term's kept tokens are known once the teacher has
    decoded, so the teacher runs first), and the returned loss, metrics and
    gradients are the sums over the ranks."""
    accum = max(int(cfg.train.grad_accum), 1)
    tf_rate = schedules.tf_rate_at(state.step, cfg.objective)
    micro = microbatches(
        accum, audio=audio, audio_lens=audio_lens, tokens=tokens, real=real,
        unlab_audio=unlab_audio, unlab_audio_lens=unlab_audio_lens,
        unlab_real=unlab_real, unlab_text=unlab_text,
        unlab_text_real=unlab_text_real)
    if draws is not None and len(draws) != accum:
        raise ValueError(f"{len(draws)} draws for {accum} microbatches")
    blocks = [None, None, None]
    if dp is not None:
        local = [audio.shape[0],
                 None if unlab_audio is None else unlab_audio.shape[0],
                 None if unlab_text is None else unlab_text.shape[0]]
        if global_rows is None:
            raise ValueError("a data-parallel step needs global_rows, the "
                             "global batches' sizes")
        blocks = DP.microbatch_blocks(dp, accum, local, global_rows)
        for mb in micro:
            for fields, block in zip(STREAMS, blocks):
                if block is not None and block[0] == block[1]:
                    _stand_in(mb, fields)
    params = state.opt.params
    loss = grads = None
    aux: dict = {}
    for i, mb in enumerate(micro):
        li, ai = _micro_loss(cfg, state, mb, cmvn, tf_rate,
                             draws[i] if draws is not None else StepDraws(),
                             backend, dp, blocks)
        gi = torch.autograd.grad(li, params, allow_unused=True)
        # a leaf no term reaches gets an exact zero
        gi = [torch.zeros_like(p) if g is None else g
              for p, g in zip(params, gi)]
        li = li.detach()
        if grads is None:
            loss, grads, aux = li, gi, ai
        else:
            loss = loss + li
            grads = [a + b for a, b in zip(grads, gi)]
            aux = {k: aux[k] + ai[k] for k in aux}
    # the mean over the microbatches, as the reference scales its sums
    inv = 1.0 / accum
    loss = loss * inv
    grads = [g * inv for g in grads]
    aux = {k: v * inv for k, v in aux.items()}
    if dp is not None:
        # the metrics ride in the gradients' reduction: one sum for all
        keys = [k for k, v in aux.items() if torch.is_tensor(v)]
        vec = torch.stack([loss] + [aux[k].float() for k in keys])
        *grads, vec = DP.all_reduce_grads([*grads, vec])
        loss = vec[0]
        aux.update(zip(keys, vec[1:]))
    aux["tf_rate"] = tf_rate
    samples = torch.where(real, audio_lens, 0).sum()
    if dp is not None:
        samples = DP.all_reduce_counts(samples.double())
    aux["frames"] = samples.long() // cfg.frontend.hop_length
    return loss, aux, grads


def _block_rows(block: tuple[int, int, int] | None
                ) -> tuple[int, int, int] | None:
    """The ``rows`` a stream's draws take: its block, or for an empty block
    row 0's (the stand-in's draws are weighed out with it)."""
    if block is None or block[0] < block[1]:
        return block
    return (0, 1, block[2])


def _micro_loss(cfg: Config, state: TrainState, mb: dict, cmvn,
                tf_rate: float, draws: StepDraws, backend: str | None,
                dp: DP.DataParallel | None,
                blocks: list | None = None) -> tuple[torch.Tensor, dict]:
    """The loss of one microbatch ``mb`` (the fields of
    :func:`loss_and_grads`) with its graph -> (loss, {"ce", "acc"} and
    {"ctc"}, {"text_ae"}, {"pseudo", "pseudo_gate"} where the step runs
    them; the CTC family's {"nll_per_label"} and {"pseudo",
    "pseudo_gate"}; the transducer's {"nll_per_label"} and {"text_ilm"},
    {"pseudo", "pseudo_gate"}; every family's {"mwer", "mwer_risk"} under
    ``objective.lambda_mwer``), normalized by the microbatch's own
    (global) counts; ``blocks``: each stream's block
    (:func:`loss_and_grads`)."""
    obj = cfg.objective
    blocks = blocks or [None, None, None]
    fam = family_terms(cfg)
    tokens = mask_unreal(mb["tokens"], mb["real"])
    b, u = tokens.shape
    rows = _block_rows(blocks[0])
    with torch.no_grad():
        feats, flens = featurize(cfg, mb["audio"], mb["audio_lens"], cmvn,
                                 True, backend, draws.labeled, state.gen,
                                 rows, speed=True, dgen=state.dgen, dp=dp)
    bf16 = cfg.train.bf16_weight_stream
    student = weight_view(state.model, bf16)
    text = None
    if obj.lambda_text_ae > 0.0 and "unlab_text" in mb:
        text = mask_unreal(mb["unlab_text"], mb["unlab_text_real"])
    pseudo = obj.lambda_pseudo > 0.0 and "unlab_audio" in mb
    # the terms' counts: the supervised term's, text targets, kept pseudo
    # labels, the labels of the joint CTC term or of the transducer's
    # lattice, MWER's rows
    zero = torch.zeros((), dtype=torch.float64, device=tokens.device)
    sup, aux_count = fam.step_counts(cfg, tokens, mb["real"])
    counts = [sup.double(), zero, zero, aux_count.double(), zero]
    if obj.lambda_mwer > 0.0:
        counts[4] = LO.mwer_count(tokens).double()
    if text is not None:
        counts[1] = fam.text_count(text).double()
    if pseudo:
        ua, ua_lens, ureal = (mb["unlab_audio"], mb["unlab_audio_lens"],
                              mb["unlab_real"])
        with torch.no_grad():
            clean, clens = featurize(cfg, ua, ua_lens, cmvn, False, backend)
        # hypotheses capped by the labeled stream's token bucket
        max_len = min(cfg.decode.max_decode_len, u)
        labels = draws.pseudo_labels
        if labels is None:
            teacher = (weight_view(state.ema, bf16) if obj.use_ema_teacher
                       else student)
            labels = teacher(fam.step_teacher_labels, cfg, clean, clens,
                             max_len, backend)
        counts[2] = fam.kept_count(labels, obj.pseudo_confidence,
                                   ureal).double()
    counts = torch.stack(counts)
    if dp is not None:
        counts = DP.all_reduce_counts(counts)
    den = torch.clamp_min(counts.float(), 1.0)
    masks = draws.labeled.masks
    if masks is None:
        masks = state.model.dropout_masks(state.dgen, b, feats.shape[1], u,
                                          feats.device, rows)
    loss, aux, enc, enc_mask = student(
        fam.step_supervised, cfg, feats, flens, tokens, mb["real"], tf_rate,
        state.gen, backend, den, cfg.train.remat_encoder, rows, masks)
    if obj.lambda_mwer > 0.0:
        # on the supervised pass's encoder output; before the warmup ends
        # the term is exactly 0 and its beam does not run (the reference's
        # lax.cond)
        if state.step >= obj.mwer_warmup_steps:
            mwer, risk = student(fam.step_mwer, cfg, enc, enc_mask, tokens,
                                 den[4], backend, draws.mwer_nbest)
        else:
            mwer = risk = torch.zeros((), device=tokens.device)
        loss = loss + obj.lambda_mwer * mwer
        aux.update(mwer=mwer.detach(), mwer_risk=risk.detach())
    if text is not None:
        term = student(fam.step_text, cfg, text, den[1], backend)
        loss = loss + obj.lambda_text_ae * term
        aux[fam.TEXT_KEY] = term.detach()
    if pseudo:
        urows = _block_rows(blocks[1])
        with torch.no_grad():
            augmented, _ = featurize(cfg, ua, ua_lens, cmvn, True, backend,
                                     draws.unlabeled, state.gen, urows,
                                     dgen=state.dgen, dp=dp)
        umasks = draws.unlabeled.masks
        if umasks is None:
            umasks = state.model.dropout_masks(
                state.dgen, ua.shape[0], augmented.shape[1], max_len,
                augmented.device, urows)
        pl = student(fam.step_pseudo, cfg, clean, augmented, clens, max_len,
                     ureal, backend, labels, den[2], umasks)
        # the gate multiplies the term, which runs from step 0 (a NaN in
        # it poisons the loss even while the gate is closed, as in JAX)
        gate = float(state.step >= obj.pseudo_warmup_steps)
        loss = loss + obj.lambda_pseudo * gate * pl
        aux.update(pseudo=pl.detach(), pseudo_gate=gate)
    return loss, aux


def family_terms(cfg: Config):
    """The module of the family's terms, one interface for the three
    (``TEXT_KEY``, ``step_counts``, ``step_supervised``, ``step_mwer``,
    ``step_mwer_nbest``, ``text_count``, ``step_text``, ``step_teacher_labels``,
    ``kept_count``, ``step_pseudo``): ``objectives/losses.py`` (LAS),
    ``objectives/ctc_semi.py`` or ``objectives/transducer_semi.py``."""
    return {"ctc": CSEMI, "transducer": TSEMI}.get(cfg.model.family, LO)


@torch.no_grad()
def apply_grads(cfg: Config, state: TrainState,
                grads: list[torch.Tensor]) -> tuple[torch.Tensor, float]:
    """The optimizer chain on ``grads`` (``schedules.update``: the frozen
    leaves zeroed, the clip, one optimizer step), the EMA update and the
    step count -> (the global norm of the gradients as given, the learning
    rate used)."""
    gnorm, lr = schedules.update(state.opt, grads, cfg.train)
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
    draws: list[StepDraws] | None = None,
    backend: str | None = None,
    dp: DP.DataParallel | None = None,
    **unlab,
) -> dict:
    """One update of ``state`` in place (arguments as for
    :func:`loss_and_grads`, the unlabeled batches by keyword) -> metrics:
    0-dim tensors on the device, plus the floats ``tf_rate``, ``lr`` and,
    with the pseudo-label term, ``pseudo_gate``.  Under ``dp`` every rank
    clips and steps the same summed gradient, so the replicas stay
    bitwise equal, and the metrics are the global batch's."""
    loss, aux, grads = loss_and_grads(cfg, state, audio, audio_lens, tokens,
                                      real, cmvn, draws, backend, dp=dp,
                                      **unlab)
    gnorm, lr = apply_grads(cfg, state, grads)
    return dict(aux, loss=loss, grad_norm=gnorm, lr=lr)
