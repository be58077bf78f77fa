"""PyTorch port parity: the supervised train step and its pieces.

Each piece is held against its JAX counterpart on the same numpy inputs:
``masked_ce`` / ``token_accuracy`` (1e-6), the learning-rate schedules
(1e-7 relative), optax's global-norm clip and Adam, ``forward_teacher`` at
teacher-forcing rates 1 and 0 (both deterministic; 1e-5), ``featurize``
with the JAX package's SpecAugment draws, and the whole step: JAX's
``supervised_step_fn`` on the CPU (its XLA scan fallback) against the
port's ``supervised_step`` from the same weights, batch and CMVN at a small
width in float32 -- loss, ce and acc to 1e-5, every gradient leaf to rtol
2e-4 / atol 2e-5, every parameter after the Adam update to 1e-6 (against
JAX's, moved by what the two gradients' difference does to Adam's first
update).  The
port's own SpecAugment draws are checked for their ranges (the bits differ
from ``jax.random`` by design).  The step with ``train.remat_encoder`` and
``train.bf16_weight_stream`` against JAX's with the same settings (the
bound and its reason at ``BF16_STREAM_GRAD_TOL``), and remat on against
off, bitwise.  Then the ``train`` CLI end to end on the CPU, and its
refusals.
"""

import copy
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semi_supervised_asr_tpu.config import (
    ObjectiveConfig, TrainConfig, load_config as jax_load_config,
)
from semi_supervised_asr_tpu.models import speller as JS
from semi_supervised_asr_tpu.objectives import losses as JL
from semi_supervised_asr_tpu.ops import frontend as JF
from semi_supervised_asr_tpu.training import schedules as JSCH
from semi_supervised_asr_tpu.training import train_step as JT
from semi_supervised_asr_tpu_torch import synthetic, weights
from semi_supervised_asr_tpu_torch import train as TRN
from semi_supervised_asr_tpu_torch import transcribe as TR
from semi_supervised_asr_tpu_torch.config import (
    FrontendConfig, load_config,
)
from semi_supervised_asr_tpu_torch.data import pipeline
from semi_supervised_asr_tpu_torch.data.bucketing import make_bucket_spec
from semi_supervised_asr_tpu_torch.data.registry import build_datasets
from semi_supervised_asr_tpu_torch.data.vocab import EOS
from semi_supervised_asr_tpu_torch.models.seq2seq import build_model
from semi_supervised_asr_tpu_torch.objectives import losses as LO
from semi_supervised_asr_tpu_torch.ops import frontend as F
from semi_supervised_asr_tpu_torch.training import schedules as SCH
from semi_supervised_asr_tpu_torch.training import train_step as TS

CONFIG = "configs/timit.yaml"
# configs/timit.yaml cut to a small width: 2 listener layers, float32
SMALL = [
    "model.enc_hidden=32", "model.enc_layers=1", "model.dec_hidden=32",
    "model.attn_dim=16", "model.attn_conv_channels=4",
    "model.attn_conv_width=10", "model.embed_dim=16",
    "model.compute_dtype=float32", "train.batch_size=4",
    "train.warmup_steps=0", "data.dataset=synthetic",
    "data.num_synthetic_utts=8", "data.frame_buckets=[128]",
    "data.token_buckets=[12]",
]
# configs/ls960_conformer.yaml cut to a small width: a 2-block conformer of
# d_model 32, the flash attention route, float32
CONFORMER_CONFIG = "configs/ls960_conformer.yaml"
CONFORMER = [
    "model.enc_hidden=16", "model.enc_heads=2", "model.enc_ff_dim=32",
    "model.enc_blocks=2", "model.conv_channels=4",
    "model.conformer_conv_width=5", "model.attn_backend=flash",
    "model.enc_dropout=0", "model.dec_hidden=32", "model.dec_layers=1",
    "model.attn_dim=16", "model.attn_conv_channels=4",
    "model.attn_conv_width=10", "model.embed_dim=16",
    "model.compute_dtype=float32", "train.batch_size=4",
    "train.warmup_steps=0", "data.sortagrad_epochs=0",
    "data.dataset=synthetic", "data.num_synthetic_utts=8",
    "data.frame_buckets=[128]", "data.token_buckets=[12]",
    "train.async_ckpt=false",
]
TOL_GRAD = dict(rtol=2e-4, atol=2e-5)
# the JAX references run once each, so their XLA compile dominates: the
# cheap backend settings halve it; the results stay inside the tolerances
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: its shapes are tiny, and the
    test workers that share the machine would oversubscribe its cores
    (each small torch op then waits on the other workers' threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def run_jax(fn, *args):
    """fn(*args) through jit, compiled with FAST_XLA."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(*args)


def jax_feat_draws(jcfg, key, audio, audio_lens, speed=False):
    """The draws the JAX package's ``featurize(..., rng=key,
    augment=True, speed=speed)`` makes for this batch (speed factor
    indices, the noise's uniforms and white noise, the SpecAugment bands,
    the warp's w and d), as the port's ``TS.Draws``; computed in one jit,
    as the step computes them."""
    got = run_cached(_feat_draws(jcfg.frontend, speed), key,
                     jnp.asarray(audio).astype(jnp.float32),
                     jnp.asarray(audio_lens))
    def torch_of(v):
        if isinstance(v, tuple):
            return tuple(map(torch_of, v))
        return None if v is None else t(v)

    return TS.Draws(**{k: torch_of(v) for k, v in got.items()})


@functools.lru_cache(maxsize=None)
def _feat_draws(fc, speed):
    def draws(key, wave, lens):
        b, s = wave.shape
        out = dict(speed=None, noise=None, specaug=None, warp=None)
        if speed and fc.speed_perturb:
            k = jax.random.fold_in(key, 11)
            out["speed"] = jax.random.randint(k, (b,), 0,
                                              len(fc.speed_perturb))
            _, lens = JF.speed_perturb(k, wave, lens, fc.speed_perturb)
        if fc.noise_aug_prob > 0.0:
            src = tuple(fc.noise_sources)
            ka, ks, kc, kw = jax.random.split(jax.random.fold_in(key, 13), 4)
            out["noise"] = (
                jax.random.uniform(ka, (b,)), jax.random.uniform(ks, (b,)),
                jax.random.randint(kc, (b,), 0, len(src))
                if len(src) > 1 else None,
                jax.random.normal(kw, (b, s))
                if "white" in src or b == 1 else None)
        frames = JF.frame_lengths(jnp.asarray([s]), fc)[0]
        flens = jnp.minimum(JF.frame_lengths(lens, fc), frames)
        if fc.spec_augment:
            out["specaug"] = JF.sample_specaug_params(key, b, fc.n_mels,
                                                      flens, fc)
            if fc.time_warp_param > 0:
                w_ = fc.time_warp_param
                kw, kd = jax.random.split(jax.random.fold_in(key, 7))
                lf = flens.astype(jnp.float32)
                w = jnp.floor(w_ + jax.random.uniform(kw, (b,))
                              * jnp.maximum(lf - 2 * w_, 1.0))
                d = jnp.round(jax.random.uniform(kd, (b,)) * (2 * w_) - w_)
                out["warp"] = (w, d)
        return out

    return draws


def jax_pass_masks(mcfg, model, rng, b, frames, u):
    """The dropout keep masks of the JAX package's ``forward_teacher(...,
    rng, train=True)`` for features [b, frames] and u decoder steps ->
    (listener masks, speller masks [b, u, D]), each None at rate 0."""
    enc_shapes = tuple(model.listener.dropout_shapes(b, frames)) \
        if mcfg.enc_dropout > 0.0 else ()
    dec_shape = model.speller.dropout_shape(b, u) \
        if mcfg.dec_dropout > 0.0 else None
    enc, dec = run_cached(_pass_masks(mcfg.enc_dropout, mcfg.dec_dropout,
                                      enc_shapes, dec_shape), rng)
    return ([t(m) for m in enc] if enc_shapes else None,
            None if dec is None else t(dec))


@functools.lru_cache(maxsize=None)
def _pass_masks(enc_rate, dec_rate, enc_shapes, dec_shape):
    def masks(rng):
        rng, drop = jax.random.split(rng)
        enc = [jax.random.bernoulli(jax.random.fold_in(drop, i),
                                    1.0 - enc_rate, shape)
               for i, shape in enumerate(enc_shapes)]
        dec = None
        if dec_shape is not None and len(dec_shape) == 4:
            # the transformer speller: site i of [b, u, d] from
            # fold_in(rng, i), stacked on axis 1
            b, sites, u, width = dec_shape
            dec = jnp.stack([jax.random.bernoulli(
                jax.random.fold_in(rng, i), 1.0 - dec_rate, (b, u, width))
                for i in range(sites)], axis=1)
        elif dec_shape is not None:
            b, u, width = dec_shape
            steps = jax.random.split(rng, u)
            dec = jnp.stack([jax.random.bernoulli(
                jax.random.fold_in(steps[i], 1), 1.0 - dec_rate, (b, width))
                for i in range(u)], axis=1)
        return enc, dec

    return masks


_COMPILED = {}


def run_cached(fn, *args):
    """fn(*args) through jit, compiled with FAST_XLA once per function and
    argument shapes."""
    sig = (fn, *((a.shape, a.dtype) for a in args))
    if sig not in _COMPILED:
        _COMPILED[sig] = jax.jit(fn).lower(*args).compile(
            compiler_options=FAST_XLA)
    return _COMPILED[sig](*args)


@pytest.mark.parametrize("smoothing", [0.0, 0.05])
def test_masked_ce_and_accuracy_match_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 7, 65)).astype(np.float32) * 3
    targets = rng.integers(3, 65, (4, 7)).astype(np.int32)
    targets[1, 4:] = 0
    targets[3, :] = 0
    targets[2, 2] = logits[2, 2].argmax()        # a hit for the accuracy
    ref_ce, ref_lp, ref_acc, (ref_ins, _) = run_jax(
        lambda lg, y: (*JL.masked_ce(lg, y, smoothing),
                       JL.token_accuracy(lg, y), JL.shift_targets(y)),
        jnp.asarray(logits), jnp.asarray(targets))
    ce, lp = LO.masked_ce(t(logits), t(targets), smoothing)
    np.testing.assert_allclose(ce.item(), float(ref_ce), rtol=1e-6)
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), rtol=1e-6,
                               atol=1e-6)
    acc = LO.token_accuracy(t(logits), t(targets))
    np.testing.assert_allclose(acc.item(), float(ref_acc), rtol=1e-6)
    ins, tg = LO.shift_targets(t(targets))
    np.testing.assert_array_equal(ins.numpy(), np.asarray(ref_ins))
    assert tg is not None


@pytest.mark.parametrize("schedule",
                         ["constant", "cosine", "exponential", "noam"])
def test_learning_rate_schedule_matches_optax(schedule):
    cfg = TrainConfig(learning_rate=5e-4, lr_schedule=schedule,
                      warmup_steps=100, decay_steps=1000, lr_min_ratio=0.1)
    ref = JSCH.learning_rate_schedule(cfg)
    got = SCH.learning_rate_schedule(cfg)
    for step in (0, 1, 99, 100, 101, 600, 1100, 5000):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-7,
                                   err_msg=f"step {step}")
    obj = ObjectiveConfig(tf_rate_start=1.0, tf_rate_end=0.8,
                          tf_decay_steps=300)
    for step in (0, 1, 150, 300, 900):
        np.testing.assert_allclose(SCH.tf_rate_at(step, obj),
                                   float(JSCH.tf_rate_at(step, obj)),
                                   rtol=1e-7)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_and_adam_match_optax(scale):
    """One clipped Adam update: clip scales only above the threshold."""
    rng = np.random.default_rng(1)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,))]
    grads = [rng.standard_normal(p.shape).astype(np.float32) * scale
             for p in params]
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=0,
                      lr_schedule="constant", grad_clip_norm=5.0)
    opt = JSCH.make_optimizer(cfg)
    jp = [jnp.asarray(p) for p in params]
    want = run_jax(
        lambda g, p: optax.apply_updates(p, opt.update(g, opt.init(p), p)[0]),
        [jnp.asarray(g) for g in grads], jp)
    tparams = [t(p.copy()) for p in params]
    tgrads = [t(g.copy()) for g in grads]
    norm = SCH.global_norm(tgrads)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)),
                               rtol=1e-6)
    SCH.clip_by_global_norm(tgrads, cfg.grad_clip_norm, norm)
    SCH.Adam(tparams, cfg).step(tgrads)
    for got, ref in zip(tparams, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


def test_specaug_draws_respect_the_ranges():
    cfg = FrontendConfig(n_mels=80, freq_mask_param=15, n_freq_masks=2,
                         time_mask_param=35, n_time_masks=2)
    lens = torch.tensor([400, 123, 7, 1, 0, 250], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    seen_w = set()
    for _ in range(200):
        fs, fw, ts, tw = F.sample_specaug_params(gen, 6, 80, lens, cfg)
        assert all(x.dtype == torch.int32 for x in (fs, fw, ts, tw))
        assert ((fw >= 0) & (fw <= 15)).all()
        assert ((fs >= 0) & (fs + fw <= 80)).all()
        cap = torch.clamp_max((0.2 * lens.float()).int(), 35)[:, None]
        assert ((tw >= 0) & (tw <= cap)).all()
        assert ((ts >= 0) & (ts + tw <= torch.clamp_min(lens, 1)[:, None])
                ).all()
        seen_w.update(fw.flatten().tolist())
    assert seen_w == set(range(16))      # every width 0..F is drawn


def jax_step_draws(jcfg, model, rng, audio, audio_lens, tokens,
                   unlab_audio=None, unlab_lens=None):
    """Every draw of the JAX package's ``supervised_step_fn`` from
    ``state.rng = rng``, as the port's one ``TS.StepDraws`` per
    microbatch: microbatch i's key is ``fold_in(k_step, i)`` under
    ``train.grad_accum`` (else ``k_step``), split into the labeled view's
    featurize key, the supervised pass's, the augmented unlabeled view's
    and the pseudo-label student's."""
    accum = max(int(jcfg.train.grad_accum), 1)
    _, k_step = jax.random.split(rng)

    def frames(a):
        return int(JF.frame_lengths(jnp.asarray([a.shape[1]]),
                                    jcfg.frontend)[0])

    m, u = audio.shape[0] // accum, tokens.shape[1]
    out = []
    for i in range(accum):
        key = jax.random.fold_in(k_step, i) if accum > 1 else k_step
        k_feat, k_tf, k_pl_feat, k_pl = jax.random.split(key, 4)
        sl = slice(i * m, (i + 1) * m)
        lab = jax_feat_draws(jcfg, k_feat, audio[sl], audio_lens[sl],
                             speed=True)
        lab.masks = jax_pass_masks(jcfg.model, model, k_tf, m, frames(audio),
                                   u)
        step = TS.StepDraws(lab)
        if unlab_audio is not None:
            mu = unlab_audio.shape[0] // accum
            su = slice(i * mu, (i + 1) * mu)
            step.unlabeled = jax_feat_draws(jcfg, k_pl_feat, unlab_audio[su],
                                            unlab_lens[su])
            step.unlabeled.masks = jax_pass_masks(
                jcfg.model, model, k_pl, mu, frames(unlab_audio),
                min(jcfg.decode.max_decode_len, u))
        out.append(step)
    return out


def make_step_setup(config, overrides, after=("frontend.spec_augment=false",)):
    """Both configs, the JAX parameter tree, a batch with a filler row, and
    the CMVN statistics (``after``: overrides applied last)."""
    pcfg = load_config(config, overrides + list(after))
    bundle = build_datasets(pcfg)
    pcfg = TR.finalize_config(pcfg, bundle.vocab.size)
    jcfg = jax_load_config(config, overrides + list(after))
    jcfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, vocab_size=bundle.vocab.size, n_mels=80))
    spec = make_bucket_spec(pcfg.data, pcfg.frontend,
                            pcfg.model.time_reduction)
    batch = pipeline.assemble_batch(bundle.train, [0, 1, 2, 0], 3, (128, 12),
                                    spec, pcfg.frontend)
    cmvn = pipeline.compute_global_cmvn(bundle.train, pcfg.frontend)
    flat = weights.init_numpy(pcfg.model, seed=0)
    return pcfg, jcfg, batch, cmvn, flat


@pytest.fixture(scope="module")
def step_setup():
    return make_step_setup(CONFIG, SMALL)


def port_model(cfg, flat):
    model = build_model(cfg.model)
    weights.load_flat(model, flat)
    return model


@pytest.mark.parametrize("tf_rate", [1.0, 0.0])
def test_forward_teacher_matches_jax(tf_rate):
    """tf_rate 1 (ground truth) and 0 (argmax feedback) are deterministic
    on both sides; B=8, U=6, enc 128, dec 128, vocab 65."""
    check_forward_teacher(tf_rate)


@pytest.mark.parametrize("tf_rate", [1.0, 0.0])
def test_forward_teacher_with_dec_dropout_matches_jax(tf_rate):
    """``model.dec_dropout`` 0.3 in training: the port's speller takes the
    per-step keep masks JAX's ``forward_teacher(..., train=True)`` draws
    (``fold_in(step_rngs[s], 1)``, step 0 included)."""
    check_forward_teacher(tf_rate, dec_dropout=0.3)


def check_forward_teacher(tf_rate, dec_dropout=0.0):
    over = ["model.enc_hidden=64", "model.dec_hidden=128",
            "model.compute_dtype=float32", f"model.dec_dropout={dec_dropout}"]
    cfg = TR.finalize_config(load_config(CONFIG, over), 65)
    flat = weights.init_numpy(cfg.model, seed=2)
    speller = port_model(cfg, flat).speller
    rng = np.random.default_rng(3)
    b, tt, u = 8, 10, 6
    enc = rng.standard_normal((b, tt, cfg.model.enc_out_dim)).astype(
        np.float32)
    mask = np.arange(tt)[None, :] < np.asarray([10, 3, 7, 10, 1, 8, 9, 5]
                                               )[:, None]
    tokens = rng.integers(3, 65, (b, u)).astype(np.int32)
    tokens[:, 0] = 1
    jcfg = jax_load_config(CONFIG, over)
    jcfg = dataclasses.replace(jcfg.model, vocab_size=65, n_mels=80)
    sp = jax.tree.map(jnp.asarray, weights.unflatten_tree(flat)["speller"])
    train = dec_dropout > 0
    ref = run_jax(
        lambda p, e, m, tk, k: JS.forward_teacher(p, jcfg, e, m, tk,
                                                  tf_rate, k, train),
        sp, jnp.asarray(enc), jnp.asarray(mask), jnp.asarray(tokens),
        jax.random.PRNGKey(0))
    masks = None
    if train:
        steps = jax.random.split(jax.random.PRNGKey(0), u)
        masks = torch.stack([t(jax.random.bernoulli(
            jax.random.fold_in(steps[s], 1), 1.0 - dec_dropout,
            (b, cfg.model.dec_hidden + cfg.model.enc_out_dim)))
            for s in range(u)], dim=1)
        assert speller.dropout_shape(b, u) == tuple(masks.shape)
    with torch.no_grad():
        got = speller.forward_teacher(t(enc), t(mask), t(tokens), tf_rate,
                                      torch.Generator().manual_seed(0),
                                      drop_masks=masks)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_featurize_with_jax_specaug_bands_matches_jax(step_setup):
    """The port's featurize, given the bands the JAX package's SpecAugment
    draws from a key, gives JAX's augmented features (noise audio, as in
    tests/test_torch_frontend.py, so no frame sits at the log floor)."""
    pcfg, _, _, cmvn, _ = step_setup
    jcfg = jax_load_config(CONFIG, SMALL)
    rng = np.random.default_rng(5)
    s = (128 - 1) * pcfg.frontend.hop_length
    audio = (rng.standard_normal((4, s)) * 0.1).astype(np.float32)
    lens = np.asarray([s, s - 3000, 0, 901], np.int32)
    audio *= np.arange(s)[None, :] < lens[:, None]
    key = jax.random.PRNGKey(7)
    jmean, jistd = jnp.asarray(cmvn[0]), jnp.asarray(cmvn[1])
    ref, ref_lens = run_jax(
        functools.partial(JT.featurize, jcfg, augment=True),
        jnp.asarray(audio), jnp.asarray(lens), (jmean, jistd), key)
    # the draws JAX's spec_augment makes inside featurize
    bands = run_jax(lambda k, n: JF.sample_specaug_params(
        k, 4, 80, n, jcfg.frontend), key, ref_lens)
    assert int(np.asarray(bands[1]).sum() + np.asarray(bands[3]).sum()) > 0
    pcfg = dataclasses.replace(pcfg, frontend=dataclasses.replace(
        pcfg.frontend, spec_augment=True))
    got, got_lens = TS.featurize(pcfg, t(audio), t(lens),
                                 (t(cmvn[0]), t(cmvn[1])), augment=True,
                                 draws=TS.Draws(
                                     specaug=tuple(t(x) for x in bands)))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def stash():
    """An optax transformation that keeps the gradients in its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def test_supervised_step_matches_jax(step_setup):
    check_supervised_step(*step_setup)


def test_conformer_supervised_step_matches_jax():
    """The same step with a tiny conformer listener under attn_backend
    flash (its MHSA on the plain version of K5 here); one block, so that
    JAX's compile stays short."""
    check_supervised_step(*make_step_setup(
        CONFORMER_CONFIG, CONFORMER + ["model.enc_blocks=1",
                                       "model.conformer_conv_width=3"]))


# every regularization and augmentation option of the recipes at once,
# with two microbatches
EVERY_DRAW = [
    "train.grad_accum=2", "model.enc_dropout=0.2", "model.dec_dropout=0.2",
    "frontend.spec_augment=true", "frontend.time_warp_param=5",
    "frontend.speed_perturb=[0.9,1.0,1.1]", "frontend.noise_aug_prob=0.7",
    "frontend.noise_sources=[white,babble]"]


def test_accumulated_step_with_every_draw_matches_jax():
    """``train.grad_accum=2`` with encoder and decoder dropout, speed
    perturbation, white and babble noise, the SpecAugment bands and time
    warp: JAX's step against the port's, each microbatch fed JAX's draws
    (its own key, ``fold_in(k_step, i)``), at the step test's
    tolerances."""
    setup = make_step_setup(CONFIG, SMALL, after=EVERY_DRAW)
    pcfg, _, batch, _, flat = setup
    draws = jax_step_draws(setup[1], port_model(pcfg, flat),
                           jax.random.PRNGKey(0), batch.audio,
                           batch.audio_lens, batch.tokens)
    assert len(draws) == 2 and all(
        d.labeled.masks[0] is not None and d.labeled.masks[1] is not None
        and d.labeled.warp is not None for d in draws)
    check_supervised_step(*setup, draws=draws)


def test_accum_matches_full_batch(step_setup):
    """The identity of tests/test_train_step.py::
    test_accum_matches_full_batch: with equal audio and token lengths in
    every row (so each microbatch's own normalization equals the full
    batch's), ``train.grad_accum=2`` gives the full batch's loss (1e-5)
    and, through a plain gradient step (linear in the gradient, as the
    reference's SGD), its parameters (rtol 1e-3 / atol 1e-5).  A batch
    that does not divide raises."""
    pcfg, _, batch, cmvn, flat = step_setup
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal(batch.audio.shape) * 0.1).astype(
        np.float32)
    tokens = np.zeros_like(batch.tokens)
    tokens[:, :7] = rng.integers(3, pcfg.model.vocab_size, (4, 7))
    tokens[:, 7] = EOS
    args = (t(audio), torch.full((4,), audio.shape[1], dtype=torch.int32),
            t(tokens), torch.ones(4, dtype=torch.bool),
            (t(cmvn[0]), t(cmvn[1])))
    out = {}
    for accum in (1, 2, 3):
        cfg = pcfg.replace(train=dataclasses.replace(pcfg.train,
                                                     grad_accum=accum))
        st = TS.init_train_state(cfg, port_model(cfg, flat), seed=0)
        if accum == 3:
            with pytest.raises(ValueError, match="grad_accum 3"):
                TS.loss_and_grads(cfg, st, *args)
            continue
        loss, _, grads = TS.loss_and_grads(cfg, st, *args)
        out[accum] = loss, [(p - 0.1 * g).detach().numpy()
                            for p, g in zip(st.opt.params, grads)]
    np.testing.assert_allclose(out[2][0].item(), out[1][0].item(), rtol=1e-5)
    for a, b in zip(out[2][1], out[1][1]):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


def check_supervised_step(pcfg, jcfg, batch, cmvn, flat, draws=None,
                          keys=("loss", "ce", "acc", "grad_norm")):
    """The port's step against JAX's from the same state -> the port's
    metrics (``keys``: the metrics compared)."""
    tree = jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))
    opt = optax.chain(stash(), JSCH.make_optimizer(jcfg.train))
    state = JT.TrainState(params=tree, opt_state=run_jax(opt.init, tree),
                          ema_params=tree, step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(0))
    new_state, ref = run_jax(
        functools.partial(JT.supervised_step_fn, jcfg, opt), state,
        jnp.asarray(batch.audio), jnp.asarray(batch.audio_lens),
        jnp.asarray(batch.tokens), jnp.asarray(batch.real),
        (jnp.asarray(cmvn[0]), jnp.asarray(cmvn[1])))
    ref_grads = weights.flatten_tree(
        jax.tree.map(np.asarray, new_state.opt_state[0]))
    ref_params = weights.flatten_tree(
        jax.tree.map(np.asarray, new_state.params))

    args = (t(batch.audio), t(batch.audio_lens), t(batch.tokens),
            t(batch.real), (t(cmvn[0]), t(cmvn[1])))
    model = port_model(pcfg, flat)
    st = TS.init_train_state(pcfg, copy.deepcopy(model), seed=0)
    _, _, grads = TS.loss_and_grads(pcfg, st, *args, draws)
    st = TS.init_train_state(pcfg, model, seed=0)
    got = TS.supervised_step(pcfg, st, *args, draws)
    for k in (*keys, *(k for k in ("ctc", "nll_per_label") if k in ref)):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    assert got["tf_rate"] == float(ref["tf_rate"]) == 1.0
    assert int(got["frames"]) == int(ref["frames"])
    assert st.step == 1
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref_grads)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref_grads[n], **TOL_GRAD,
                                   err_msg=n)
    # Adam's first update is u(g) = g / (|g| + 1e-8) (no clip here: the
    # norm is far below 5).  Where |g| is within a few eps (1e-8) of zero,
    # float32 noise that the two frameworks sum differently moves u by a
    # visible fraction, so the port's parameters are held to JAX's moved by
    # exactly that difference of the (already compared) gradients: every
    # entry to 1e-6.
    assert float(ref["grad_norm"]) < pcfg.train.grad_clip_norm
    lr = pcfg.train.learning_rate

    def u(g):
        return g.astype(np.float64) / (np.abs(g) + 1e-8)

    for (n, p), g in zip(model.named_parameters(), grads):
        want = ref_params[n] - lr * (u(g.numpy()) - u(ref_grads[n]))
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6, err_msg=n)
    return got


# train.remat_encoder + train.bf16_weight_stream against JAX: both cast
# every float32 parameter to bf16 inside the loss, and a weight used at
# every decoder step sums its per-step gradients in bf16 (the reference's
# scan transpose of its bf16 parameters, the port's autograd over the bf16
# copy).  The two sum in other orders, so an entry can land one bf16 ulp
# (2^-8 of it) away; elsewhere the float32 sums differ by ~1e-6 relative
# (test_supervised_step_matches_jax).  So every entry is held within
# chip_smoke.py's bound for a bf16 step (BF16_STEP_GRAD_TOL of the model's
# largest gradient entry) or one bf16 ulp of itself, whichever is larger,
# and the loss within its BF16_STEP_LOSS_TOL.
BF16_STREAM_LOSS_TOL = 1e-5
BF16_STREAM_GRAD_TOL = 1e-3


def test_remat_and_bf16_weight_stream_step_matches_jax(step_setup):
    pcfg, jcfg, batch, cmvn, flat = step_setup
    over = dict(remat_encoder=True, bf16_weight_stream=True)
    pcfg = pcfg.replace(train=dataclasses.replace(pcfg.train, **over))
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **over))
    tree = jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))
    opt = optax.chain(stash(), JSCH.make_optimizer(jcfg.train))
    state = JT.TrainState(params=tree, opt_state=run_jax(opt.init, tree),
                          ema_params=tree, step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(0))
    new_state, ref = run_jax(
        functools.partial(JT.supervised_step_fn, jcfg, opt), state,
        jnp.asarray(batch.audio), jnp.asarray(batch.audio_lens),
        jnp.asarray(batch.tokens), jnp.asarray(batch.real),
        (jnp.asarray(cmvn[0]), jnp.asarray(cmvn[1])))
    ref_grads = weights.flatten_tree(
        jax.tree.map(np.asarray, new_state.opt_state[0]))
    model = port_model(pcfg, flat)
    st = TS.init_train_state(pcfg, model, seed=0)
    loss, aux, grads = TS.loss_and_grads(
        pcfg, st, t(batch.audio), t(batch.audio_lens), t(batch.tokens),
        t(batch.real), (t(cmvn[0]), t(cmvn[1])))
    np.testing.assert_allclose(loss.item(), float(ref["loss"]),
                               rtol=BF16_STREAM_LOSS_TOL)
    names = [n for n, _ in model.named_parameters()]
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    for n, g in zip(names, grads):
        assert g.dtype == torch.float32
        got, want = g.numpy(), ref_grads[n]
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(
            np.abs(got), np.abs(want)) + 1e-30)) - 7)
        bound = np.maximum(BF16_STREAM_GRAD_TOL * scale, ulp)
        worst = float((np.abs(got - want) / bound).max())
        assert worst <= 1.0, (n, worst)
        # the gradient came back through the bf16 copy
        assert torch.equal(g, g.to(torch.bfloat16).float()), n
    # the masters stay float32 and move
    apply = TS.apply_grads(pcfg, st, grads)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert math.isfinite(float(apply[0]))


@pytest.mark.parametrize("bf16, dropout", [(False, 0.0), (True, 0.0),
                                           (False, 0.2)],
                         ids=["False", "True", "dropout"])
def test_remat_encoder_gradients_bitwise_equal(step_setup, bf16, dropout):
    """The listener recomputed in the backward gives the same bits in
    float32 on the CPU, with and without the bf16 weight stream, and with
    encoder and decoder dropout (the masks drawn once, before the
    checkpointed region, and handed to the recomputation)."""
    pcfg, _, batch, cmvn, flat = step_setup
    args = (t(batch.audio), t(batch.audio_lens), t(batch.tokens),
            t(batch.real), (t(cmvn[0]), t(cmvn[1])))
    pcfg = pcfg.replace(model=dataclasses.replace(
        pcfg.model, enc_dropout=dropout, dec_dropout=dropout))
    out = []
    for remat in (False, True):
        cfg = pcfg.replace(train=dataclasses.replace(
            pcfg.train, remat_encoder=remat, bf16_weight_stream=bf16))
        st = TS.init_train_state(cfg, port_model(cfg, flat), seed=0)
        out.append(TS.loss_and_grads(cfg, st, *args))
    (l0, _, g0), (l1, _, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    if dropout:
        # the masks did drop: the loss moved off the dropout-free one
        st = TS.init_train_state(step_setup[0],
                                 port_model(step_setup[0], flat), seed=0)
        assert not torch.equal(TS.loss_and_grads(step_setup[0], st,
                                                 *args)[0], l0)


TINY = ["model.enc_hidden=16", "model.enc_layers=1", "model.dec_hidden=16",
        "model.attn_dim=8", "model.attn_conv_channels=2",
        "model.attn_conv_width=4", "model.embed_dim=8",
        "model.compute_dtype=float32", "train.batch_size=4",
        "data.dataset=synthetic", "data.num_synthetic_utts=6",
        "data.frame_buckets=[128]", "data.token_buckets=[12]",
        "decode.max_decode_len=8"]


def train_records(workdir):
    """The per-step records of metrics.jsonl (the Solver also logs "data"
    and "wall" records there)."""
    return [r for r in map(json.loads, (workdir / "metrics.jsonl")
                           .read_text().splitlines())
            if r["prefix"] == "train"]


def test_train_cli_then_transcribe_on_cpu(tmp_path, capsys):
    d = tmp_path / "run"
    argv = ["--config", CONFIG, "--workdir", str(d), "--steps", "2",
            "--device", "cpu", *TINY]
    assert TRN.main(argv) == 0
    recs = train_records(d)
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert set(TRN.METRIC_KEYS) <= set(r)
        assert all(math.isfinite(r[k]) for k in TRN.METRIC_KEYS)
    cfg = TR.finalize_config(load_config(CONFIG, TINY), 65)
    wav = synthetic.write_wavs(tmp_path, cfg, build_datasets(cfg).vocab, 1)
    out = tmp_path / "hyps.jsonl"
    assert TR.main(["--config", CONFIG, "--load-dir", str(d), "--device",
                    "cpu", "--beam", "1", "--out", str(out), str(wav[0]),
                    *TINY]) == 0
    assert json.loads(out.read_text())["audio"] == str(wav[0])


def test_train_cli_semi_on_cpu(tmp_path):
    """configs/ls100_semi.yaml (text autoencoder, EMA-teacher pseudo-labels,
    the unlabeled streams) at the tiny width: the pseudo-label gate is
    closed at step 0 and open from step 1."""
    d = tmp_path / "semi"
    assert TRN.main(["--config", "configs/ls100_semi.yaml", "--workdir",
                     str(d), "--steps", "2", "--device", "cpu", *TINY,
                     "objective.pseudo_warmup_steps=1"]) == 0
    recs = train_records(d)
    assert [r["pseudo_gate"] for r in recs] == [0.0, 1.0]
    for r in recs:
        assert all(math.isfinite(r[k])
                   for k in TRN.METRIC_KEYS + TRN.SEMI_KEYS)
        assert r["text_ae"] > 0


@pytest.mark.parametrize("override, message", [
    ("model.param_dtype=bfloat16", "model.param_dtype"),
    ("train.freeze=[listener]", "train.freeze"),
    ("train.checkify_errors=nan", "train.checkify_errors"),
    ("objective.lambda_mwer=0.2", "objective.lambda_mwer"),
])
def test_train_cli_refuses_unported_options(tmp_path, override, message):
    with pytest.raises(SystemExit, match=message):
        TRN.main(["--config", CONFIG, "--workdir", str(tmp_path), "--steps",
                  "1", "--device", "cpu", *TINY, override])


@pytest.mark.parametrize("override, message", [
    ("train.optimizer=adamw", "train.optimizer"),
    ("data.use_feature_store=true", "data.use_feature_store"),
    ("parallel.model_parallel=2", "parallel.model_parallel"),
])
def test_train_cli_refuses_unported_conformer_options(tmp_path, override,
                                                      message):
    with pytest.raises(SystemExit, match=message):
        TRN.main(["--config", CONFORMER_CONFIG, "--workdir", str(tmp_path),
                  "--steps", "1", "--device", "cpu", *CONFORMER, override])


# the three recipes whose options this slice ports, at a tiny width: each
# keeps what it ships (ls100_bpe: BPE units, time warp W=80;
# ls960_conformer: enc_dropout; ls960_transformer: enc_dropout under
# remat_encoder)
RECIPE_TINY = ["model.enc_hidden=16", "model.dec_hidden=16",
               "model.attn_dim=8", "model.attn_conv_channels=2",
               "model.attn_conv_width=4", "model.embed_dim=8",
               "train.batch_size=4", "data.dataset=synthetic",
               "data.num_synthetic_utts=8", "data.token_buckets=[12]",
               "decode.max_decode_len=8", "train.total_steps=1",
               "train.eval_every=0", "train.log_every=1"]
RECIPES = {
    "ls100_bpe": ["model.enc_layers=1", "data.bpe_path=",
                  "data.frame_buckets=[128]"],
    "ls960_conformer": ["model.enc_blocks=1", "model.enc_heads=2",
                        "model.enc_ff_dim=32", "model.dec_layers=1",
                        "model.attn_backend=flash",
                        "data.frame_buckets=[160]"],
    "ls960_transformer": ["model.enc_blocks=1", "model.enc_heads=2",
                          "model.enc_ff_dim=32", "model.dec_layers=1",
                          "model.attn_backend=flash",
                          "data.frame_buckets=[160]"],
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_main_trains_the_recipe_as_shipped(name, tmp_path, capsys):
    from semi_supervised_asr_tpu_torch import main as M

    config = f"configs/{name}.yaml"
    over = RECIPE_TINY + RECIPES[name]
    cfg = load_config(config, over)
    assert (cfg.data.unit == "bpe" and cfg.frontend.time_warp_param == 80
            if name == "ls100_bpe" else cfg.model.enc_dropout == 0.1)
    assert cfg.train.remat_encoder == (name == "ls960_transformer")
    assert M.main(["--config", config, "--train", "--workdir",
                   str(tmp_path), "--device", "cpu", *over]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert math.isfinite(out["final_dev"]["dev_error"])
    rec, = train_records(tmp_path)
    assert math.isfinite(rec["loss"])


def test_train_cli_needs_cuda_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        TRN.main(["--config", CONFIG, "--workdir", str(tmp_path), "--steps",
                  "1", *TINY])
