"""PyTorch port parity: the audio frontend and the fused post-FFT kernel K1.

Inputs are drawn with numpy from a seed and fed to the JAX reference and
to the port alike.  K1's plain version is held against the Pallas kernel
in interpret mode at the reference's own tolerance, 1e-5
(tests/test_pallas_frontend.py); the CUDA kernel itself is compared with
that plain version on the card by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.config import Config, FrontendConfig
from semi_supervised_asr_tpu.ops import frontend as JF
from semi_supervised_asr_tpu.ops import frontend_oracle as oracle
from semi_supervised_asr_tpu.ops import pallas_frontend as PF
from semi_supervised_asr_tpu.training import train_step as JTS
from semi_supervised_asr_tpu_torch import _native
from semi_supervised_asr_tpu_torch.ops import frontend as TF
from semi_supervised_asr_tpu_torch.ops import fused_frontend as TFF
from semi_supervised_asr_tpu_torch.training import train_step as TTS
from tests.test_torch_train import jax_feat_draws, run_jax
from tests.test_torch_train import one_thread  # noqa: F401 -- autouse

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = FrontendConfig(cmvn="global", spec_augment=True)


def audio_batch(seed, b=3, frames=48, cfg=CFG):
    rng = np.random.default_rng(seed)
    s = (frames - 1) * cfg.hop_length
    audio = (rng.standard_normal((b, s)) * 0.1).astype(np.float32)
    lens = np.asarray([s, s - 2 * cfg.hop_length, s - 7 * cfg.hop_length,
                       0, 5 * cfg.hop_length + 3][:b], np.int32)
    lm = oracle.log_mel(audio[0].astype(np.float64), cfg)
    mean, inv_std = oracle.cmvn_stats(lm)
    return audio, lens, mean.astype(np.float32), inv_std.astype(np.float32)


def pspec_batch(seed, b=3, t=48):
    rng = np.random.default_rng(seed)
    pspec = np.exp(rng.standard_normal((b, t, 257)) * 2.0).astype(np.float32)
    lens = np.asarray([t, t - 5, 17][:b], np.int32)
    mean = rng.standard_normal(80).astype(np.float32)
    istd = rng.uniform(0.5, 2.0, 80).astype(np.float32)
    return pspec, lens, mean, istd


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("augment", [False, True])
def test_fused_post_fft_plain_matches_pallas(augment):
    pspec, lens, mean, istd = pspec_batch(1 + augment)
    specaug = None
    if augment:
        specaug = tuple(np.asarray(x) for x in run_jax(
            lambda k, n: JF.sample_specaug_params(k, pspec.shape[0], 80, n,
                                                  CFG),
            jax.random.PRNGKey(7), jnp.asarray(lens)))
        assert sum(int(w.sum()) for w in (specaug[1], specaug[3])) > 0
    ref = run_jax(lambda p, n, m, i, *sa: PF.fused_post_fft(
        p, n, CFG, m, i, sa or None, interpret=True),
        jnp.asarray(pspec), jnp.asarray(lens), jnp.asarray(mean),
        jnp.asarray(istd),
        *(() if specaug is None else tuple(map(jnp.asarray, specaug))))
    got = TFF.fused_post_fft(
        t(pspec), t(lens), CFG, t(mean), t(istd),
        None if specaug is None else tuple(map(t, specaug)),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fused_wrapper_takes_plain_version_for_cpu_tensors():
    pspec, lens, mean, istd = pspec_batch(3)
    before = dict(_native.LAUNCHES)
    got = TFF.fused_post_fft(t(pspec), t(lens), CFG, t(mean), t(istd))
    want = TFF.fused_post_fft_reference(t(pspec), t(lens), CFG, t(mean),
                                        t(istd))
    assert _native.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="backend"):
        TFF.fused_post_fft(t(pspec), t(lens), CFG, t(mean), t(istd),
                           backend="cuda")


@pytest.mark.parametrize("scale", ["slaney", "htk"])
def test_packed_mel_runs_rebuild_the_bank(scale):
    """The kernel sums each filter over its packed run of non-zero bins;
    the runs must hold every non-zero weight of the dense bank."""
    cfg = dataclasses.replace(CFG, mel_scale=scale)
    w, lo, off = TFF._mel_runs_np(cfg)
    _, fb = TF.host_constants(cfg)
    dense = np.zeros_like(fb)
    for m in range(fb.shape[1]):
        dense[lo[m]:lo[m] + off[m + 1] - off[m], m] = w[off[m]:off[m + 1]]
    np.testing.assert_array_equal(dense, fb)
    assert off[-1] < fb.size // 10          # triangular: mostly zeros


@pytest.mark.parametrize("backend", ["matmul", "xla"])
def test_log_mel_features_matches_jax(backend):
    cfg = dataclasses.replace(CFG, fft_backend=backend)
    audio, lens, mean, istd = audio_batch(4, b=5, frames=56, cfg=cfg)
    ref, ref_lens = run_jax(
        lambda a, n, m, i: JF.log_mel_features(a, n, cfg, m, i),
        jnp.asarray(audio), jnp.asarray(lens), jnp.asarray(mean),
        jnp.asarray(istd))
    got, got_lens = TF.log_mel_features(t(audio), t(lens), cfg, t(mean),
                                        t(istd))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the fused path (K1's plain version on CPU) agrees with the unfused one
    fused, _ = TTS.featurize(Config(frontend=cfg), t(audio), t(lens),
                             (t(mean), t(istd)))
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref), **TOL)


def test_utterance_cmvn_matches_jax():
    cfg = dataclasses.replace(CFG, cmvn="utterance")
    audio, lens, _, _ = audio_batch(5, b=3)
    ref, _ = run_jax(lambda a, n: JF.log_mel_features(a, n, cfg),
                     jnp.asarray(audio), jnp.asarray(lens))
    got, _ = TF.log_mel_features(t(audio), t(lens), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_featurize_int16_matches_jax():
    cfg = Config(frontend=dataclasses.replace(CFG, fft_backend="matmul"))
    audio, lens, mean, istd = audio_batch(6, b=4, frames=64)
    pcm = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
    ref, ref_lens = run_jax(
        lambda a, n, m, i: JTS.featurize(cfg, a, n, (m, i), None, False),
        jnp.asarray(pcm), jnp.asarray(lens), jnp.asarray(mean),
        jnp.asarray(istd))
    got, got_lens = TTS.featurize(cfg, t(pcm), t(lens), (t(mean), t(istd)))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # time warp after CMVN and the bands, with the JAX package's draws
    # (JAX's featurize compiled with FAST_XLA: the default optimizations
    # fuse the warp's lerp into the chain and move JAX's own result by up
    # to 1.7e-5)
    warp = Config(frontend=dataclasses.replace(cfg.frontend,
                                               time_warp_param=5))
    key = jax.random.PRNGKey(9)
    cmvn = (jnp.asarray(mean), jnp.asarray(istd))
    ref, _ = run_jax(lambda a, n: JTS.featurize(warp, a, n, cmvn, key, True),
                     jnp.asarray(pcm), jnp.asarray(lens))
    draws = jax_feat_draws(warp, key, pcm, lens)
    assert bool((draws.warp[1] != 0).any())
    got, _ = TTS.featurize(warp, t(pcm), t(lens), (t(mean), t(istd)),
                           augment=True, draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# the waveform and feature augmentations against the JAX package's, with
# its draws: 1e-6 relative (and 1e-7 absolute where a value cancels to
# near zero)
AUG_TOL = dict(rtol=1e-6, atol=1e-7)


def wave_batch(seed, b=5, s=4000):
    """Noise waveforms [b, s] with pads exactly 0: a full row, shorter
    ones and an empty one."""
    rng = np.random.default_rng(seed)
    lens = np.asarray([s, s - 1, 2501, 0, 37, 3999, 1200][:b], np.int32)
    audio = (rng.standard_normal((b, s)) * 0.1).astype(np.float32)
    return audio * (np.arange(s)[None, :] < lens[:, None]), lens


def test_speed_perturb_matches_jax():
    factors = (0.9, 1.0, 1.1)
    audio, lens = wave_batch(11, b=7)
    key = jax.random.PRNGKey(3)
    ref, ref_lens = run_jax(
        lambda a, n: JF.speed_perturb(key, a, n, factors),
        jnp.asarray(audio), jnp.asarray(lens))
    idx = jax.random.randint(key, (7,), 0, 3)
    assert set(np.asarray(idx).tolist()) == {0, 1, 2}
    got, got_lens = TF.apply_speed_perturb(t(audio), t(lens), factors,
                                           t(idx))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **AUG_TOL)
    # the full row's slow factor is clamped to the buffer; pads exactly 0;
    # a factor of exactly 1.0 leaves its rows bit-exact
    assert int(got_lens[0]) <= audio.shape[1]
    pad = np.arange(audio.shape[1])[None, :] >= got_lens.numpy()[:, None]
    assert not got.numpy()[pad].any()
    same, same_lens = TF.apply_speed_perturb(
        t(audio), t(lens), factors, torch.ones(7, dtype=torch.long))
    assert torch.equal(same, t(audio)) and torch.equal(same_lens, t(lens))


@pytest.mark.parametrize("sources, b", [
    (("white",), 5), (("babble",), 5), (("white", "babble"), 5),
    (("babble",), 1)], ids=["white", "babble", "both", "babble-b1"])
def test_noise_augment_matches_jax(sources, b):
    audio, lens = wave_batch(12, b=b)
    key = jax.random.PRNGKey(4)
    prob, snr = 0.8, (5.0, 20.0)
    ref = run_jax(lambda a, n: JF.noise_augment(
        jax.random.fold_in(key, 13), a, n, prob, snr, sources),
        jnp.asarray(audio), jnp.asarray(lens))
    fcfg = dataclasses.replace(CFG, noise_aug_prob=prob, noise_snr_db=snr,
                               noise_sources=sources)
    draws = jax_feat_draws(Config(frontend=fcfg), key, audio, lens).noise
    got = TF.apply_noise(t(audio), t(lens), prob, snr, sources, draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **AUG_TOL)
    pad = np.arange(audio.shape[1])[None, :] >= lens[:, None]
    assert not got.numpy()[pad].any()
    # the mixed rows realize the drawn SNR
    mixed = (draws[0].numpy() < prob) & (lens > 0) & (
        np.abs(audio).sum(1) > 0)
    assert mixed.any()
    sig = audio[mixed].astype(np.float64)
    noise = got.numpy()[mixed] - sig
    snr_db = 10 * np.log10((sig ** 2).sum(1) / (noise ** 2).sum(1))
    want = snr[0] + draws[1].numpy()[mixed] * (snr[1] - snr[0])
    np.testing.assert_allclose(snr_db, want, atol=1e-3)


def test_time_warp_matches_jax():
    """W=5: rows of 2W + 1 = 11 frames or fewer pass unchanged."""
    cfg = dataclasses.replace(CFG, time_warp_param=5)
    rng = np.random.default_rng(13)
    lens = np.asarray([48, 47, 30, 12, 11, 0], np.int32)
    feats = rng.standard_normal((6, 48, 80)).astype(np.float32)
    feats *= (np.arange(48)[None, :] < lens[:, None])[..., None]
    key = jax.random.PRNGKey(6)
    ref = run_jax(lambda f, n: JF.time_warp(key, f, n, cfg),
                  jnp.asarray(feats), jnp.asarray(lens))
    kw, kd = jax.random.split(key)
    lf = jnp.asarray(lens, jnp.float32)
    w = jnp.floor(5 + jax.random.uniform(kw, (6,)) * jnp.maximum(lf - 10,
                                                                 1.0))
    d = jnp.round(jax.random.uniform(kd, (6,)) * 10 - 5)
    got = TF.apply_time_warp(t(feats), t(lens), 5, t(w), t(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **AUG_TOL)
    assert torch.equal(got[4:], t(feats[4:]))        # short rows
    pad = np.arange(48)[None, :] >= lens[:, None]
    assert not got.numpy()[pad].any()
    assert not torch.equal(got[:3], t(feats[:3]))
    # the port's own draws keep the reference's ranges
    w2, d2 = TF.sample_time_warp(torch.Generator().manual_seed(0),
                                 t(lens[:3]), 5)
    assert ((w2 >= 5) & (w2 < t(lens[:3]) - 5)).all()
    assert ((d2 >= -5) & (d2 <= 5) & (d2 == d2.round())).all()


def test_featurize_with_every_augmentation_matches_jax():
    """Speed, babble and white noise, the SpecAugment bands and time warp
    in JAX's featurize (labeled view) against the port's with JAX's draws;
    the port takes its fused path, K1's plain twin standing in for the
    kernel."""
    fcfg = dataclasses.replace(
        CFG, fused_pallas=True, speed_perturb=(0.9, 1.0, 1.1),
        noise_aug_prob=0.7, noise_sources=("white", "babble"),
        time_warp_param=5, freq_mask_param=10, time_mask_param=8)
    cfg = Config(frontend=fcfg)
    audio, lens, mean, istd = audio_batch(14, b=5, frames=64, cfg=fcfg)
    key = jax.random.PRNGKey(15)
    cmvn = (jnp.asarray(mean), jnp.asarray(istd))
    ref, ref_lens = run_jax(
        lambda a, n: JTS.featurize(cfg, a, n, cmvn, key, True, speed=True),
        jnp.asarray(audio), jnp.asarray(lens))
    draws = jax_feat_draws(cfg, key, audio, lens, speed=True)
    got, got_lens = TTS.featurize(cfg, t(audio), t(lens), (t(mean), t(istd)),
                                  augment=True, draws=draws, speed=True)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
