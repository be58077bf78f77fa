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
        specaug = tuple(np.asarray(x) for x in JF.sample_specaug_params(
            jax.random.PRNGKey(7), pspec.shape[0], 80, jnp.asarray(lens),
            CFG))
        assert sum(int(w.sum()) for w in (specaug[1], specaug[3])) > 0
    ref = PF.fused_post_fft(
        jnp.asarray(pspec), jnp.asarray(lens), CFG, jnp.asarray(mean),
        jnp.asarray(istd),
        None if specaug is None else tuple(map(jnp.asarray, specaug)),
        interpret=True,
    )
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
    ref, ref_lens = JF.log_mel_features(
        jnp.asarray(audio), jnp.asarray(lens), cfg, jnp.asarray(mean),
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
    ref, _ = JF.log_mel_features(jnp.asarray(audio), jnp.asarray(lens), cfg)
    got, _ = TF.log_mel_features(t(audio), t(lens), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_featurize_int16_matches_jax():
    cfg = Config(frontend=dataclasses.replace(CFG, fft_backend="matmul"))
    audio, lens, mean, istd = audio_batch(6, b=4, frames=64)
    pcm = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
    ref, ref_lens = JTS.featurize(
        cfg, jnp.asarray(pcm), jnp.asarray(lens),
        (jnp.asarray(mean), jnp.asarray(istd)), None, False)
    got, got_lens = TTS.featurize(cfg, t(pcm), t(lens), (t(mean), t(istd)))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # augmentation the port does not run yet is refused, naming the key
    warp = Config(frontend=dataclasses.replace(cfg.frontend,
                                               time_warp_param=5))
    with pytest.raises(NotImplementedError, match="time_warp_param"):
        TTS.featurize(warp, t(pcm), t(lens), (t(mean), t(istd)),
                      augment=True)
