"""PyTorch port parity: listener, attention, speller step, greedy and beam.

Weights are drawn with numpy (``weights.init_numpy``) and cross into both
packages through the weight bridge; the bridge's names and shapes are held
against the JAX initializer's tree.  Inputs are drawn with numpy.  In
float32, encoder outputs and attention keys agree to 1e-5 and greedy and
beam-5 decodes give identical tokens with scores within 1e-4 (a sum of up
to 20 per-step log-probabilities, each within ~1e-6).  The listener's
bfloat16 case is bounded by 1e-2: three stacked layers of bf16 h-rounding
flips (see tests/test_torch_lstm.py), each moving a unit by ~1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.config import DecodeConfig, ModelConfig
from semi_supervised_asr_tpu.decode import beam as JB
from semi_supervised_asr_tpu.decode import greedy as JG
from semi_supervised_asr_tpu.models import attention as JA
from semi_supervised_asr_tpu.models import seq2seq as JM
from semi_supervised_asr_tpu.models import speller as JS
from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.decode.beam import beam_decode_from_enc
from semi_supervised_asr_tpu_torch.decode.greedy import greedy_decode_from_enc
from semi_supervised_asr_tpu_torch.models.attention import Attention
from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    FAST_XLA, one_thread, run_jax,
)

CFG = ModelConfig(
    n_mels=80, vocab_size=65, enc_hidden=128, enc_base_layers=1,
    enc_layers=2, dec_hidden=64, attn_dim=32, attn_conv_channels=4,
    attn_conv_width=10, embed_dim=32, compute_dtype="float32",
    lstm_backend="pallas",
)
B, T_FEAT = 8, 64
LENS = np.asarray([64, 61, 48, 33, 64, 7, 50, 1], np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)
MAX_LEN = 20


def build(cfg=CFG, seed=0):
    """Random weights as a JAX parameter tree and in the port's model."""
    tree = weights.unflatten_tree(weights.init_numpy(cfg, seed))
    model = Seq2Seq(cfg)
    weights.load_tree(model, tree)
    return jax.tree.map(jnp.asarray, tree), model.eval()


def feats_batch(seed=1):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T_FEAT, 80)).astype(np.float32)
    feats *= (np.arange(T_FEAT)[None, :, None] < LENS[:, None, None])
    return feats


def encode_both(cfg=CFG):
    params, model = build(cfg)
    feats = feats_batch()
    ref = run_jax(lambda p, f, n: JM.encode(p, f, n, cfg), params,
                  jnp.asarray(feats), jnp.asarray(LENS))
    with torch.inference_mode():
        got = model.encode(torch.from_numpy(feats), torch.from_numpy(LENS))
    return params, model, ref, got


@pytest.fixture(scope="module")
def encoded():
    """(JAX params, port model, JAX (enc, mask, keys), port's)."""
    return encode_both()


def test_encode_matches_jax(encoded):
    _, _, ref, got = encoded
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_encode_bf16_matches_jax():
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    _, _, ref, got = encode_both(cfg)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-2, atol=1e-2)


def test_bridge_refuses_mismatched_trees(encoded):
    params, model, _, _ = encoded
    # the port's names and shapes are those of the JAX initializer's tree
    jax_tree = jax.eval_shape(lambda k: JM.init_model(k, CFG),
                              jax.random.PRNGKey(0))
    flat = weights.flatten_tree(jax.tree.map(np.asarray, params))
    want = weights.flatten_tree(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax_tree))
    assert ({k: v.shape for k, v in flat.items()}
            == {k: v.shape for k, v in want.items()})
    with pytest.raises(KeyError, match="missing"):
        weights.load_flat(model, {k: v for k, v in flat.items()
                                  if k != "speller.b_out"})
    with pytest.raises(KeyError, match="unexpected"):
        weights.load_flat(model, dict(flat, extra=np.zeros(1)))
    bad = dict(flat)
    bad["speller.attention.conv"] = np.zeros((1, 10, 4), np.float32)
    with pytest.raises(ValueError, match="shape"):
        weights.load_flat(model, bad)


@pytest.mark.parametrize("kind", ["location", "additive", "dot"])
def test_attend_matches_jax(kind):
    cfg = dataclasses.replace(CFG, attn_type=kind)
    params = jax.tree.map(np.asarray, run_jax(
        lambda k: JA.init_attention(k, cfg), jax.random.PRNGKey(3)))
    att = Attention(cfg)
    weights.load_tree(att, params)
    rng = np.random.default_rng(4)
    t = 16
    enc = rng.standard_normal((B, t, cfg.enc_out_dim)).astype(np.float32)
    query = rng.standard_normal((B, cfg.dec_hidden)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.asarray([16, 9, 1, 12, 16, 3, 5, 8])[:, None]
    alpha = rng.uniform(0, 1, (B, t)).astype(np.float32) * mask
    def jfn(p, q, a, e, m):
        k = JA.precompute_keys(p, e)
        return k, JA.attend(p, q, a, k, e, m, sharpening=1.5)

    keys, ref = run_jax(jfn, params, jnp.asarray(query), jnp.asarray(alpha),
                        jnp.asarray(enc), jnp.asarray(mask))
    keys = np.asarray(keys)
    with torch.inference_mode():
        tkeys = att.precompute_keys(torch.from_numpy(enc))
        got = att.attend(torch.from_numpy(query), torch.from_numpy(alpha),
                         tkeys, torch.from_numpy(enc), torch.from_numpy(mask),
                         sharpening=1.5)
    np.testing.assert_allclose(tkeys.numpy(), keys, **TOL)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert np.all(got[1].numpy()[~mask] == 0.0)       # exact zeros on pads


@pytest.mark.parametrize("tied", [False, True])
def test_speller_step_matches_jax(tied, encoded):
    cfg = dataclasses.replace(CFG, tie_embedding=tied, dec_layers=2)
    params, model = build(cfg)
    _, _, (enc, mask, keys), _ = encoded
    sp = params["speller"]
    state = JS.init_state(B, enc.shape[1], cfg, mask)
    tokens = jnp.asarray(np.arange(B) % cfg.vocab_size, jnp.int32)
    with torch.inference_mode():
        tstate = model.speller.init_state(B, torch.from_numpy(np.array(mask)))
    args = (sp, state, tokens, keys, enc, mask)
    step = jax.jit(lambda p, st, tok, k, e, m: JS.speller_step(
        p, cfg, st, tok, k, e, m)).lower(*args).compile(
        compiler_options=FAST_XLA)
    for _ in range(3):      # a few steps so the alignment feeds back
        state, logits, alpha = step(sp, state, tokens, keys, enc, mask)
        with torch.inference_mode():
            tstate, tlogits, talpha = model.speller.step(
                tstate, torch.from_numpy(np.array(tokens)),
                torch.from_numpy(np.array(keys)),
                torch.from_numpy(np.array(enc)),
                torch.from_numpy(np.array(mask)))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), **TOL)
        np.testing.assert_allclose(talpha.numpy(), np.asarray(alpha), **TOL)
        for k in state:
            np.testing.assert_allclose(tstate[k].numpy(),
                                       np.asarray(state[k]), **TOL)
        tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)


def _decode_inputs(encoded):
    """Both decoders start from the JAX encoder outputs."""
    params, model, j, _ = encoded
    t = tuple(torch.from_numpy(np.array(x)) for x in j)
    return params, model, j, t


def test_greedy_tokens_identical_to_jax(encoded):
    params, model, j, t = _decode_inputs(encoded)
    ref_tok, ref_lp = run_jax(lambda p, *a: JG.greedy_decode_from_enc(
        p, CFG, *a, MAX_LEN), params["speller"], *j)
    with torch.inference_mode():
        tok, lp = greedy_decode_from_enc(model.speller, *t, MAX_LEN)
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("coverage", [0.0, 0.3])
def test_beam_tokens_identical_to_jax(coverage, encoded):
    params, model, j, t = _decode_inputs(encoded)
    dcfg = DecodeConfig(beam_size=5, coverage_weight=coverage)
    # the reference's best hypothesis is the head of its sorted n-best
    # (a stable argsort against a first-max argmax), so one reference run
    # checks both of the port's outputs
    ref = run_jax(lambda p, *a: JB.beam_decode_from_enc(
        p, CFG, dcfg, *a, MAX_LEN, return_nbest=True), params["speller"], *j)
    ref_nbest = (np.asarray(ref[0]), np.asarray(ref[1]))
    ref_best = (ref_nbest[0][:, 0], ref_nbest[1][:, 0])
    for nbest, want in ((False, ref_best), (True, ref_nbest)):
        with torch.inference_mode():
            got = beam_decode_from_enc(model.speller, dcfg, *t, MAX_LEN,
                                       return_nbest=nbest)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-4,
                                   atol=1e-4)


def test_beam_refuses_unported_options(encoded):
    _, model, _, t = _decode_inputs(encoded)
    # LM fusion and biasing are ported (tests/test_torch_lm_fusion.py,
    # tests/test_torch_biasing.py): given no LM and no trie, the beam
    # decodes as without the keys, as the reference's does
    with torch.inference_mode():
        plain = beam_decode_from_enc(model.speller, DecodeConfig(), *t,
                                     MAX_LEN)
        for dcfg in (DecodeConfig(lm_weight=0.3), DecodeConfig(lm_ckpt="lm"),
                     DecodeConfig(bias_phrases="hot.txt", bias_bonus=2.0)):
            got = beam_decode_from_enc(model.speller, dcfg, *t, MAX_LEN)
            assert all(torch.equal(a, b) for a, b in zip(got, plain))
    # the reference's own refusal: deep / cold fusion is the LSTM speller's
    with pytest.raises(ValueError, match="LSTM speller"):
        Seq2Seq(dataclasses.replace(CFG, lm_fusion="deep",
                                    decoder_arch="transformer"))
