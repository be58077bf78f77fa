"""PyTorch port parity: the transformer speller (``model.decoder_arch:
transformer``, ``configs/ls960_aed.yaml``).

Weights are drawn with numpy (``weights.init_numpy``) and carried into the
JAX tree by name; the bridge's names and shapes are held against
``init_transformer_speller``'s tree ([in, heads, d_head] projections
kept).  In float32:

* the teacher-forced pass against JAX's, with JAX's dropout keep masks
  fed in (``fold_in(rng, i)``, three sites a block), logits and alphas to
  1e-5;
* the KV-cache step against the port's own teacher, position by position,
  to 1e-5 (the reference's own check, tests/test_transformer_speller.py),
  against JAX's step, and the write by index against the reference's
  one-hot ``where`` over the whole cache (equal logits);
* greedy and beam-3 decodes against JAX's: equal tokens, scores to 1e-4;
* the supervised step of a tiny ``ls960_aed`` against JAX's
  (``check_supervised_step``), and ``main --train`` then ``--test``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.config import DecodeConfig, ModelConfig
from semi_supervised_asr_tpu.decode import beam as JB
from semi_supervised_asr_tpu.decode import greedy as JG
from semi_supervised_asr_tpu.models import transformer_speller as JTS
from semi_supervised_asr_tpu_torch import main as M
from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.decode.beam import beam_decode_from_enc
from semi_supervised_asr_tpu_torch.decode.greedy import greedy_decode_from_enc
from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq
from semi_supervised_asr_tpu_torch.models.transformer_speller import (
    TransformerSpeller,
)
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    FAST_XLA, check_supervised_step, make_step_setup, one_thread, run_jax, t,
)

CFG = ModelConfig(
    n_mels=80, vocab_size=31, enc_hidden=12, enc_base_layers=1,
    enc_layers=1, decoder_arch="transformer", dec_hidden=32, dec_blocks=2,
    dec_heads=4, dec_ff_dim=48, dec_max_len=16, compute_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)
B, T_ENC, U = 4, 9, 7
LENS = np.asarray([9, 6, 1, 8])


def build(cfg=CFG, seed=0):
    """The speller's weights as a JAX tree and in the port's model."""
    tree = weights.unflatten_tree(weights.init_numpy(cfg, seed))
    model = Seq2Seq(cfg)
    weights.load_tree(model, tree)
    return jax.tree.map(jnp.asarray, tree["speller"]), model.speller.eval()


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, T_ENC, CFG.enc_out_dim)).astype(np.float32)
    mask = np.arange(T_ENC)[None, :] < LENS[:, None]
    tokens = rng.integers(3, CFG.vocab_size, (B, U)).astype(np.int32)
    tokens[:, 0] = 1
    return enc * mask[..., None], mask, tokens


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_bridge_matches_the_jax_tree(tie):
    cfg = dataclasses.replace(CFG, tie_embedding=tie)
    ref = jax.eval_shape(lambda k: JTS.init_transformer_speller(k, cfg),
                         jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path, simple=True, separator="."):
            tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = {k: tuple(p.shape) for k, p in
           TransformerSpeller(cfg).named_parameters()}
    assert got == want
    assert got["blocks.0.wq"] == (32, 4, 8)
    assert ("w_out" in got) == (not tie)


@pytest.mark.parametrize("dec_dropout", [0.0, 0.2])
def test_forward_teacher_matches_jax(dec_dropout):
    cfg = dataclasses.replace(CFG, dec_dropout=dec_dropout)
    params, speller = build(cfg)
    enc, mask, tokens = inputs()
    rng = jax.random.PRNGKey(3)
    train = dec_dropout > 0
    ref = run_jax(lambda p, e, m, tk, k: JTS.forward_teacher(
        p, cfg, e, m, tk, k, train), params, jnp.asarray(enc),
        jnp.asarray(mask), jnp.asarray(tokens), rng)
    masks = None
    if train:
        # the reference's sites: bernoulli(fold_in(rng, i), keep, [B, U, d])
        masks = torch.stack([t(jax.random.bernoulli(
            jax.random.fold_in(rng, i), 1.0 - dec_dropout,
            (B, U, cfg.dec_hidden))) for i in range(3 * cfg.dec_blocks)],
            dim=1)
        assert speller.dropout_shape(B, U) == tuple(masks.shape)
    with torch.no_grad():
        got = speller.forward_teacher(t(enc), t(mask), t(tokens),
                                      drop_masks=masks)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


def onehot_write(kv, li, pos, new):
    """The reference's cache write: a one-hot ``where`` over every slot."""
    hit = torch.arange(kv.shape[2])[None, :] == pos[:, None]
    kv[:, li] = torch.where(hit[..., None], new[:, None, :], kv[:, li])


def test_step_matches_teacher_and_jax(monkeypatch):
    params, speller = build()
    enc, mask, tokens = inputs()
    with torch.no_grad():
        teacher, _ = speller.forward_teacher(t(enc), t(mask), t(tokens))
        cache = speller.precompute_decode_cache(t(enc))
    jcache = run_jax(lambda p, e: JTS.precompute_cross(p, CFG, e), params,
                     jnp.asarray(enc))
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)
    state = speller.init_state(B, t(mask), U)
    jstate = JTS.init_state(B, CFG, U)
    args = (params, jstate, jnp.asarray(tokens[:, 0]), jcache,
            jnp.asarray(mask))
    jstep = jax.jit(lambda p, st, tk, c, m: JTS.step(p, CFG, st, tk, c, m)
                    ).lower(*args).compile(compiler_options=FAST_XLA)
    steps = []
    with torch.no_grad():
        for u in range(U):
            state, logits, alpha = speller.step(state, t(tokens[:, u]),
                                                cache, None, t(mask))
            jstate, jlogits, jalpha = jstep(
                params, jstate, jnp.asarray(tokens[:, u]), jcache,
                jnp.asarray(mask))
            np.testing.assert_allclose(logits.numpy(),
                                       teacher[:, u].numpy(), **TOL)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **TOL)
            np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha),
                                       **TOL)
            steps.append(logits)
    for k in ("kv_k", "kv_v", "dpos"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                   **TOL)
    # the write by index computes what the one-hot write computes
    monkeypatch.setattr(TransformerSpeller, "write_kv",
                        staticmethod(onehot_write))
    state = speller.init_state(B, t(mask), U)
    with torch.no_grad():
        for u in range(U):
            state, logits, _ = speller.step(state, t(tokens[:, u]), cache,
                                            None, t(mask))
            assert torch.equal(logits, steps[u])
    with pytest.raises(ValueError, match="dec_max_len"):
        speller.init_state(B, t(mask), CFG.dec_max_len + 1)


@pytest.mark.parametrize("beam", [1, 3])
def test_decode_matches_jax(beam):
    params, speller = build(seed=4)
    enc, mask, _ = inputs(seed=5)
    with torch.no_grad():
        cache = speller.precompute_decode_cache(t(enc))
    args = (params, jnp.asarray(enc), jnp.asarray(mask))
    if beam == 1:
        ref = run_jax(lambda p, e, m: JG.greedy_decode_from_enc(
            p, CFG, e, m, JTS.precompute_cross(p, CFG, e), 10), *args)
        with torch.inference_mode():
            got = greedy_decode_from_enc(speller, t(enc), t(mask), cache, 10)
    else:
        dcfg = DecodeConfig(beam_size=beam)
        ref = run_jax(lambda p, e, m: JB.beam_decode_from_enc(
            p, CFG, dcfg, e, m, JTS.precompute_cross(p, CFG, e), 10,
            return_nbest=True), *args)
        with torch.inference_mode():
            got = beam_decode_from_enc(speller, dcfg, t(enc), t(mask),
                                       cache, 10, return_nbest=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-4, atol=1e-4)


# configs/ls960_aed.yaml cut to a small width: one encoder block and one
# decoder block (so that JAX's compile stays short), float32, dropout as
# shipped (the draws fed in are JAX's)
AED = ["model.enc_hidden=8", "model.enc_heads=2", "model.enc_ff_dim=16",
       "model.enc_blocks=1", "model.conv_channels=2", "model.dec_hidden=16",
       "model.dec_heads=2", "model.dec_ff_dim=24", "model.dec_blocks=1",
       "model.dec_max_len=16", "model.compute_dtype=float32",
       "train.batch_size=4", "train.warmup_steps=0",
       "data.dataset=synthetic", "data.num_synthetic_utts=8",
       "data.frame_buckets=[128]", "data.token_buckets=[12]",
       "decode.max_decode_len=8"]


def test_supervised_step_matches_jax():
    from tests.test_torch_train import jax_step_draws

    pcfg, jcfg, batch, cmvn, flat = make_step_setup("configs/ls960_aed.yaml",
                                                    AED)
    model = Seq2Seq(pcfg.model)
    draws = jax_step_draws(jcfg, model, jax.random.PRNGKey(0), batch.audio,
                           batch.audio_lens, batch.tokens)
    assert draws[0].labeled.masks[1].shape == (4, 3, 12, 16)
    check_supervised_step(pcfg, jcfg, batch, cmvn, flat, draws)


def test_main_trains_and_tests(tmp_path, capsys):
    base = ["--config", "configs/ls960_aed.yaml", "--device", "cpu"]
    assert M.main([*base, "--train", "--workdir", str(tmp_path), *AED,
                   "train.total_steps=1", "train.eval_every=0"]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(final["final_dev"]["dev_error"])
    for beam, mode in (("1", "greedy"), ("2", "beam")):
        assert M.main([*base, "--test", "--load-dir", str(tmp_path),
                       "--beam", beam, *AED]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["mode"] == mode and "cap_hit_rate" in out
    # no CTC head: --beam 0 raises as the reference's CTC decode does
    with pytest.raises(SystemExit, match="needs a CTC head"):
        M.main([*base, "--test", "--load-dir", str(tmp_path), "--beam", "0",
                *AED])
