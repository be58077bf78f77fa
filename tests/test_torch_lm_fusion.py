"""PyTorch port parity: LM fusion -- shallow fusion in the four beams (with
the transducer's internal-LM correction) and deep / cold fusion in the
LSTM speller.

Seeded numpy weights (``weights.init_numpy`` / ``init_module``) cross into
the JAX trees by name, inputs are drawn with numpy, at small widths (V 12
for the LAS and its LMs: E 16, H 32, 2 layers; the streaming tests' models
of V 10 for the CTC and transducer families; B 3 or 2, U <= 8):

* the LAS beam (K 3) with shallow fusion of the LSTM and the transformer
  LM, and under cold fusion (the speller's ``lm_h`` / ``lm_c`` reordered
  with the beam, as under deep fusion) with an LSTM LM besides: identical hypotheses, scores to
  rtol 1e-4 (tests/test_lm_fusion.py's); ``lm_weight`` 0 is bitwise the
  beam without an LM;
* the CTC prefix beam and the transducer beam (with ``ilm_weight``) fused:
  identical hypotheses, scores to rtol 1e-4;
* the fused beams' carries: two chunks equal the whole walk bitwise, and
  JAX's carried decode; ``StreamingTranscriber`` and
  ``MultiStreamTranscriber`` with the LM give the fused offline decode;
* deep and cold fusion: the speller step and the teacher-forced logits to
  1e-5, the loss's gradients within ``GRAD_TOL`` of the largest entry, the
  frozen LM's gradient exactly zero (no path reaches it: the step's
  gradients hold zeros); ``attach_fusion_lm`` refuses a mismatch; greedy
  equals the beam at K 1;
* the Solver: ``main --test`` with ``decode.lm_ckpt`` decodes with an LM
  the ``lm_trainer`` CLI trained, an empty ``lm_ckpt`` warns and decodes
  without; cold fusion grafts the trained LM at startup (the EMA buffer
  too), leaves it bitwise unchanged over the steps, and resumes exactly.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.config import DecodeConfig as JDecodeConfig
from semi_supervised_asr_tpu.config import ModelConfig as JModelConfig
from semi_supervised_asr_tpu.decode import beam as JB
from semi_supervised_asr_tpu.decode import ctc_beam as JCB
from semi_supervised_asr_tpu.decode import streaming as JS
from semi_supervised_asr_tpu.decode import transducer_beam as JTB
from semi_supervised_asr_tpu.models import lm as JLM
from semi_supervised_asr_tpu.models import speller as JSP
from semi_supervised_asr_tpu.objectives import losses as JL
from semi_supervised_asr_tpu_torch import main as M
from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.config import (
    Config, DataConfig, DecodeConfig, ModelConfig,
)
from semi_supervised_asr_tpu_torch.data.registry import build_vocab
from semi_supervised_asr_tpu_torch.data.synthetic import make_utterance
from semi_supervised_asr_tpu_torch.decode import streaming as S
from semi_supervised_asr_tpu_torch.decode.beam import beam_decode_from_enc
from semi_supervised_asr_tpu_torch.decode.ctc_beam import ctc_beam_from_enc
from semi_supervised_asr_tpu_torch.decode.greedy import greedy_decode_from_enc
from semi_supervised_asr_tpu_torch.decode.transducer_beam import (
    transducer_beam_from_enc,
)
from semi_supervised_asr_tpu_torch.models import lm as LM
from semi_supervised_asr_tpu_torch.models.seq2seq import build_model
from semi_supervised_asr_tpu_torch.models.speller import attach_fusion_lm
from semi_supervised_asr_tpu_torch.objectives import losses as LO
from semi_supervised_asr_tpu_torch.training import lm_trainer as LT
from semi_supervised_asr_tpu_torch.training import train_step as TS
from semi_supervised_asr_tpu_torch.training.solver import Solver
from semi_supervised_asr_tpu_torch.training.train_step import featurize
from tests.test_torch_ckpt import (
    SMALL, assert_state_bitwise_equal, small_cfg,
)
from tests.test_torch_streaming import (  # noqa: F401 -- models: fixture
    CMVN, MAX_U, SCORE, models,
)
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    one_thread, run_jax,
)

V, E, H, LAYERS = 12, 16, 32, 2
B, T_ENC, MAX_LEN, K = 3, 9, 8, 3
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5
LAS = dict(n_mels=80, vocab_size=V, enc_hidden=8, enc_base_layers=1,
           enc_layers=1, dec_hidden=16, attn_dim=8, attn_conv_channels=2,
           attn_conv_width=4, embed_dim=8, compute_dtype="float32",
           lm_fusion_embed=E, lm_fusion_hidden=H, lm_fusion_layers=LAYERS,
           lm_fusion_dim=8)


def t(a):
    return torch.from_numpy(np.asarray(a))


def make_lm(arch: str, vocab: int = V, seed: int = 5):
    """(port LM, JAX tree): the LSTM LM of E / H / 2 layers, or a
    transformer LM of d_model 16, 2 blocks of 4 heads, max_len 32."""
    if arch == "lstm":
        lm = LM.LSTMLM(vocab, E, H, LAYERS)
    else:
        lm = LM.TransformerLM(vocab, 16, 2, 4, 32, 32)
    flat = weights.init_module(lm, seed)
    weights.load_flat(lm, flat)
    return lm.eval(), jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))


def las(fusion: str = "none", seed: int = 0):
    """(port config, JAX config, port model, JAX tree) of a small LAS."""
    kw = dict(LAS, lm_fusion=fusion)
    cfg = ModelConfig(**kw)
    flat = weights.init_numpy(cfg, seed)
    model = build_model(cfg).eval()
    weights.load_flat(model, flat)
    return cfg, JModelConfig(**kw), model, jax.tree.map(
        jnp.asarray, weights.unflatten_tree(flat))


def enc_inputs(e_dim: int, seed: int = 3, b: int = B, t_enc: int = T_ENC):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, t_enc, e_dim)).astype(np.float32)
    lens = np.array([t_enc, t_enc - 3, 2][:b])
    mask = np.arange(t_enc)[None, :] < lens[:, None]
    return enc * mask[..., None], mask


# ---------------------------------------------------------------- LAS beam

@pytest.mark.parametrize("fusion, arch", [("none", "lstm"),
                                          ("none", "transformer"),
                                          ("cold", "lstm")])
def test_las_beam_fusion_matches_jax(fusion, arch):
    cfg, jcfg, model, tree = las(fusion)
    enc, mask = enc_inputs(cfg.enc_out_dim)
    dcfg = DecodeConfig(beam_size=K, lm_weight=0.4)
    jdcfg = JDecodeConfig(beam_size=K, lm_weight=0.4)
    lm, ltree = make_lm(arch)
    sp = tree["speller"]
    ref = run_jax(lambda p, lp, e, m: JB.beam_decode_from_enc(
        p, jcfg, jdcfg, e, m, JSP.precompute_decode_cache(p, jcfg, e),
        MAX_LEN, lm_params=lp, lm_step_fn=JLM.lm_step, return_nbest=True), sp, ltree, jnp.asarray(enc), jnp.asarray(mask))
    with torch.inference_mode():
        e, m = t(enc), t(mask)
        got = beam_decode_from_enc(
            model.speller, dcfg, e, m,
            model.speller.precompute_decode_cache(e), MAX_LEN,
            return_nbest=True, lm=lm)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **SCORE)
    # hypotheses that say something (random weights can emit EOS at once)
    assert (got[0][:, 0, 1:] > 2).any()


def test_lm_weight_zero_is_no_fusion(models):
    """At ``lm_weight`` 0 each beam given an LM decodes bitwise as without
    one (the CTC and transducer carries then hold no LM slots)."""
    cfg, _, model, _ = las()
    enc, mask = enc_inputs(cfg.enc_out_dim)
    lm, _ = make_lm("lstm")
    outs = {}
    with torch.inference_mode():
        e, m = t(enc), t(mask)
        keys = model.speller.precompute_decode_cache(e)
        outs["las"] = [beam_decode_from_enc(
            model.speller, DecodeConfig(beam_size=K, lm_weight=0.0), e, m,
            keys, MAX_LEN, return_nbest=True, lm=fused) for fused in
            (lm, None)]
        for kind in ("ctc", "blstm"):
            mcfg, _, mm, _ = models[kind]
            lm10, _ = make_lm("lstm", vocab=mcfg.model.vocab_size)
            ee, kk = enc_inputs(mcfg.model.enc_out_dim, 7, b=2, t_enc=12)
            ee, kk = t(ee), t(kk)
            if kind == "ctc":
                outs[kind] = [ctc_beam_from_enc(
                    mm.ctc, ee, kk, MAX_U, K, return_carry=True, lm=fused,
                    lm_weight=0.0) for fused in (lm10, None)]
            else:
                outs[kind] = [transducer_beam_from_enc(
                    mm, mcfg.model, ee, kk, MAX_U, K, 2, return_carry=True,
                    lm=fused, lm_weight=0.0) for fused in (lm10, None)]
            assert len(outs[kind][0][2]) == 5       # no LM slots
    for kind, (a, b_) in outs.items():
        assert all(torch.equal(x, y) for x, y in
                   zip(S.tree_leaves(a), S.tree_leaves(b_))), kind


# ------------------------------------------------- CTC and transducer beams

def ctc_and_transducer(models, kind, arch, lm_w, ilm_w, seed=7):
    """Both packages' fused beam (n-best) over the same encoder output."""
    cfg, jcfg, model, tree = models[kind]
    m = cfg.model
    enc, mask = enc_inputs(m.enc_out_dim, seed, b=2, t_enc=12)
    lm, ltree = make_lm(arch, vocab=m.vocab_size)
    step = JLM.lm_step
    if kind == "ctc":
        ref = run_jax(lambda p, lp, e, k: JCB.ctc_beam_from_enc(
            p["ctc"], e, k, MAX_U, beam_size=K, lm_params=lp,
            lm_step_fn=step, lm_weight=lm_w, return_nbest=True),
            tree, ltree, jnp.asarray(enc), jnp.asarray(mask))
        with torch.inference_mode():
            got = ctc_beam_from_enc(model.ctc, t(enc), t(mask), MAX_U, K,
                                    return_nbest=True, lm=lm,
                                    lm_weight=lm_w)
    else:
        ref = run_jax(lambda p, lp, e, k: JTB.transducer_beam_from_enc(
            p, jcfg.model, e, k, MAX_U, beam_size=K, max_symbols=2,
            lm_params=lp, lm_step_fn=step, lm_weight=lm_w,
            ilm_weight=ilm_w, return_nbest=True),
            tree, ltree, jnp.asarray(enc), jnp.asarray(mask))
        with torch.inference_mode():
            got = transducer_beam_from_enc(
                model, m, t(enc), t(mask), MAX_U, K, 2, return_nbest=True,
                lm=lm, lm_weight=lm_w, ilm_weight=ilm_w)
    return got, ref


@pytest.mark.parametrize("kind, arch, lm_w, ilm_w", [
    ("ctc", "lstm", 0.5, 0.0), ("ctc", "transformer", 0.5, 0.0),
    ("blstm", "lstm", 0.5, 0.3), ("blstm", "transformer", 0.5, 0.0)])
def test_ctc_and_transducer_beams_fuse_as_jax(models, kind, arch, lm_w,
                                             ilm_w):
    got, ref = ctc_and_transducer(models, kind, arch, lm_w, ilm_w)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **SCORE)
    assert (got[0][:, 0] > 0).sum() > 2


@pytest.mark.parametrize("decoder", ["ctc_beam", "transducer_beam"])
def test_fused_carries_match_whole_walk_and_jax(models, decoder):
    """Two chunks of 6 frames through the fused carry: the port's whole
    walk bitwise, JAX's carried decode (best tokens; scores to 1e-4)."""
    kind = "ctc" if decoder == "ctc_beam" else "blstm"
    cfg, jcfg, model, tree = models[kind]
    m = cfg.model
    enc, mask = enc_inputs(m.enc_out_dim, 7, b=2, t_enc=12)
    lm, ltree = make_lm("lstm", vocab=m.vocab_size)
    lm_w = 0.5
    if kind == "ctc":
        def port(e, k, c):
            return ctc_beam_from_enc(model.ctc, e, k, MAX_U, K, carry=c,
                                     return_carry=True, lm=lm,
                                     lm_weight=lm_w)[2]

        def jdec(p, lp, e, k, c):
            return JCB.ctc_beam_from_enc(
                p["ctc"], e, k, MAX_U, beam_size=K, lm_params=lp,
                lm_step_fn=JLM.lm_step, lm_weight=lm_w, carry=c,
                return_carry=True)[2]
    else:
        def port(e, k, c):
            return transducer_beam_from_enc(
                model, m, e, k, MAX_U, K, 2, carry=c, return_carry=True,
                lm=lm, lm_weight=lm_w, ilm_weight=0.2)[2]

        def jdec(p, lp, e, k, c):
            return JTB.transducer_beam_from_enc(
                p, jcfg.model, e, k, MAX_U, beam_size=K, max_symbols=2,
                lm_params=lp, lm_step_fn=JLM.lm_step, lm_weight=lm_w,
                ilm_weight=0.2, carry=c, return_carry=True)[2]
    halves = (slice(0, 6), slice(6, 12))
    with torch.inference_mode():
        whole = port(t(enc), t(mask), None)
        got = None
        for h in halves:
            got = port(t(enc[:, h]), t(mask[:, h]), got)
    assert all(torch.equal(a, b) for a, b in zip(S.tree_leaves(got),
                                                 S.tree_leaves(whole)))
    jgot = None
    for h in halves:
        jgot = run_jax(jdec, tree, ltree, enc[:, h], mask[:, h], jgot)
    for row in range(2):
        toks, score = S._best_hyp(got, row, ctc=kind == "ctc", beam_size=K,
                                  lm_weight=lm_w)
        jtoks, jscore = JS._best_hyp(jgot, row, ctc=kind == "ctc",
                                     beam_size=K, lm_weight=lm_w, bias=None)
        assert toks == jtoks and len(toks) > 0, (row, toks, jtoks)
        np.testing.assert_allclose(score, jscore, **SCORE)


def fused_offline(model, cfg, wav, lm, lm_w, ilm_w):
    """The fused offline beam (K 2) of ``wav`` padded to the streaming
    chunk grid, as any bucketed batch pads it -> (tokens, score)."""
    m, f = cfg.model, cfg.frontend
    n_frames = 1 + (len(wav) - f.n_fft) // f.hop_length
    c = m.time_reduction
    need = (-(-n_frames // c) * c - 1) * f.hop_length + f.n_fft
    a = np.zeros((need,), np.float32)
    a[:len(wav)] = wav
    with torch.inference_mode():
        feats, flens = featurize(cfg, t(a)[None], torch.tensor([len(wav)]),
                                 tuple(t(x) for x in CMVN))
        enc, mask = model.encode(feats, flens)
        if m.family == "ctc":
            toks, score = ctc_beam_from_enc(model.ctc, enc, mask, MAX_U, 2,
                                            lm=lm, lm_weight=lm_w)
        else:
            toks, score = transducer_beam_from_enc(
                model, m, enc, mask, MAX_U, 2, 4, lm=lm, lm_weight=lm_w,
                ilm_weight=ilm_w)
    return [int(x) for x in toks[0] if x != 0], float(score[0])


@pytest.mark.parametrize("kind", ["blstm", "ctc"])
def test_fused_streams_match_offline(models, kind):
    """``StreamingTranscriber`` and ``MultiStreamTranscriber`` (two
    staggered streams) with the LM: the fused offline decode's tokens and
    scores (the multi-stream carry keeps the LM state's K rows a stream on
    axis 1)."""
    cfg, _, model, _ = models[kind]
    lm, _ = make_lm("lstm", vocab=cfg.model.vocab_size)
    # weights at which the fused decode differs from the plain one and
    # still emits
    lm_w, ilm_w = (0.3, 0.3) if kind == "blstm" else (0.5, 0.0)
    # utterances 0 and 1 of the synthetic corpus (the streaming tests')
    vocab = build_vocab(Config())
    wavs = [make_utterance(i, vocab, DataConfig(), cfg.frontend, min_tokens=4,
                           max_tokens=6).audio.astype(np.float32)
            for i in range(2)]
    kw = dict(beam_size=2, lm=lm, lm_weight=lm_w, ilm_weight=ilm_w)
    ms = S.MultiStreamTranscriber(model, cfg, CMVN, MAX_U, 2, **kw)
    sids = [ms.open() for _ in wavs]
    pieces = (900, 1300)
    for r in range(-(-max(map(len, wavs)) // 900)):
        for sid, w, n in zip(sids, wavs, pieces):
            ms.feed(sid, w[r * n: (r + 1) * n])
        ms.pump()
    multi = [ms.finalize(sid) for sid in sids]
    for w, (mt, msc) in zip(wavs, multi):
        toks, score = S.stream_decode(model, cfg, CMVN, w, MAX_U,
                                      piece_samples=1777, **kw)
        off_toks, off_score = fused_offline(model, cfg, w, lm, lm_w, ilm_w)
        assert toks == off_toks and len(toks) > 1, (toks, off_toks)
        assert toks != fused_offline(model, cfg, w, None, 0.0, 0.0)[0]
        np.testing.assert_allclose(score, off_score, **SCORE)
        assert mt == toks
        np.testing.assert_allclose(msc, score, rtol=1e-5)
    with pytest.raises(ValueError, match="transducer-only"):
        S.StreamingTranscriber(models["ctc"][2], models["ctc"][0], CMVN,
                               MAX_U, beam_size=2, ilm_weight=0.2)


# ---------------------------------------------------- deep and cold fusion

@pytest.fixture(scope="module", params=["deep", "cold"])
def fused(request):
    """(fusion, port config, port model, JAX config, JAX tree, enc, mask,
    tokens) with the fusion LM grafted from a seeded LSTM LM."""
    cfg, jcfg, model, tree = las(request.param, seed=1)
    lm, ltree = make_lm("lstm")
    attach_fusion_lm(model.speller, lm)
    tree = dict(tree, speller=JSP.attach_fusion_lm(tree["speller"], ltree))
    enc, mask = enc_inputs(cfg.enc_out_dim, seed=4)
    rng = np.random.default_rng(6)
    tok = rng.integers(3, V, (B, 6)).astype(np.int32)
    tok[0, 5], tok[1, 3], tok[1, 4:], tok[2, 0], tok[2, 1:] = 2, 2, 0, 2, 0
    return request.param, cfg, model, jcfg, tree, enc, mask, tok


def test_fusion_speller_step_matches_jax(fused):
    _, cfg, model, jcfg, tree, enc, mask, tok = fused
    sp = tree["speller"]

    def jsteps(p, e, k, tk):
        keys = JSP.precompute_decode_cache(p, jcfg, e)
        st = JSP.init_state(B, T_ENC, jcfg, k)
        outs = []
        for u in range(3):
            st, lg, _ = JSP.speller_step(p, jcfg, st, tk[:, u], keys, e, k)
            outs.append((lg, st["lm_h"], st["lm_c"]))
        return outs

    ref = run_jax(jsteps, sp, jnp.asarray(enc), jnp.asarray(mask),
                  jnp.asarray(tok))
    with torch.inference_mode():
        e, m = t(enc), t(mask)
        keys = model.speller.precompute_decode_cache(e)
        st = model.speller.init_state(B, m)
        for u, (lg_ref, h_ref, c_ref) in enumerate(ref):
            st, lg, _ = model.speller.step(st, t(tok[:, u]), keys, e, m)
            np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
            np.testing.assert_allclose(st["lm_h"].numpy(), np.asarray(h_ref),
                                       **TOL)
            np.testing.assert_allclose(st["lm_c"].numpy(), np.asarray(c_ref),
                                       **TOL)


def test_fusion_teacher_loss_and_grads_match_jax(fused):
    fusion, cfg, model, jcfg, tree, enc, mask, tok = fused
    tin = np.concatenate([np.ones((B, 1), np.int32), tok[:, :-1]], axis=1)

    def jloss(p, e, k):
        logits, _ = JSP.forward_teacher(p, jcfg, e, k, jnp.asarray(tin))
        return JL.masked_ce(logits, jnp.asarray(tok))[0], logits

    (loss_ref, logits_ref), (g_ref, ge_ref) = run_jax(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True),
        tree["speller"], jnp.asarray(enc), jnp.asarray(mask))
    sp = copy.deepcopy(model.speller)
    e = t(enc).requires_grad_(True)
    logits, _ = sp.forward_teacher(e, t(mask), t(tin), 1.0)
    loss = LO.masked_ce(logits, t(tok))[0]
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_ref), **TOL)
    np.testing.assert_allclose(loss.item(), float(loss_ref), **TOL)
    params = dict(sp.named_parameters())
    grads = torch.autograd.grad(loss, [*params.values(), e],
                                allow_unused=True)
    want = weights.flatten_tree(jax.tree.map(np.asarray, g_ref))
    want["enc"] = np.asarray(ge_ref)
    scale = max(np.abs(w).max() for w in want.values())
    for name, g in zip([*params, "enc"], grads):
        if name.startswith("fusion_lm."):
            # the frozen LM: no path reaches it; the reference's gradient
            # (through stop_gradient) is exactly zero
            assert g is None and not want[name].any(), name
            continue
        err = np.abs(g.numpy() - want[name]).max()
        assert err <= GRAD_TOL * scale, (name, err, scale)
    assert any(n.startswith("fusion.") for n in params)


def test_frozen_lm_gets_zero_gradients_in_the_step(tmp_path):
    """The train step's gradient list holds exact zeros for every
    ``fusion_lm`` leaf, so the global-norm clip and Adam leave them as
    they are."""
    s = Solver(small_cfg(**{"model.lm_fusion": "cold",
                            "model.lm_fusion_embed": 8,
                            "model.lm_fusion_hidden": 16,
                            "model.lm_fusion_layers": 1}), tmp_path, "cpu")
    batch = next(s._labeled_stream())[2]
    tensors = s.step_inputs(batch)[0]
    _, _, grads = TS.loss_and_grads(s.cfg, s.state, *tensors, s.cmvn_dev)
    names = [n for n, _ in s.state.model.named_parameters()]
    lm_grads = [g for n, g in zip(names, grads) if ".fusion_lm." in n]
    assert len(lm_grads) == 6 and all(not g.any() for g in lm_grads)
    assert any(g.any() for n, g in zip(names, grads) if ".fusion." in n)


def test_attach_fusion_lm_refuses_a_mismatch():
    _, _, model, _ = las("cold")
    with pytest.raises(ValueError, match="fusion LM mismatch at"):
        attach_fusion_lm(model.speller, LM.LSTMLM(V, E, H + 8, LAYERS))
    with pytest.raises(ValueError, match="fusion LM mismatch"):
        attach_fusion_lm(model.speller, LM.LSTMLM(V, E, H, 1))
    _, _, plain, _ = las()
    with pytest.raises(ValueError, match="lm_fusion is off"):
        attach_fusion_lm(plain.speller, LM.LSTMLM(V, E, H, LAYERS))
    with pytest.raises(ValueError, match="LSTM speller"):
        build_model(ModelConfig(**dict(LAS, lm_fusion="deep",
                                       decoder_arch="transformer",
                                       dec_heads=2)))


def test_cold_fusion_greedy_equals_beam_k1(fused):
    _, cfg, model, _, _, enc, mask, _ = fused
    with torch.inference_mode():
        e, m = t(enc), t(mask)
        keys = model.speller.precompute_decode_cache(e)
        g_toks, _ = greedy_decode_from_enc(model.speller, e, m, keys,
                                           MAX_LEN)
        b_toks, _ = beam_decode_from_enc(model.speller,
                                         DecodeConfig(beam_size=1), e, m,
                                         keys, MAX_LEN)
    assert torch.equal(g_toks, b_toks)


# ----------------------------------------------------------------- Solver

LM_OVER = ["lm.total_steps=4", "lm.log_every=2", "lm.hidden=16",
           "lm.embed_dim=8", "lm.layers=1", "lm.batch_size=4",
           "data.num_synthetic_utts=16"]


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    assert LT.main(["--config", "configs/synthetic_smoke.yaml", "--workdir",
                    str(d), "--device", "cpu", *LM_OVER]) == 0
    return d


def test_main_test_decodes_with_the_trained_lm(lm_dir, tmp_path, capsys):
    cli = [f"{k}={v}" for k, v in {
        **SMALL, "train.total_steps": 1, "lm.hidden": 16,
        "lm.embed_dim": 8, "lm.layers": 1}.items()]
    base = ["--config", "configs/synthetic_smoke.yaml", "--device", "cpu"]
    assert M.main([*base, "--train", "--workdir", str(tmp_path), *cli]) == 0
    capsys.readouterr()
    out = {}
    for name, extra in (("fused", [f"decode.lm_ckpt={lm_dir}",
                                   "decode.lm_weight=0.3"]),
                        ("empty", ["decode.lm_weight=0.3"])):
        assert M.main([*base, "--test", "--load-dir", str(tmp_path), *cli,
                       *extra]) == 0
        cap = capsys.readouterr()
        out[name] = (json.loads(cap.out.strip().splitlines()[-1]), cap.err)
    rates = {k: v for k, v in out["fused"][0].items()
             if k in ("per", "cer", "ter")}
    assert len(rates) == 1 and np.isfinite(*rates.values())
    assert out["fused"][0]["n_utts"] == out["empty"][0]["n_utts"] > 0
    assert "shallow fusion: lstm LM from" in out["fused"][1]
    assert "decode.lm_ckpt is empty — shallow fusion DISABLED" in \
        out["empty"][1]
    with pytest.raises(SystemExit, match="no trained LM"):
        M.main([*base, "--test", "--load-dir", str(tmp_path), *cli,
                "decode.lm_weight=0.3", f"decode.lm_ckpt={tmp_path}/none"])


def test_cold_fusion_graft_and_exact_resume(lm_dir, tmp_path):
    """The trained LM is grafted at startup into the model and the EMA
    buffer; it stays bitwise unchanged over the steps; a run stopped at
    step 2 and resumed to 3 is the uninterrupted run, bitwise."""
    extra = {"model.lm_fusion": "cold", "model.lm_fusion_ckpt": lm_dir,
             "model.lm_fusion_embed": 8, "model.lm_fusion_hidden": 16,
             "model.lm_fusion_layers": 1, "train.ckpt_every": 2,
             "train.polyak_decay": 0.9}
    cfg = small_cfg(**extra, **{"train.total_steps": 3})
    lm = LT.load_lm(lm_dir, cfg, build_vocab(cfg).size, dims=(8, 16, 1))
    full = Solver(cfg, tmp_path / "full", "cpu")
    for mod in (full.state.model, full.state.ema):
        for (n, a), b_ in zip(mod.speller.fusion_lm.named_parameters(),
                              lm.parameters()):
            assert torch.equal(a, b_), n
    full.train()
    for a, b_ in zip(full.state.model.speller.fusion_lm.parameters(),
                     lm.parameters()):
        assert torch.equal(a, b_)
    Solver(small_cfg(**extra, **{"train.total_steps": 2}),
           tmp_path / "split", "cpu").train()
    resumed = Solver(cfg, tmp_path / "split", "cpu")
    resumed.train(resume=True)
    assert resumed.state.step == 3
    assert_state_bitwise_equal(full.state, resumed.state)
