"""PyTorch port parity: the transducer family and the forward-only listener.

The same numpy inputs and weights (``weights.init_numpy`` carried into the
JAX tree by name) go through the JAX package and the port, at tiny widths:

* the lattice NLL (``transducer_loss``: the port's one autograd Function
  with explicit alpha and beta passes) and its gradient against JAX's
  ``jax.grad`` of the anti-diagonal scan, on rows with U_b = 0, T_b = 1
  and a filler row: per-row NLL to rtol 1e-5 / atol 1e-5 (the reference's
  tests/test_transducer_loss.py), the gradient to 1e-5 of its largest
  entry; ``model.joint_chunk_frames`` against the full grid in the port:
  the lattice terms and the loss bitwise, the gradients to the reference's
  rtol 1e-5 / atol 1e-6 (each chunk's weight gradients are summed apart
  from the others', in another order than the full grid's one product);
* ``joint_logits``, ``predictor_train`` and ``predictor_step`` in float32
  (1e-5) and bfloat16 (1e-3, the LSTM tests' bf16 bound);
* the forward-only listener, with and without encoder dropout (JAX's
  masks), in float32 (1e-5);
* greedy decoding (equal tokens, scores to 1e-5 relative), the beam's
  n-best (equal tokens, scores to 1e-5) and the beam of 1 against greedy;
* ``pseudo_label_loss`` (rows dropped by confidence; the semi step keeps
  every row) and ``ilm_text_loss`` with their gradients (the ILM term's
  listener and ``w_enc`` gradients exactly zero);
* the supervised step (``configs/ls100_transducer.yaml`` cut small, remat
  on as shipped) and the semi-supervised step (``ls100_transducer_semi``,
  its JAX step compiled once and run with the pseudo-label gate closed and
  open) against JAX's ``supervised_step_fn``: metrics to 1e-5, gradients
  to ``TOL_GRAD``, the EMA buffer to 1e-6;
* ``build_model`` on the three shipped transducer configs at full width,
  ``main --train`` / ``--test`` and ``transcribe`` on tiny versions of
  ``ls100_transducer`` and ``ls100_transducer_semi``, and the refusals.

The two-rank semi step is in tests/test_torch_dp.py.
"""

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

from semi_supervised_asr_tpu.config import ModelConfig as JModelConfig
from semi_supervised_asr_tpu.config import ObjectiveConfig as JObjective
from semi_supervised_asr_tpu.config import load_config as jax_load_config
from semi_supervised_asr_tpu.decode import transducer_beam as JTB
from semi_supervised_asr_tpu.decode import transducer_greedy as JTG
from semi_supervised_asr_tpu.models import listener as JLI
from semi_supervised_asr_tpu.models import transducer as JTD
from semi_supervised_asr_tpu.objectives import transducer_loss as JTL
from semi_supervised_asr_tpu.objectives import transducer_semi as JTS
from semi_supervised_asr_tpu.ops import frontend as JF
from semi_supervised_asr_tpu.training import schedules as JSCH
from semi_supervised_asr_tpu.training import train_step as JT
from semi_supervised_asr_tpu_torch import main as M
from semi_supervised_asr_tpu_torch import synthetic, weights
from semi_supervised_asr_tpu_torch import transcribe as TR
from semi_supervised_asr_tpu_torch.config import ModelConfig, load_config
from semi_supervised_asr_tpu_torch.data import pipeline
from semi_supervised_asr_tpu_torch.data.bucketing import make_bucket_spec
from semi_supervised_asr_tpu_torch.data.registry import build_datasets
from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD
from semi_supervised_asr_tpu_torch.decode.transducer_beam import (
    transducer_beam_from_enc,
)
from semi_supervised_asr_tpu_torch.decode.transducer_greedy import (
    transducer_greedy_from_enc,
)
from semi_supervised_asr_tpu_torch.models import transducer as TD
from semi_supervised_asr_tpu_torch.models.listener import Listener
from semi_supervised_asr_tpu_torch.models.seq2seq import build_model
from semi_supervised_asr_tpu_torch.objectives import transducer_loss as TL
from semi_supervised_asr_tpu_torch.objectives import transducer_semi as TS_
from semi_supervised_asr_tpu_torch.training import train_step as TS
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    FAST_XLA, TOL_GRAD, check_supervised_step, make_step_setup, one_thread,
    port_model, run_jax, stash, t, train_records,
)

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = dict(rtol=1e-3, atol=1e-3)
V = 12
# the model of the unit tests: a 1 + 1 layer listener of 8 (bidirectional,
# or forward-only of 16), predictor and joint of 16, V = 12
TINY = dict(n_mels=20, vocab_size=V, family="transducer", enc_hidden=8,
            enc_base_layers=1, enc_layers=1, pred_hidden=16, pred_layers=1,
            joint_dim=16, embed_dim=8, compute_dtype="float32")


def configs(**over):
    kw = dict(TINY, **over)
    return ModelConfig(**kw), JModelConfig(**kw)


def tiny_model(cfg, seed: int = 0):
    """The port's model and the same weights as a JAX tree."""
    flat = weights.init_numpy(cfg, seed)
    model = build_model(cfg)
    weights.load_flat(model, flat)
    return model, jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))


def test_jax_init_tree_loads_and_init_numpy_draws_by_path():
    """A JAX ``init_transducer`` tree (numpy leaves) of the forward-only
    listener loads into the port by name (the bidirectional one's names and
    shapes are the port's too); ``init_numpy`` draws the predictor
    embedding normal x 0.02, the joint's matrices glorot and its biases
    zero."""
    from semi_supervised_asr_tpu.models import seq2seq as JM

    for bidirectional in (True, False):
        cfg, jcfg = configs(enc_bidirectional=bidirectional)
        model = build_model(cfg)
        if bidirectional:
            shapes = weights.flatten_tree(jax.tree.map(
                lambda a: np.empty(a.shape, bool), jax.eval_shape(
                    lambda: JM.init_model(jax.random.PRNGKey(0), jcfg))))
            assert {n: tuple(p.shape) for n, p in model.named_parameters()} \
                == {n: a.shape for n, a in shapes.items()}
    tree = jax.tree.map(np.asarray, run_jax(
        lambda k: JM.init_model(k, jcfg), jax.random.PRNGKey(0)))
    weights.load_tree(model, tree)
    np.testing.assert_array_equal(model.predictor.embed.detach().numpy(),
                                  tree["predictor"]["embed"])
    np.testing.assert_array_equal(model.listener.layers[1].w_hh.detach()
                                  .numpy(), tree["listener"]["layers"][1]
                                  ["w_hh"])
    flat = weights.init_numpy(cfg, 0)
    assert flat.keys() == weights.flatten_tree(tree).keys()
    emb = flat["predictor.embed"]
    assert 0.015 < emb.std() < 0.025
    assert not flat["joint.b"].any() and not flat["joint.b_out"].any()
    bound = math.sqrt(6.0 / (16 + V))
    w_out = flat["joint.w_out"]
    assert np.abs(w_out).max() <= bound and np.abs(w_out).max() > bound / 2


# --------------------------------------------------------------------- #
# the lattice loss
# --------------------------------------------------------------------- #

def lattice_case(seed: int = 0, b: int = 5, tt: int = 9, u: int = 5):
    """Logits [B, T, U+1, V] and rows: full, U_b = 0, T_b = 1, ragged, and a
    filler row."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, tt, u + 1, V)) * 2).astype(np.float32)
    enc_lens = np.asarray([tt, 4, 1, 7, 6], np.int32)
    labels = rng.integers(1, V, (b, u)).astype(np.int32)
    label_lens = np.asarray([u, 0, 3, 2, 4], np.int32)
    real = np.asarray([True, True, True, True, False])
    return logits, enc_lens, labels, label_lens, real


def test_lattice_nll_and_gradient_match_jax():
    logits, enc_lens, labels, label_lens, real = lattice_case()
    # an upstream gradient on every row's NLL, besides the mean's
    w = np.linspace(0.2, 1.0, len(real)).astype(np.float32)

    def jloss(lg):
        mean, nll = JTL.transducer_loss(
            lg, jnp.asarray(enc_lens), jnp.asarray(labels),
            jnp.asarray(label_lens), real=jnp.asarray(real))
        return mean + jnp.sum(nll * w), (mean, nll)

    (_, (ref_mean, ref_nll)), ref_g = run_jax(
        jax.value_and_grad(jloss, has_aux=True), jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    mean, nll = TL.transducer_loss(x, t(enc_lens), t(labels), t(label_lens),
                                   real=t(real))
    (mean + (nll * t(w)).sum()).backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(ref_nll),
                               **TOL)
    np.testing.assert_allclose(mean.item(), float(ref_mean), rtol=1e-5)
    ref_g = np.asarray(ref_g)
    assert np.abs(x.grad.numpy() - ref_g).max() <= 1e-5 * np.abs(ref_g).max()
    # the filler row is weighed out of the mean, not out of its own NLL
    np.testing.assert_allclose(
        mean.item(), nll[:4].mean().item(), rtol=1e-6)


@pytest.mark.parametrize("chunk", [3, 16])
def test_joint_chunk_frames_match_full_grid(chunk):
    """``joint_lattice_terms`` in chunks of 3 frames (the last one padded)
    and of 16 (one chunk past T) against the full grid."""
    cfg, _ = configs()
    model, _ = tiny_model(cfg, 3)
    rng = np.random.default_rng(4)
    b, tt, u = 3, 7, 4
    enc = t(rng.standard_normal((b, tt, cfg.enc_out_dim)).astype(np.float32))
    pred = t(rng.standard_normal((b, u + 1, 16)).astype(np.float32))
    labels = t(rng.integers(1, V, (b, u)).astype(np.int32))
    enc_lens, label_lens = t(np.asarray([7, 4, 2])), t(np.asarray([4, 2, 0]))
    out = {}
    for c in (0, chunk):
        e = enc.clone().requires_grad_(True)
        p = pred.clone().requires_grad_(True)
        model.zero_grad()
        if c:
            terms = TD.joint_lattice_terms(model.joint, e, p, labels, cfg,
                                           chunk_frames=c)
        else:
            terms = TL.lattice_terms(TD.joint_logits(model.joint, e, p, cfg),
                                     labels)
        loss, _ = TL.transducer_loss_from_parts(*terms, enc_lens, label_lens)
        loss.backward()
        out[c] = ([x.detach() for x in terms], loss.detach(),
                  [e.grad, p.grad] + [q.grad.clone()
                                      for q in model.joint.parameters()])
    (terms0, loss0, g0), (terms1, loss1, g1) = out[0], out[chunk]
    assert all(torch.equal(a, b) for a, b in zip(terms0, terms1))
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)


# --------------------------------------------------------------------- #
# joint, predictor, listener
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_joint_and_predictor_match_jax(dtype):
    cfg, jcfg = configs(compute_dtype=dtype)
    model, tree = tiny_model(cfg, 1)
    rng = np.random.default_rng(2)
    b, tt, u = 3, 6, 5
    enc = rng.standard_normal((b, tt, cfg.enc_out_dim)).astype(np.float32)
    labels = rng.integers(1, V, (b, u)).astype(np.int32)
    tok = np.asarray([1, 5, 7], np.int32)

    def jfn(p, e, y, k):
        pred = JTD.predictor_train(p["predictor"], y, jcfg)
        logits = JTD.joint_logits(p["joint"], e, pred, jcfg)
        st0 = JTD.predictor_init_state(jcfg, b)
        step, (hc,) = JTD.predictor_step(p["predictor"], k, st0, jcfg)
        row = JTD.joint_row(p["joint"], e[:, 0], step, jcfg)
        return pred, logits, step, hc[1], row

    ref = run_jax(jfn, tree, jnp.asarray(enc), jnp.asarray(labels),
                  jnp.asarray(tok))
    with torch.inference_mode():
        pred = TD.predictor_train(model.predictor, t(labels), cfg)
        logits = TD.joint_logits(model.joint, t(enc), pred, cfg)
        step, ((_, c),) = TD.predictor_step(
            model.predictor, t(tok), TD.predictor_init_state(cfg, b, "cpu"),
            cfg)
        row = TD.joint_row(model.joint, t(enc)[:, 0], step, cfg)
    tol = TOL if dtype == "float32" else TOL_BF16
    for name, got, want in zip(("pred", "logits", "step", "c", "row"),
                               (pred, logits, step, c, row), ref):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_forward_only_listener_matches_jax(rate):
    """``model.enc_bidirectional: false``: one cell a layer, enc_out_dim =
    enc_hidden; with ``rate`` the dropout sites take JAX's masks."""
    cfg, jcfg = configs(enc_bidirectional=False, enc_hidden=16,
                        enc_dropout=rate)
    model, tree = tiny_model(cfg, 5)
    names = [n for n, _ in model.listener.named_parameters()]
    assert names == ["layers.0.w_ih", "layers.0.w_hh", "layers.0.b",
                     "layers.1.w_ih", "layers.1.w_hh", "layers.1.b"]
    assert model.listener.layers[1].w_ih.shape == (32, 64)
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((3, 24, 20)).astype(np.float32)
    lens = np.asarray([24, 17, 6], np.int32)
    key = jax.random.PRNGKey(7)
    shapes = model.listener.dropout_shapes(3, 24) if rate else []

    def jfn(p, f, n):
        # the keep masks of JAX's sites, drawn as its listener draws them
        masks = [jax.random.bernoulli(jax.random.fold_in(key, i),
                                      1.0 - rate, shape)
                 for i, shape in enumerate(shapes)]
        return JLI.listener_apply(p["listener"], f, n, jcfg, train=rate > 0,
                                  dropout_rng=key), masks

    (ref, ref_lens), masks = run_jax(jfn, tree, jnp.asarray(feats),
                                     jnp.asarray(lens))
    masks = [t(m) for m in masks] or None
    if rate:
        assert [m.shape[-1] for m in masks] == [16, 16]
    with torch.inference_mode():
        enc, enc_lens = model.listener(t(feats), t(lens), masks=masks)
    assert enc.shape == (3, 12, 16)
    np.testing.assert_array_equal(enc_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref), **TOL)


# --------------------------------------------------------------------- #
# decoding
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def decode_setup():
    """A tiny model whose joint is sharpened (w_out x 3) and leans to the
    blank (its bias 2), so that rows both emit and pass frames; encoder
    outputs of three rows of 10, 7 and 3 frames."""
    cfg, jcfg = configs()
    flat = weights.init_numpy(cfg, 8)
    flat["joint.w_out"] = flat["joint.w_out"] * 3.0
    flat["joint.b_out"][PAD] = 2.0
    model = build_model(cfg)
    weights.load_flat(model, flat)
    tree = jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))
    rng = np.random.default_rng(9)
    enc = rng.standard_normal((3, 10, cfg.enc_out_dim)).astype(np.float32)
    mask = np.arange(10)[None, :] < np.asarray([10, 7, 3])[:, None]
    return cfg, jcfg, model, tree, enc * mask[..., None], mask


@pytest.mark.parametrize("mode", ["greedy", "beam_nbest", "beam_k1"])
def test_transducer_decodes_match_jax(decode_setup, mode):
    cfg, jcfg, model, tree, enc, mask = decode_setup
    max_u = 8
    if mode == "greedy":
        ref = run_jax(lambda p, e, m: JTG.transducer_greedy_from_enc(
            p, jcfg, e, m, max_u, max_symbols=3), tree, jnp.asarray(enc),
            jnp.asarray(mask))
    else:
        k = 1 if mode == "beam_k1" else 3
        ref = run_jax(lambda p, e, m: JTB.transducer_beam_from_enc(
            p, jcfg, e, m, max_u, beam_size=k, max_symbols=3,
            return_nbest=k > 1), tree, jnp.asarray(enc), jnp.asarray(mask))
    with torch.inference_mode():
        if mode == "greedy":
            got = transducer_greedy_from_enc(model, cfg, t(enc), t(mask),
                                             max_u, 3)
        else:
            got = transducer_beam_from_enc(model, cfg, t(enc), t(mask),
                                           max_u, k, 3,
                                           return_nbest=k > 1)
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-5, atol=1e-5)
    toks = got[0].numpy()
    assert (toks != PAD).any() and (toks == PAD).any()
    if mode == "beam_k1":      # the reference's K=1 == greedy
        with torch.inference_mode():
            g = transducer_greedy_from_enc(model, cfg, t(enc), t(mask),
                                           max_u, 3)
        np.testing.assert_array_equal(g[0].numpy(), toks)
        np.testing.assert_allclose(g[1].numpy(), got[1].numpy(), rtol=1e-6)


# --------------------------------------------------------------------- #
# the semi-supervised terms
# --------------------------------------------------------------------- #

def test_pseudo_label_loss_matches_jax():
    """Student and teacher from different weights, clean and augmented
    views of noise features (24 frames, lengths 24/17/10/24, the third row
    filler), the confidence threshold between two rows' confidences (the
    semi step below keeps every row).  Loss to 1e-5 and gradients to
    ``TOL_GRAD``."""
    cfg, jcfg = configs()
    student, s_tree = tiny_model(cfg, 10)
    teacher, t_tree = tiny_model(cfg, 11)
    rng = np.random.default_rng(12)
    clean, aug = (rng.standard_normal((4, 24, 20)).astype(np.float32)
                  for _ in range(2))
    lens = np.asarray([24, 17, 10, 24], np.int32)
    row_mask = np.asarray([True, True, False, True])
    max_u = 6
    labels = TS_.teacher_labels(teacher, t(clean), t(lens), max_u, 3)
    hyps, path_lp, t_lens = labels
    conf = path_lp / (t_lens + (hyps != PAD).sum(1)).float()
    real = sorted(conf[t(row_mask)].tolist())
    assert real[-1] - real[0] > 1e-3
    confidence = math.exp((real[0] + real[-1]) / 2)
    obj = JObjective(pseudo_confidence=confidence)

    def jfn(p, tp, c, a, n, m):
        return JTS.pseudo_label_loss(p, tp, jcfg, obj, c, a, n,
                                     jax.random.PRNGKey(0), max_u,
                                     row_mask=m, max_symbols=3)

    ref, ref_g = run_jax(jax.value_and_grad(jfn), s_tree, t_tree,
                         jnp.asarray(clean), jnp.asarray(aug),
                         jnp.asarray(lens), jnp.asarray(row_mask))
    loss = TS_.pseudo_label_loss(student, teacher, confidence, t(clean),
                                 t(aug), t(lens), max_u, t(row_mask), 3)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    assert loss.item() > 0
    names, params = zip(*student.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    ref_g = weights.flatten_tree(jax.tree.map(np.asarray, ref_g))
    for n, g in zip(names, grads):
        g = np.zeros_like(ref_g[n]) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref_g[n], **TOL_GRAD, err_msg=n)
    assert TS_.pseudo_keep(labels, confidence, t(row_mask)).sum() == 1


def test_ilm_text_loss_matches_jax():
    """Unlabeled text rows (EOS-terminated, PAD-padded, one all-PAD):
    loss and gradients to 1e-5 / ``TOL_GRAD``; the listener's and
    ``w_enc``'s gradients exactly zero."""
    cfg, jcfg = configs()
    model, tree = tiny_model(cfg, 13)
    text = np.asarray([[4, 7, 9, 3, EOS, PAD],
                       [5, EOS, PAD, PAD, PAD, PAD],
                       [PAD] * 6,
                       [8, 8, 11, 6, 10, EOS]], np.int32)
    ref, ref_g = run_jax(jax.value_and_grad(
        lambda p, x: JTS.ilm_text_loss(p, jcfg, x)), tree, jnp.asarray(text))
    loss = TS_.ilm_text_loss(model, t(text))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    ref_g = weights.flatten_tree(jax.tree.map(np.asarray, ref_g))
    for n, g in zip(names, grads):
        if n.startswith("listener.") or n == "joint.w_enc":
            assert g is None or not g.any(), n
            assert not ref_g[n].any(), n
            continue
        assert g is not None and g.any(), n
        np.testing.assert_allclose(g.numpy(), ref_g[n], **TOL_GRAD,
                                   err_msg=n)


# --------------------------------------------------------------------- #
# the whole steps
# --------------------------------------------------------------------- #

# configs/ls100_transducer*.yaml cut to a small width, float32, the
# synthetic corpus in one 128-frame / 12-token bucket; remat as shipped
STEP = ["model.enc_hidden=8", "model.enc_layers=1", "model.pred_hidden=16",
        "model.joint_dim=16", "model.embed_dim=8",
        "model.compute_dtype=float32", "train.batch_size=4",
        "train.warmup_steps=0", "data.dataset=synthetic",
        "data.num_synthetic_utts=8", "data.frame_buckets=[128]",
        "data.token_buckets=[12]", "decode.max_decode_len=6",
        "decode.max_symbols=2"]


def test_supervised_step_matches_jax():
    # the NLL is a mean over rows, not tokens: its gradient's norm at
    # random weights is tens, so the clip moves out of the way of the
    # helper's unclipped Adam update
    pcfg, jcfg, batch, cmvn, flat = make_step_setup(
        "configs/ls100_transducer.yaml", STEP + ["train.grad_clip_norm=100"])
    assert pcfg.train.remat_encoder and pcfg.model.family == "transducer"
    got = check_supervised_step(pcfg, jcfg, batch, cmvn, flat,
                                keys=("loss", "grad_norm"))
    assert "nll_per_label" in got and "ce" not in got


WARMUP = 2
SEMI = STEP + [f"objective.pseudo_warmup_steps={WARMUP}",
               "objective.pseudo_confidence=0", "objective.ema_decay=0.9"]
SEMI_CONFIG = "configs/ls100_transducer_semi.yaml"


@pytest.fixture(scope="module")
def semi_setup():
    """Both configs, the student's and the teacher's weights, a labeled,
    an unlabeled audio and a text batch (each with a filler row), the CMVN
    statistics, and JAX's step compiled once (the gate is a traced
    comparison of ``state.step``)."""
    pcfg = load_config(SEMI_CONFIG, SEMI)
    bundle = build_datasets(pcfg)
    pcfg = TR.finalize_config(pcfg, bundle.vocab.size)
    jcfg = jax_load_config(SEMI_CONFIG, SEMI)
    jcfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, vocab_size=bundle.vocab.size, n_mels=80))
    spec = make_bucket_spec(pcfg.data, pcfg.frontend,
                            pcfg.model.time_reduction)
    lab = pipeline.assemble_batch(bundle.train, [0, 1, 2, 0], 3, (128, 12),
                                  spec, pcfg.frontend)
    unlab = pipeline.assemble_batch(bundle.unlabeled_audio, [0, 1, 2, 3], 3,
                                    (128, 12), spec, pcfg.frontend)
    text, text_real = next(pipeline.text_batches(bundle.unlabeled_text, 12,
                                                 4, seed=2))
    text_real = text_real & (np.arange(4) < 3)
    s = dict(pcfg=pcfg, jcfg=jcfg, lab=lab, unlab=unlab, text=text,
             text_real=text_real,
             cmvn=pipeline.compute_global_cmvn(bundle.train, pcfg.frontend),
             flat=weights.init_numpy(pcfg.model, seed=0),
             teacher=weights.init_numpy(pcfg.model, seed=1))
    opt, state, args = jax_inputs(s, 0)
    s["step"] = jax.jit(functools.partial(
        JT.supervised_step_fn, jcfg, opt)).lower(state, *args).compile(
        compiler_options=FAST_XLA)
    return s


def tree_of(flat):
    return jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))


def jax_inputs(s, step: int):
    tree = tree_of(s["flat"])
    opt = optax.chain(stash(), JSCH.make_optimizer(s["jcfg"].train))
    state = JT.TrainState(params=tree, opt_state=run_jax(opt.init, tree),
                          ema_params=tree_of(s["teacher"]),
                          step=jnp.asarray(step, jnp.int32),
                          rng=jax.random.PRNGKey(0))
    lab, unlab, cmvn = s["lab"], s["unlab"], s["cmvn"]
    args = (jnp.asarray(lab.audio), jnp.asarray(lab.audio_lens),
            jnp.asarray(lab.tokens), jnp.asarray(lab.real),
            (jnp.asarray(cmvn[0]), jnp.asarray(cmvn[1])),
            jnp.asarray(unlab.audio), jnp.asarray(unlab.audio_lens),
            jnp.asarray(unlab.real), jnp.asarray(s["text"]),
            jnp.asarray(s["text_real"]))
    return opt, state, args


@pytest.mark.parametrize("step", [0, WARMUP])
def test_semi_step_matches_jax(semi_setup, step):
    s = semi_setup
    pcfg, jcfg, lab, unlab, cmvn = (s[k] for k in ("pcfg", "jcfg", "lab",
                                                   "unlab", "cmvn"))
    _, state, jargs = jax_inputs(s, step)
    new_state, ref = s["step"](state, *jargs)
    ref_grads = weights.flatten_tree(
        jax.tree.map(np.asarray, new_state.opt_state[0]))
    ref_ema = weights.flatten_tree(
        jax.tree.map(np.asarray, new_state.ema_params))
    # the SpecAugment bands JAX draws for the labeled view (k_feat) and the
    # augmented unlabeled view (k_pl_feat)
    _, k_step = jax.random.split(state.rng)
    k_feat, _, k_pl_feat, _ = jax.random.split(k_step, 4)
    ptorch = (t(cmvn[0]), t(cmvn[1]))

    def bands(key, batch):
        _, lens = TS.featurize(pcfg, t(batch.audio), t(batch.audio_lens),
                               ptorch)
        return tuple(t(x) for x in run_jax(
            lambda k, n: JF.sample_specaug_params(k, 4, 80, n,
                                                  jcfg.frontend),
            key, jnp.asarray(lens.numpy())))

    model = port_model(pcfg, s["flat"])
    st = TS.init_train_state(pcfg, model, seed=0)
    st.ema = port_model(pcfg, s["teacher"]).requires_grad_(False)
    st.step = step
    loss, aux, grads = TS.loss_and_grads(
        pcfg, st, t(lab.audio), t(lab.audio_lens), t(lab.tokens),
        t(lab.real), ptorch,
        [TS.StepDraws(TS.Draws(specaug=bands(k_feat, lab)),
                      TS.Draws(specaug=bands(k_pl_feat, unlab)))],
        unlab_audio=t(unlab.audio), unlab_audio_lens=t(unlab.audio_lens),
        unlab_real=t(unlab.real), unlab_text=t(s["text"]),
        unlab_text_real=t(s["text_real"]))
    got = dict(aux, loss=loss)
    for k in ("loss", "nll_per_label", "text_ilm", "pseudo"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    assert got["pseudo_gate"] == float(ref["pseudo_gate"]) == float(
        step >= WARMUP)
    assert float(ref["pseudo"]) > 0 and float(ref["text_ilm"]) > 0
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref_grads)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref_grads[n], **TOL_GRAD,
                                   err_msg=n)
    TS.apply_grads(pcfg, st, [g.clone() for g in grads])
    assert st.step == step + 1
    for n, e in st.ema.named_parameters():
        np.testing.assert_allclose(e.numpy(), ref_ema[n], rtol=0, atol=1e-6,
                                   err_msg=n)


# --------------------------------------------------------------------- #
# the shipped configs and the CLIs
# --------------------------------------------------------------------- #

def test_build_model_takes_the_shipped_transducer_configs():
    """The four transducer recipes build at their shipped widths (not
    run); ``ls100_conformer_streaming``'s listener is the chunk-causal
    conformer of 12 blocks of d_model 256 behind a 2-block stem."""
    for name in ("ls100_transducer", "ls100_transducer_semi",
                 "ls100_transducer_streaming"):
        cfg = TR.finalize_config(load_config(f"configs/{name}.yaml"), 31)
        model = build_model(cfg.model)
        assert isinstance(model, TD.Transducer), name
        assert model.joint.w_out.shape == (512, 31)
        assert model.predictor.layers[0].w_hh.shape == (512, 2048)
        streaming = name.endswith("streaming")
        assert cfg.model.enc_bidirectional == (not streaming)
        first = model.listener.layers[0]
        assert hasattr(first, "w_hh") == streaming, name
        assert model.joint.w_enc.shape[0] == 768
    cfg = TR.finalize_config(
        load_config("configs/ls100_conformer_streaming.yaml"), 31)
    model = build_model(cfg.model)
    assert isinstance(model, TD.Transducer)
    assert (cfg.model.enc_attn_chunk, cfg.model.enc_attn_left_chunks) == \
        (16, 2)
    assert len(model.listener.blocks) == 12 and len(model.listener.conv) == 2
    assert model.joint.w_enc.shape == (256, 512)


# tiny versions of the two recipes for the CLIs
CLI = ["model.enc_hidden=8", "model.enc_layers=1", "model.pred_hidden=16",
       "model.joint_dim=16", "model.embed_dim=8", "train.batch_size=4",
       "data.dataset=synthetic", "data.num_synthetic_utts=8",
       "data.frame_buckets=[128]", "data.token_buckets=[12]",
       "decode.max_decode_len=6", "decode.max_symbols=2",
       "objective.pseudo_warmup_steps=1", "objective.pseudo_confidence=0"]


@pytest.mark.parametrize("name", ["ls100_transducer",
                                  "ls100_transducer_semi"])
def test_main_train_test_and_transcribe(name, tmp_path, capsys):
    """``main --train`` for 2 steps, ``--test`` by the beam, by greedy and
    by ``--beam 0`` (LAS-only: decoded greedy), then ``transcribe`` with
    ``--nbest`` and its refusal of ``--beam 0``."""
    config = f"configs/{name}.yaml"
    d = tmp_path / "run"
    run = ["train.total_steps=2", "train.eval_every=2", "train.log_every=1"]
    assert M.main(["--config", config, "--train", "--workdir", str(d),
                   "--device", "cpu", *CLI, *run]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert math.isfinite(out["final_dev"]["dev_error"])
    recs = train_records(d)
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert math.isfinite(r["loss"]) and math.isfinite(r["nll_per_label"])
    if name.endswith("semi"):
        assert [r["pseudo_gate"] for r in recs] == [0.0, 1.0]
        assert all(r["text_ilm"] > 0 and r["pseudo"] > 0 for r in recs)
    tests = {}
    for beam in ("3", "1", "0"):
        assert M.main(["--config", config, "--test", "--load-dir", str(d),
                       "--device", "cpu", "--beam", beam, *CLI]) == 0
        tests[beam] = json.loads(capsys.readouterr().out.strip()
                                 .splitlines()[-1])
        assert math.isfinite(tests[beam]["cer"])
        assert "cap_hit_rate" not in tests[beam]
    assert tests["0"]["cer"] == tests["1"]["cer"]
    cfg = TR.finalize_config(load_config(config, CLI), 31)
    wav = synthetic.write_wavs(tmp_path, cfg, build_datasets(cfg).vocab, 1)
    assert TR.main(["--config", config, "--load-dir", str(d), "--device",
                    "cpu", "--beam", "3", "--nbest", "3", str(wav[0]),
                    *CLI]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(res["nbest"]) == 3 and res["audio"] == str(wav[0])
    scores = [c["score"] for c in res["nbest"]]
    assert scores == sorted(scores, reverse=True)
    with pytest.raises(SystemExit, match="LAS-only"):
        TR.main(["--config", config, "--load-dir", str(d), "--device", "cpu",
                 "--beam", "0", str(wav[0]), *CLI])


@pytest.mark.parametrize("override, error, message", [
    ("objective.lambda_ctc=0.3", ValueError, "disable objective.lambda_ctc"),
    ("model.lm_fusion=cold", ValueError, "has no LM fusion yet"),
    # shallow fusion and the ILM correction are ported: what stays refused
    # is an LM the port cannot read, a JAX (orbax) one or none at all
    pytest.param("decode.ilm_weight=0.2 decode.lm_weight=0.3 "
                 "decode.lm_ckpt={tmp}/jax_lm", SystemExit,
                 "orbax -> params.npz converter",
                 id="decode.ilm_weight=0.2-SystemExit-decode.ilm_weight"),
    pytest.param("decode.lm_weight=0.3 decode.lm_ckpt={tmp}/no_lm",
                 SystemExit, "shallow LM fusion: .* no trained LM",
                 id="decode.lm_weight=0.3-SystemExit-shallow LM fusion"),
])
def test_main_refuses_what_the_family_does_not_run(tmp_path, override,
                                                    error, message):
    # what the JAX trainer leaves: an orbax directory, no params.npz
    orbax = tmp_path / "jax_lm" / "lm_params"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(error, match=message):
        M.main(["--config", "configs/ls100_transducer.yaml", "--train",
                "--workdir", str(tmp_path / "run"), "--device", "cpu", *CLI,
                *override.format(tmp=tmp_path).split()])
