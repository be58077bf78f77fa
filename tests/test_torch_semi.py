"""PyTorch port parity: the semi-supervised LAS step (configs/ls100_semi.yaml's
objective) at a small width in float32.

Held against the JAX package on the same numpy inputs and weights:
``text_ae_loss`` (1e-5; every listener gradient of the port exactly 0),
``pseudo_label_loss`` with a teacher whose weights differ from the
student's, keeping every row or dropping some by confidence, with one
filler row (1e-5; no gradient reaches the teacher), and the whole step:
JAX's ``supervised_step_fn`` with its unlabeled arguments, compiled once
and run with the pseudo-label gate closed (step 0) and open (step =
``pseudo_warmup_steps``), against the port's ``loss_and_grads`` and
``apply_grads`` with the SpecAugment bands JAX draws for the labeled and
the augmented unlabeled view fed in: the metrics to 1e-5, the gradients to
``TOL_GRAD``, the parameters after Adam as ``check_supervised_step`` holds
them, and the EMA buffer (the teacher) to 1e-6.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semi_supervised_asr_tpu.config import load_config as jax_load_config
from semi_supervised_asr_tpu.objectives import losses as JL
from semi_supervised_asr_tpu.ops import frontend as JF
from semi_supervised_asr_tpu.training import schedules as JSCH
from semi_supervised_asr_tpu.training import train_step as JT
from semi_supervised_asr_tpu_torch import transcribe as TR
from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.config import load_config
from semi_supervised_asr_tpu_torch.data import pipeline
from semi_supervised_asr_tpu_torch.data.bucketing import make_bucket_spec
from semi_supervised_asr_tpu_torch.data.registry import build_datasets
from semi_supervised_asr_tpu_torch.objectives import losses as LO
from semi_supervised_asr_tpu_torch.training import train_step as TS
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    CONFIG, EVERY_DRAW, FAST_XLA, SMALL, TOL_GRAD, jax_step_draws,
    one_thread, port_model, run_jax, stash, t,
)

WARMUP = 2
# the semi-supervised objective on the small timit width; teacher forcing
# stays at 1 so that no scheduled-sampling draw enters the step at
# step = WARMUP, and the confidence filter keeps every row (the loss test
# drops rows)
SEMI = SMALL + [
    "objective.lambda_text_ae=0.3", "objective.lambda_pseudo=0.5",
    f"objective.pseudo_warmup_steps={WARMUP}",
    "objective.pseudo_confidence=0", "objective.use_ema_teacher=true",
    "objective.ema_decay=0.9", "objective.tf_rate_end=1.0",
]


@pytest.fixture(scope="module")
def setup():
    """Both configs, the student's and the teacher's weights, a labeled
    batch, an unlabeled audio batch and a text batch (each with a filler
    row), and the CMVN statistics."""
    pcfg = load_config(CONFIG, SEMI)
    bundle = build_datasets(pcfg)
    pcfg = TR.finalize_config(pcfg, bundle.vocab.size)
    jcfg = jax_load_config(CONFIG, SEMI)
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
    text_real = text_real & (np.arange(4) < 3)   # a filler row, not all-PAD
    assert text[3].any()
    cmvn = pipeline.compute_global_cmvn(bundle.train, pcfg.frontend)
    return dict(pcfg=pcfg, jcfg=jcfg, lab=lab, unlab=unlab, text=text,
                text_real=text_real, cmvn=cmvn,
                flat=weights.init_numpy(pcfg.model, seed=0),
                teacher=weights.init_numpy(pcfg.model, seed=1))


def tree_of(flat):
    return jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))


def test_text_ae_loss_matches_jax(setup):
    s = setup
    text = np.where(s["text_real"][:, None], s["text"], 0)
    obj = s["jcfg"].objective
    ref = run_jax(lambda p, x: JL.text_ae_loss(p, s["jcfg"].model, obj, x),
                  tree_of(s["flat"]), jnp.asarray(text))
    model = port_model(s["pcfg"], s["flat"])
    loss = LO.text_ae_loss(model.speller, obj.label_smoothing, t(text))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    listener = [g for n, g in zip(names, grads) if n.startswith("listener.")]
    assert listener and all(g is None or not g.any() for g in listener)
    emb = grads[names.index("speller.embedding")]
    assert emb is not None and emb.any()


def features(seed: int, b: int = 4, frames: int = 128):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, frames, 80)).astype(np.float32)


@pytest.mark.parametrize("keep", ["all", "some"])
def test_pseudo_label_loss_matches_jax(setup, keep):
    """Student and teacher from different weights, clean and augmented
    views of noise features, lengths 128/97/57/128, the third row filler;
    ``keep="some"`` sets the confidence threshold between two rows'
    confidences, so that the filter drops at least one real row."""
    s = setup
    pcfg, jcfg = s["pcfg"], s["jcfg"]
    clean, aug = features(3), features(4)
    lens = np.asarray([128, 97, 57, 128], np.int32)
    row_mask = np.asarray([True, True, False, True])
    max_len = 12
    student = port_model(pcfg, s["flat"])
    teacher = port_model(pcfg, s["teacher"])
    args = (t(clean), t(aug), t(lens), max_len, t(row_mask))
    confidence = 0.0
    if keep == "some":
        hyps, hyp_logp = LO.teacher_labels(teacher, t(clean), t(lens),
                                           max_len)
        mask = LO.token_mask(hyps)
        conf = ((hyp_logp * mask).sum(1) / mask.sum(1).clamp_min(1.0))
        real = sorted(conf[torch.from_numpy(row_mask)].tolist())
        assert real[-1] - real[0] > 1e-3
        confidence = math.exp((real[0] + real[-1]) / 2)
    obj = dataclasses.replace(jcfg.objective, pseudo_confidence=confidence)
    ref = run_jax(
        lambda p, tp, c, a, n, m: JL.pseudo_label_loss(
            p, tp, jcfg.model, obj, c, a, n, jax.random.PRNGKey(0),
            max_len, row_mask=m),
        tree_of(s["flat"]), tree_of(s["teacher"]), jnp.asarray(clean),
        jnp.asarray(aug), jnp.asarray(lens), jnp.asarray(row_mask))
    loss = LO.pseudo_label_loss(student, teacher, confidence, *args)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    assert loss.item() > 0
    assert all(g is None for g in torch.autograd.grad(
        loss, list(teacher.parameters()), allow_unused=True,
        retain_graph=True))
    grads = torch.autograd.grad(loss, list(student.parameters()),
                                allow_unused=True)
    assert any(g is not None and g.any() for g in grads)


def jax_inputs(s, step: int):
    """JAX's train state at ``step`` and the step's batch arguments."""
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


@pytest.fixture(scope="module")
def jax_semi_step(setup):
    """JAX's step with the unlabeled arguments, compiled once (the gate is
    a traced comparison of ``state.step``), the gradients kept in the
    optimizer state."""
    opt, state, args = jax_inputs(setup, 0)
    return jax.jit(functools.partial(
        JT.supervised_step_fn, setup["jcfg"], opt)).lower(
        state, *args).compile(compiler_options=FAST_XLA)


@pytest.mark.parametrize("step", [0, WARMUP])
def test_semi_step_matches_jax(setup, jax_semi_step, step):
    s = setup
    pcfg, jcfg, lab, unlab = s["pcfg"], s["jcfg"], s["lab"], s["unlab"]
    cmvn = s["cmvn"]
    _, state, jargs = jax_inputs(s, step)
    new_state, ref = jax_semi_step(state, *jargs)
    ref_grads = weights.flatten_tree(
        jax.tree.map(np.asarray, new_state.opt_state[0]))
    ref_params = weights.flatten_tree(
        jax.tree.map(np.asarray, new_state.params))
    ref_ema = weights.flatten_tree(
        jax.tree.map(np.asarray, new_state.ema_params))

    # the bands JAX's featurize draws for the labeled view (k_feat) and the
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
    for k in ("loss", "ce", "acc", "text_ae", "pseudo"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    assert got["pseudo_gate"] == float(ref["pseudo_gate"]) == float(
        step >= WARMUP)
    assert float(ref["pseudo"]) > 0
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref_grads)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref_grads[n], **TOL_GRAD,
                                   err_msg=n)
    gnorm, lr = TS.apply_grads(pcfg, st, [g.clone() for g in grads])
    np.testing.assert_allclose(gnorm.item(), float(ref["grad_norm"]),
                               rtol=1e-5)
    assert st.step == step + 1
    # parameters after Adam as check_supervised_step holds them
    assert float(ref["grad_norm"]) < pcfg.train.grad_clip_norm

    def u(g):
        return g.astype(np.float64) / (np.abs(g) + 1e-8)

    for (n, p), g in zip(model.named_parameters(), grads):
        want = ref_params[n] - lr * (u(g.numpy()) - u(ref_grads[n]))
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6, err_msg=n)
    for n, e in st.ema.named_parameters():
        assert not e.requires_grad
        np.testing.assert_allclose(e.numpy(), ref_ema[n], rtol=0, atol=1e-6,
                                   err_msg=n)


def test_accumulated_semi_step_with_every_draw_matches_jax(setup):
    """The semi step under ``train.grad_accum=2`` with dropout, speed,
    noise, the SpecAugment bands and time warp (EVERY_DRAW): the labeled,
    unlabeled-audio and text batches each split in two, each microbatch
    fed JAX's draws for its labeled view, its augmented unlabeled view and
    the student's dropout; metrics to 1e-5 and gradients to TOL_GRAD, the
    pseudo-label gate open."""
    s = setup
    pcfg = load_config(CONFIG, SEMI + EVERY_DRAW)
    pcfg = TR.finalize_config(pcfg, s["pcfg"].model.vocab_size)
    jcfg = jax_load_config(CONFIG, SEMI + EVERY_DRAW)
    jcfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, vocab_size=s["pcfg"].model.vocab_size, n_mels=80))
    lab, unlab, cmvn = s["lab"], s["unlab"], s["cmvn"]
    opt, state, jargs = jax_inputs(dict(s, jcfg=jcfg), WARMUP)
    new_state, ref = jax.jit(functools.partial(
        JT.supervised_step_fn, jcfg, opt)).lower(state, *jargs).compile(
        compiler_options=FAST_XLA)(state, *jargs)
    ref_grads = weights.flatten_tree(
        jax.tree.map(np.asarray, new_state.opt_state[0]))

    model = port_model(pcfg, s["flat"])
    draws = jax_step_draws(jcfg, model, state.rng, lab.audio,
                           lab.audio_lens, lab.tokens, unlab.audio,
                           unlab.audio_lens)
    assert all(d.unlabeled.masks[0] is not None for d in draws)
    st = TS.init_train_state(pcfg, model, seed=0)
    st.ema = port_model(pcfg, s["teacher"]).requires_grad_(False)
    st.step = WARMUP
    loss, aux, grads = TS.loss_and_grads(
        pcfg, st, t(lab.audio), t(lab.audio_lens), t(lab.tokens),
        t(lab.real), (t(cmvn[0]), t(cmvn[1])), draws,
        unlab_audio=t(unlab.audio), unlab_audio_lens=t(unlab.audio_lens),
        unlab_real=t(unlab.real), unlab_text=t(s["text"]),
        unlab_text_real=t(s["text_real"]))
    got = dict(aux, loss=loss)
    for k in ("loss", "ce", "acc", "text_ae", "pseudo"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    assert got["pseudo_gate"] == float(ref["pseudo_gate"]) == 1.0
    names = [n for n, _ in model.named_parameters()]
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref_grads[n], **TOL_GRAD,
                                   err_msg=n)
