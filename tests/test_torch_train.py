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
from ``jax.random`` by design).  Then the ``train`` CLI end to end on the
CPU, and its refusals.
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
from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq
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


@pytest.mark.parametrize("smoothing", [0.0, 0.05])
def test_masked_ce_and_accuracy_match_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 7, 65)).astype(np.float32) * 3
    targets = rng.integers(3, 65, (4, 7)).astype(np.int32)
    targets[1, 4:] = 0
    targets[3, :] = 0
    targets[2, 2] = logits[2, 2].argmax()        # a hit for the accuracy
    ref_ce, ref_lp = JL.masked_ce(jnp.asarray(logits), jnp.asarray(targets),
                                  smoothing)
    ce, lp = LO.masked_ce(t(logits), t(targets), smoothing)
    np.testing.assert_allclose(ce.item(), float(ref_ce), rtol=1e-6)
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), rtol=1e-6,
                               atol=1e-6)
    acc = LO.token_accuracy(t(logits), t(targets))
    ref_acc = JL.token_accuracy(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(acc.item(), float(ref_acc), rtol=1e-6)
    ins, tg = LO.shift_targets(t(targets))
    ref_ins, _ = JL.shift_targets(jnp.asarray(targets))
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


def make_step_setup(config, overrides):
    """Both configs, the JAX parameter tree, a batch with a filler row, and
    the CMVN statistics."""
    pcfg = load_config(config, overrides + ["frontend.spec_augment=false"])
    bundle = build_datasets(pcfg)
    pcfg = TR.finalize_config(pcfg, bundle.vocab.size)
    jcfg = jax_load_config(config, overrides + ["frontend.spec_augment=false"])
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
    model = Seq2Seq(cfg.model)
    weights.load_flat(model, flat)
    return model


@pytest.mark.parametrize("tf_rate", [1.0, 0.0])
def test_forward_teacher_matches_jax(tf_rate):
    """tf_rate 1 (ground truth) and 0 (argmax feedback) are deterministic
    on both sides; B=8, U=6, enc 128, dec 128, vocab 65."""
    cfg = load_config(CONFIG, ["model.enc_hidden=64", "model.dec_hidden=128",
                               "model.compute_dtype=float32"])
    cfg = TR.finalize_config(cfg, 65)
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
    jcfg = jax_load_config(CONFIG, ["model.enc_hidden=64",
                                    "model.dec_hidden=128",
                                    "model.compute_dtype=float32"])
    jcfg = dataclasses.replace(jcfg.model, vocab_size=65, n_mels=80)
    sp = jax.tree.map(jnp.asarray, weights.unflatten_tree(flat)["speller"])
    ref = run_jax(
        lambda p, e, m, tk, k: JS.forward_teacher(p, jcfg, e, m, tk,
                                                  tf_rate, k),
        sp, jnp.asarray(enc), jnp.asarray(mask), jnp.asarray(tokens),
        jax.random.PRNGKey(0))
    with torch.no_grad():
        got = speller.forward_teacher(t(enc), t(mask), t(tokens), tf_rate,
                                      torch.Generator().manual_seed(0))
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
    bands = JF.sample_specaug_params(key, 4, 80, ref_lens, jcfg.frontend)
    assert int(np.asarray(bands[1]).sum() + np.asarray(bands[3]).sum()) > 0
    pcfg = dataclasses.replace(pcfg, frontend=dataclasses.replace(
        pcfg.frontend, spec_augment=True))
    got, got_lens = TS.featurize(pcfg, t(audio), t(lens),
                                 (t(cmvn[0]), t(cmvn[1])), augment=True,
                                 specaug=tuple(t(x) for x in bands))
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


def check_supervised_step(pcfg, jcfg, batch, cmvn, flat):
    tree = jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))
    opt = optax.chain(stash(), JSCH.make_optimizer(jcfg.train))
    state = JT.TrainState(params=tree, opt_state=opt.init(tree),
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
    _, _, grads = TS.loss_and_grads(pcfg, st, *args)
    st = TS.init_train_state(pcfg, model, seed=0)
    got = TS.supervised_step(pcfg, st, *args)
    for k in ("loss", "ce", "acc", "grad_norm"):
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
    ("model.dec_dropout=0.1", "model.dec_dropout"),
    ("frontend.speed_perturb=[0.9,1.1]", "frontend.speed_perturb"),
    ("train.grad_accum=2", "train.grad_accum"),
    ("objective.lambda_mwer=0.2", "objective.lambda_mwer"),
])
def test_train_cli_refuses_unported_options(tmp_path, override, message):
    with pytest.raises(SystemExit, match=message):
        TRN.main(["--config", CONFIG, "--workdir", str(tmp_path), "--steps",
                  "1", "--device", "cpu", *TINY, override])


@pytest.mark.parametrize("override, message", [
    ("model.enc_attn_chunk=8", "model.enc_attn_chunk"),
    ("model.enc_dropout=0.1", "model.enc_dropout"),
    ("train.remat_encoder=true", "train.remat_encoder"),
])
def test_train_cli_refuses_unported_conformer_options(tmp_path, override,
                                                      message):
    with pytest.raises(SystemExit, match=message):
        TRN.main(["--config", CONFORMER_CONFIG, "--workdir", str(tmp_path),
                  "--steps", "1", "--device", "cpu", *CONFORMER, override])


def test_train_cli_needs_cuda_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        TRN.main(["--config", CONFIG, "--workdir", str(tmp_path), "--steps",
                  "1", *TINY])
