"""PyTorch port parity: BEST-RQ pretraining (``objectives/best_rq.py``,
``training/pretrain.py``), its transfer (``train.init_encoder_from``),
``train.freeze``, the offline self-training round (``selftrain.py``) and
the ``python -m`` aliases.

At the widths of ``tests/test_bestrq.py`` (enc_hidden 8, 2 listener
layers, codebook 32 x 8), seeded numpy weights (``weights.init_module``)
crossed into the JAX tree by name, JAX through ``run_jax``:

* the quantizer bitwise, the targets equal (the smallest top-two margin
  printed), span dilation and masking from given starts equal;
* ``prediction_ce`` and its metrics within 1e-6, the loss bitwise
  unchanged when labels outside the mask flip;
* ``bestrq_loss`` and every gradient leaf of the pBLSTM and the conformer
  listener with JAX's mask and noise fed in: loss within 1e-5 relative,
  gradients at the step test's tolerance (``tests/test_torch_train.py``),
  and one clipped Adam step's parameters against optax's;
* the port's own draw (a span in every real row with frames, none in the
  padding, a function of (seed, step) alone, rows of a global draw);
* the pretraining CLI in process, exact resume (4 steps straight against
  2 + 2, bitwise), the transfer into each family (listener and EMA buffer
  equal to the file bitwise) and its refusals by name, ``train.freeze``
  (the listener bitwise unchanged under Adam; the clip's norm without the
  frozen leaves, the logged norm with them; adamw's decay of the frozen
  leaves as optax's chain), the CUDA refusal;
* ``selftrain.pseudo_label_entries`` against the JAX function on the same
  transcription results, its filters, the CLI with ``--union``;
* the ``training`` and ``decode`` aliases.
"""

import contextlib
import dataclasses
import functools
import io
import json
import math
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semi_supervised_asr_tpu import selftrain as JST
from semi_supervised_asr_tpu.config import (
    TrainConfig as JTrainConfig, load_config as jax_load_config,
)
from semi_supervised_asr_tpu.objectives import best_rq as JBRQ
from semi_supervised_asr_tpu.training import schedules as JSCH
from semi_supervised_asr_tpu_torch import selftrain as ST
from semi_supervised_asr_tpu_torch import synthetic, weights
from semi_supervised_asr_tpu_torch import transcribe as TR
from semi_supervised_asr_tpu_torch.config import TrainConfig, load_config
from semi_supervised_asr_tpu_torch.data.registry import build_datasets
from semi_supervised_asr_tpu_torch.objectives import best_rq as BRQ
from semi_supervised_asr_tpu_torch.training import pretrain as PT
from semi_supervised_asr_tpu_torch.training import schedules as SCH
from semi_supervised_asr_tpu_torch.training.solver import Solver
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    CONFORMER, CONFORMER_CONFIG, TOL_GRAD, one_thread, run_jax, t,
)

CONFIG = "configs/synthetic_smoke.yaml"
# tests/test_bestrq.py's widths and pretrain knobs
PIECES = ["pretrain.codebook_size=32", "pretrain.codebook_dim=8",
          "pretrain.mask_prob=0.08", "pretrain.mask_span=4"]
ARCHS = {
    "blstm": (CONFIG, ["model.enc_hidden=8", "model.enc_layers=2",
                       "model.enc_base_layers=1"]),
    # a 2-block conformer of d_model 32 on the flash route, float32, no
    # dropout (the JAX listener's draws are not fed in)
    "conformer": (CONFORMER_CONFIG, CONFORMER),
}
# the pretraining runs: synthetic_smoke at a tiny width, 8 utterances in
# batches of 4, a resume save every 2 steps
RUN = ["data.num_synthetic_utts=8", "train.batch_size=4",
       "model.enc_hidden=8", "model.enc_layers=2", "model.enc_base_layers=1",
       "model.attn_dim=8", "model.dec_hidden=16", "model.embed_dim=8",
       "model.attn_conv_channels=2", "model.attn_conv_width=5",
       "decode.max_decode_len=6", "data.frame_buckets=[128]",
       "data.token_buckets=[16]", "pretrain.codebook_size=16",
       "pretrain.codebook_dim=4", "pretrain.mask_prob=0.1",
       "pretrain.mask_span=4", "pretrain.log_every=1",
       "pretrain.ckpt_every=2"]
FAMILIES = {"las": [], "ctc": ["model.family=ctc"],
            "transducer": ["model.family=transducer", "model.pred_hidden=8",
                           "model.joint_dim=8"]}
B, T = 4, 64
LENS = np.array([T, T - 9, T // 2, 5], np.int32)
REAL = np.array([True, True, True, False])


def both_configs(config, overrides):
    """(the port's, JAX's) config, model dims filled in."""
    over = [*overrides, *PIECES, "model.compute_dtype=float32"]
    out = []
    for load in (load_config, jax_load_config):
        cfg = load(config, over)
        out.append(cfg.replace(model=dataclasses.replace(
            cfg.model, n_mels=80, vocab_size=16)))
    return out


def feats_of(seed=0, m=80):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, m)).astype(np.float32)
    return feats * (np.arange(T)[None, :, None] < LENS[:, None, None])


def jax_masking(key, lens, pcfg, m=80):
    """JAX's span starts (``sample_mask``'s draw before its dilation),
    standard-normal noise and mask for ``bestrq_loss(rng=key)``, drawn in
    one jit as the loss draws them."""
    def draws(key, lens):
        k_mask, k_noise, _ = jax.random.split(key, 3)
        valid = jnp.arange(T)[None, :] < lens[:, None]
        r_bern, r_pos = jax.random.split(k_mask)
        starts = jax.random.bernoulli(r_bern, pcfg.mask_prob, (B, T)) & valid
        pos = jax.random.randint(r_pos, (B,), 0, jnp.maximum(lens, 1))
        starts = starts | jax.nn.one_hot(pos, T, dtype=bool)
        noise = jax.random.normal(k_noise, (B, T, m), jnp.float32)
        return starts, noise, JBRQ.sample_mask(k_mask, B, T, lens, pcfg)

    return tuple(map(np.asarray, run_jax(draws, key, jnp.asarray(lens))))


def test_make_quantizer_bitwise_equal_to_jax():
    pcfg, jpcfg = (c.pretrain for c in both_configs(CONFIG, []))
    for n_mels, r in ((80, 4), (80, 8), (40, 2)):
        for a, b in zip(BRQ.make_quantizer(n_mels, r, pcfg),
                        JBRQ.make_quantizer(n_mels, r, jpcfg)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_head_init_is_glorot_and_zero():
    """``weights.init_module`` draws the head by its path as the reference's
    ``init_bestrq_head``: ``head.w`` glorot uniform, ``head.b`` zeros."""
    pcfg, _ = both_configs(*ARCHS["blstm"])
    flat = weights.init_module(BRQ.BestRQModel(pcfg.model, pcfg.pretrain), 0)
    w, b = flat["head.w"], flat["head.b"]
    fan_in, fan_out = pcfg.model.enc_out_dim, pcfg.pretrain.codebook_size
    assert w.shape == (fan_in, fan_out) and not b.any()
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
    assert abs(float(w.std()) - bound / math.sqrt(3.0)) < 0.1 * bound


def test_targets_equal_jax():
    """The argmax over the codebook, JAX's against the port's at the
    tests' seed; the smallest top-two margin over the frames that hold
    features says how far the nearest flip is (an all-pad stacked frame
    scores 0 against every code and takes code 0 in both)."""
    pcfg, _ = both_configs(CONFIG, [])
    proj, cb = BRQ.make_quantizer(80, 4, pcfg.pretrain)
    feats = feats_of()
    want = run_jax(lambda f: JBRQ.bestrq_targets(f, proj, cb, 4),
                   jnp.asarray(feats))
    got = BRQ.bestrq_targets(t(feats), t(proj), t(cb), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scores = BRQ.bestrq_scores(t(feats), t(proj), t(cb), 4)
    top2 = torch.topk(scores, 2, dim=-1).values
    frames = torch.arange(T // 4)[None, :] * 4 < t(LENS)[:, None]
    margin = (top2[..., 0] - top2[..., 1])[frames].min().item()
    print(f"smallest top-two margin of the targets: {margin:.3e}")
    assert margin > 0


@pytest.mark.parametrize("span", [1, 4, 20])
def test_span_dilation_and_masking_match_jax(span):
    pcfg, jcfg = both_configs(CONFIG, [])
    pcfg = dataclasses.replace(pcfg.pretrain, mask_span=span)
    jpcfg = dataclasses.replace(jcfg.pretrain, mask_span=span)
    rng = np.random.default_rng(span)
    starts = rng.random((B, T)) < 0.1
    jmask = np.asarray(run_jax(lambda s: JBRQ.dilate_spans(s, span),
                               jnp.asarray(starts)))
    np.testing.assert_array_equal(
        BRQ.dilate_spans(t(starts), span).numpy(), jmask)
    feats = feats_of(span)
    key = jax.random.PRNGKey(span)
    jmask = jmask & (np.arange(T)[None, :] < LENS[:, None])
    # eager, so the noise is the bits masked_inputs draws (under one jit
    # XLA's fusion moves the normal's last bit)
    noise = np.asarray(jax.random.normal(key, feats.shape, jnp.float32))
    want = JBRQ.masked_inputs(key, jnp.asarray(feats), jnp.asarray(jmask),
                              jpcfg)
    x, mask = BRQ.apply_masking(t(feats), t(LENS),
                                BRQ.MaskDraws(t(starts), t(noise)), pcfg)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_array_equal(x.numpy(), np.asarray(want))


def test_prediction_ce_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 10, 32)).astype(np.float32) * 2
    labels = rng.integers(0, 32, (3, 10)).astype(np.int32)
    pos = rng.random((3, 10)) < 0.4
    labels[0, :4] = logits[0, :4].argmax(-1)      # hits for the accuracy
    pos[0, :4] = True
    ref_loss, ref = run_jax(JBRQ.prediction_ce, jnp.asarray(logits),
                            jnp.asarray(labels), jnp.asarray(pos))
    loss, got = BRQ.prediction_ce(t(logits), t(labels).long(), t(pos))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6,
                                   err_msg=k)
    flipped = np.where(pos, labels, (labels + 7) % 32)
    loss2, got2 = BRQ.prediction_ce(t(logits), t(flipped).long(), t(pos))
    assert torch.equal(loss, loss2)
    assert torch.equal(got["mask_acc"], got2["mask_acc"])


@functools.lru_cache(maxsize=None)
def reference_step(arch: str):
    """One BEST-RQ step of ``arch`` from the same weights, features and
    JAX's masking draws -> (port config, weights, draws, JAX's loss,
    metrics, gradients and parameters after one clipped Adam step)."""
    pcfg, jcfg = both_configs(*ARCHS[arch])
    # a clip low enough to scale the gradients
    jcfg = jcfg.replace(train=dataclasses.replace(
        jcfg.train, grad_clip_norm=0.1, learning_rate=1e-3, warmup_steps=0))
    pcfg = pcfg.replace(train=dataclasses.replace(
        pcfg.train, grad_clip_norm=0.1, learning_rate=1e-3, warmup_steps=0))
    flat = weights.init_module(BRQ.BestRQModel(pcfg.model, pcfg.pretrain), 0)
    tree = jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))
    r = pcfg.model.time_reduction
    proj, cb = BRQ.make_quantizer(80, r, pcfg.pretrain)
    key = jax.random.PRNGKey(7)
    starts, noise, mask = jax_masking(key, LENS, jcfg.pretrain)
    opt = JSCH.make_optimizer(jcfg.train)

    def step(p, f, lens, real):
        (loss, metrics), g = jax.value_and_grad(
            lambda q: JBRQ.bestrq_loss(q, jcfg.model, jcfg.pretrain, f, lens,
                                       real, key, proj, cb),
            has_aux=True)(p)
        u, _ = opt.update(g, opt.init(p), p)
        return loss, metrics, g, optax.apply_updates(p, u)

    loss, metrics, grads, new = run_jax(
        step, tree, jnp.asarray(feats_of()), jnp.asarray(LENS),
        jnp.asarray(REAL))
    as_np = functools.partial(jax.tree.map, np.asarray)
    return (pcfg, flat, (starts, noise, mask), float(loss),
            {k: float(v) for k, v in metrics.items()},
            weights.flatten_tree(as_np(grads)), weights.flatten_tree(
                as_np(new)), (proj, cb))


def port_step(arch: str):
    """The port's loss, metrics and gradients on ``reference_step``'s
    inputs -> (model, loss, metrics, grads)."""
    pcfg, flat, (starts, noise, _), *_, (proj, cb) = reference_step(arch)
    model = BRQ.BestRQModel(pcfg.model, pcfg.pretrain)
    weights.load_flat(model, flat)
    loss, metrics = BRQ.bestrq_loss(
        model, pcfg.pretrain, t(feats_of()), t(LENS), t(REAL), t(proj),
        t(cb), BRQ.MaskDraws(t(starts), t(noise)))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return model, loss, metrics, list(grads)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bestrq_loss_and_grads_match_jax(arch):
    pcfg, _, (starts, noise, mask), ref_loss, ref, ref_grads, *_ = \
        reference_step(arch)
    # the port's apply of JAX's starts is JAX's mask
    _, got_mask = BRQ.apply_masking(t(feats_of()), t(LENS),
                                    BRQ.MaskDraws(t(starts), t(noise)),
                                    pcfg.pretrain)
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    model, loss, metrics, grads = port_step(arch)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    assert ref["masked_positions"] > 0
    for k in ref:
        np.testing.assert_allclose(float(metrics[k]), ref[k], rtol=1e-5,
                                   err_msg=k)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref_grads)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref_grads[n], **TOL_GRAD,
                                   err_msg=n)


def test_pretraining_step_matches_optax_adam():
    """One clipped Adam step (``schedules.update``) from the same init
    against optax's chain.  Adam's first update is g / (|g| + 1e-8): where
    |g| is within a few eps of zero the two gradients' float32 noise moves
    it visibly, so the port's parameters are held to JAX's moved by
    exactly that difference of the (already compared) clipped gradients."""
    pcfg, _, _, _, ref, ref_grads, ref_new, _ = reference_step("blstm")
    model, _, _, grads = port_step("blstm")
    names = [n for n, _ in model.named_parameters()]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = SCH.make_optimizer(list(model.named_parameters()), pcfg.train)
    gnorm, lr = SCH.update(opt, [g.clone() for g in grads], pcfg.train)
    ref_norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in ref_grads.values()))
    np.testing.assert_allclose(gnorm.item(), ref_norm, rtol=1e-5)
    clip = pcfg.train.grad_clip_norm
    assert gnorm.item() > clip

    def u(g, norm):
        g = g.astype(np.float64) * clip / norm
        return g / (np.abs(g) + 1e-8)

    for n, g in zip(names, grads):
        p = dict(model.named_parameters())[n].detach().numpy()
        want = ref_new[n] - lr * (u(g.numpy(), gnorm.item())
                                  - u(ref_grads[n], ref_norm))
        np.testing.assert_allclose(p, want, rtol=0, atol=1e-6, err_msg=n)
        assert not torch.equal(before[n], torch.from_numpy(p)) or \
            not ref_grads[n].any()


def test_port_draws():
    """At least one span in every real row with frames, none in the
    padding; the same draw for the same (seed, step), another for the next
    step; a draw at a global batch's shape keeps the rows asked for."""
    pcfg, _ = both_configs(*ARCHS["blstm"])
    pcfg = pcfg.replace(pretrain=dataclasses.replace(pcfg.pretrain,
                                                     mask_prob=1e-4))
    model = BRQ.BestRQModel(pcfg.model, pcfg.pretrain)
    lens = torch.tensor([T, 20, 1, 0])

    def draw(step, rows=None, b=B, ln=lens):
        return BRQ.draw_masking(PT.step_generator(0, step, "cpu"),
                                model.listener, pcfg.model, pcfg.pretrain,
                                (b, T, 80), ln, rows)

    for step in range(6):
        d = draw(step)
        _, mask = BRQ.apply_masking(torch.zeros(B, T, 80), lens, d,
                                    pcfg.pretrain)
        for row, n in enumerate(lens.tolist()):
            assert bool(mask[row, :n].any()) == (n > 0), (step, row)
            assert not mask[row, n:].any(), (step, row)
    a, b = draw(3), draw(3)
    assert torch.equal(a.starts, b.starts) and torch.equal(a.noise, b.noise)
    assert not torch.equal(a.noise, draw(4).noise)
    part = draw(3, rows=(1, 3, B), b=2, ln=lens[1:3])
    assert torch.equal(part.starts, a.starts[1:3])
    assert torch.equal(part.noise, a.noise[1:3])


def run_cli(argv):
    """The pretraining CLI in process -> its printed result."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert PT.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """One tiny pretraining run of 4 steps through the CLI, shared by the
    CLI, resume, transfer and freeze cases -> (workdir, its result)."""
    d = tmp_path_factory.mktemp("brq") / "straight"
    out = run_cli(["--config", CONFIG, "--workdir", str(d), "--device",
                   "cpu", *RUN, "pretrain.total_steps=4"])
    return d, out


def test_pretrain_cli_on_cpu(pretrained):
    d, out = pretrained
    assert set(PT.METRIC_KEYS) | {"first_loss", "wall_s"} == set(out)
    assert all(math.isfinite(v) for v in out.values())
    recs = [json.loads(x) for x in
            (d / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(r["prefix"] == "pretrain" for r in recs)
    for r in recs:
        assert all(math.isfinite(r[f"bestrq_{k}"]) for k in PT.METRIC_KEYS)
    assert out["first_loss"] == recs[0]["bestrq_loss"]
    meta = json.loads((d / "meta.json").read_text())
    assert set(meta) == {"encoder_arch", "enc_hidden", "time_reduction",
                         "n_listener_leaves", "codebook_size",
                         "codebook_dim", "quantizer_seed", "steps"}
    with np.load(PT.encoder_ckpt_dir(d) / PT.PARAMS_FILE) as enc, \
            np.load(d / "bestrq_params" / PT.PARAMS_FILE) as full:
        assert meta["n_listener_leaves"] == len(enc.files)
        assert {f"listener.{k}" for k in enc.files} | {"head.w", "head.b"} \
            == set(full.files)
        for k in enc.files:
            np.testing.assert_array_equal(enc[k], full[f"listener.{k}"])
    assert (d / "cmvn.npz").exists()
    assert torch.load(d / "train_ckpt" / PT.STATE_FILE,
                      weights_only=False)["step"] == 4


def test_pretrain_resume_is_bitwise(pretrained, tmp_path):
    """2 steps, then the same command to 4 in a new call: the parameters
    and Adam's state equal the straight run's bit for bit."""
    d, _ = pretrained
    run = ["--config", CONFIG, "--workdir", str(tmp_path), "--device", "cpu",
           *RUN]
    run_cli([*run, "pretrain.total_steps=2"])
    out = run_cli([*run, "pretrain.total_steps=4"])
    assert math.isfinite(out["loss"])
    a = torch.load(d / "train_ckpt" / PT.STATE_FILE, weights_only=False)
    b = torch.load(tmp_path / "train_ckpt" / PT.STATE_FILE,
                   weights_only=False)
    assert a["step"] == b["step"] == 4
    for k in a["model"]:
        assert torch.equal(a["model"][k].view(torch.uint8),
                           b["model"][k].view(torch.uint8)), k
    for k in ("mu", "nu"):
        for x, y in zip(a["opt"][k], b["opt"][k], strict=True):
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    assert a["opt"]["count"] == b["opt"]["count"] == 4


def encoder_file(d):
    with np.load(PT.encoder_ckpt_dir(d) / PT.PARAMS_FILE) as z:
        return {k: z[k] for k in z.files}


def solver_from(d, workdir, extra=()):
    cfg = load_config(CONFIG, [*RUN, f"train.init_encoder_from={d}",
                               "train.total_steps=2", "train.eval_every=0",
                               "train.ckpt_every=0", *extra])
    return Solver(cfg, workdir, "cpu")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_transfer_into_family(pretrained, tmp_path, family):
    """The listener and its EMA copy equal the file bitwise before the
    first step."""
    d, _ = pretrained
    s = solver_from(d, tmp_path, FAMILIES[family])
    want = encoder_file(d)
    for module in (s.state.model.listener, s.state.ema.listener):
        got = dict(module.named_parameters())
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].detach().numpy(), v)


@pytest.mark.parametrize("case", ["leaf_count", "shape", "missing", "orbax"])
def test_transfer_refusals(pretrained, tmp_path, case):
    d, _ = pretrained
    src, extra = d, []
    if case == "leaf_count":
        extra, match = ["model.enc_layers=3"], "n_listener_leaves"
    elif case == "shape":
        # meta.json's count matches; the widths do not
        extra, match = ["model.enc_hidden=16"], "layers.0.fwd.w_ih"
    elif case == "missing":
        src, match = tmp_path / "nothing", "no pretrained encoder"
    else:
        src = tmp_path / "jax_run"
        (PT.encoder_ckpt_dir(src) / "_CHECKPOINT_METADATA").parent.mkdir(
            parents=True)
        match = "orbax -> params.npz converter"
    with pytest.raises((ValueError, PT.EncoderNotFound), match=match):
        solver_from(src, tmp_path / "ft", extra)


def test_freeze_keeps_the_pretrained_listener(pretrained, tmp_path):
    """train.freeze=[listener] with Adam: after 2 steps the listener is
    the file's bit for bit and the speller has moved; the logged
    grad_norm still counts the listener's gradients."""
    d, _ = pretrained
    s = solver_from(d, tmp_path, ["train.freeze=[listener]",
                                  "train.log_every=1"])
    speller = [p.detach().clone() for p in s.state.model.speller.parameters()]
    s.train()
    want = encoder_file(d)
    for k, p in s.state.model.listener.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[k], err_msg=k)
    assert not all(torch.equal(a, b) for a, b in zip(
        speller, s.state.model.speller.parameters()))
    assert all(r["grad_norm"] > 0 for r in s.history)


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_freeze_chain_matches_optax(optimizer):
    """The reference's chain with train.freeze=[listener]: the frozen
    leaves' gradients (large enough to trip the clip on their own) leave
    the clip's norm, the logged norm keeps them; 2 steps against optax,
    under adamw the frozen leaves decaying as optax's do."""
    rng = np.random.default_rng(5)
    tree = {"listener": {"layers": [{"w": rng.standard_normal((3, 4))}]},
            "speller": {"b": rng.standard_normal(5)}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape)
                          .astype(np.float32), tree) for _ in range(2)]
    for g in grads:
        g["listener"]["layers"][0]["w"] *= 100.0
    kw = dict(learning_rate=1e-2, warmup_steps=0, lr_schedule="constant",
              grad_clip_norm=5.0, optimizer=optimizer, weight_decay=0.1,
              freeze=("listener",))
    opt = JSCH.make_optimizer(JTrainConfig(**kw))

    def updates(p, gs):
        s = opt.init(p)
        for g in gs:
            u, s = opt.update(g, s, p)
            p = optax.apply_updates(p, u)
        return p

    want = weights.flatten_tree(jax.tree.map(np.asarray, run_jax(
        updates, jax.tree.map(jnp.asarray, tree),
        [jax.tree.map(jnp.asarray, g) for g in grads])))
    flat = weights.flatten_tree(tree)
    names = sorted(flat)
    assert names == ["listener.layers.0.w", "speller.b"]
    assert SCH.reference_path(names[0]) == jax.tree_util.keystr(
        (jax.tree_util.DictKey("listener"), jax.tree_util.DictKey("layers"),
         jax.tree_util.SequenceKey(0), jax.tree_util.DictKey("w")))
    params = [t(flat[n].copy()) for n in names]
    cfg = TrainConfig(**kw)
    sopt = SCH.make_optimizer(list(zip(names, params)), cfg)
    assert sopt.frozen == [True, False]
    for g in grads:
        fg = weights.flatten_tree(g)
        tg = [t(fg[n].copy()) for n in names]
        raw = float(optax.global_norm(g))
        live = float(np.linalg.norm(fg["speller.b"]))
        assert live < cfg.grad_clip_norm < raw
        gnorm, _ = SCH.update(sopt, tg, cfg)
        np.testing.assert_allclose(gnorm.item(), raw, rtol=1e-6)
        # the live leaf was not clipped: its frozen neighbour left the norm
        np.testing.assert_array_equal(tg[1].numpy(), fg["speller.b"])
        assert not tg[0].any()
    for n, p in zip(names, params):
        np.testing.assert_allclose(p.numpy(), want[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)
    frozen_moved = not np.array_equal(params[0].numpy(), flat[names[0]])
    assert frozen_moved == (optimizer == "adamw")


def test_pretrain_cli_needs_cuda_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        PT.main(["--config", CONFIG, "--workdir", str(tmp_path), *RUN])


# the transcription results both packages' pseudo_label_entries get:
# entry 2's hypothesis is empty, the scores unordered
RESULTS = [{"text": "a b", "score": -0.5}, {"text": "c", "score": -2.0},
           {"text": "", "score": -0.1}, {"text": "d e f", "score": -0.2},
           {"text": "g", "score": -1.0}]


@pytest.mark.parametrize("min_score, keep_frac", [
    (None, None), (-1.0, None), (None, 0.5), (-1.5, 0.4)])
def test_pseudo_label_entries_match_jax(tmp_path, monkeypatch, min_score,
                                        keep_frac):
    entries = [{"uid": f"u{4 - i}", "audio": f"a{i}.wav",
                "n_samples": 100 + i, "text": "ignored"}
               for i in range(len(RESULTS))]
    seen = []

    def fake(rec, paths, mode):
        seen.append((list(paths), mode))
        return RESULTS

    monkeypatch.setattr("semi_supervised_asr_tpu.transcribe.transcribe",
                        fake)
    monkeypatch.setattr(TR, "transcribe", fake)
    want = JST.pseudo_label_entries(None, entries, tmp_path, "greedy",
                                    min_score, keep_frac)
    got = ST.pseudo_label_entries(None, entries, tmp_path, "greedy",
                                  min_score, keep_frac)
    assert got == want
    assert seen[0] == seen[1]
    assert got[1]["decoded_nonempty"] == 4


def test_selftrain_cli_with_union(tmp_path, capsys):
    """A teacher directory (params.npz + cmvn.npz) pseudo-labels a
    manifest of three files greedily; --keep-frac 0.5 --union writes the
    labeled manifest, then the kept entries, in the training schema."""
    cfg = TR.finalize_config(load_config(CONFIG, RUN), 0)
    vocab = build_datasets(cfg).vocab
    cfg = TR.finalize_config(cfg, vocab.size)
    files = synthetic.write_wavs(tmp_path, cfg, vocab, 3)
    teacher = tmp_path / "teacher"
    teacher.mkdir()
    synthetic.write_model_dir(teacher, cfg, files, seed=0)
    manifest = tmp_path / "unlabeled.jsonl"
    manifest.write_text("".join(json.dumps(
        {"uid": f"u{i}", "audio": f.name, "n_samples": 1000}) + "\n"
        for i, f in enumerate(files)))
    labeled = tmp_path / "labeled.jsonl"
    labeled.write_text(json.dumps({"uid": "l0", "audio": "x.wav",
                                   "n_samples": 5, "text": "a"}) + "\n")
    out = tmp_path / "out" / "pseudo.jsonl"
    assert ST.main(["--config", CONFIG, "--load-dir", str(teacher),
                    "--manifest", str(manifest), "--out", str(out),
                    "--beam", "1", "--keep-frac", "0.5", "--union",
                    str(labeled), "--device", "cpu", *RUN]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["total"] == 3 and stats["union"] is True
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines[0]["uid"] == "l0"
    kept = lines[1:]
    assert len(kept) == stats["kept"] == (
        max(1, round(0.5 * stats["after_min_score"]))
        if stats["after_min_score"] else 0)
    for e in kept:
        assert set(e) == {"uid", "audio", "n_samples", "text",
                          "pseudo_score"}
        assert e["text"] and e["audio"] == str(tmp_path / e["audio"]
                                               .split("/")[-1])
    assert [e["uid"] for e in kept] == sorted(e["uid"] for e in kept)


@pytest.mark.parametrize("alias, flag", [("training", "--train"),
                                         ("decode", "--test")])
def test_python_m_aliases(monkeypatch, alias, flag):
    calls = []
    monkeypatch.setattr("semi_supervised_asr_tpu_torch.main.main",
                        lambda argv: calls.append(argv) or 0)
    monkeypatch.setattr(sys, "argv", ["x", "--config", CONFIG])
    with pytest.raises(SystemExit) as e:
        runpy.run_module(f"semi_supervised_asr_tpu_torch.{alias}",
                         run_name="__main__")
    assert e.value.code == 0
    assert calls == [[flag, "--config", CONFIG]]
