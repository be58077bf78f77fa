"""PyTorch port parity: the transformer and conformer listeners, the conv
stem, and the BLSTM listener behind a conv stem.

Small configs (2 blocks, d_model 32, 2 heads of 16, a 2-block stem with 4
channels over 20 mels) with weights from ``weights.init_numpy``, copied into
the JAX tree by name.  The port's ``Seq2Seq.encode`` is held against JAX's
``seq2seq.encode`` with ``attn_backend`` flash and xla in float32 (1e-5;
JAX's flash route on the CPU is its plain ``mhsa_reference``, the port's
for CPU tensors too), the encoder's gradients against ``jax.grad`` (rtol
2e-4 / atol 2e-5, the training slice's tolerances), the conv stem alone
at odd and even T against ``conv_stem_apply``, forward and gradients (with
no convolution called: its backward has no atomics on the card); and the
port's listeners keep the pad contract: valid frames unchanged by a longer
bucket, exact zeros on pad frames (after tests/test_flash_mhsa.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.config import ModelConfig as JModelConfig
from semi_supervised_asr_tpu.models import listener as JL
from semi_supervised_asr_tpu.models import seq2seq as JM
from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models import listener as L
from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    one_thread, run_jax,
)

KW = dict(n_mels=20, vocab_size=16, enc_hidden=16, enc_heads=2,
          enc_ff_dim=32, enc_blocks=2, conv_subsample=2, conv_channels=4,
          conformer_conv_width=5, attn_dim=16, attn_conv_channels=2,
          attn_conv_width=5, dec_hidden=16, dec_layers=1, embed_dim=16,
          compute_dtype="float32")
LENS = (24, 17, 12, 0)
TOL_GRAD = dict(rtol=2e-4, atol=2e-5)
# the JAX gradient runs once per case, so its XLA compile dominates: the
# cheap backend settings (as in test_torch_train.py) cut it
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def configs(**kw):
    return ModelConfig(**{**KW, **kw}), JModelConfig(**{**KW, **kw})


def feats(t=24, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(LENS), t, KW["n_mels"])).astype(np.float32)
    x[np.arange(t)[None, :] >= np.asarray(LENS)[:, None]] = 0.0
    return x, np.asarray(LENS, np.int32)


def model_pair(cfg, seed=0):
    flat = weights.init_numpy(cfg, seed)
    model = Seq2Seq(cfg)
    weights.load_flat(model, flat)
    return model, jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))


@pytest.fixture(scope="module", params=["transformer", "conformer"])
def arch(request):
    return request.param


@pytest.mark.parametrize("attn", ["flash", "xla"])
def test_encode_matches_jax(arch, attn):
    cfg, jcfg = configs(encoder_arch=arch, attn_backend=attn)
    model, tree = model_pair(cfg)
    shapes = weights.flatten_tree(jax.tree.map(
        lambda s: np.empty(s.shape, bool),
        jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), jcfg))))
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(s.shape) for n, s in shapes.items()}
    x, lens = feats()
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x), torch.from_numpy(lens))
    want = run_jax(lambda p, f, n: JM.encode(p, f, n, jcfg), tree,
                   jnp.asarray(x), jnp.asarray(lens))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for a, w in zip((got[0], got[2]), (want[0], want[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_encoder_grads_match_jax(arch):
    """d(sum(enc * cot)) for every listener leaf and the features, through
    the flash route (the autograd of the plain MHSA on the CPU)."""
    check_encoder_grads(*configs(encoder_arch=arch, attn_backend="flash"))


@pytest.mark.parametrize("encoder", ["blstm", "transformer", "conformer"])
def test_encoder_dropout_grads_match_jax(encoder):
    """The same in training with ``model.enc_dropout`` 0.3: the port's
    listener takes the keep masks JAX's ``encode(..., train=True,
    dropout_rng)`` draws at each site (every BiLSTM layer; a transformer
    block's attention and FFN outputs; a conformer block's ff1, attention,
    conv module and ff2)."""
    kw = dict(encoder_arch=encoder, attn_backend="flash", enc_dropout=0.3)
    if encoder == "blstm":
        kw.update(enc_base_layers=1, enc_layers=1)
    check_encoder_grads(*configs(**kw), dropout_rng=jax.random.PRNGKey(8))


def check_encoder_grads(cfg, jcfg, dropout_rng=None):
    model, tree = model_pair(cfg, seed=1)
    x, lens = feats(seed=4)
    shapes = model.listener.dropout_shapes(*x.shape[:2])
    masks = None
    if dropout_rng is not None:
        keep = 1.0 - cfg.enc_dropout
        masks = [torch.from_numpy(np.array(m)) for m in run_jax(
            lambda k: [jax.random.bernoulli(jax.random.fold_in(k, i), keep,
                                            shape)
                       for i, shape in enumerate(shapes)], dropout_rng)]
        assert len(masks) == {"blstm": 2, "transformer": 4,
                              "conformer": 8}[cfg.encoder_arch]
    t_out = shapes[-1][1]
    cot = np.random.default_rng(5).standard_normal(
        (len(LENS), t_out, cfg.enc_out_dim)).astype(np.float32)

    def jloss(lp, xx):
        enc, _, _ = JM.encode({**tree, "listener": lp}, xx, jnp.asarray(lens),
                              jcfg, train=dropout_rng is not None,
                              dropout_rng=dropout_rng)
        return jnp.sum(enc * cot)

    args = (tree["listener"], jnp.asarray(x))
    jg, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1))).lower(*args).compile(
        compiler_options=FAST_XLA)(*args)
    want = weights.flatten_tree(jax.tree.map(np.asarray, jg))
    xt = torch.from_numpy(x).requires_grad_(True)
    enc, _ = model.listener(xt, torch.from_numpy(lens), None, masks)
    names, leaves = zip(*model.listener.named_parameters())
    grads = torch.autograd.grad((enc * torch.from_numpy(cot)).sum(),
                                [*leaves, xt])
    assert sorted(names) == sorted(want)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n], **TOL_GRAD, err_msg=n)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jdx), **TOL_GRAD)


def test_pad_invariance_and_exact_pad_zeros(arch):
    cfg, _ = configs(encoder_arch=arch, attn_backend="flash")
    model, _ = model_pair(cfg, seed=2)
    x, lens = feats()
    with torch.no_grad():
        e1, m1, _ = model.encode(torch.from_numpy(x), torch.from_numpy(lens))
        xp = np.pad(x, [(0, 0), (0, 8), (0, 0)])
        e2, m2, _ = model.encode(torch.from_numpy(xp), torch.from_numpy(lens))
    t1 = e1.shape[1]
    assert torch.equal(m1, m2[:, :t1])
    np.testing.assert_allclose((e1 * m1[:, :, None]).numpy(),
                               (e2[:, :t1] * m2[:, :t1, None]).numpy(),
                               atol=1e-6)
    assert (e2[~m2] == 0).all()


@pytest.mark.parametrize("t", [23, 24])
def test_conv_stem_matches_jax(t):
    """Odd T pads the time axis (1, 1), even T (0, 1); 20 -> 10 -> 5 mels
    takes the freq axis through both cases too."""
    cfg, jcfg = configs(encoder_arch="conformer")
    model, tree = model_pair(cfg, seed=3)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((3, t, cfg.n_mels)).astype(np.float32)
    lens = np.asarray([t, t - 6, 1], np.int32)
    x[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    with torch.no_grad():
        got, got_lens = L.conv_stem_apply(model.listener.conv,
                                          torch.from_numpy(x),
                                          torch.from_numpy(lens),
                                          torch.float32)
    want, want_lens = run_jax(
        lambda p, f, n: JL.conv_stem_apply(p, f, n, jcfg),
        tree["listener"]["conv"], jnp.asarray(x), jnp.asarray(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape == (3, (t + 3) // 4, L.conv_stem_dims(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("t", [23, 24])
def test_conv_stem_gradients_match_jax(t, monkeypatch):
    """The stem's gradients (input, every filter and bias) against
    ``jax.grad`` of JAX's stem, with no convolution anywhere in the port's
    forward or backward: the windows-times-filter form, whose backward
    has no atomics on the card."""
    cfg, jcfg = configs(encoder_arch="conformer")
    model, tree = model_pair(cfg, seed=5)
    rng = np.random.default_rng(t + 1)
    x = rng.standard_normal((3, t, cfg.n_mels)).astype(np.float32)
    lens = np.asarray([t, t - 6, 1], np.int32)
    x[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    dy = rng.standard_normal(
        (3, (t + 3) // 4, L.conv_stem_dims(cfg))).astype(np.float32)

    def refuse(*a, **k):
        raise AssertionError("the conv stem ran a convolution")

    for name in ("conv2d", "conv_transpose2d"):
        monkeypatch.setattr(L.Fn, name, refuse)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = L.conv_stem_apply(model.listener.conv, xt,
                               torch.from_numpy(lens), torch.float32)
    leaves = [xt] + [p for blk in model.listener.conv for p in (blk.w, blk.b)]
    got = torch.autograd.grad((out * torch.from_numpy(dy)).sum(), leaves)

    def loss(params, xx):
        y, _ = JL.conv_stem_apply(params, xx, jnp.asarray(lens), jcfg)
        return jnp.sum(y * dy)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1))).lower(
        tree["listener"]["conv"], jnp.asarray(x)).compile(
        compiler_options=FAST_XLA)(tree["listener"]["conv"], jnp.asarray(x))
    want = [gx] + [g for blk in gp for g in (blk["w"], blk["b"])]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_GRAD)


def test_blstm_listener_with_conv_stem_matches_jax():
    cfg, jcfg = configs(encoder_arch="blstm", conv_subsample=1, enc_layers=1)
    jcfg = dataclasses.replace(jcfg, lstm_backend="xla")
    model, tree = model_pair(cfg, seed=4)
    x, lens = feats()
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x), torch.from_numpy(lens))
    want = run_jax(lambda p, f, n: JM.encode(p, f, n, jcfg), tree,
                   jnp.asarray(x), jnp.asarray(lens))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw, error, message", [
    (dict(encoder_arch="conformer", enc_attn_chunk=4, attn_backend="flash"),
     ValueError, "attn_backend=xla"),
    (dict(encoder_arch="transformer", enc_attn_chunk=4), ValueError,
     "conformer-only"),
    (dict(encoder_arch="conformer", attn_backend="pallas"), ValueError,
     "attn_backend"),
    (dict(encoder_arch="lstm"), ValueError, "encoder_arch"),
])
def test_unported_listener_options_are_refused(kw, error, message):
    with pytest.raises(error, match=message):
        Seq2Seq(configs(**kw)[0])
