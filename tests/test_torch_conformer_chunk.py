"""PyTorch port parity: the chunk-causal conformer (``model.enc_attn_chunk``).

The same seeded numpy weights (``weights.init_numpy``, carried into the JAX
tree by name) and inputs go through the JAX package and the port, at a tiny
width: 2 blocks of d_model 16 (2 heads), conv width 5, a 1-block causal
stem of 4 channels, chunks of 4 encoder frames with 1 left chunk, float32.

* the chunk mask equals JAX's ``_chunk_mask`` (left 0, 1 and unlimited);
* the chunked forward (causal stem, chunk mask, causal depthwise conv)
  equals ``conformer_listener_apply`` to 1e-5 of the output's largest
  entry, and its gradients (every listener leaf and the features) equal
  ``jax.grad``'s to 1e-5 of each leaf's largest entry; a change in a later
  chunk leaves the earlier frames bitwise unchanged;
* the streamed encoder (``conformer_listener_apply_stream``, with cache
  rolling past the left window and a padded final chunk) equals the
  offline one to the reference's ulp-scale bound (1e-5 of its largest
  entry), and equals JAX's streamed encoder to 1e-5;
* the causal stem alone, streamed with its 2-frame carries, equals the
  offline causal stem bitwise and JAX's causal stem to 1e-6;
* the ``configs/ls100_conformer_streaming.yaml`` step (cut small, remat
  off as shipped) against JAX's ``supervised_step_fn``, and the recipe's
  ``main --train`` / ``--test`` (beam 4 on the chunked encoder);
* the refusals: the chunk mask on the flash route, at construction.
"""

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
from semi_supervised_asr_tpu.models import conformer_listener as JCL
from semi_supervised_asr_tpu.models import listener as JL
from semi_supervised_asr_tpu.training import schedules as JSCH
from semi_supervised_asr_tpu.training import train_step as JT
from semi_supervised_asr_tpu_torch import main as M
from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models import conformer_listener as CL
from semi_supervised_asr_tpu_torch.models import listener as L
from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq
from semi_supervised_asr_tpu_torch.training import train_step as TS
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    make_step_setup, one_thread, port_model, run_jax, stash, t,
    train_records,
)

KW = dict(n_mels=16, vocab_size=10, encoder_arch="conformer", enc_hidden=8,
          enc_heads=2, enc_ff_dim=32, enc_blocks=2, conformer_conv_width=5,
          conv_subsample=1, conv_channels=4, enc_attn_chunk=4,
          enc_attn_left_chunks=1, compute_dtype="float32")
CHUNK_FEATS = KW["enc_attn_chunk"] * 2          # feature frames a chunk


def configs(**over):
    kw = dict(KW, **over)
    return ModelConfig(**kw), JModelConfig(**kw)


@pytest.fixture(scope="module")
def pair():
    """The port's listener and the same weights as a JAX tree."""
    cfg, jcfg = configs()
    flat = {k[len("listener."):]: v
            for k, v in weights.init_numpy(cfg, 0).items()
            if k.startswith("listener.")}
    lis = CL.ConformerListener(cfg)
    weights.load_flat(lis, flat)
    return cfg, jcfg, lis, jax.tree.map(jnp.asarray,
                                        weights.unflatten_tree(flat))


def feats(t: int, n_valid: int, seed: int, b: int = 1):
    rng = np.random.default_rng(seed)
    x = np.zeros((b, t, KW["n_mels"]), np.float32)
    x[:, :n_valid] = rng.standard_normal((b, n_valid, KW["n_mels"]))
    return x


@pytest.mark.parametrize("t, chunk, left", [(6, 2, 1), (13, 4, 0),
                                            (16, 4, -1)])
def test_chunk_mask_matches_jax(t, chunk, left):
    np.testing.assert_array_equal(CL._chunk_mask(t, chunk, left),
                                  JCL._chunk_mask(t, chunk, left))


def test_chunked_forward_and_grads_match_jax(pair):
    cfg, jcfg, lis, tree = pair
    x = feats(40, 40, 0, b=3)
    x[1, 30:] = 0.0
    x[2, 17:] = 0.0
    lens = np.array([40, 30, 17], np.int32)
    cot = np.random.default_rng(1).standard_normal(
        (3, 20, cfg.enc_out_dim)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    leaves = dict(lis.named_parameters())
    enc, enc_lens = lis(xt, torch.from_numpy(lens))
    grads = torch.autograd.grad((enc * torch.from_numpy(cot)).sum(),
                                [xt, *leaves.values()])

    def loss(p, f):
        e, _ = JCL.conformer_listener_apply(p, f, jnp.asarray(lens), jcfg)
        return jnp.sum(e * cot), e

    (_, want), (gp, gx) = run_jax(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True), tree,
        jnp.asarray(x))
    np.testing.assert_array_equal(enc_lens.numpy(), [20, 15, 9])
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(enc.detach().numpy() - np.asarray(want)).max() \
        <= 1e-5 * scale
    want_g = {"feats": np.asarray(gx),
              **weights.flatten_tree(jax.tree.map(np.asarray, gp))}
    for name, g in zip(["feats", *leaves], grads):
        w = want_g[name]
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1e-30), (name, err)

    # a change in a later chunk leaves earlier frames' bits alone
    x2 = x.copy()
    x2[0, 24:32] += 1.0                   # encoder chunk 3 (frames 12-15)
    with torch.no_grad():
        e1 = lis(torch.from_numpy(x), torch.from_numpy(lens))[0]
        e2 = lis(torch.from_numpy(x2), torch.from_numpy(lens))[0]
    assert torch.equal(e1[0, :12], e2[0, :12])
    assert not torch.allclose(e1[0, 12:16], e2[0, 12:16])


def stream_port(lis, cfg, x, n_valid):
    """Feed [1, T, F] features chunk by chunk -> the streamed frames."""
    rope = CL.conformer_rope_table(cfg, 64, "cpu")
    st = CL.conformer_stream_init(cfg, 1, "cpu")
    outs, full = [], n_valid // CHUNK_FEATS
    for i in range(full):
        o, st = CL.conformer_listener_apply_stream(
            lis, torch.from_numpy(x[:, i * CHUNK_FEATS:(i + 1) * CHUNK_FEATS]),
            st, rope)
        outs.append(o)
    rem = n_valid - full * CHUNK_FEATS
    if rem:
        pad = np.zeros((1, CHUNK_FEATS, x.shape[2]), np.float32)
        pad[:, :rem] = x[:, full * CHUNK_FEATS: n_valid]
        o, st = CL.conformer_listener_apply_stream(
            lis, torch.from_numpy(pad), st, rope, torch.tensor([rem]))
        outs.append(o[:, : (rem + 1) // 2])
    return torch.cat(outs, dim=1).numpy()


def stream_jax(tree, jcfg, x, n_valid):
    rope = JCL.conformer_rope_table(jcfg, 64)
    st = JCL.conformer_stream_init(jcfg, 1)
    step = jax.jit(lambda p, f, s, fl: JCL.conformer_listener_apply_stream(
        p, f, jcfg, s, rope, frame_lens=fl))
    outs, full = [], n_valid // CHUNK_FEATS
    for i in range(full):
        o, st = step(tree, x[:, i * CHUNK_FEATS:(i + 1) * CHUNK_FEATS], st,
                     jnp.array([CHUNK_FEATS]))
        outs.append(np.asarray(o))
    rem = n_valid - full * CHUNK_FEATS
    pad = np.zeros((1, CHUNK_FEATS, x.shape[2]), np.float32)
    pad[:, :rem] = x[:, full * CHUNK_FEATS: n_valid]
    o, st = step(tree, pad, st, jnp.array([rem]))
    outs.append(np.asarray(o)[:, : (rem + 1) // 2])
    return np.concatenate(outs, axis=1)


def test_stream_matches_offline_and_jax(pair):
    """6 chunks (the cache rolls past its 1-chunk window), a padded final
    partial chunk, offline pad frames past the valid ones."""
    cfg, jcfg, lis, tree = pair
    n_valid = 45
    x = feats(48, n_valid, 2)
    with torch.no_grad():
        off, lens = lis(torch.from_numpy(x), torch.tensor([n_valid]))
    n = int(lens[0])
    got = stream_port(lis, cfg, x, n_valid)
    assert got.shape[1] == n == 23
    off = off.numpy()[:, :n]
    assert np.abs(got - off).max() <= 1e-5 * max(np.abs(off).max(), 1.0)
    want = stream_jax(tree, jcfg, x, n_valid)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_causal_stem_streams_bitwise_and_matches_jax(pair):
    cfg, jcfg, lis, tree = pair
    for t, n_valid in ((24, 24), (24, 21)):
        x = feats(t, n_valid, t + n_valid)
        lens = torch.tensor([n_valid])
        with torch.no_grad():
            off, off_lens = L.conv_stem_apply(lis.conv, torch.from_numpy(x),
                                              lens, torch.float32, True)
            carry = L.conv_stem_stream_init(cfg, 1, "cpu")
            outs = []
            for i in range(0, t, CHUNK_FEATS):
                last = i + CHUNK_FEATS >= t
                o, carry, _ = L.conv_stem_stream(
                    lis.conv, torch.from_numpy(x[:, i:i + CHUNK_FEATS]),
                    torch.float32, carry,
                    torch.tensor([n_valid - i]) if last else None)
                outs.append(o)
        assert torch.equal(torch.cat(outs, dim=1), off)
        want, want_lens = run_jax(
            lambda p, f: JL.conv_stem_apply(p, f, jnp.asarray([n_valid]),
                                            jcfg, causal=True),
            tree["conv"], jnp.asarray(x))
        np.testing.assert_array_equal(off_lens.numpy(), want_lens)
        np.testing.assert_allclose(off.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_flash_route_refuses_the_chunk_mask():
    """The reference refuses the chunk mask with ``attn_backend: flash``
    (K5's key mask cannot express a sliding window); the port refuses it
    with the reference's message when the model is built."""
    cfg, jcfg = configs(attn_backend="flash")
    with pytest.raises(ValueError, match="attn_backend=xla") as port:
        Seq2Seq(cfg)
    shapes = jax.eval_shape(
        lambda: JCL.init_conformer_listener(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(AssertionError) as ref:     # raised while tracing
        jax.eval_shape(lambda p: JCL.conformer_listener_apply(
            p, jnp.zeros((1, 8, 16)), jnp.array([8]), jcfg), shapes)
    assert str(port.value) == str(ref.value)


# configs/ls100_conformer_streaming.yaml cut small: 2 blocks of d_model 16,
# a stem of 4 channels, chunks of 4 encoder frames (the recipe's left 2)
RECIPE = "configs/ls100_conformer_streaming.yaml"
TINY = ["model.enc_hidden=8", "model.enc_heads=2", "model.enc_ff_dim=16",
        "model.enc_blocks=2", "model.conv_channels=4",
        "model.conformer_conv_width=5", "model.enc_attn_chunk=4",
        "model.pred_hidden=16", "model.joint_dim=16", "model.embed_dim=8",
        "train.batch_size=4", "data.dataset=synthetic",
        "data.num_synthetic_utts=8", "data.frame_buckets=[128]",
        "data.token_buckets=[12]", "decode.max_decode_len=6",
        "decode.max_symbols=2"]


def test_recipe_step_matches_jax():
    """The recipe's supervised step (causal stem, chunk mask and causal
    conv inside it; remat off as shipped) against JAX's
    ``supervised_step_fn``: loss and gradient norm to 1e-5 relative, each
    gradient leaf to 1e-5 of the model's largest gradient entry.  A leaf
    sums up to B x T' products in another float32 order than JAX's, so its
    difference scales with those products, not with its own sum: where the
    sum cancels, a bound relative to the leaf's own largest entry (or
    ``check_supervised_step``'s elementwise one) measures the cancellation
    (the stem's second filter: 2.7e-5 on an entry of 9e-3; block 0's wq:
    3e-5 of its own largest entry, 7e-7 of the model's)."""
    pcfg, jcfg, batch, cmvn, flat = make_step_setup(
        RECIPE, TINY + ["model.compute_dtype=float32"])
    assert not pcfg.train.remat_encoder
    assert (pcfg.model.enc_attn_chunk, pcfg.model.enc_attn_left_chunks,
            pcfg.model.conv_subsample) == (4, 2, 2)
    tree = jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))
    opt = optax.chain(stash(), JSCH.make_optimizer(jcfg.train))
    state = JT.TrainState(params=tree, opt_state=run_jax(opt.init, tree),
                          ema_params=tree, step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(0))
    new_state, ref = run_jax(
        functools.partial(JT.supervised_step_fn, jcfg, opt), state,
        *(jnp.asarray(a) for a in (batch.audio, batch.audio_lens,
                                   batch.tokens, batch.real)),
        (jnp.asarray(cmvn[0]), jnp.asarray(cmvn[1])))
    ref_grads = weights.flatten_tree(
        jax.tree.map(np.asarray, new_state.opt_state[0]))
    model = port_model(pcfg, flat)
    loss, metrics, grads = TS.loss_and_grads(
        pcfg, TS.init_train_state(pcfg, model, seed=0), t(batch.audio),
        t(batch.audio_lens), t(batch.tokens), t(batch.real),
        (t(cmvn[0]), t(cmvn[1])))
    np.testing.assert_allclose(loss.item(), float(ref["loss"]), rtol=1e-5)
    gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads))
    np.testing.assert_allclose(gnorm.item(), float(ref["grad_norm"]),
                               rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref_grads)
    top = max(np.abs(w).max() for w in ref_grads.values())
    for n, g in zip(names, grads):
        err = np.abs(g.numpy() - ref_grads[n]).max()
        assert err <= 1e-5 * top, (n, err, top)


def test_recipe_trains_and_tests(tmp_path, capsys):
    """``main --train`` (2 steps, the validation's beam 4 on the chunked
    encoder) and ``--test`` by the beam and by greedy."""
    d = tmp_path / "run"
    assert M.main(["--config", RECIPE, "--train", "--workdir", str(d),
                   "--device", "cpu", *TINY, "train.total_steps=2",
                   "train.eval_every=2", "train.log_every=1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert math.isfinite(out["final_dev"]["dev_error"])
    assert [r["step"] for r in train_records(d)] == [1, 2]
    for beam in ("4", "1"):
        assert M.main(["--config", RECIPE, "--test", "--load-dir", str(d),
                       "--device", "cpu", "--beam", beam, *TINY]) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert math.isfinite(res["cer"])
