"""PyTorch port parity: the CTC family and the LAS joint-CTC head.

The same numpy inputs and weights (``weights.init_numpy`` carried into the
JAX tree by name) go through the JAX package and the port:

* the CTC NLL (``ctc_per_utt_nll``, optax's ``ctc_loss`` in the reference)
  and its gradient with respect to the encoder and the head, on rows with
  repeated labels, an all-PAD row and a row whose frames cannot hold its
  labels (optax's large finite loss): 1e-5 relative on the NLL, 1e-5 on
  every gradient entry;
* best-path greedy (equal tokens, log-probs to 1e-5), the prefix beam
  (equal tokens, scores to 1e-5, best and n-best), and the LAS beam with
  the joint CTC head, n-best rescoring and one-pass (equal tokens, scores
  to 1e-4, the reference's tolerance for CTC scores,
  tests/test_ctc.py:48, 203);
* the supervised step of the CTC family and of LAS with
  ``objective.lambda_ctc`` against JAX's (``check_supervised_step`` of
  tests/test_torch_train.py: loss to 1e-5, gradients to rtol 2e-4 /
  atol 2e-5, the Adam update to 1e-6);
* ``main --train`` then ``--test`` of a tiny ``configs/ls100_ctc.yaml``
  (prefix beam and ``--beam 0``) and of timit with the joint head
  (``--beam 0``, ``decode.ctc_weight``, ``decode.ctc_one_pass``).
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.config import DecodeConfig, ModelConfig
from semi_supervised_asr_tpu.decode import beam as JB
from semi_supervised_asr_tpu.decode import ctc as JC
from semi_supervised_asr_tpu.decode import ctc_beam as JCB
from semi_supervised_asr_tpu.models import seq2seq as JM
from semi_supervised_asr_tpu.objectives import losses as JL
from semi_supervised_asr_tpu_torch import main as M
from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD
from semi_supervised_asr_tpu_torch.decode.beam import beam_decode_from_enc
from semi_supervised_asr_tpu_torch.decode.ctc import ctc_greedy_from_enc
from semi_supervised_asr_tpu_torch.decode.ctc_beam import ctc_beam_from_enc
from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq
from semi_supervised_asr_tpu_torch.objectives import losses as LO
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    check_supervised_step, make_step_setup, one_thread, run_jax, t,
)

E, V = 12, 9
TOL = dict(rtol=1e-5, atol=1e-5)


def head(seed: int = 0, scale: float = 1.0):
    """A CTC head {w [E, V], b [V]} as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((E, V)) * scale).astype(np.float32),
            "b": (rng.standard_normal(V) * 0.1).astype(np.float32)}


def port_head(p, grad: bool = False):
    return SimpleNamespace(**{k: torch.tensor(v, requires_grad=grad)
                              for k, v in p.items()})


def jhead(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def enc_batch(b: int, tt: int, lens, seed: int = 1):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, tt, E)).astype(np.float32)
    mask = np.arange(tt)[None, :] < np.asarray(lens)[:, None]
    return enc * mask[..., None], mask


def test_ctc_nll_and_gradient_match_optax():
    """Rows: distinct labels, repeated labels (a blank must separate
    them), all PAD, and 4 repeated labels in 5 frames (needs 7: optax's
    log_epsilon gives a loss near 1e5, finite)."""
    p = head()
    enc, mask = enc_batch(4, 10, [10, 9, 6, 5])
    tokens = np.array([[3, 4, 5, EOS, PAD, PAD],
                       [6, 6, 7, 7, EOS, PAD],
                       [PAD] * 6,
                       [8, 8, 8, 8, EOS, PAD]], np.int32)

    def jloss(params, e):
        nll, n = JL.ctc_per_utt_nll(params, e, jnp.asarray(mask),
                                    jnp.asarray(tokens))
        return nll.sum(), (nll, n)

    (_, (ref, ref_n)), (ref_gp, ref_ge) = run_jax(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True), jhead(p), jnp.asarray(enc))
    ctc = port_head(p, grad=True)
    e = torch.tensor(enc, requires_grad=True)
    nll, n = LO.ctc_per_utt_nll(ctc, e, t(mask), t(tokens))
    nll.sum().backward()
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    assert np.asarray(ref)[3] > 1e4 and np.isfinite(np.asarray(ref)[3])
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(ref),
                               rtol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ref_ge), **TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(getattr(ctc, k).grad.numpy(),
                                   np.asarray(ref_gp[k]), rtol=1e-5,
                                   atol=1e-4, err_msg=k)
    # the joint CTC-attention term: all-PAD rows weighed out, per label
    got = LO.ctc_loss(port_head(p), t(enc), t(mask), t(tokens))
    want = run_jax(lambda h, e, m, y: JL.ctc_loss(h, e, m, y), jhead(p),
                   jnp.asarray(enc), jnp.asarray(mask), jnp.asarray(tokens))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_ctc_greedy_matches_jax():
    p = head(2, scale=2.0)
    enc, mask = enc_batch(5, 14, [14, 11, 3, 14, 1], seed=3)
    ref = run_jax(JC.ctc_greedy_from_enc, jhead(p), jnp.asarray(enc),
                  jnp.asarray(mask))
    got = ctc_greedy_from_enc(port_head(p), t(enc), t(mask))
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **TOL)
    assert (got[0].numpy() == EOS).any()


@pytest.mark.parametrize("nbest", [False, True])
def test_ctc_prefix_beam_matches_jax(nbest):
    p = head(4, scale=1.5)
    enc, mask = enc_batch(4, 12, [12, 9, 5, 12], seed=5)
    ref = run_jax(lambda h, e, m: JCB.ctc_beam_from_enc(
        h, e, m, 8, beam_size=4, return_nbest=nbest), jhead(p),
        jnp.asarray(enc), jnp.asarray(mask))
    with torch.inference_mode():
        got = ctc_beam_from_enc(port_head(p), t(enc), t(mask), 8, 4,
                                return_nbest=nbest)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **TOL)
    # PAD-padded, no EOS terminator
    assert (got[0].numpy() != PAD).any()


# the LAS model with the joint CTC head, at the width of
# tests/test_torch_speller.py's decoders (encoder outputs drawn directly)
JOINT = ModelConfig(
    n_mels=80, vocab_size=30, enc_hidden=8, enc_base_layers=1, enc_layers=1,
    dec_hidden=24, attn_dim=16, attn_conv_channels=4, attn_conv_width=5,
    embed_dim=16, compute_dtype="float32", ctc_head=True)


@pytest.mark.parametrize("one_pass", [False, True],
                         ids=["rescoring", "one_pass"])
def test_joint_ctc_beam_matches_jax(one_pass):
    tree = weights.unflatten_tree(weights.init_numpy(JOINT, 6))
    model = Seq2Seq(JOINT)
    weights.load_tree(model, tree)
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(7)
    b, tt = 3, 11
    enc = rng.standard_normal((b, tt, JOINT.enc_out_dim)).astype(np.float32)
    mask = np.arange(tt)[None, :] < np.asarray([11, 8, 4])[:, None]
    enc *= mask[..., None]
    keys = run_jax(lambda sp, e: JM.S.precompute_decode_cache(sp, JOINT, e),
                   params["speller"], jnp.asarray(enc))
    dcfg = DecodeConfig(beam_size=3, ctc_weight=0.3, ctc_one_pass=one_pass)
    ref = run_jax(lambda p, e, m, k: JB.beam_decode_from_enc(
        p["speller"], JOINT, dcfg, e, m, k, 7, ctc_params=p["ctc"],
        return_nbest=True), params, jnp.asarray(enc), jnp.asarray(mask),
        keys)
    with torch.inference_mode():
        got = beam_decode_from_enc(model.speller, dcfg, t(enc), t(mask),
                                   t(keys), 7, return_nbest=True,
                                   ctc=model.ctc)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-4, atol=1e-4)


# configs/timit.yaml and configs/ls100_ctc.yaml cut to a small width
CTC_STEP = {
    "las_lambda_ctc": ("configs/timit.yaml", [
        "model.enc_hidden=16", "model.enc_layers=1", "model.dec_hidden=16",
        "model.attn_dim=8", "model.attn_conv_channels=2",
        "model.attn_conv_width=4", "model.embed_dim=8",
        "model.enc_base_layers=0", "objective.lambda_ctc=0.3"]),
    "ctc_family": ("configs/ls100_ctc.yaml", [
        "model.enc_hidden=16", "model.enc_layers=1", "model.enc_base_layers=0",
        "train.remat_encoder=false"]),
}
STEP_COMMON = ["model.compute_dtype=float32", "train.batch_size=4",
               "train.warmup_steps=0", "data.dataset=synthetic",
               "data.num_synthetic_utts=8", "data.frame_buckets=[128]",
               "data.token_buckets=[12]"]


@pytest.mark.parametrize("name", sorted(CTC_STEP))
def test_supervised_step_matches_jax(name):
    config, over = CTC_STEP[name]
    setup = make_step_setup(config, over + STEP_COMMON)
    keys = (("loss", "grad_norm") if name == "ctc_family"
            else ("loss", "ce", "acc", "grad_norm"))
    got = check_supervised_step(*setup, keys=keys)
    assert ("ctc" in got) == (name == "las_lambda_ctc")
    assert ("nll_per_label" in got) == (name == "ctc_family")


TINY = ["model.enc_hidden=16", "model.enc_layers=1", "train.batch_size=4",
        "data.dataset=synthetic", "data.num_synthetic_utts=8",
        "data.frame_buckets=[128]", "data.token_buckets=[12]",
        "decode.max_decode_len=8", "model.compute_dtype=float32"]
CLI = {
    "ls100_ctc": ("configs/ls100_ctc.yaml", [], [
        ([], "beam"), (["--beam", "0"], "ctc"), (["--beam", "1"], "greedy")]),
    "timit_joint_ctc": ("configs/timit.yaml", [
        "model.dec_hidden=16", "model.attn_dim=8",
        "model.attn_conv_channels=2", "model.attn_conv_width=4",
        "model.embed_dim=8", "objective.lambda_ctc=0.3"], [
        (["--beam", "0"], "ctc"),
        (["--beam", "3", "decode.ctc_weight=0.3"], "beam"),
        (["--beam", "3", "decode.ctc_weight=0.3",
          "decode.ctc_one_pass=true"], "beam")]),
}


@pytest.mark.parametrize("name", sorted(CLI))
def test_main_trains_and_tests(name, tmp_path, capsys):
    config, over, tests = CLI[name]
    base = ["--config", config, "--device", "cpu"]
    assert M.main([*base, "--train", "--workdir", str(tmp_path), *TINY,
                   *over, "train.total_steps=1", "train.eval_every=0",
                   "train.log_every=1"]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(final["final_dev"]["dev_error"])
    for argv, mode in tests:
        flags = [a for a in argv if a.startswith("--") or a.isdigit()]
        assert M.main([*base, "--test", "--load-dir", str(tmp_path), *flags,
                       *TINY, *over, *(a for a in argv if a not in flags)]
                      ) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["mode"] == mode and out["n_utts"] > 0
        # the length cap is tracked for EOS-terminated LAS decodes only
        assert ("cap_hit_rate" in out) == (name != "ls100_ctc"
                                           and mode != "ctc")
