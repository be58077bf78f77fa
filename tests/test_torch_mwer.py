"""PyTorch port parity: MWER sequence training on the three families.

The same numpy inputs and weights (``weights.init_numpy`` carried into the
JAX tree by name) go through the JAX package and the port, in float32 at
tiny widths:

* ``batched_edit_distance`` on ragged, empty and equal sequences with
  broadcast [B, K] batch dims: exactly JAX's, and the port's host scorer's
  (``utils/native_ops.py::batch_edit_distance_py``);
* ``expected_risk``: the loss, the mean risk and the gradient with respect
  to the sequence log-probs (1e-6);
* each family's ``mwer_loss_from_enc`` (LAS: the attention beam and the
  teacher-forced rescoring; CTC: the prefix beam, the CTC marginals, an
  empty and a dead hypothesis; the transducer: its beam, the predictor over
  B*K rows and the lattice NLL, with the full joint grid and in frame
  chunks, both against JAX's full grid) with a given n-best fed to both
  (JAX's beam's, one hypothesis replaced by the reference, so that no
  search stands between the two rescorings) and end to end (the port's own
  beam, whose n-best must equal JAX's, against JAX's term on that
  n-best): loss and mean risk to 1e-5 relative (the
  loss, a difference of integer risks near 0, also to 1e-6 absolute), the
  gradients of the encoder output and of every leaf to rtol 2e-4 and 1e-5
  of the largest entry;
* ``main --train`` with MWER on tiny ``ls100_ctc`` and ``ls100_transducer``
  recipes: ``mwer`` and ``mwer_risk`` in ``metrics.jsonl``, 0 before the
  warmup ends.

The step with MWER before and after ``mwer_warmup_steps`` against JAX's is
tests/test_torch_ctc.py's CTC semi step; the two-rank MWER step against
one process is a case of tests/test_torch_dp.py.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.config import DecodeConfig as JDecode
from semi_supervised_asr_tpu.config import ModelConfig as JModelConfig
from semi_supervised_asr_tpu.config import ObjectiveConfig as JObjective
from semi_supervised_asr_tpu.decode import beam as JB
from semi_supervised_asr_tpu.decode import ctc_beam as JCB
from semi_supervised_asr_tpu.decode import transducer_beam as JTB
from semi_supervised_asr_tpu.models import speller as JS
from semi_supervised_asr_tpu.objectives import ctc_mwer as JCM
from semi_supervised_asr_tpu.objectives import losses as JL
from semi_supervised_asr_tpu.objectives import transducer_mwer as JTM
from semi_supervised_asr_tpu.ops import edit_distance as JED
from semi_supervised_asr_tpu_torch import main as M
from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.config import (
    ModelConfig, ObjectiveConfig,
)
from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD
from semi_supervised_asr_tpu_torch.models.seq2seq import build_model
from semi_supervised_asr_tpu_torch.objectives import ctc_mwer as CM
from semi_supervised_asr_tpu_torch.objectives import losses as LO
from semi_supervised_asr_tpu_torch.objectives import transducer_mwer as TM
from semi_supervised_asr_tpu_torch.ops.edit_distance import (
    batched_edit_distance,
)
from semi_supervised_asr_tpu_torch.utils.native_ops import (
    batch_edit_distance_py,
)
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    FAST_XLA, TOL_GRAD, one_thread, run_jax, t, train_records,
)

V, K, U = 9, 3, 6
# one tiny model a family: a listener of 8 a direction (its output is fed
# in), a speller, a CTC head, or a predictor and joint of 16
BASE = dict(n_mels=20, vocab_size=V, enc_hidden=8, enc_base_layers=1,
            enc_layers=1, embed_dim=8, compute_dtype="float32")
FAMILY = {
    "las": dict(dec_hidden=16, attn_dim=8, attn_conv_channels=2,
                attn_conv_width=3),
    "ctc": dict(family="ctc"),
    "transducer": dict(family="transducer", pred_hidden=16, pred_layers=1,
                       joint_dim=16),
    "transducer_chunked": dict(family="transducer", pred_hidden=16,
                               pred_layers=1, joint_dim=16,
                               joint_chunk_frames=3),
}
# weights seeds whose random models give n-best lists of unequal risks
SEED = {"las": 1, "ctc": 1, "transducer": 1, "transducer_chunked": 1}
MAX_SYMBOLS = 2


def test_edit_distance_matches_jax_and_the_host_scorer():
    """[B=4, K=3] hypotheses against [4, 1] references: ragged lengths,
    an empty hypothesis, an empty reference, equal sequences, padding
    values that are not PAD."""
    rng = np.random.default_rng(0)
    hyp = rng.integers(1, 5, (4, 3, 7)).astype(np.int32)
    ref = rng.integers(1, 5, (4, 1, 6)).astype(np.int32)
    hyp_lens = rng.integers(0, 8, (4, 3)).astype(np.int32)
    ref_lens = rng.integers(1, 7, (4, 1)).astype(np.int32)
    hyp_lens[0, 0] = 0                       # an empty hypothesis
    ref_lens[1, 0] = 0                       # an empty reference
    hyp[2, 1, :5] = ref[2, 0, :5]            # equal sequences
    hyp_lens[2, 1], ref_lens[2, 0] = 5, 5
    got = batched_edit_distance(t(hyp), t(hyp_lens), t(ref), t(ref_lens))
    full = (4, 3, 6)
    ref_j = JED.batched_edit_distance(
        jnp.asarray(hyp), jnp.asarray(hyp_lens),
        jnp.broadcast_to(jnp.asarray(ref), full),
        jnp.broadcast_to(jnp.asarray(ref_lens), (4, 3)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_j))
    host, _ = batch_edit_distance_py(
        hyp.reshape(12, 7), hyp_lens.reshape(12),
        np.broadcast_to(ref, full).reshape(12, 6),
        np.broadcast_to(ref_lens, (4, 3)).reshape(12))
    np.testing.assert_array_equal(got.numpy().reshape(12), host)
    assert got[2, 1] == 0 and got[0, 0] == ref_lens[0, 0]
    np.testing.assert_array_equal(got[1].numpy(), hyp_lens[1])


def test_expected_risk_and_gradient_match_jax():
    """Rows of unequal risks, equal risks (the loss 0) and a weight-0 row;
    a dead hypothesis at -1e30."""
    rng = np.random.default_rng(1)
    logp = rng.standard_normal((3, 4)).astype(np.float32) * 3
    logp[0, 3] = -1e30
    risks = np.asarray([[0, 2, 5, 1], [3, 3, 3, 3], [1, 0, 4, 2]], np.int32)
    weight = np.asarray([1.0, 1.0, 0.0], np.float32)

    def jax_fn(lp):
        return JL.expected_risk(lp, jnp.asarray(risks), jnp.asarray(weight))

    (ref, ref_risk), ref_grad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(logp))
    lp = t(logp).requires_grad_(True)
    loss, risk = LO.expected_risk(lp, t(risks), t(weight))
    grad, = torch.autograd.grad(loss, lp)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(risk.item(), float(ref_risk), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-6,
                               atol=1e-7)
    assert not grad[1].any() and not grad[2].any()


def tokens_and_enc(e_dim: int):
    """Gold tokens [3, U] (EOS-terminated: a repeated label, an empty
    row) and an encoder output [3, 10, e_dim] with lengths 10, 7, 4."""
    tokens = np.asarray([[3, 4, 5, 6, EOS, PAD], [2, 2, 7, EOS, PAD, PAD],
                         [PAD] * U], np.int32)
    rng = np.random.default_rng(2)
    lens = np.asarray([10, 7, 4])
    mask = np.arange(10)[None, :] < lens[:, None]
    enc = rng.standard_normal((3, 10, e_dim)).astype(np.float32) * mask[..., None]
    return tokens, enc, mask


BEAMS = {"las": (JB, "beam_decode_from_enc"),
         "ctc": (JCB, "ctc_beam_from_enc"),
         "transducer": (JTB, "transducer_beam_from_enc")}


def jax_nbest(family, tree, jcfg, enc, mask):
    """The n-best JAX's MWER term proposes (as numpy)."""
    def beam(p, e, m):
        if family == "las":
            keys = JS.precompute_decode_cache(p["speller"], jcfg, e)
            return JB.beam_decode_from_enc(
                p["speller"], jcfg, JDecode(beam_size=K, length_penalty=1.0),
                e, m, keys, max_len=U, return_nbest=True)
        if family == "ctc":
            return JCB.ctc_beam_from_enc(p["ctc"], e, m, U, beam_size=K,
                                         return_nbest=True)
        return JTB.transducer_beam_from_enc(
            p, jcfg, e, m, U, beam_size=K, max_symbols=MAX_SYMBOLS,
            return_nbest=True)

    return tuple(np.array(x) for x in run_jax(beam, tree, enc, mask))


def jax_mwer_fed(family, tree, jcfg, enc, mask, tokens):
    """JAX's MWER of the family with its beam's output given: a function
    of (hyps, scores) -> ((loss, mean risk), (d params, d enc)), compiled
    once (the reference's function imports its beam at call time, so the
    beam is replaced while it traces)."""
    jobj = JObjective(mwer_beam=K)
    fn = {"las": JL.mwer_loss_from_enc, "ctc": JCM.mwer_loss_from_enc,
          "transducer": functools.partial(JTM.mwer_loss_from_enc,
                                          max_symbols=MAX_SYMBOLS)}[family]
    module, name = BEAMS[family]

    def loss(p, e, hyps, scores):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, name, lambda *a, **k: (hyps, scores))
            return fn(p, jcfg, jobj, e, mask, tokens)

    grad_fn = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    compiled = {}

    def run(nbest):
        args = (tree, enc, *(jnp.asarray(x) for x in nbest))
        if not compiled:
            compiled[0] = jax.jit(grad_fn).lower(*args).compile(
                compiler_options=FAST_XLA)
        return compiled[0](*args)

    return run


def fed_nbest(family, nbest, tokens):
    """A given n-best: the beam's, with row 0's last hypothesis replaced by
    its reference (risk 0), and for the CTC family row 1's last hypothesis
    empty and its second dead (its score at -1e30)."""
    hyps, scores = (x.copy() for x in nbest)
    hyps[0, K - 1] = (tokens[0] if family == "las"
                      else np.where(tokens[0] == EOS, PAD, tokens[0]))
    if family == "ctc":
        hyps[1, K - 1] = PAD
        scores[1, K - 2] = -1e30
    return hyps, scores


@pytest.fixture(scope="module")
def mwer_cases():
    """Per case: the port's model, the inputs, the n-best JAX's beam
    proposes and a given one, and JAX's results on each (the chunked
    transducer's are the full grid's: the same weights and inputs)."""
    cases, refs = {}, {}
    for case, over in FAMILY.items():
        family = case.split("_")[0]
        kw = dict(BASE, **over)
        cfg, jcfg = ModelConfig(**kw), JModelConfig(**kw)
        flat = weights.init_numpy(cfg, seed=SEED[case])
        model = build_model(cfg)
        weights.load_flat(model, flat)
        tokens, enc, mask = tokens_and_enc(cfg.enc_out_dim)
        if family not in refs:
            tree = jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))
            jargs = (jnp.asarray(enc), jnp.asarray(mask))
            beam = jax_nbest(family, tree, jcfg, *jargs)
            nbest = {"end_to_end": beam,
                     "nbest_fed": fed_nbest(family, beam, tokens)}
            run = jax_mwer_fed(family, tree, jcfg, *jargs,
                               jnp.asarray(tokens))
            refs[family] = nbest, {k: run(v) for k, v in nbest.items()}
        nbest, ref = refs[family]
        cases[case] = dict(model=model, tokens=tokens, enc=enc, mask=mask,
                           nbest=nbest, ref=ref)
    return cases


PORT = {"las": LO.mwer_loss_from_enc, "ctc": CM.mwer_loss_from_enc,
        "transducer": functools.partial(TM.mwer_loss_from_enc,
                                        max_symbols=MAX_SYMBOLS)}
NBEST = {"las": LO.mwer_nbest, "ctc": CM.mwer_nbest,
         "transducer": functools.partial(TM.mwer_nbest,
                                         max_symbols=MAX_SYMBOLS)}


@pytest.mark.parametrize("search", ["nbest_fed", "end_to_end"])
@pytest.mark.parametrize("case", sorted(FAMILY))
def test_mwer_loss_matches_jax(mwer_cases, case, search):
    c = mwer_cases[case]
    family, model, mask = case.split("_")[0], c["model"], t(c["mask"])
    nbest, tokens = c["nbest"][search], t(c["tokens"])
    (ref, ref_risk), (gp, ge) = c["ref"][search]
    # a weighted row's hypotheses differ in risk, so the loss moves
    risks, weight = LO.nbest_risks(t(nbest[0]), tokens)
    assert ((risks.amax(dim=1) > risks.amin(dim=1)) & (weight > 0)).any()
    e = t(c["enc"]).requires_grad_(True)
    fed = None
    if search == "nbest_fed":
        fed = tuple(t(x) for x in nbest)
    else:
        # the port's own beam proposes JAX's n-best
        own = NBEST[family](model, ObjectiveConfig(mwer_beam=K), e.detach(),
                            mask, U)
        np.testing.assert_array_equal(own[0].numpy(), nbest[0])
    loss, risk = PORT[family](model, ObjectiveConfig(mwer_beam=K), e, mask,
                              tokens, nbest=fed)
    # the loss is a difference of integer risks of order 1-10 and may sit
    # near 0: an absolute bound beside the relative one
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(risk.item(), float(ref_risk), rtol=1e-5)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, [e, *params], allow_unused=True)
    want = {"enc": np.asarray(ge), **weights.flatten_tree(
        jax.tree.map(np.asarray, gp))}
    got = dict(zip(("enc", *names), grads))
    assert set(got) == set(want)
    # float32 sums over the B*K rows in another order: the step tests'
    # rtol (TOL_GRAD), their atol taken as 1e-5 of the largest entry
    scale = max(np.abs(w).max() for w in want.values())
    moved = 0
    for n, g in got.items():
        w = want[n]
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=TOL_GRAD["rtol"],
                                   atol=1e-5 * scale, err_msg=n)
        moved += bool(np.abs(w).max() > 0)
    assert moved >= 3


# tiny versions of the CTC and transducer recipes, MWER from step 2
TINY = ["model.enc_hidden=8", "model.enc_layers=1", "model.pred_hidden=16",
        "model.joint_dim=16", "model.embed_dim=8", "train.batch_size=4",
        "data.dataset=synthetic", "data.num_synthetic_utts=8",
        "data.frame_buckets=[128]", "data.token_buckets=[12]",
        "decode.max_decode_len=8", "decode.max_symbols=2",
        "model.compute_dtype=float32", "objective.lambda_mwer=0.3",
        "objective.mwer_beam=2", "objective.mwer_warmup_steps=1",
        "train.total_steps=2", "train.eval_every=0", "train.log_every=1"]


@pytest.mark.parametrize("name", ["ls100_ctc", "ls100_transducer"])
def test_main_trains_mwer(name, tmp_path):
    assert M.main(["--config", f"configs/{name}.yaml", "--train",
                   "--workdir", str(tmp_path), "--device", "cpu",
                   *TINY]) == 0
    recs = train_records(tmp_path)
    assert [r["step"] for r in recs] == [1, 2]
    assert recs[0]["mwer"] == recs[0]["mwer_risk"] == 0.0
    assert recs[1]["mwer_risk"] > 0
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["mwer"])
               for r in recs)
