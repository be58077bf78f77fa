"""PyTorch port parity: token timestamps and forced alignment.

The same numpy inputs and weights go through the JAX package and the port,
in float32 at tiny widths:

* ``ctc_viterbi_align`` (``ops/ctc_align.py``) on rows with a repeated
  token (a blank forced between), an infeasible row (too few frames), a row
  of no tokens, frozen frames past ``frame_lens``, on random posteriors and
  on uniform ones (every candidate ties: the first maximum wins, as
  ``jnp.argmax``): starts and ends exact, ``path_logp`` to 1e-5, -inf where
  JAX's is;
* ``transcribe --timestamps`` against the reference's ``transcribe`` on the
  same weights (its Solver's decode functions given them in place of a
  checkpoint): the CTC
  family's best path, timit's LAS greedy with the joint-CTC head (both timed
  by forced alignment), the transducer's greedy emission frames; a file
  longer than the largest bucket decoded in chunks, its times offset by the
  chunk: every record equal (scores to 1e-5), times exact to the 3
  decimals written; the refusals' messages;
* ``align.py`` on a synthetic manifest with an infeasible and an empty
  entry: the reference's ``align_entries`` records, exit 0 with those two
  ``"failed"``, exit 1 when every entry fails.

Streamed emission frames against the offline walk's are in
tests/test_torch_streaming.py.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu import align as JA
from semi_supervised_asr_tpu import transcribe as JTR
from semi_supervised_asr_tpu.config import load_config as jax_load_config
from semi_supervised_asr_tpu.data import registry as JREG
from semi_supervised_asr_tpu.data.bucketing import (
    make_bucket_spec as jax_bucket_spec,
)
from semi_supervised_asr_tpu.ops import ctc_align as JCA
from semi_supervised_asr_tpu.training.solver import Solver as JaxSolver
from semi_supervised_asr_tpu_torch import align as A
from semi_supervised_asr_tpu_torch import synthetic, weights
from semi_supervised_asr_tpu_torch import transcribe as TR
from semi_supervised_asr_tpu_torch.config import load_config
from semi_supervised_asr_tpu_torch.data.registry import build_vocab
from semi_supervised_asr_tpu_torch.data.vocab import PAD
from semi_supervised_asr_tpu_torch.ops.ctc_align import ctc_viterbi_align
from tests.test_torch_train import one_thread  # noqa: F401 -- autouse


@pytest.mark.parametrize("posteriors", ["random", "uniform"])
def test_ctc_viterbi_align_matches_jax(posteriors):
    """Rows: distinct tokens; a repeated token; more tokens than frames
    (infeasible); no tokens; 5 valid frames of 12 (frozen after)."""
    b, t, v = 5, 12, 7
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((b, t, v)) * 2 if posteriors == "random"
              else np.zeros((b, t, v)))
    logp = np.array(jax.nn.log_softmax(jnp.asarray(logits, jnp.float32)))
    tokens = np.asarray([[3, 4, 5, 6], [2, 2, 5, PAD], [3, 4, 3, 4],
                         [PAD] * 4, [6, 6, 1, PAD]], np.int32)
    token_lens = np.asarray([4, 3, 4, 0, 3], np.int32)
    frame_lens = np.asarray([12, 12, 3, 9, 5], np.int32)
    ref = JCA.ctc_viterbi_align(jnp.asarray(logp), jnp.asarray(frame_lens),
                                jnp.asarray(tokens), jnp.asarray(token_lens))
    got = ctc_viterbi_align(torch.from_numpy(logp),
                            torch.from_numpy(frame_lens),
                            torch.from_numpy(tokens),
                            torch.from_numpy(token_lens))
    starts, ends, plp = (x.numpy() for x in got)
    np.testing.assert_array_equal(starts, np.asarray(ref[0]))
    np.testing.assert_array_equal(ends, np.asarray(ref[1]))
    np.testing.assert_allclose(plp, np.asarray(ref[2]), rtol=1e-5, atol=1e-5)
    assert starts.dtype == ends.dtype == np.int32
    assert np.isinf(plp[2]) and np.isfinite(plp[[0, 1, 3, 4]]).all()
    assert (starts[3] == -1).all() and (ends[4, :3] < 5).all()
    # the repeat's two tokens are separated by at least one blank frame
    assert starts[1, 1] > ends[1, 0] + 1


# tiny versions of the three recipes the timestamps serve
TINY = ["model.enc_hidden=8", "model.enc_layers=1", "train.batch_size=4",
        "data.dataset=synthetic", "data.num_synthetic_utts=8",
        "data.frame_buckets=[128]", "data.token_buckets=[12,24]",
        "decode.max_decode_len=12", "model.compute_dtype=float32"]
RECIPES = {
    "ctc": ("configs/ls100_ctc.yaml", ["model.enc_base_layers=0"],
            "greedy"),
    "las_ctc": ("configs/timit.yaml", [
        "model.dec_hidden=16", "model.attn_dim=8",
        "model.attn_conv_channels=2", "model.attn_conv_width=4",
        "model.embed_dim=8", "objective.lambda_ctc=0.3"], "greedy"),
    "transducer": ("configs/ls100_transducer.yaml", [
        "model.pred_hidden=16", "model.joint_dim=16", "model.embed_dim=8",
        "decode.max_symbols=2"], "greedy"),
}


def reference_solver(jcfg, tree, cmvn):
    """The reference's Solver as its ``transcribe`` and ``align_entries``
    use it, given the weights in place of a checkpoint: its decode
    functions read the config (finalized as its constructor does), the
    bucket spec, the vocab, the CMVN statistics and the parameters; the
    training state its constructor builds is not needed."""
    solver = JaxSolver.__new__(JaxSolver)
    solver.vocab = JREG.build_vocab(jcfg)
    solver.cfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, vocab_size=solver.vocab.size, n_mels=jcfg.frontend.n_mels,
        ctc_head=jcfg.model.ctc_head or jcfg.objective.lambda_ctc > 0.0))
    solver.spec = jax_bucket_spec(jcfg.data, jcfg.frontend,
                                  jcfg.model.time_reduction)
    solver.from_features, solver.mesh, solver._decode_fns = False, None, {}
    solver.state = SimpleNamespace(params=tree)
    solver.eval_params = lambda require_ckpt=False: tree
    solver.cmvn = cmvn
    return solver


def recipe(name, d):
    """The port's and JAX's configs, audio files (the last one a .npy
    longer than the largest bucket) and a model directory of random
    weights; the reference's Solver decodes with the same weights."""
    config, over, _ = RECIPES[name]
    over = TINY + over
    cfg = load_config(config, over)
    vocab = build_vocab(cfg)
    cfg = TR.finalize_config(cfg, vocab.size)
    files = synthetic.write_wavs(d, cfg, vocab, 3, min_tokens=3,
                                 max_tokens=6)
    long = np.concatenate([np.asarray(TR.load_audio(f), np.float32)
                           for f in files] * 2)
    np.save(d / "long.npy", long)
    files.append(d / "long.npy")
    synthetic.write_model_dir(d, cfg, files, seed=1)
    tree = jax.tree.map(jnp.asarray, weights.unflatten_tree(
        weights.init_numpy(cfg.model, seed=1)))
    with np.load(d / "cmvn.npz") as z:
        cmvn = (z["mean"], z["inv_std"])
    solver = reference_solver(jax_load_config(config, over), tree, cmvn)
    return cfg, files, solver, TR.Recognizer.from_dir(cfg, d, "cpu")


@pytest.fixture(scope="module")
def recipes(tmp_path_factory):
    return {name: recipe(name, tmp_path_factory.mktemp(name))
            for name in RECIPES}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_transcribe_timestamps_match_the_reference(recipes, name, capsys):
    cfg, files, solver, rec = recipes[name]
    mode = RECIPES[name][2]
    got = TR.transcribe(rec, files, mode, timestamps=True)
    port_err = capsys.readouterr().err
    want = JTR.transcribe(solver, files, mode, timestamps=True)
    # the records equal but for the scores' float32 sums
    np.testing.assert_allclose([r.pop("score") for r in got],
                               [r.pop("score") for r in want], rtol=1e-5)
    assert got == want
    assert port_err == capsys.readouterr().err
    assert got[-1]["chunks"] > 1
    timed = [r for r in got if r["tokens"]]
    assert timed and all(tk["end_s"] >= tk["start_s"] for r in timed
                         for tk in r["tokens"])
    # a chunked file's second chunk starts after the first chunk's audio
    spec = rec.spec
    off = (spec.samples_for_frames(spec.frame_buckets[-1])
           / cfg.frontend.sample_rate)
    assert got[-1]["tokens"][-1]["start_s"] >= off or not got[-1]["tokens"]


@pytest.mark.parametrize("name, extra, message", [
    ("transducer", ["--beam", "3"], "add --beam 1"),
    ("ctc", ["--beam", "3", "--nbest", "2"], "drop --nbest"),
    ("ctc", ["--streaming", "--beam", "3"], "greedy-only"),
])
def test_transcribe_timestamps_refusals(recipes, tmp_path, name, extra,
                                        message):
    cfg, files, _, _ = recipes[name]
    config, over, _ = RECIPES[name]
    with pytest.raises(SystemExit, match=message):
        TR.main(["--config", config, "--load-dir", str(files[0].parent),
                 "--device", "cpu", "--timestamps", *extra, str(files[0]),
                 *TINY, *over])


def manifest(d, files, texts):
    """A manifest in ``d``: audio paths relative to it where the files
    are there."""
    m = d / "manifest.jsonl"
    m.write_text("".join(
        json.dumps({"uid": f"u{i}", "text": txt,
                    "audio": f.name if f.parent == d else str(f)}) + "\n"
        for i, (f, txt) in enumerate(zip(files, texts))))
    return m


def test_align_cli_matches_the_reference(recipes, tmp_path, capsys):
    """Four entries of the CTC recipe: two transcripts that fit, one too
    long for its frames (no CTC path) and one empty."""
    cfg, files, solver, rec = recipes["ctc"]
    d = files[0].parent
    vocab = rec.vocab
    letters = [s for s in vocab.tokens if len(s) == 1 and s.isalpha()]
    texts = ["".join(letters[:4]), "".join(letters[2:5]),
             "".join(letters * 3)[:22], ""]
    m = manifest(d, files[:4], texts)
    entries = A.read_manifest(m)
    got = A.align_entries(rec, entries, d)
    want = JA.align_entries(solver, entries, d)
    assert got == want
    assert [("failed" in r) for r in got] == [False, False, True, True]
    config, over, _ = RECIPES["ctc"]
    base = ["--config", config, "--load-dir", str(d), "--device", "cpu",
            *TINY, *over]
    out = tmp_path / "aligned.jsonl"
    assert A.main([*base, "--manifest", str(m), "--out", str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines == got
    assert "2/4 entries failed" in capsys.readouterr().err
    bad = manifest(tmp_path, [files[0]], [""])
    assert A.main([*base, "--manifest", str(bad)]) == 1


def test_align_refuses_the_transducer(recipes):
    _, files, _, rec = recipes["transducer"]
    with pytest.raises(ValueError, match="forced alignment needs CTC frame "
                                         "posteriors"):
        A.align_entries(rec, [], files[0].parent)
