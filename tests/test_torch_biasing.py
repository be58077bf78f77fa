"""PyTorch port parity: contextual biasing in every decoder.

Seeded numpy weights cross into the JAX trees by name (the LAS of
``tests/test_torch_lm_fusion.py``, V 12; the streaming tests' CTC and
forward-only transducer models, V 10), encoder outputs drawn with numpy:

* the trie's arrays bitwise those of the JAX ``build_bias_trie`` on the
  reference test's phrase sets (nested, overlapping, tail phrases,
  duplicates), and the same refusals;
* each of the five biased decoders (LAS beam, CTC prefix beam, CTC greedy
  walk, transducer greedy walk and beam) against JAX's at a small and a
  large bonus: identical tokens, scores (and the carries' bias slots) to
  ``rtol = atol = 1e-5``; a zero bonus is bitwise no biasing;
* the biased carries of the CTC and transducer walks, greedy and beam, in
  two chunks bitwise the whole walk;
* the LAS beam equal to the port's ``python_beam`` oracle under biasing;
* the config path: ``transcribe`` offline (beam, ``--nbest``) and
  streamed (one stream and ``--streams 2``) with ``decode.bias_phrases``,
  the half-configured and greedy warnings, and the Solver's ``test``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.config import DecodeConfig as JDecodeConfig
from semi_supervised_asr_tpu.decode import beam as JB
from semi_supervised_asr_tpu.decode import biasing as JBZ
from semi_supervised_asr_tpu.decode import ctc as JCTC
from semi_supervised_asr_tpu.decode import ctc_beam as JCB
from semi_supervised_asr_tpu.decode import transducer_beam as JTB
from semi_supervised_asr_tpu.decode import transducer_greedy as JTG
from semi_supervised_asr_tpu.models import speller as JSP
from semi_supervised_asr_tpu_torch import synthetic
from semi_supervised_asr_tpu_torch import transcribe as TR
from semi_supervised_asr_tpu_torch.config import DecodeConfig, load_config
from semi_supervised_asr_tpu_torch.data.registry import build_vocab
from semi_supervised_asr_tpu_torch.decode import biasing as BZ
from semi_supervised_asr_tpu_torch.decode import ctc as CTC
from semi_supervised_asr_tpu_torch.decode import streaming as S
from semi_supervised_asr_tpu_torch.decode.beam import beam_decode_from_enc
from semi_supervised_asr_tpu_torch.decode.ctc_beam import ctc_beam_from_enc
from semi_supervised_asr_tpu_torch.decode.python_beam import (
    beam_decode_python,
)
from semi_supervised_asr_tpu_torch.decode.transducer_beam import (
    transducer_beam_from_enc,
)
from semi_supervised_asr_tpu_torch.decode.transducer_greedy import (
    transducer_greedy_from_enc, transducer_greedy_init,
)
from tests.test_torch_lm_fusion import enc_inputs, las, t
from tests.test_torch_streaming import (  # noqa: F401 -- models: fixture
    CLI, MAX_U, models,
)
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    FAST_XLA, one_thread,
)

TOL = dict(rtol=1e-5, atol=1e-5)
K, MAX_LEN = 3, 8
# phrases of the LAS vocabulary (12) and of the streaming models' (10)
LAS_PHRASES = [[4, 7], [5], [6, 6, 3], [8, 9, 10]]
PHRASES = [[4, 5], [7, 8, 4], [6]]
BONUSES = (0.5, 3.0)
A, B_, C = 4, 5, 6


@pytest.mark.parametrize("phrases", [
    [[4, 5, 6], [4, 5], [7]],                 # nested
    [[4, 5], [4, 5, 6]],
    [[5, 6], [5, 6, 7, 8]],                   # overlapping
    [[4, 4, 5], [5, 4]],
    [[A, B_, A], [B_, A, C]],                 # tail phrases (suffix links)
    [[A, B_, C], [B_, 7]],
    [[A, B_, C, 7], [B_, C]],
    [[], [4], [4], [9, 3, 9, 3]],             # empty and duplicate
])
def test_trie_arrays_are_the_references(phrases):
    got = BZ.build_bias_trie(phrases, 12, 0.7)
    want = JBZ.build_bias_trie(phrases, 12, 0.7)
    for name, g, w in zip(BZ.BiasTrie._fields, got, want):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    for bad in ([[4, 0]], [[1]], [[2, 4]], [[12]], [[], []]):
        with pytest.raises(ValueError) as port:
            BZ.build_bias_trie(bad, 12, 1.0)
        with pytest.raises(ValueError) as ref:
            JBZ.build_bias_trie(bad, 12, 1.0)
        assert str(port.value) == str(ref.value)


def _tries(phrases, vocab, bonus):
    return (BZ.build_bias_trie(phrases, vocab, bonus),
            JBZ.build_bias_trie(phrases, vocab, bonus))


def _compiled(fn, *args):
    """One compile of ``fn`` (FAST_XLA), called at every bonus: the tries
    of one phrase set share their shapes."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)


def _decoder(name, models):
    """(port fn(trie) -> outputs, JAX fn(params, trie, enc, mask),
    its params, enc, mask, phrases, vocab) of one biased decoder."""
    if name == "las_beam":
        cfg, jcfg, model, tree = las()
        enc, mask = enc_inputs(cfg.enc_out_dim)
        dcfg = DecodeConfig(beam_size=K)
        jdcfg = JDecodeConfig(beam_size=K)

        def port(trie):
            e, m = t(enc), t(mask)
            return beam_decode_from_enc(
                model.speller, dcfg, e, m,
                model.speller.precompute_decode_cache(e), MAX_LEN,
                return_nbest=True, bias=trie)

        def ref(p, trie, e, m):
            return JB.beam_decode_from_enc(
                p["speller"], jcfg, jdcfg, e, m,
                JSP.precompute_decode_cache(p["speller"], jcfg, e), MAX_LEN,
                return_nbest=True, bias=trie)
        return port, ref, tree, enc, mask, LAS_PHRASES, 12
    kind = "ctc" if name.startswith("ctc") else "blstm"
    cfg, jcfg, model, tree = models[kind]
    m = cfg.model
    enc, mask = enc_inputs(m.enc_out_dim, 7, b=2, t_enc=12)
    if name == "ctc_beam":
        def port(trie):
            return ctc_beam_from_enc(model.ctc, t(enc), t(mask), MAX_U, K,
                                     return_nbest=True, bias=trie)

        def ref(p, trie, e, k):
            return JCB.ctc_beam_from_enc(p["ctc"], e, k, MAX_U, beam_size=K,
                                         return_nbest=True, bias=trie)
    elif name == "ctc_greedy":
        def port(trie):
            return CTC.ctc_greedy_stream(
                model.ctc, t(enc), t(mask), MAX_U,
                CTC.ctc_greedy_stream_init(2, MAX_U, "cpu",
                                           bias=trie is not None),
                bias=trie)

        def ref(p, trie, e, k):
            return JCTC.ctc_greedy_stream(
                p["ctc"], e, k, MAX_U,
                JCTC.ctc_greedy_stream_init(2, MAX_U, bias=True), bias=trie)
    elif name == "transducer_greedy":
        def port(trie):
            return transducer_greedy_from_enc(model, m, t(enc), t(mask),
                                              MAX_U, 2, bias=trie)

        def ref(p, trie, e, k):
            return JTG.transducer_greedy_from_enc(
                p, jcfg.model, e, k, MAX_U, max_symbols=2, bias=trie)
    else:
        def port(trie):
            return transducer_beam_from_enc(model, m, t(enc), t(mask), MAX_U,
                                            K, 2, return_nbest=True,
                                            bias=trie)

        def ref(p, trie, e, k):
            return JTB.transducer_beam_from_enc(
                p, jcfg.model, e, k, MAX_U, beam_size=K, max_symbols=2,
                return_nbest=True, bias=trie)
    return port, ref, tree, enc, mask, PHRASES, 10


DECODERS = ["las_beam", "ctc_beam", "ctc_greedy", "transducer_greedy",
            "transducer_beam"]


@pytest.mark.parametrize("name", DECODERS)
def test_biased_decoder_matches_jax(models, name):
    port, ref, tree, enc, mask, phrases, vocab = _decoder(name, models)
    compiled = None
    with torch.inference_mode():
        plain = port(None)
    moved = False
    for bonus in BONUSES:
        trie, jtrie = _tries(phrases, vocab, bonus)
        args = (tree, jtrie, jnp.asarray(enc), jnp.asarray(mask))
        compiled = compiled or _compiled(ref, *args)
        want = jax.tree.leaves(compiled(*args))
        with torch.inference_mode():
            got = S.tree_leaves(port(trie))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            if g.dtype.is_floating_point:
                np.testing.assert_allclose(g.numpy(), w, **TOL)
            else:
                np.testing.assert_array_equal(g.numpy(), w)
        moved |= not torch.equal(got[0], S.tree_leaves(plain)[0])
        # a zero bonus is bitwise no biasing
        if bonus == BONUSES[0]:
            with torch.inference_mode():
                zero = port(BZ.build_bias_trie(phrases, vocab, 0.0))
            n_plain = len(S.tree_leaves(plain))
            assert all(torch.equal(a, b) for a, b in zip(
                S.tree_leaves(zero)[:n_plain], S.tree_leaves(plain)))
    assert moved, "biasing never changed the hypotheses"


@pytest.mark.parametrize("decoder", ["ctc_greedy", "ctc_beam",
                                     "transducer_greedy", "transducer_beam"])
def test_biased_carries_resume_exactly(models, decoder):
    """Two chunks of 6 frames through the biased carry: the whole walk's
    carry bitwise (the bias slots included)."""
    kind = "ctc" if decoder.startswith("ctc") else "blstm"
    cfg, _, model, _ = models[kind]
    m = cfg.model
    enc, mask = enc_inputs(m.enc_out_dim, 7, b=2, t_enc=12)
    trie = BZ.build_bias_trie(PHRASES, 10, 1.0)
    if decoder == "ctc_greedy":
        # with the frames slot too: it keeps its place, the bias trails
        def walk(e, k, c, base):
            c = c or CTC.ctc_greedy_stream_init(2, MAX_U, "cpu", True, True)
            return CTC.ctc_greedy_stream(model.ctc, e, k, MAX_U, c, base,
                                         bias=trie)
    elif decoder == "ctc_beam":
        def walk(e, k, c, base):
            return ctc_beam_from_enc(model.ctc, e, k, MAX_U, K, carry=c,
                                     return_carry=True, bias=trie)[2]
    elif decoder == "transducer_greedy":
        def walk(e, k, c, base):
            c = c or transducer_greedy_init(model, m, 2, MAX_U, "cpu",
                                            bias=True)
            return transducer_greedy_from_enc(model, m, e, k, MAX_U, 2,
                                              carry=c, return_carry=True,
                                              bias=trie)[2]
    else:
        def walk(e, k, c, base):
            return transducer_beam_from_enc(model, m, e, k, MAX_U, K, 2,
                                            carry=c, return_carry=True,
                                            bias=trie)[2]
    with torch.inference_mode():
        whole = walk(t(enc), t(mask), None, 0)
        got = None
        for h in (slice(0, 6), slice(6, 12)):
            got = walk(t(enc[:, h]), t(mask[:, h]), got, h.start)
    assert all(torch.equal(a, b) for a, b in zip(S.tree_leaves(got),
                                                 S.tree_leaves(whole)))
    # the bias slots trail the carry and moved off the root
    assert int(S.tree_leaves(whole)[-1 if kind == "blstm" else -2].max()) > 0


def test_las_beam_matches_python_oracle():
    cfg, _, model, _ = las()
    enc, mask = enc_inputs(cfg.enc_out_dim)
    dcfg = DecodeConfig(beam_size=K)
    trie = BZ.build_bias_trie(LAS_PHRASES, 12, 1.5)
    with torch.inference_mode():
        e, m = t(enc), t(mask)
        toks, scores = beam_decode_from_enc(
            model.speller, dcfg, e, m,
            model.speller.precompute_decode_cache(e), MAX_LEN, bias=trie)
        for r in range(e.shape[0]):
            er, mr = e[r:r + 1], m[r:r + 1]
            want, score = beam_decode_python(
                model.speller, dcfg, er, mr,
                model.speller.precompute_decode_cache(er), MAX_LEN,
                bias=trie)
            got = [int(x) for x in toks[r] if x != 0]
            assert got == want, (r, got, want)
            np.testing.assert_allclose(float(scores[r]), score, **TOL)


def test_config_path_biases_transcribe_and_solver(tmp_path, capsys):
    """``decode.bias_phrases`` + ``decode.bias_bonus`` through transcribe
    (offline beam and n-best, one stream and two) and the Solver's beam
    test; one key alone warns and decodes unbiased; greedy warns."""
    config = "configs/ls100_transducer_streaming.yaml"
    cfg = load_config(config, CLI)
    vocab = build_vocab(cfg)
    cfg = TR.finalize_config(cfg, vocab.size)
    files = synthetic.write_wavs(tmp_path, cfg, vocab, 2)
    synthetic.write_model_dir(tmp_path, cfg, files, seed=1)
    hot = tmp_path / "hot.txt"
    hot.write_text("# hotwords\nab\n\nthe\n")
    base = ["--config", config, "--load-dir", str(tmp_path), "--device",
            "cpu", *map(str, files), *CLI]
    keys = [f"decode.bias_phrases={hot}", "decode.bias_bonus=4.0"]

    def run(*extra):
        assert TR.main(base + list(extra)) == 0
        out, err = capsys.readouterr()
        return [json.loads(x) for x in out.strip().splitlines()], err

    plain, _ = run("--beam", "3")
    biased, err = run("--beam", "3", *keys)
    assert "contextual biasing: 2 phrases" in err
    assert [r["text"] for r in biased] != [r["text"] for r in plain]
    nbest, _ = run("--beam", "3", "--nbest", "2", *keys)
    assert [r["text"] for r in nbest] == [r["text"] for r in biased]
    for extra in (["--streaming"], ["--streaming", "--streams", "2"]):
        streamed, _ = run("--beam", "3", *extra, *keys)
        assert [r["text"] for r in streamed] == [r["text"] for r in biased]
        np.testing.assert_allclose([r["score"] for r in streamed],
                                   [r["score"] for r in biased], rtol=1e-4)
    half, err = run("--beam", "3", keys[0])
    assert "biasing DISABLED" in err and half == plain
    _, err = run("--beam", "1", *keys)
    assert "runs unbiased" in err
    # the Solver's test on a fresh workdir (random weights): the beam
    # builds the trie once, greedy warns
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    solver = Solver(load_config(config, CLI + keys), tmp_path / "run", "cpu")
    assert solver.test("beam")["n_utts"] > 0
    solver.test("greedy")
    err = capsys.readouterr().err
    assert err.count("contextual biasing: 2 phrases") == 1
    assert "runs unbiased" in err
