"""PyTorch port: the serving export (``export.py``) on ``torch.export``.

On the CPU, at small widths (the LAS of ``tests/test_torch_lm_fusion.py``,
the streaming tests' CTC and transducer models, a 2-block conformer), with
a short ``decode.max_decode_len``:

* the exported graph holds the ``ssasr_torch`` custom ops: K1 and K2
  (the BLSTM LAS), K1 and K5's forward (the conformer with
  ``attn_backend: flash``);
* a program saved and loaded back equals the live port decode (the
  ``Recognizer``'s): tokens identical, scores within 1e-6, for the biased
  LAS beam and the CTC best path; the LAS program's tokens are those of
  the JAX ``build_decode_fn`` on the same weights (the numpy weights of
  ``weights.init_numpy`` in both trees);
* the streaming bundle through ``StreamingArtifact`` equals
  ``StreamingTranscriber``: CTC greedy and the transducer beam, biased,
  the latter with shallow LM fusion;
* the CLI writes its manifest, programs and vocab; ``--bf16`` stores the
  float weights in bfloat16 and keeps the CMVN float32; a biased greedy
  export without ``--streaming`` is refused.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu import export as JEX
from semi_supervised_asr_tpu.config import Config as JConfig
from semi_supervised_asr_tpu.config import DecodeConfig as JDecodeConfig
from semi_supervised_asr_tpu.config import ModelConfig as JModelConfig
from semi_supervised_asr_tpu_torch import export as EX
from semi_supervised_asr_tpu_torch import synthetic
from semi_supervised_asr_tpu_torch import transcribe as TR
from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.config import (
    Config, DecodeConfig, ModelConfig, load_config,
)
from semi_supervised_asr_tpu_torch.data.corpus import load_audio
from semi_supervised_asr_tpu_torch.data.registry import build_vocab
from semi_supervised_asr_tpu_torch.data.synthetic import make_utterance
from semi_supervised_asr_tpu_torch.decode import biasing as BZ
from semi_supervised_asr_tpu_torch.decode import streaming as S
from semi_supervised_asr_tpu_torch.models.seq2seq import build_model
from tests.test_torch_lm_fusion import LAS, make_lm
from tests.test_torch_streaming import (  # noqa: F401 -- models: fixture
    CLI, CMVN, models,
)
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    FAST_XLA, one_thread,
)

FRAMES, B = 48, 2
OPS = {"k1": "ssasr_torch.fused_post_fft.default",
       "k2": "ssasr_torch.lstm_scan_fwd.default",
       "k5": "ssasr_torch.flash_mhsa_fwd.default"}


def graph_ops(ep) -> set[str]:
    return {str(n.target) for n in ep.graph.nodes
            if str(n.target).startswith("ssasr_torch.")}


def audio_batch(cfg, seed=0):
    s = EX.samples_for_frames(cfg, FRAMES)
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((B, s)) * 0.1).astype(np.float32)
    return audio, np.array([s, s - 1500], np.int32)


@pytest.fixture(scope="module")
def las_setup(tmp_path_factory):
    """The small LAS with a phrase file: (config, model, vocab, the numpy
    weights, the phrase file)."""
    d = tmp_path_factory.mktemp("las")
    vocab = build_vocab(Config())
    hot = d / "hot.txt"
    hot.write_text("ae\naa iy\n")
    kw = dict(LAS, vocab_size=vocab.size)
    cfg = Config(model=ModelConfig(**kw), decode=DecodeConfig(
        beam_size=3, max_decode_len=6, bias_phrases=str(hot),
        bias_bonus=2.0))
    flat = weights.init_numpy(cfg.model, 0)
    model = build_model(cfg.model).eval()
    weights.load_flat(model, flat)
    return cfg, model, vocab, flat, hot


@pytest.fixture(scope="module")
def las_program(las_setup, tmp_path_factory):
    """The biased LAS beam program, saved and loaded back."""
    cfg, model, vocab, _, _ = las_setup
    ep = EX.export_decode(cfg, copy.deepcopy(model), CMVN, B, FRAMES,
                          "beam", vocab=vocab)
    path = tmp_path_factory.mktemp("prog") / "las.pt2"
    torch.export.save(ep, str(path))
    return ep, path


def test_graph_holds_the_kernel_ops(las_program):
    ep, _ = las_program
    assert {OPS["k1"], OPS["k2"]} <= graph_ops(ep)
    # the conformer's attention: K5's forward (and K1)
    kw = dict(n_mels=80, vocab_size=10, family="ctc",
              encoder_arch="conformer", enc_hidden=8, enc_heads=2,
              enc_ff_dim=16, enc_blocks=2, conv_subsample=2,
              conv_channels=4, attn_backend="flash",
              compute_dtype="float32")
    cfg = Config(model=ModelConfig(**kw))
    model = build_model(cfg.model).eval()
    weights.load_flat(model, weights.init_numpy(cfg.model, 0))
    ep = EX.export_decode(cfg, model, CMVN, B, FRAMES, "greedy")
    assert {OPS["k1"], OPS["k5"]} <= graph_ops(ep)


def test_saved_program_equals_live_decode_and_jax(las_setup, las_program):
    cfg, model, vocab, flat, hot = las_setup
    audio, lens = audio_batch(cfg)
    rec = TR.Recognizer(cfg, model, CMVN, vocab, torch.device("cpu"),
                        bias=BZ.bias_from_config(cfg.decode, vocab, "cpu"))
    live = rec.decode(audio, lens, "beam")
    toks, scores = EX.run_artifact(las_program[1], audio, lens)
    np.testing.assert_array_equal(toks.numpy(), live[0])
    np.testing.assert_allclose(scores.numpy(), live[1], rtol=0, atol=1e-6)
    assert (live[0][:, 0] > 2).all()
    # the same weights in the JAX package's decode function
    jcfg = JConfig(model=JModelConfig(**dict(LAS, vocab_size=vocab.size)),
                   decode=JDecodeConfig(**dataclasses.asdict(cfg.decode)))
    params = jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))
    params["__cmvn_mean"], params["__cmvn_std"] = CMVN
    fn = JEX.build_decode_fn(jcfg, params, "beam")
    jt, _ = jax.jit(fn).lower(audio, lens).compile(
        compiler_options=FAST_XLA)(audio, lens)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))


def test_ctc_greedy_program_equals_live_decode(models, tmp_path):
    cfg, _, model, _ = models["ctc"]
    audio, lens = audio_batch(cfg, seed=1)
    ep = EX.export_decode(cfg, copy.deepcopy(model), CMVN, B, FRAMES,
                          "greedy")
    assert {OPS["k1"], OPS["k2"]} <= graph_ops(ep)
    torch.export.save(ep, str(tmp_path / "ctc.pt2"))
    toks, scores = EX.load_artifact(tmp_path / "ctc.pt2")(audio, lens)
    rec = TR.Recognizer(cfg, model, CMVN, build_vocab(cfg),
                        torch.device("cpu"))
    live = rec.decode(audio, lens, "greedy")
    np.testing.assert_array_equal(toks.numpy(), live[0])
    np.testing.assert_allclose(scores.numpy(), live[1], rtol=0, atol=1e-6)


def _bundle(d, cfg, model, mode, lm=None, bias=None):
    b = EX.export_streaming(cfg, copy.deepcopy(model), CMVN, mode,
                            None if lm is None else copy.deepcopy(lm),
                            bias=bias)
    files = {}
    for name, ep in b["programs"].items():
        torch.export.save(ep, str(d / f"{name}.pt2"))
        files[name] = f"{name}.pt2"
    (d / "manifest.json").write_text(json.dumps(
        {"streaming": {**b["meta"], "files": files}}))


@pytest.mark.parametrize("kind, beam, fused", [("ctc", 1, False),
                                               ("blstm", 2, True)])
def test_streaming_artifact_equals_transcriber(models, tmp_path, kind, beam,
                                               fused):
    cfg, _, model, _ = models[kind]
    d = DecodeConfig(beam_size=beam, max_decode_len=10, max_symbols=1,
                     lm_weight=0.3 if fused else 0.0)
    cfg = cfg.replace(decode=d)
    lm = make_lm("lstm", vocab=10)[0] if fused else None
    trie = BZ.build_bias_trie([[4, 5], [7]], 10, 1.0)
    _bundle(tmp_path, cfg, model, "greedy" if beam == 1 else "beam", lm,
            trie)
    wav = make_utterance(0, build_vocab(Config()), cfg.data, cfg.frontend,
                         min_tokens=4, max_tokens=6).audio.astype(np.float32)
    got = EX.stream_artifact_decode(tmp_path, wav, 1777)
    want = S.stream_decode(model, cfg, CMVN, wav, 10, piece_samples=1777,
                           max_symbols=1, beam_size=beam, lm=lm,
                           lm_weight=d.lm_weight, bias=trie)
    assert got[0] == want[0] and len(got[0]) > 2
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)


def test_cli_writes_manifest_and_bf16(tmp_path, capsys):
    config = "configs/ls100_transducer_streaming.yaml"
    cfg = load_config(config, CLI)
    vocab = build_vocab(cfg)
    cfg = TR.finalize_config(cfg, vocab.size)
    files = synthetic.write_wavs(tmp_path, cfg, vocab, 1)
    synthetic.write_model_dir(tmp_path, cfg, files, seed=1)
    (tmp_path / "hot.txt").write_text("ab\n")
    out = tmp_path / "exp"
    keys = [f"decode.bias_phrases={tmp_path / 'hot.txt'}",
            "decode.bias_bonus=2.0", "decode.max_decode_len=4",
            "decode.max_symbols=1"]
    base = ["--config", config, "--load-dir", str(tmp_path), "--out",
            str(out), "--device", "cpu", "--batch", "1", "--greedy",
            "--frames", "32"]
    with pytest.raises(SystemExit, match="applies to beam decode only"):
        EX.main(base + CLI + keys)
    assert EX.main(base + ["--streaming", "--bf16"] + CLI + keys) == 0
    assert "bakes UNBIASED" in capsys.readouterr().out
    man = json.loads((out / "manifest.json").read_text())
    art = man["artifacts"][0]
    assert (art["mode"], art["batch"], art["frames"], art["param_dtype"]) \
        == ("greedy", 1, 32, "bfloat16")
    assert (out / art["file"]).stat().st_size == art["bytes"]
    assert set(man["streaming"]["files"]) == {"init", "chunk", "final",
                                              "emit"}
    assert (out / "vocab.json").exists()
    ep = torch.export.load(str(out / art["file"]))
    dtypes = {k: v.dtype for k, v in ep.state_dict.items()}
    assert dtypes.pop("cmvn_mean") == dtypes.pop("cmvn_inv_std") \
        == torch.float32
    floats = {v for v in dtypes.values() if v.is_floating_point}
    assert floats == {torch.bfloat16}
    wav = load_audio(files[0])[:art["samples"]]
    audio = np.zeros((1, art["samples"]), np.float32)
    audio[0, :len(wav)] = wav
    toks, _ = ep.module()(torch.from_numpy(audio),
                          torch.tensor([art["samples"]], dtype=torch.int32))
    assert toks.shape == (1, 4)
