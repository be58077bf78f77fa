"""PyTorch port, the whole serving slice: WAV files -> texts.

The port's ``transcribe`` CLI (on CPU, so every kernel runs its plain
version) is held against the JAX package driven through its own call
chain -- ``featurize`` -> ``seq2seq.encode`` -> ``beam_decode_from_enc`` /
``greedy_decode_from_enc`` -- on the same weights, CMVN statistics and
padded batches, with ``configs/timit.yaml`` cut to a small width and
float32 compute.  Texts must be identical; scores agree to 1e-4.  Also:
the port imports no JAX, and it refuses what this slice does not serve.
"""

import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.io import wavfile

from semi_supervised_asr_tpu.config import load_config
from semi_supervised_asr_tpu.data.bucketing import make_bucket_spec
from semi_supervised_asr_tpu.data.registry import build_vocab
from semi_supervised_asr_tpu.decode.beam import beam_decode_from_enc
from semi_supervised_asr_tpu.decode.greedy import greedy_decode_from_enc
from semi_supervised_asr_tpu.models import seq2seq as JM
from semi_supervised_asr_tpu.ops import frontend_oracle as oracle
from semi_supervised_asr_tpu.training.train_step import featurize
from semi_supervised_asr_tpu_torch import synthetic, weights
from semi_supervised_asr_tpu_torch import transcribe as TR
from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq
from tests.test_torch_train import one_thread  # noqa: F401 -- autouse

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs" / "timit.yaml")
SMALL = [
    "model.enc_hidden=128", "model.enc_layers=2", "model.dec_hidden=64",
    "model.attn_dim=32", "model.attn_conv_channels=4",
    "model.attn_conv_width=10", "model.embed_dim=32",
    "model.compute_dtype=float32", "train.batch_size=4",
    "data.frame_buckets=[48,96]", "decode.max_decode_len=16",
]
# configs/ls960_conformer.yaml cut to a small width: a 2-block conformer
# listener (d_model 32) under attn_backend flash, float32, synthetic data
CONFORMER_CONFIG = str(REPO / "configs" / "ls960_conformer.yaml")
CONFORMER = [
    "model.enc_hidden=16", "model.enc_heads=2", "model.enc_ff_dim=32",
    "model.enc_blocks=2", "model.conv_channels=4",
    "model.conformer_conv_width=5", "model.attn_backend=flash",
    "model.dec_hidden=32", "model.dec_layers=1", "model.attn_dim=16",
    "model.attn_conv_channels=4", "model.attn_conv_width=10",
    "model.embed_dim=16", "model.compute_dtype=float32",
    "train.batch_size=4", "data.dataset=synthetic",
    "data.frame_buckets=[96]", "data.token_buckets=[16]",
    "decode.max_decode_len=16",
]
# one bucket, one batch: a short file, a full one and one cut in two
CONFORMER_LENGTHS = (4000, 9000, 20000)
# sample counts: two buckets, a zero-free short file, and one longer than
# the largest bucket (decoded as two chunks)
LENGTHS = (4000, 6500, 7000, 12000, 14500, 9000, 20000)


def make_workdir(d, config, overrides, lengths=LENGTHS):
    cfg = load_config(config, overrides)
    vocab = build_vocab(cfg)
    cfg = TR.finalize_config(cfg, vocab.size)
    files = synthetic.write_wavs(d, cfg, vocab, len(lengths), lengths,
                                 min_tokens=12, max_tokens=12)
    synthetic.write_model_dir(d, cfg, files, seed=0)
    with np.load(d / "params.npz") as z:
        params = jax.tree.map(jnp.asarray, weights.unflatten_tree(dict(z)))
    return d, cfg, vocab, files, params


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return make_workdir(tmp_path_factory.mktemp("slice"), CONFIG, SMALL)


@pytest.fixture(scope="module")
def conformer_workdir(tmp_path_factory):
    return make_workdir(tmp_path_factory.mktemp("conformer"),
                        CONFORMER_CONFIG, CONFORMER, CONFORMER_LENGTHS)


@functools.partial(jax.jit, static_argnums=(0, 5))
def jax_decode(cfg, params, audio, lens, cmvn, mode):
    feats, flens = featurize(cfg, audio, lens, cmvn, None, False)
    enc, mask, keys = JM.encode(params, feats, flens, cfg.model)
    max_u = TR.max_decode_steps(cfg, enc.shape[1])
    if mode == "greedy":
        hyps, lp = greedy_decode_from_enc(params["speller"], cfg.model, enc,
                                          mask, keys, max_u)
        return hyps, lp.sum(axis=1)
    return beam_decode_from_enc(params["speller"], cfg.model, cfg.decode,
                                enc, mask, keys, max_u)


def jax_transcribe(cfg, vocab, files, params, cmvn, mode):
    """The reference path, without a Solver: same bucketing and padding."""
    spec = make_bucket_spec(cfg.data, cfg.frontend, cfg.model.time_reduction)
    by_bucket = {}
    for f in files:
        a = wavfile.read(f)[1].astype(np.float32) / 32768.0
        s = spec.samples_for_frames(spec.frame_buckets[-1])
        for ci, piece in enumerate([a[i: i + s] for i in range(0, len(a), s)]):
            fb = spec.frame_bucket(spec.frames_for_samples(len(piece)))
            by_bucket.setdefault(fb, []).append(((str(f), ci), piece))
    out = {}
    bs = cfg.train.batch_size
    for fb, items in sorted(by_bucket.items()):
        s_len = spec.samples_for_frames(fb)
        for start in range(0, len(items), bs):
            chunk = items[start: start + bs]
            audio = np.zeros((bs, s_len), np.float32)
            lens = np.zeros((bs,), np.int32)
            for r, (_, a) in enumerate(chunk):
                audio[r] = oracle.pad_for_batch(a, s_len, cfg.frontend)
                lens[r] = len(a)
            hyps, scores = jax_decode(cfg, params, jnp.asarray(audio),
                                      jnp.asarray(lens), cmvn, mode)
            for r, (key, _) in enumerate(chunk):
                out[key] = (vocab.decode_text(np.asarray(hyps)[r]),
                            float(np.asarray(scores)[r]))
    return out


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_transcribe_matches_jax_chain(workdir, mode, tmp_path, capsys):
    check_transcribe(workdir, CONFIG, SMALL, mode, tmp_path)


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_conformer_transcribe_matches_jax_chain(conformer_workdir, mode,
                                                tmp_path, capsys):
    check_transcribe(conformer_workdir, CONFORMER_CONFIG, CONFORMER, mode,
                     tmp_path)


def check_transcribe(workdir, config, overrides, mode, tmp_path):
    d, cfg, vocab, files, params = workdir
    out = tmp_path / "hyps.jsonl"
    argv = ["--config", config, "--load-dir", str(d), "--device", "cpu",
            "--out", str(out), *map(str, files), *overrides]
    if mode == "greedy":
        argv[:0] = ["--beam", "1"]
    assert TR.main(argv) == 0
    got = [json.loads(line) for line in out.read_text().splitlines()]
    with np.load(d / "cmvn.npz") as z:
        cmvn = (jnp.asarray(z["mean"]), jnp.asarray(z["inv_std"]))
    ref = jax_transcribe(cfg, vocab, files, params, cmvn, mode)
    assert [g["audio"] for g in got] == [str(f) for f in files]
    for g in got:
        parts = sorted(k for k in ref if k[0] == g["audio"])
        assert g.get("chunks", 1) == len(parts)
        texts = [ref[k][0] for k in parts]
        assert g["text"] == " ".join(x for x in texts if x)
        assert g["score"] == pytest.approx(sum(ref[k][1] for k in parts),
                                           rel=1e-4, abs=1e-4)
    assert any(g.get("chunks") == 2 for g in got)


def test_nbest_is_sorted_and_led_by_the_best(workdir, tmp_path):
    d, _, _, files, _ = workdir
    out = tmp_path / "nbest.jsonl"
    TR.main(["--config", CONFIG, "--load-dir", str(d), "--device", "cpu",
             "--nbest", "3", "--out", str(out), str(files[0]), *SMALL])
    rec = json.loads(out.read_text())
    scores = [c["score"] for c in rec["nbest"]]
    assert len(scores) == 3 and scores == sorted(scores, reverse=True)
    assert rec["text"] == rec["nbest"][0]["text"]


def test_init_numpy_fits_the_model_and_repeats(workdir):
    """chip_smoke.py's weights: the model's names and shapes, from a seed."""
    _, cfg, _, _, _ = workdir
    a = weights.init_numpy(cfg.model, seed=0)
    weights.load_flat(Seq2Seq(cfg.model), a)
    b = weights.init_numpy(cfg.model, seed=0)
    c = weights.init_numpy(cfg.model, seed=1)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["speller.w_out"], c["speller.w_out"])
    assert all(v.dtype == np.float32 and np.isfinite(v).all()
               for v in a.values())


@pytest.mark.parametrize("arch", ["transformer", "conformer"])
def test_init_numpy_fits_the_attention_listeners(conformer_workdir, arch):
    """The same for the attention listeners: their LayerNorm gains are
    ones, their biases zeros, the conv stem's kernels glorot over the
    receptive field (fan_in 9*C_in, fan_out 9*C)."""
    _, cfg, _, _, _ = conformer_workdir
    mcfg = dataclasses.replace(cfg.model, encoder_arch=arch)
    a = weights.init_numpy(mcfg, seed=0)
    weights.load_flat(Seq2Seq(mcfg), a)
    b = weights.init_numpy(mcfg, seed=0)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert all(v.dtype == np.float32 and np.isfinite(v).all()
               for v in a.values())
    assert (a["listener.blocks.1.attn.wq"] != 0).all()
    gains = [k for k in a if k.endswith(".g")]
    assert gains and all((a[k] == 1.0).all() for k in gains)
    biases = [k for k in a if k.startswith("listener.")
              and k.rsplit(".", 1)[-1].startswith("b")]
    assert biases and all((a[k] == 0.0).all() for k in biases)
    c = cfg.model.conv_channels
    for i, c_in in enumerate((1, c)):
        w = a[f"listener.conv.{i}.w"]
        bound = np.sqrt(6.0 / (9 * c_in + 9 * c))
        assert w.shape == (3, 3, c_in, c)
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.5 * bound
    if arch == "conformer":
        assert (a["listener.blocks.0.ff1.ln.g"] == 1.0).all()


def test_port_imports_no_jax():
    """Every port module and chip_smoke import with JAX and the JAX package
    blocked by a meta-path finder (the port keeps its own host-side
    copies)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'optax', 'orbax',\n"
        "           'semi_supervised_asr_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import semi_supervised_asr_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "new = ('ops.flash_mhsa', 'models.transformer_listener',\n"
        "       'models.conformer_listener', 'objectives.losses',\n"
        "       'training.train_step', 'data.pipeline', 'data.registry',\n"
        "       'decode.greedy', 'train', 'training.solver',\n"
        "       'training.checkpointing', 'main', 'utils.metrics',\n"
        "       'utils.native_ops', 'utils.error_analysis',\n"
        "       'utils.logging')\n"
        "assert all(P.__name__ + '.' + m in sys.modules for m in new)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in BLOCKED)\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("extra, message", [
    (["--beam", "0"], "CTC"),
    (["--timestamps"], "timestamps"),
    (["--streaming"], "streaming"),
    (["--beam", "1", "--nbest", "2"], "nbest"),
    (["decode.lm_weight=0.3"], "LM fusion"),
    (["decode.ctc_weight=0.3"], "CTC rescoring"),
    (["model.lm_fusion=deep"], "lm_fusion"),
])
def test_cli_refuses_unported_options(workdir, extra, message):
    d, _, _, files, _ = workdir
    with pytest.raises(SystemExit, match=message):
        TR.main(["--config", CONFIG, "--load-dir", str(d), "--device",
                 "cpu", str(files[0]), *SMALL, *extra])


def test_cli_needs_cuda_unless_told_cpu(workdir, monkeypatch):
    d, _, _, files, _ = workdir
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        TR.main(["--config", CONFIG, "--load-dir", str(d), str(files[0]),
                 *SMALL])
