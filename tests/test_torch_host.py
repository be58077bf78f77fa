"""PyTorch port: its own copies of the host-side modules agree with the JAX
package's originals.

The port imports nothing of the JAX package (tests/test_torch_slice.py
checks that in a subprocess), so it carries copies of ``config``, the
vocabularies, the synthetic corpus, bucketing, audio loading, the numpy
frontend oracle and ``collect_files``.  Each copy is held here against its
original: configs load to the same fields for every file in ``configs/``,
and the rest give identical outputs.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

from semi_supervised_asr_tpu import config as JC
from semi_supervised_asr_tpu import transcribe as JTR
from semi_supervised_asr_tpu.data import bucketing as JB
from semi_supervised_asr_tpu.data import corpus as JCO
from semi_supervised_asr_tpu.data import registry as JR
from semi_supervised_asr_tpu.data import synthetic as JSY
from semi_supervised_asr_tpu.data import vocab as JV
from semi_supervised_asr_tpu.ops import frontend_oracle as JO
from semi_supervised_asr_tpu.utils import flac as JFL
from semi_supervised_asr_tpu_torch import config as PC
from semi_supervised_asr_tpu_torch import transcribe as PTR
from semi_supervised_asr_tpu_torch.data import bucketing as PB
from semi_supervised_asr_tpu_torch.data import corpus as PCO
from semi_supervised_asr_tpu_torch.data import registry as PR
from semi_supervised_asr_tpu_torch.data import synthetic as PSY
from semi_supervised_asr_tpu_torch.data import vocab as PV
from semi_supervised_asr_tpu_torch.ops import frontend_oracle as PO

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.yaml"))
OVERRIDES = ["model.enc_hidden=96", "data.frame_buckets=[64,128]",
             "frontend.speed_perturb=[0.9,1.0,1.1]", "train.freeze=[listener]"]


@pytest.mark.parametrize("name", CONFIGS)
def test_load_config_matches_jax(name):
    path = REPO / "configs" / name
    assert (dataclasses.asdict(PC.load_config(path))
            == dataclasses.asdict(JC.load_config(path)))
    assert (dataclasses.asdict(PC.load_config(path, OVERRIDES))
            == dataclasses.asdict(JC.load_config(path, OVERRIDES)))


def test_vocabs_match_jax():
    for got, want in ((PV.timit_vocab(), JV.timit_vocab()),
                      (PV.timit_vocab(fold48=True),
                       JV.timit_vocab(fold48=True)),
                      (PV.char_vocab(), JV.char_vocab())):
        assert (got.tokens, got.unit) == (want.tokens, want.unit)
    cfg = PC.load_config(REPO / "configs" / "timit.yaml")
    assert PR.build_vocab(cfg).tokens == JR.build_vocab(
        JC.load_config(REPO / "configs" / "timit.yaml")).tokens
    with pytest.raises(NotImplementedError, match="data.unit='bpe'"):
        PR.build_vocab(cfg.replace(data=dataclasses.replace(cfg.data,
                                                            unit="bpe")))


@pytest.mark.parametrize("difficulty", [0.0, 0.5])
def test_make_utterance_matches_jax(difficulty):
    pd = dataclasses.replace(PC.DataConfig(), synthetic_difficulty=difficulty,
                             synthetic_grammar=3)
    jd = dataclasses.replace(JC.DataConfig(), synthetic_difficulty=difficulty,
                             synthetic_grammar=3)
    pv, jv = PV.timit_vocab(), JV.timit_vocab()
    for i in range(3):
        got = PSY.make_utterance(i, pv, pd, PC.FrontendConfig())
        want = JSY.make_utterance(i, jv, jd, JC.FrontendConfig())
        np.testing.assert_array_equal(got.audio, want.audio)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert (got.uid, got.text) == (want.uid, want.text)
    ds = PSY.SyntheticDataset(pv, pd, PC.FrontendConfig(), n_utts=4)
    assert [ds.audio_len(i) for i in range(4)] == [len(ds[i].audio)
                                                   for i in range(4)]


def test_bucketing_matches_jax():
    kw = dict(frame_buckets=(100, 200, 401), token_buckets=(48, 12),
              audio_i16_transfer=True)
    got = PB.make_bucket_spec(dataclasses.replace(PC.DataConfig(), **kw),
                              PC.FrontendConfig(), 8)
    want = JB.make_bucket_spec(dataclasses.replace(JC.DataConfig(), **kw),
                               JC.FrontendConfig(), 8)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    rng = np.random.default_rng(0)
    lengths = [(int(s), int(u)) for s, u in zip(
        rng.integers(100, 7000, 40), rng.integers(1, 50, 40))]
    assert (PB.plan_epoch(lengths, got, 4, seed=3, epoch=1,
                          drop_remainder=False)
            == JB.plan_epoch(lengths, want, 4, seed=3, epoch=1,
                             drop_remainder=False))


def test_frontend_oracle_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(3000) * 0.1
    for pc, jc in ((PC.FrontendConfig(), JC.FrontendConfig()),
                   (PC.FrontendConfig(center=False, mel_scale="htk"),
                    JC.FrontendConfig(center=False, mel_scale="htk"))):
        np.testing.assert_array_equal(PO.padded_window(pc),
                                      JO.padded_window(jc))
        np.testing.assert_array_equal(
            PO.mel_filterbank(80, 512, 16000, 20.0, 7600.0, "slaney"),
            JO.mel_filterbank(80, 512, 16000, 20.0, 7600.0, "slaney"))
        lm = PO.log_mel(x, pc)
        np.testing.assert_array_equal(lm, JO.log_mel(x, jc))
        for a, b in zip(PO.cmvn_stats(lm), JO.cmvn_stats(lm)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(PO.pad_for_batch(x, 4000, pc),
                                      JO.pad_for_batch(x, 4000, jc))


def test_audio_loading_and_collect_files_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    pcm = rng.integers(-3000, 3000, 1600).astype(np.int16)
    wavfile.write(tmp_path / "a.wav", 16000, pcm)
    np.save(tmp_path / "b.npy", rng.standard_normal(800).astype(np.float32))
    (tmp_path / "sub").mkdir()
    wavfile.write(tmp_path / "sub" / "c.WAV", 16000, pcm[:700])
    JFL.write_flac_verbatim(tmp_path / "sub" / "d.flac", pcm[:900])
    (tmp_path / "notes.txt").write_text("not audio")
    files = PTR.collect_files([str(tmp_path)])
    assert files == JTR.collect_files([str(tmp_path)])
    assert [f.name for f in files] == ["a.wav", "b.npy", "c.WAV", "d.flac"]
    for f in files:
        for i16 in (False, True):
            got = PCO.load_audio(f, prefer_i16=i16)
            want = JCO.load_audio(f, prefer_i16=i16)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    manifest = tmp_path / "train.jsonl"
    manifest.write_text('{"uid": "a", "audio": "a.wav", "n_samples": 1600, '
                        '"text": "aa b"}\n')
    got = PCO.ManifestDataset(manifest, PV.timit_vocab())[0]
    want = JCO.ManifestDataset(manifest, JV.timit_vocab())[0]
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.audio, want.audio)
