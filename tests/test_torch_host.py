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
import itertools
import json
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

from semi_supervised_asr_tpu import config as JC
from semi_supervised_asr_tpu import transcribe as JTR
from semi_supervised_asr_tpu.data import bucketing as JB
from semi_supervised_asr_tpu.data import corpus as JCO
from semi_supervised_asr_tpu.data import pipeline as JP
from semi_supervised_asr_tpu.data import registry as JR
from semi_supervised_asr_tpu.data import synthetic as JSY
from semi_supervised_asr_tpu.data import vocab as JV
from semi_supervised_asr_tpu.ops import frontend_oracle as JO
from semi_supervised_asr_tpu.utils import error_analysis as JEA
from semi_supervised_asr_tpu.utils import flac as JFL
from semi_supervised_asr_tpu.utils import metrics as JM
from semi_supervised_asr_tpu.utils import native_ops as JN
from semi_supervised_asr_tpu_torch import config as PC
from semi_supervised_asr_tpu_torch import transcribe as PTR
from semi_supervised_asr_tpu_torch.data import bucketing as PB
from semi_supervised_asr_tpu_torch.data import corpus as PCO
from semi_supervised_asr_tpu_torch.data import pipeline as PP
from semi_supervised_asr_tpu_torch.data import registry as PR
from semi_supervised_asr_tpu_torch.data import synthetic as PSY
from semi_supervised_asr_tpu_torch.data import vocab as PV
from semi_supervised_asr_tpu_torch.ops import frontend_oracle as PO
from semi_supervised_asr_tpu_torch.utils import error_analysis as PEA
from semi_supervised_asr_tpu_torch.utils import logging as PL
from semi_supervised_asr_tpu_torch.utils import metrics as PM
from semi_supervised_asr_tpu_torch.utils import native_ops as PN

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
    # data.unit=bpe: the merge-free default, and a trained model's file
    bpe = cfg.replace(data=dataclasses.replace(cfg.data, unit="bpe",
                                               bpe_path=""))
    jbpe = JC.load_config(REPO / "configs" / "timit.yaml",
                          ["data.unit=bpe", "data.bpe_path="])
    got, want = PR.build_vocab(bpe), JR.build_vocab(jbpe)
    assert (got.tokens, got.merges, got.unit) == (want.tokens, want.merges,
                                                  want.unit)


def bpe_texts(seed: int, n: int = 60) -> list[str]:
    """Sentences of random words over a small alphabet, so that pairs
    repeat and ties on count occur."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdeilnorst'"))
    words = ["".join(rng.choice(letters, rng.integers(1, 7)))
             for _ in range(40)]
    return [" ".join(rng.choice(words, rng.integers(3, 12)))
            for _ in range(n)]


@pytest.mark.parametrize("size", [30, 80, 1000])
def test_bpe_matches_jax(size, tmp_path):
    """train_bpe's pieces and merges, encode_text / decode_text, save /
    load and the registry's bpe branch are the JAX package's; 1000 asks
    for more merges than the texts hold, so training stops where no pair
    repeats."""
    from semi_supervised_asr_tpu.data import bpe as JBPE
    from semi_supervised_asr_tpu_torch.data import bpe as PBPE

    texts = bpe_texts(size)
    got, want = PBPE.train_bpe(texts, size), JBPE.train_bpe(texts, size)
    assert (got.tokens, got.merges) == (want.tokens, want.merges)
    assert got.size == want.size <= size
    probe = texts[:5] + ["unseen zzz words", "Mixed CASE text"]
    for text in probe:
        ids = got.encode_text(text, add_sos_eos=True)
        assert ids == want.encode_text(text, add_sos_eos=True)
        assert got.decode_text(ids) == want.decode_text(ids)
        assert got.decode(ids, False) == want.decode(ids, False)
    got.save(tmp_path / "p.json")
    want.save(tmp_path / "j.json")
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json"
                                                 ).read_text()
    loaded = PBPE.BPEVocab.load(tmp_path / "j.json")
    assert (loaded.tokens, loaded.merges) == (want.tokens, want.merges)
    over = ["data.unit=bpe", f"data.bpe_path={tmp_path / 'p.json'}"]
    path = REPO / "configs" / "ls100_bpe.yaml"
    assert PR.build_vocab(PC.load_config(path, over)).tokens == \
        JR.build_vocab(JC.load_config(path, over)).tokens


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


def test_read_manifest_matches_jax(tmp_path):
    """``align.py``'s copy of the reference's ``selftrain.read_manifest``:
    JSON lines, blank lines skipped."""
    from semi_supervised_asr_tpu.selftrain import read_manifest as jax_read
    from semi_supervised_asr_tpu_torch.align import read_manifest

    m = tmp_path / "m.jsonl"
    m.write_text('{"uid": "a", "audio": "a.wav", "text": "x y"}\n\n'
                 '  {"uid": "b", "audio": "/b.flac", "text": ""}  \n')
    assert read_manifest(m) == jax_read(m) == [
        {"uid": "a", "audio": "a.wav", "text": "x y"},
        {"uid": "b", "audio": "/b.flac", "text": ""}]


def semi_configs(tmp_path=None):
    """configs/ls100_semi.yaml on the synthetic corpus, or, given a
    directory, on manifests there -- for the port and for JAX."""
    extra = (["data.num_synthetic_utts=6", "data.dataset=synthetic"]
             if tmp_path is None else [f"data.data_dir={tmp_path}"])
    path = REPO / "configs" / "ls100_semi.yaml"
    return PC.load_config(path, extra), JC.load_config(path, extra)


def test_unlabeled_sets_match_jax(tmp_path):
    """The registry's unlabeled audio and text: synthetic (seed + 2 and
    + 3) and from the manifests of the configured splits."""
    pc, jc = semi_configs()
    got, want = PR.build_datasets(pc), JR.build_datasets(jc)
    for name in ("unlabeled_audio", "unlabeled_text"):
        g, w = getattr(got, name), getattr(want, name)
        assert (len(g), g.labeled, g.cfg.synthetic_seed) == (
            len(w), w.labeled, w.cfg.synthetic_seed)
        for i in range(3):
            np.testing.assert_array_equal(g[i].audio, w[i].audio)
            np.testing.assert_array_equal(g[i].tokens, w[i].tokens)
    rng = np.random.default_rng(3)
    for split, text in (("train-clean-100", "ab c"),
                        ("train-clean-360", "de f"), ("dev", "g")):
        wavfile.write(tmp_path / f"{split}.wav", 16000,
                      rng.integers(-3000, 3000, 1600).astype(np.int16))
        (tmp_path / f"{split}.jsonl").write_text(
            f'{{"uid": "{split}", "audio": "{split}.wav", '
            f'"n_samples": 1600, "text": "{text}"}}\n')
    pc, jc = semi_configs(tmp_path)
    got, want = PR.build_datasets(pc), JR.build_datasets(jc)
    for name in ("train", "unlabeled_audio", "unlabeled_text"):
        g, w = getattr(got, name)[0], getattr(want, name)[0]
        np.testing.assert_array_equal(g.audio, w.audio)
        np.testing.assert_array_equal(g.tokens, w.tokens)
    assert got.unlabeled_audio[0].uid == "train-clean-360"


def test_unlabeled_streams_match_jax():
    """The first batches of the unlabeled audio stream (the largest
    frame and token bucket, no dropped remainder, train.seed + 1) and of
    the text stream (the largest token bucket, train.seed + 2), array for
    array, across an epoch boundary; the text stream resumed by
    ``skip_batches``; both sharded as JAX's: a rank's rows of every global
    batch (``row_shard``) and every n-th batch (``shard_index``)."""
    pc, jc = semi_configs()
    pspec = PB.make_bucket_spec(dataclasses.replace(
        pc.data, frame_buckets=(1600,), token_buckets=(256,)),
        pc.frontend, 8)
    jspec = JB.make_bucket_spec(dataclasses.replace(
        jc.data, frame_buckets=(1600,), token_buckets=(256,)),
        jc.frontend, 8)
    pset = PR.build_datasets(pc).unlabeled_audio
    jset = JR.build_datasets(jc).unlabeled_audio
    got = PP.repeating_batches(pset, pspec, pc.frontend, 4, 1,
                               drop_remainder=False)
    want = JP.repeating_batches(jset, jspec, jc.frontend, 4, 1,
                                drop_remainder=False)
    for g, w in zip(got, itertools.islice(want, 4)):
        for f in ("audio", "audio_lens", "tokens", "real"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert g.bucket == w.bucket == (1600, 256)
    ptext = PR.build_datasets(pc).unlabeled_text
    jtext = JR.build_datasets(jc).unlabeled_text
    for (gt, gr), (wt, wr) in zip(
            PP.text_batches(ptext, 256, 4, 2),
            itertools.islice(JP.text_batches(jtext, 256, 4, 2), 4)):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gr, wr)
    # a resumed stream skips at plan cost
    gt, gr = next(PP.text_batches(ptext, 256, 4, 2, skip_batches=3))
    wt, wr = next(JP.text_batches(jtext, 256, 4, 2, skip_batches=3))
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gr, wr)
    # sharded: rank 1 of 2 by rows, and the second of two plan shards,
    # each resumed past a batch
    for kw in ({"row_shard": (1, 2, 2)},
               {"shard_index": 1, "num_shards": 2}):
        got = PP.repeating_batches(pset, pspec, pc.frontend, 4, 1,
                                   drop_remainder=False, skip_batches=1,
                                   **kw)
        want = JP.repeating_batches(jset, jspec, jc.frontend, 4, 1,
                                    drop_remainder=False, skip_batches=1,
                                    **kw)
        for g, w in zip(got, itertools.islice(want, 2)):
            for f in ("audio", "audio_lens", "tokens", "real"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        for (gt, gr), (wt, wr) in zip(
                PP.text_batches(ptext, 256, 4, 2, skip_batches=1, **kw),
                itertools.islice(JP.text_batches(jtext, 256, 4, 2,
                                                 skip_batches=1, **kw), 2)):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gr, wr)


def random_rows(rng, b, u, vocab_size):
    """[b, u] ids with EOS / PAD cut at random places, and ragged lengths."""
    x = rng.integers(0, vocab_size, (b, u)).astype(np.int32)
    for r in range(b):
        cut = rng.integers(0, u + 1)
        if cut < u:
            x[r, cut] = rng.choice([2, 0])
    return x, rng.integers(0, u + 1, b).astype(np.int32)


def test_edit_distance_and_metrics_match_jax():
    """The native edit distance (and its plain numpy version) against the
    JAX package's, with and without a fold table; PER with the TIMIT
    39-fold, CER, WER and hypothesis lengths: identical counts."""
    rng = np.random.default_rng(7)
    vocab = PV.timit_vocab()
    table = np.asarray(PV.timit_39_id_map(vocab), np.int32)
    for b, uh, ur in ((1, 1, 1), (9, 17, 12), (33, 40, 40)):
        hyps, hl = random_rows(rng, b, uh, vocab.size)
        refs, rl = random_rows(rng, b, ur, vocab.size)
        for t in (None, table):
            want = JN.batch_edit_distance(hyps, hl, refs, rl, t)
            for got in (PN.batch_edit_distance(hyps, hl, refs, rl, t),
                        PN.batch_edit_distance_py(hyps, hl, refs, rl, t)):
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and np.array_equal(g, w)
        np.testing.assert_array_equal(PM.hyp_lengths(hyps),
                                      JM.hyp_lengths(hyps))
        for g, w in zip(PM.per_batch(hyps, refs, vocab),
                        JM.per_batch(hyps, refs, JV.timit_vocab())):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(PM.cer_batch(hyps, refs), JM.cer_batch(hyps, refs)):
            np.testing.assert_array_equal(g, w)
    chars, jchars = PV.char_vocab(), JV.char_vocab()
    hyps, _ = random_rows(rng, 6, 30, chars.size)
    refs, _ = random_rows(rng, 6, 30, chars.size)
    assert PM.wer_batch(hyps, refs, chars) == JM.wer_batch(hyps, refs,
                                                            jchars)
    for h, r in (("a b c", "a c"), ("", "x y"), ("x", ""), ("", "")):
        assert PM.wer_strings(h, r) == JM.wer_strings(h, r)
    e = PM.ErrorRate()
    e.update(np.array([1, 2]), np.array([3, 4]))
    assert (e.errors, e.total, e.rate) == (3, 7, 3 / 7)


def test_error_analysis_matches_jax():
    """analyze_records and summary_line on phone records (the 39-fold)
    and on char records (words)."""
    rng = np.random.default_rng(3)
    vocab, jvocab = PV.timit_vocab(), JV.timit_vocab()
    phones = vocab.tokens[4:]
    words = ["the", "cat", "sat", "on", "a", "mat", "q"]

    def records(units):
        out = []
        for i in range(12):
            ref = list(rng.choice(units, rng.integers(1, 9)))
            hyp = list(rng.choice(units, rng.integers(0, 9)))
            out.append({"uid": f"u{i}", "ref": " ".join(ref),
                        "hyp": " ".join(hyp), "errors": int(rng.integers(9)),
                        "ref_len": len(ref)})
        return out

    for recs, unit, pv, jv in ((records(phones), "phone", vocab, jvocab),
                               (records(words), "char", None, None)):
        got = PEA.analyze_records(recs, pv, unit)
        assert got == JEA.analyze_records(recs, jv, unit)
        assert PEA.summary_line(got) == JEA.summary_line(got)


def test_dev_and_test_splits_match_jax(tmp_path, capsys):
    """The registry's dev split (synthetic: seed + 1, max(n // 4, 4)
    utterances; manifests: dev.jsonl) and data.test_split, with the
    warning when its manifest is missing."""
    for n in (6, 40):
        extra = ["data.dataset=synthetic", f"data.num_synthetic_utts={n}"]
        path = REPO / "configs" / "timit.yaml"
        got = PR.build_datasets(PC.load_config(path, extra))
        want = JR.build_datasets(JC.load_config(path, extra))
        assert len(got.dev) == len(want.dev) == max(n // 4, 4)
        assert got.test is None and want.test is None
        for i in (0, len(got.dev) - 1):
            assert got.dev[i].uid == want.dev[i].uid
            np.testing.assert_array_equal(got.dev[i].audio, want.dev[i].audio)
            np.testing.assert_array_equal(got.dev[i].tokens,
                                          want.dev[i].tokens)
    rng = np.random.default_rng(5)
    for split, text in (("train-clean-100", "ab c"), ("dev", "d e"),
                        ("test-clean", "f")):
        wavfile.write(tmp_path / f"{split}.wav", 16000,
                      rng.integers(-3000, 3000, 1600).astype(np.int16))
        (tmp_path / f"{split}.jsonl").write_text(
            f'{{"uid": "{split}", "audio": "{split}.wav", '
            f'"n_samples": 1600, "text": "{text}"}}\n')
    path = REPO / "configs" / "ls100_semi.yaml"
    for test_split in ("test-clean", "test-other"):
        extra = [f"data.data_dir={tmp_path}", "data.unlabeled_audio_split=",
                 "data.unlabeled_text_split=",
                 f"data.test_split={test_split}"]
        got = PR.build_datasets(PC.load_config(path, extra))
        want_out = capsys.readouterr().out
        want = JR.build_datasets(JC.load_config(path, extra))
        assert capsys.readouterr().out == want_out
        assert got.dev[0].uid == want.dev[0].uid == "dev"
        np.testing.assert_array_equal(got.dev[0].audio, want.dev[0].audio)
        if test_split == "test-clean":
            assert got.test[0].uid == want.test[0].uid == "test-clean"
        else:
            assert got.test is None and want.test is None
            assert "test-other" in want_out and "WARNING" in want_out


def test_metrics_logger_writes_the_reference_records(tmp_path):
    """One JSON line a record with step, time, prefix and the scalars as
    floats (strings kept), as the JAX package's MetricsLogger writes."""
    log = PL.MetricsLogger(tmp_path, use_tensorboard=False)
    log.log(3, {"loss": np.float32(1.5), "n": 2, "tag": "x"}, "dev")
    log.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert set(rec) == {"step", "time", "prefix", "loss", "n", "tag"}
    assert (rec["step"], rec["prefix"], rec["loss"], rec["n"], rec["tag"]
            ) == (3, "dev", 1.5, 2.0, "x")


def _corpus_trees(root: Path) -> None:
    """Tiny TIMIT and LibriSpeech trees, written with the port's FLAC
    encoder: TIMIT holds a RIFF WAV, a NIST SPHERE .WAV, a dialect
    sentence (skipped) and a FLAC (not a TIMIT extension: ignored);
    LibriSpeech one speaker with a WAV and a FLAC utterance, and a
    transcript line without audio (skipped)."""
    from semi_supervised_asr_tpu_torch.utils.flac import write_flac_verbatim
    from tests.test_sphere import write_sphere

    rng = np.random.default_rng(4)

    def pcm(n):
        return rng.integers(-3000, 3000, n).astype(np.int16)

    spk = root / "timit" / "TRAIN" / "DR1" / "FAKS0"
    spk.mkdir(parents=True)
    wavfile.write(spk / "SI943.WAV", 16000, pcm(1200))
    write_sphere(spk / "SX13.WAV", pcm(900))
    wavfile.write(spk / "SA1.WAV", 16000, pcm(300))
    write_flac_verbatim(spk / "SX99.flac", pcm(500))
    for stem, phones in (("SI943", "h# sh iy hh ae dcl h#"),
                         ("SX13", "h# dh ax h#"), ("SA1", "h# aa h#"),
                         ("SX99", "h# iy h#")):
        (spk / f"{stem}.PHN").write_text("".join(
            f"{i * 100} {i * 100 + 100} {p}\n"
            for i, p in enumerate(phones.split())))
    for split in ("train-clean-100", "dev-clean"):
        d = root / "ls" / split / "19" / "198"
        d.mkdir(parents=True)
        wavfile.write(d / "19-198-0000.wav", 16000, pcm(1500))
        write_flac_verbatim(d / "19-198-0001.flac", pcm(2100))
        (d / "19-198.trans.txt").write_text(
            "19-198-0000 THE CAT SAT ON THE MAT\n"
            "19-198-0001 A CAT AND A HAT\n19-198-0002 NO AUDIO HERE\n")


@pytest.mark.parametrize("corpus, argv", [
    ("timit", ["--splits", "TRAIN"]),
    ("timit", ["--splits", "train", "--fold48"]),
    ("librispeech", ["--bpe", "40"]),
])
def test_preprocess_matches_jax(corpus, argv, tmp_path, capsys):
    """The port's corpus CLI writes the reference's manifests, vocab.json
    and bpe.json byte for byte."""
    from semi_supervised_asr_tpu.data import preprocess as JPRE
    from semi_supervised_asr_tpu_torch.data import preprocess as PPRE

    _corpus_trees(tmp_path)
    root = tmp_path / ("timit" if corpus == "timit" else "ls")
    outs = {}
    for name, mod in (("jax", JPRE), ("port", PPRE)):
        out = tmp_path / f"out_{name}"
        assert mod.main([corpus, "--root", str(root), "--out", str(out),
                         *argv]) == 0
        outs[name] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert outs["port"] == outs["jax"]
    names = set(outs["port"])
    assert "vocab.json" in names
    assert ("bpe.json" in names) == ("--bpe" in argv)
    manifest = [json.loads(line) for name in sorted(names - {"vocab.json",
                                                             "bpe.json"})
                for line in outs["port"][name].decode().splitlines()]
    assert len(manifest) == (2 if corpus == "timit" else 4)
    assert all(e["n_samples"] > 0 for e in manifest)
    with pytest.raises(SystemExit, match="h5py"):
        PPRE.main([corpus, "--root", str(root), "--out",
                   str(tmp_path / "f"), "--features"])
