"""PyTorch port parity: exact chunked streaming (``decode/streaming.py``).

The same seeded numpy weights (``weights.init_numpy``, carried into the JAX
tree by name) and inputs go through the JAX package and the port, at tiny
widths: a forward-only listener of 1 + 2 layers at H 8, and the
chunk-causal conformer of 2 blocks of d_model 16, chunks of 4 encoder
frames with 1 left chunk and a 1-block stem; a predictor and joint of 16,
float32.

* K2's plain twin resumes from a carried (h, c): a scan split in two
  equals the whole scan bitwise (outputs and final state, float32 and
  bfloat16), and ``lstm_kernel(h0=, c0=, return_state=True)`` equals JAX's
  ``recurrent.lstm`` to 1e-5; autograd refuses a carried state;
* the streaming listener chunk by chunk equals the offline listener to the
  reference's ulp-scale bound and JAX's ``listener_apply_stream`` to 1e-5;
* the decoders' carries (transducer greedy and beam, CTC best path and
  prefix beam, and the greedy walks with ``track_frames``): two chunks
  equal the whole walk in the port, bitwise, and JAX's carried decode
  (equal tokens and emission frames, scores to rtol 1e-4, the tolerance of
  tests/test_streaming_decode.py);
* ``StreamingTranscriber`` fed in odd pieces: the tokens of the port's
  offline decode and of JAX's ``StreamingTranscriber``, scores to rtol
  1e-4, for both recipes' listeners, greedy and beam; for the CTC family
  (best path and prefix beam) the offline decode's; greedy streams'
  ``emission_frames`` equal the offline walk's and JAX's;
* ``MultiStreamTranscriber`` (staggered feeds, a slot reused) equals single
  streams, and a round leaves inactive rows bitwise untouched;
* ``transcribe --streaming`` (``--streams 1`` and ``2``) gives the offline
  CLI's texts on a tiny ``ls100_transducer_streaming``;
* the streaming refusals are the reference's, message for message.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.config import Config as JConfig
from semi_supervised_asr_tpu.config import FrontendConfig as JFrontend
from semi_supervised_asr_tpu.config import ModelConfig as JModelConfig
from semi_supervised_asr_tpu.decode import ctc as JCTC
from semi_supervised_asr_tpu.decode import ctc_beam as JCB
from semi_supervised_asr_tpu.decode import streaming as JS
from semi_supervised_asr_tpu.decode import transducer_beam as JTB
from semi_supervised_asr_tpu.decode import transducer_greedy as JTG
from semi_supervised_asr_tpu.models import listener as JL
from semi_supervised_asr_tpu.ops import recurrent as JR
from semi_supervised_asr_tpu_torch import synthetic, weights
from semi_supervised_asr_tpu_torch import transcribe as TR
from semi_supervised_asr_tpu_torch.config import (
    Config, DataConfig, FrontendConfig, ModelConfig, load_config,
)
from semi_supervised_asr_tpu_torch.data.registry import build_vocab
from semi_supervised_asr_tpu_torch.data.synthetic import make_utterance
from semi_supervised_asr_tpu_torch.decode import ctc as CTC
from semi_supervised_asr_tpu_torch.decode import streaming as S
from semi_supervised_asr_tpu_torch.decode.ctc_beam import ctc_beam_from_enc
from semi_supervised_asr_tpu_torch.decode.transducer_beam import (
    transducer_beam_from_enc,
)
from semi_supervised_asr_tpu_torch.decode.transducer_greedy import (
    transducer_greedy_from_enc,
)
from semi_supervised_asr_tpu_torch.models import listener as L
from semi_supervised_asr_tpu_torch.models.seq2seq import build_model
from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
from semi_supervised_asr_tpu_torch.training.train_step import featurize
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    FAST_XLA, one_thread, run_jax,
)

MAX_U = 24
SCORE = dict(rtol=1e-4, atol=1e-4)
HEAD = dict(n_mels=80, vocab_size=10, pred_hidden=16, pred_layers=1,
            joint_dim=16, embed_dim=8, compute_dtype="float32")
KINDS = {
    # the streaming recipe's listener: forward-only, 1 + 2 layers of 8
    "blstm": dict(family="transducer", enc_bidirectional=False,
                  enc_hidden=8, enc_base_layers=1, enc_layers=2),
    # the chunk-causal conformer behind a 1-block causal stem
    "conformer": dict(family="transducer", encoder_arch="conformer",
                      enc_hidden=8, enc_heads=2, enc_ff_dim=32,
                      enc_blocks=2, conformer_conv_width=5,
                      conv_subsample=1, conv_channels=4, enc_attn_chunk=4,
                      enc_attn_left_chunks=1),
    "ctc": dict(family="ctc", enc_bidirectional=False, enc_hidden=8,
                enc_base_layers=1, enc_layers=2),
}
FRONT = dict(center=False, cmvn="global", spec_augment=False)
CMVN = (np.zeros(80, np.float32), np.ones(80, np.float32))


def configs(kind: str, **over):
    kw = {**HEAD, **KINDS[kind], **over}
    return (Config(frontend=FrontendConfig(**FRONT), model=ModelConfig(**kw)),
            JConfig(frontend=JFrontend(**FRONT), model=JModelConfig(**kw)))


# the weights' seed of each kind: random weights that emit more than one
# label on the test utterance (most seeds repeat one label or emit none)
SEEDS = {"blstm": 2, "conformer": 0, "ctc": 1}


@pytest.fixture(scope="module")
def models():
    """kind -> (port config, JAX config, port model, JAX tree)."""
    out = {}
    for kind, seed in SEEDS.items():
        cfg, jcfg = configs(kind)
        flat = weights.init_numpy(cfg.model, seed)
        model = build_model(cfg.model).eval()
        weights.load_flat(model, flat)
        out[kind] = (cfg, jcfg, model, jax.tree.map(
            jnp.asarray, weights.unflatten_tree(flat)))
    return out


def audio(n: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 0.1
            ).astype(np.float32)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_k2_twin_resumes_from_a_carried_state(compute):
    g = torch.Generator().manual_seed(0)
    d, t, b, h = 2, 11, 3, 8
    gx = torch.randn((d, t, b, 4 * h), generator=g)
    w = torch.randn((d, h, 4 * h), generator=g) * 0.3
    valid = (torch.arange(t)[:, None] < torch.tensor([11, 6, 0])).float()
    rev = (False, False)
    whole, (hf, cf) = K.lstm_scan(gx, w, valid, compute, rev,
                                  return_state=True)
    a, (h1, c1) = K.lstm_scan(gx[:, :4], w, valid[:4], compute, rev,
                              return_state=True)
    bb, (h2, c2) = K.lstm_scan(gx[:, 4:], w, valid[4:], compute, rev,
                               h0=h1, c0=c1, return_state=True)
    assert torch.equal(torch.cat([a, bb], dim=1), whole)
    assert torch.equal(h2, hf) and torch.equal(c2, cf)
    # no state: the scan is the one without these arguments
    assert torch.equal(K.lstm_scan(gx, w, valid, compute, rev), whole)
    # the layer against JAX's recurrent.lstm with h0 / c0 / return_state
    x = torch.randn((b, t, 5), generator=g)
    params = {"w_ih": torch.randn((5, 4 * h), generator=g) * 0.3,
              "w_hh": w[0], "b": torch.randn((4 * h,), generator=g) * 0.1}
    lens = torch.tensor([11, 6, 0], dtype=torch.int32)
    ys, (hn, cn) = K.lstm_kernel(params, x, lens, False, compute,
                                 h0=hf[0], c0=cf[0], return_state=True)
    want, (wh, wc) = run_jax(
        lambda p, xx, ll, h0, c0: JR.lstm(
            p, xx, ll, False, jnp.dtype(str(compute).split(".")[-1]),
            h0=h0, c0=c0, return_state=True),
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        jnp.asarray(x.numpy()), jnp.asarray(lens.numpy()),
        jnp.asarray(hf[0].numpy()), jnp.asarray(cf[0].numpy()))
    tol = 1e-5 if compute == torch.float32 else 2e-3
    for got, ref in ((ys, want), (hn, wh), (cn, wc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol,
                                   atol=tol)
    with pytest.raises(ValueError, match="without autograd"):
        K.lstm_scan(gx.requires_grad_(), w, valid, compute, rev, h0=h1,
                    c0=c1)


def test_streaming_listener_matches_offline_and_jax(models):
    """Chunks of 8 feature frames (the 4x pyramid's alignment: whole
    output frames), a final partial chunk masked by its length."""
    cfg, jcfg, model, tree = models["blstm"]
    n_valid, tc = 45, 8
    x = np.zeros((1, 48, 80), np.float32)
    x[:, :n_valid] = np.random.default_rng(3).standard_normal((1, n_valid,
                                                                80))
    with torch.no_grad():
        off, lens = model.listener(torch.from_numpy(x),
                                   torch.tensor([n_valid]))
    st = L.listener_stream_init(cfg.model, 1, "cpu")
    jst = JL.listener_stream_init(jcfg.model, 1)
    step = jax.jit(lambda p, f, s, fl: JL.listener_apply_stream(
        p, f, jcfg.model, s, frame_lens=fl), compiler_options=FAST_XLA)
    outs, jouts = [], []
    for i in range(0, 48, tc):
        n = min(tc, n_valid - i)
        o, st = L.listener_apply_stream(
            model.listener, torch.from_numpy(x[:, i:i + tc]), st,
            torch.tensor([n]) if n < tc else None)
        jo, jst = step(tree["listener"], x[:, i:i + tc], jst,
                       jnp.asarray([n]))
        outs.append(o.numpy())
        jouts.append(np.asarray(jo))
    got = np.concatenate(outs, axis=1)
    off = off.numpy()
    assert got.shape == off.shape and int(lens[0]) == 12
    assert np.abs(got - off).max() <= 1e-5 * max(np.abs(off).max(), 1.0)
    np.testing.assert_allclose(got, np.concatenate(jouts, axis=1), rtol=1e-5,
                               atol=1e-5)
    for (hh, cc), (jh, jc) in zip(st, jst):
        np.testing.assert_allclose(hh.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(cc.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("decoder", ["transducer_greedy", "transducer_beam",
                                     "ctc_greedy", "ctc_beam",
                                     "transducer_greedy_frames",
                                     "ctc_greedy_frames"])
def test_decoder_carries_match_whole_walk_and_jax(models, decoder):
    """Two chunks of 6 frames through the carry: the port's whole walk
    bitwise, JAX's carried decode (tokens, scores to 1e-4); the greedy
    walks also with ``track_frames`` (each chunk's ``frame_base`` its first
    frame): the emission frames equal the whole walk's and JAX's."""
    kind = "ctc" if decoder.startswith("ctc") else "blstm"
    frames = decoder.endswith("_frames")
    cfg, jcfg, model, tree = models[kind]
    m = cfg.model
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((2, 12, m.enc_out_dim)).astype(np.float32)
    mask = np.arange(12)[None, :] < np.array([[12], [9]])
    et, mt = torch.from_numpy(enc), torch.from_numpy(mask)
    halves = ((slice(0, 6)), slice(6, 12))
    with torch.inference_mode():
        if decoder.startswith("transducer_greedy"):
            def port(e, k, c, base):
                return transducer_greedy_from_enc(
                    model, m, e, k, MAX_U, 2, carry=c, return_carry=True,
                    track_frames=frames, frame_base=base)[2]
            carry0 = None
            jcarry0 = JTG.transducer_greedy_init(tree, jcfg.model, 2, MAX_U,
                                                 track_frames=frames)

            def jdec(p, e, k, c, base):
                return JTG.transducer_greedy_from_enc(
                    p, jcfg.model, e, k, MAX_U, 2, carry=c,
                    return_carry=True, track_frames=frames,
                    frame_base=base)[2]
        elif decoder == "transducer_beam":
            def port(e, k, c, base):
                return transducer_beam_from_enc(
                    model, m, e, k, MAX_U, 3, 2, carry=c,
                    return_carry=True)[2]
            carry0 = jcarry0 = None

            def jdec(p, e, k, c, base):
                return JTB.transducer_beam_from_enc(
                    p, jcfg.model, e, k, MAX_U, beam_size=3, max_symbols=2,
                    carry=c, return_carry=True)[2]
        elif decoder.startswith("ctc_greedy"):
            def port(e, k, c, base):
                return CTC.ctc_greedy_stream(model.ctc, e, k, MAX_U, c, base)
            carry0 = CTC.ctc_greedy_stream_init(2, MAX_U, "cpu", frames)
            jcarry0 = JCTC.ctc_greedy_stream_init(2, MAX_U,
                                                  track_frames=frames)

            def jdec(p, e, k, c, base):
                return JCTC.ctc_greedy_stream(p["ctc"], e, k, MAX_U, c,
                                              frame_base=base)
        else:
            def port(e, k, c, base):
                return ctc_beam_from_enc(model.ctc, e, k, MAX_U, 3, carry=c,
                                         return_carry=True)[2]
            carry0 = jcarry0 = None

            def jdec(p, e, k, c, base):
                return JCB.ctc_beam_from_enc(
                    p["ctc"], e, k, MAX_U, beam_size=3, carry=c,
                    return_carry=True)[2]
        whole = port(et, mt, carry0, 0)
        got = carry0
        for h in halves:
            got = port(et[:, h], mt[:, h], got, h.start)
    assert all(torch.equal(a, b) for a, b in zip(S.tree_leaves(got),
                                                 S.tree_leaves(whole)))
    # JAX's carried decode, compiled once for each carry structure (the
    # beams build theirs on the first chunk)
    jgot, compiled = jcarry0, {}
    for h in halves:
        args = (tree, enc[:, h], mask[:, h], jgot, h.start)
        if (jgot is None) not in compiled:
            compiled[jgot is None] = jax.jit(jdec).lower(*args).compile(
                compiler_options=FAST_XLA)
        jgot = compiled[jgot is None](*args)
    beam = decoder.endswith("beam")
    for row in range(2):
        toks, score = S._best_hyp(got, row, ctc=kind == "ctc",
                                  beam_size=3 if beam else 1)
        jtoks, jscore = JS._best_hyp(jgot, row, ctc=kind == "ctc",
                                     beam_size=3 if beam else 1,
                                     lm_weight=0.0, bias=None)
        assert toks == jtoks and len(toks) > 0, (row, toks, jtoks)
        np.testing.assert_allclose(score, jscore, **SCORE)
    if frames:
        # the carries' frame slots: -1 past each row's count
        np.testing.assert_array_equal(got[-1].numpy(), np.asarray(jgot[-1]))
        n = int(got[-3][0])            # the count, in both carries
        assert (got[-1][0, :n] >= 6).any() and (got[-1][0, n:] == -1).all()


def offline_decode(model, cfg, wav, beam_size):
    """The port's offline decode of ``wav`` padded to the streaming
    chunk grid, as any bucketed batch pads it -> (tokens, score, the
    greedy walk's emission frames or None for the beams)."""
    m, f = cfg.model, cfg.frontend
    c = m.enc_attn_chunk * m.time_reduction if m.enc_attn_chunk \
        else m.time_reduction
    n_frames = 1 + (len(wav) - f.n_fft) // f.hop_length
    need = (-(-n_frames // c) * c - 1) * f.hop_length + f.n_fft
    a = np.zeros((need,), np.float32)
    a[:len(wav)] = wav
    with torch.inference_mode():
        feats, flens = featurize(cfg, torch.from_numpy(a)[None],
                                 torch.tensor([len(wav)]),
                                 tuple(torch.from_numpy(x) for x in CMVN))
        enc, mask = model.encode(feats, flens)
        frames = None
        if m.family == "ctc":
            if beam_size > 1:
                toks, score = ctc_beam_from_enc(model.ctc, enc, mask, MAX_U,
                                                beam_size)
            else:
                toks, score = CTC.ctc_greedy_from_enc(model.ctc, enc, mask)
                # the best path's first frame of each token: the walk's
                walk = CTC.ctc_greedy_stream(
                    model.ctc, enc, mask, MAX_U,
                    CTC.ctc_greedy_stream_init(1, MAX_U, "cpu", True))
                frames = walk[4][0][: int(walk[2][0])].tolist()
        elif beam_size > 1:
            toks, score = transducer_beam_from_enc(model, m, enc, mask, MAX_U,
                                                   beam_size, 4)
        else:
            toks, score, frames = transducer_greedy_from_enc(
                model, m, enc, mask, MAX_U, 4, track_frames=True)
            frames = [int(f) for f in frames[0] if f >= 0]
    # PAD (0) pads every row; the best path's rows end in EOS (2), which
    # the comparison drops from both sides (as tests/test_streaming_*.py)
    return ([int(x) for x in toks[0] if x not in (0, 2)], float(score[0]),
            frames)


@pytest.mark.parametrize("kind, beam", [("blstm", 1), ("blstm", 2),
                                        ("conformer", 1), ("conformer", 2),
                                        ("ctc", 1), ("ctc", 2)])
def test_streaming_transcriber_matches_offline_and_jax(models, kind, beam):
    """Greedy streams track their emission frames (``track_frames``):
    the offline walk's, and JAX's streamed ones."""
    cfg, jcfg, model, tree = models[kind]
    # utterance 0 of the synthetic corpus (0.72 s, 6 labels)
    wav = make_utterance(0, build_vocab(Config()), DataConfig(),
                         cfg.frontend, min_tokens=4, max_tokens=6).audio
    wav = wav.astype(np.float32)
    track = beam == 1
    st = S.StreamingTranscriber(model, cfg, CMVN, MAX_U, beam_size=beam,
                                track_frames=track)
    for s in range(0, len(wav), 1777):
        st.feed(wav[s: s + 1777])
    toks, score = st.finalize()
    assert len(toks) > 2 and len(set(toks)) > 1, toks
    off_toks, off_score, off_frames = offline_decode(model, cfg, wav, beam)
    assert [x for x in toks if x != 2] == off_toks[:MAX_U]
    np.testing.assert_allclose(score, off_score, **SCORE)
    if track:
        frames = st.emission_frames()
        assert frames == off_frames[:len(toks)] and frames[-1] > 0
    if kind == "ctc":        # its carries are held against JAX's above
        return
    jst = JS.StreamingTranscriber(tree, jcfg, CMVN, MAX_U, beam_size=beam,
                                  track_frames=track)
    jst.feed(wav)
    jtoks, jscore = jst.finalize()
    assert toks == jtoks
    np.testing.assert_allclose(score, jscore, **SCORE)
    if track:
        assert st.emission_frames() == jst.emission_frames()


@pytest.mark.parametrize("beam", [1, 2])
def test_multistream_matches_single_streams(models, beam):
    """Three slots fed staggered, one finalized early and its slot reused:
    each file's result is a single stream's, and a round leaves every
    inactive row of every carry leaf bitwise as it was."""
    cfg, _, model, _ = models["conformer"]
    wavs = [audio(n, 20 + i) for i, n in enumerate((6000, 2500, 4700, 3900))]
    singles = [S.stream_decode(model, cfg, CMVN, w, MAX_U, beam_size=beam)
               for w in wavs]
    ms = S.MultiStreamTranscriber(model, cfg, CMVN, MAX_U, 3, beam_size=beam)
    sids = [ms.open() for _ in range(3)]
    results = {}
    cursors = [0, 0, 0]
    files = [0, 1, 2]
    while files:
        for slot, fi in enumerate(list(files)):
            if fi is None:
                continue
            w = wavs[fi]
            n = 700 + 300 * slot
            if cursors[slot] < len(w):
                ms.feed(sids[slot], w[cursors[slot]: cursors[slot] + n])
                cursors[slot] += n
        before = S.tree_leaves(ms._state)
        ready = [i for i in range(3) if ms._buf[i] is not None
                 and len(ms._buf[i]) >= ms._chunk_samples]
        if ms.pump() == 1:
            for a, b_ in zip(before, S.tree_leaves(ms._state)):
                for r in set(range(3)) - set(ready):
                    assert torch.equal(a[r], b_[r])
        for slot, fi in enumerate(files):
            if fi is not None and cursors[slot] >= len(wavs[fi]):
                results[fi] = ms.finalize(sids[slot])
                files[slot] = None
                if fi == 1:                     # the freed slot takes file 3
                    sids[slot] = ms.open()
                    files[slot], cursors[slot] = 3, 0
        files = files if any(f is not None for f in files) else []
    for fi, (toks, score) in sorted(results.items()):
        assert toks == singles[fi][0], fi
        np.testing.assert_allclose(score, singles[fi][1], rtol=1e-5)


# configs/ls100_transducer_streaming.yaml cut small for the CLI
CLI = ["model.enc_hidden=8", "model.enc_layers=2", "model.pred_hidden=16",
       "model.joint_dim=16", "model.embed_dim=8",
       "model.compute_dtype=float32", "train.batch_size=4",
       "data.dataset=synthetic", "data.num_synthetic_utts=8",
       "data.frame_buckets=[200]", "data.token_buckets=[12]",
       "decode.max_decode_len=10"]


def test_transcribe_streaming_matches_the_offline_cli(tmp_path, capsys):
    config = "configs/ls100_transducer_streaming.yaml"
    cfg = load_config(config, CLI)
    vocab = build_vocab(cfg)
    cfg = TR.finalize_config(cfg, vocab.size)
    files = synthetic.write_wavs(tmp_path, cfg, vocab, 3)
    synthetic.write_model_dir(tmp_path, cfg, files, seed=1)
    base = ["--config", config, "--load-dir", str(tmp_path), "--device",
            "cpu", *map(str, files), *CLI]
    runs = {}
    for name, extra in (("offline", ["--beam", "1"]),
                        ("stream", ["--streaming"]),
                        ("streams", ["--streaming", "--streams", "2",
                                     "--stream-chunk-ms", "130"]),
                        ("offline_beam", ["--beam", "3"]),
                        ("stream_beam", ["--streaming", "--beam", "3"])):
        assert TR.main(base + extra) == 0
        runs[name] = [json.loads(x) for x in
                      capsys.readouterr().out.strip().splitlines()]
    for a, b in (("offline", "stream"), ("offline", "streams"),
                 ("offline_beam", "stream_beam")):
        assert [r["text"] for r in runs[a]] == [r["text"] for r in runs[b]]
        np.testing.assert_allclose([r["score"] for r in runs[a]],
                                   [r["score"] for r in runs[b]], **SCORE)
    assert all(r["streaming"] for r in runs["streams"])
    assert any(r["text"] for r in runs["offline"])
    with pytest.raises(SystemExit, match="single best path; drop --nbest"):
        TR.main(base + ["--streaming", "--nbest", "2"])


@pytest.mark.parametrize("kind, over", [
    ("blstm", dict(family="las")),
    ("blstm", dict(enc_bidirectional=True)),
    ("blstm", dict(conv_subsample=1)),
    ("blstm", "center"),
    ("blstm", "cmvn"),
    ("conformer", dict(enc_attn_left_chunks=-1)),
    ("conformer", "chunk"),
    ("blstm", "track"),
])
def test_streaming_refusals_are_the_references(kind, over):
    cfg, jcfg = configs(kind, **(over if isinstance(over, dict) else {}))
    chunk = None
    # streaming timestamps with the beam
    kw = dict(beam_size=2, track_frames=True) if over == "track" else {}
    if over in ("center", "cmvn"):
        value = {"center": True, "cmvn": "utterance"}[over]
        cfg = cfg.replace(frontend=dataclasses.replace(
            cfg.frontend, **{over: value}))
        jcfg = jcfg.replace(frontend=dataclasses.replace(
            jcfg.frontend, **{over: value}))
    if over == "chunk":
        chunk = 2 * cfg.model.enc_attn_chunk * cfg.model.time_reduction
    with pytest.raises(AssertionError) as ref:
        JS.build_stream_fns({}, jcfg, CMVN, MAX_U, chunk, **kw)
    model = torch.nn.Module()
    model.listener = torch.nn.Linear(1, 1)
    with pytest.raises(ValueError) as port:
        S.build_stream_fns(model, cfg, CMVN, MAX_U, chunk, **kw)
    assert str(port.value) == str(ref.value)
