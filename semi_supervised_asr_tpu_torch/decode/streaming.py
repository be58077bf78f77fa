"""Exact chunked streaming inference (transducer and CTC families).

Counterpart of ``semi_supervised_asr_tpu/decode/streaming.py``: raw audio
fed in arbitrary pieces gives the tokens of the whole-utterance decode,
because every stage of the chunk is the same computation as the offline
one:

* frontend: with VALID framing (``frontend.center: false``) every feature
  frame is a function of its own n_fft samples, so chunks that overlap by
  n_fft - hop samples give the whole utterance's frames; each chunk goes
  through the power spectrum and the fused post-FFT kernel K1 (no
  SpecAugment bands) with global CMVN;
* listener: the forward-only LSTM listener resumes each layer's scan (K2
  on the card) from its carried (h, c), chunks aligned to the pyramid's
  reduction (``models/listener.py::listener_apply_stream``); the
  chunk-causal conformer runs one attention chunk at a time from its
  caches (``models/conformer_listener.py::
  conformer_listener_apply_stream``), the streaming chunk pinned to
  ``enc_attn_chunk`` encoder frames;
* decode: the transducer's greedy walk and beam, and the CTC family's best
  path and prefix beam, carry their state across chunks (``carry`` /
  ``return_carry``), so the chunks' walks are the whole utterance's; with
  shallow LM fusion (``lm``, ``lm_weight``; the transducer's
  ``ilm_weight``) the beams' carries hold the LM's score, state and
  next-label log-probabilities too, so a fused stream is the fused offline
  decode.  The greedy walks do not fuse, as in the reference.  With
  contextual biasing (``bias``, a :class:`~.biasing.BiasTrie`) every
  walk's carry holds its trie nodes (and the CTC walks' running bias
  score) in trailing slots, greedy and beam alike, so a biased stream is
  the biased offline decode.

The reference's refusals hold (LAS, a bidirectional or conv-stem BLSTM
listener, ``frontend.center``, a CMVN other than ``global``, an unbounded
conformer left context, a chunk size other than the conformer's), raised
as ``ValueError`` with its messages.  Streaming timestamps
(``track_frames``, greedy only): the greedy walks record each token's
emission frame in their carries, ``frame_base`` keeping the frames the
utterance's across chunks (``StreamingTranscriber.emission_frames``); the
frames keep their fixed slot and the bias slots trail, so both compose.
The reference's two jit functions are plain calls here.
"""

from __future__ import annotations

import numpy as np
import torch

from semi_supervised_asr_tpu_torch.config import Config
from semi_supervised_asr_tpu_torch.decode import biasing as BZ
from semi_supervised_asr_tpu_torch.decode.ctc import (
    ctc_greedy_stream, ctc_greedy_stream_init,
)
from semi_supervised_asr_tpu_torch.decode.ctc_beam import ctc_beam_from_enc
from semi_supervised_asr_tpu_torch.decode.transducer_beam import (
    transducer_beam_from_enc,
)
from semi_supervised_asr_tpu_torch.decode.transducer_greedy import (
    transducer_greedy_from_enc, transducer_greedy_init,
)
from semi_supervised_asr_tpu_torch.models import conformer_listener as CL
from semi_supervised_asr_tpu_torch.models import listener as L
from semi_supervised_asr_tpu_torch.training.train_step import featurize


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested tuples and dicts."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return tuple(tree_map(fn, *x) for x in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def build_stream_fns(
    model,
    cfg: Config,
    cmvn: tuple,
    max_u: int,
    chunk_frames: int | None = None,
    max_symbols: int = 4,
    beam_size: int = 1,
    max_stream_frames: int = 60_000,
    batch: int = 1,
    backend: str | None = None,
    track_frames: bool = False,
    lm=None,
    lm_weight: float = 0.0,
    ilm_weight: float = 0.0,
    bias=None,
) -> dict:
    """The computational core of streaming, shared by
    :class:`StreamingTranscriber` and :class:`MultiStreamTranscriber` ->
    dict with ``enc_state0`` / ``dec_carry0`` (the initial carries;
    ``dec_carry0`` is None for the beams, which build theirs on their first
    chunk), ``chunk_step(enc_state, dec_carry, audio [S, chunk_samples],
    frame_base)`` -> (enc_state, dec_carry), ``final_step(enc_state,
    dec_carry, audio, n_samples [S], frame_base)`` -> dec_carry (both under
    inference mode; ``chunk_fn`` / ``final_fn`` are the same without it,
    which ``export.py`` traces),
    ``decode_chunk`` and the chunk geometry (``chunk_frames``,
    ``chunk_samples``, ``conformer``).  ``batch`` sizes the carries for that
    many independent streams; every carry leaf keeps its stream axis first
    (a fused beam's LM state its K rows a stream on axis 1), and rows
    never interact.  ``cmvn`` = (mean, inv_std) on the model's
    device.  ``track_frames`` (greedy only) gives the greedy carries their
    emission-frame slot; ``lm`` / ``lm_weight`` / ``ilm_weight`` fuse the
    beams as offline; ``bias`` biases every walk."""
    m, f = cfg.model, cfg.frontend
    device = cmvn[0].device
    _check(not (track_frames and beam_size > 1),
           "track_frames (streaming timestamps) is greedy-only — the beam "
           "carries keep no per-token frame slot")
    _check(m.family in ("transducer", "ctc"),
           "streaming decode needs a frame-synchronous family (transducer "
           "or ctc) — LAS attention reads the full utterance")
    _check(m.family == "transducer" or ilm_weight == 0.0,
           "ilm_weight is transducer-only (HAT internal-LM correction)")
    conformer = m.encoder_arch == "conformer"
    if not conformer:
        _check(not m.enc_bidirectional,
               "streaming needs model.enc_bidirectional=false (or the "
               "chunk-causal conformer, model.enc_attn_chunk > 0)")
        _check(m.conv_subsample == 0,
               "blstm streaming needs conv_subsample=0 (the SAME-padded stem "
               "reads ahead; the conformer's chunked stem is causal)")
    _check(not f.center, "streaming needs frontend.center=false "
           "(reflect-padded center framing reads future samples)")
    _check(f.cmvn == "global", "streaming needs frontend.cmvn=global "
           "(utterance CMVN reads the full utterance)")
    red = m.time_reduction
    listener = model.listener
    if conformer:
        # one stream step is one attention chunk: enc_attn_chunk encoder
        # frames of enc_attn_chunk * red feature frames
        chunk_frames = chunk_frames or m.enc_attn_chunk * red
        _check(chunk_frames == m.enc_attn_chunk * red,
               "conformer streaming feeds exactly enc_attn_chunk * "
               "2**conv_subsample feature frames per chunk (got "
               f"chunk_frames={chunk_frames}, want "
               f"{m.enc_attn_chunk * red})")
        enc_state0 = CL.conformer_stream_init(m, batch, device)
        rope = CL.conformer_rope_table(m, max_stream_frames, device)

        def enc_stream(feats, enc_state, frame_lens=None):
            return CL.conformer_listener_apply_stream(
                listener, feats, enc_state, rope, frame_lens)
    else:
        chunk_frames = chunk_frames or red
        enc_state0 = L.listener_stream_init(m, batch, device)

        def enc_stream(feats, enc_state, frame_lens=None):
            return L.listener_apply_stream(listener, feats, enc_state,
                                           frame_lens, backend)
    _check(chunk_frames % red == 0, f"chunk_frames {chunk_frames} must be a "
           f"multiple of the time reduction {red}")
    chunk_samples = (chunk_frames - 1) * f.hop_length + f.n_fft

    dec_carry0 = None    # the beams build theirs on their first chunk
    if m.family == "ctc" and beam_size > 1:
        def decode_chunk(enc, mask, dec_carry, frame_base):
            return ctc_beam_from_enc(model.ctc, enc, mask, max_u, beam_size,
                                     carry=dec_carry, return_carry=True,
                                     lm=lm, lm_weight=lm_weight,
                                     bias=bias)[2]
    elif m.family == "ctc":
        dec_carry0 = ctc_greedy_stream_init(batch, max_u, device,
                                            track_frames, bias is not None)

        def decode_chunk(enc, mask, dec_carry, frame_base):
            return ctc_greedy_stream(model.ctc, enc, mask, max_u, dec_carry,
                                     frame_base, bias)
    elif beam_size > 1:
        def decode_chunk(enc, mask, dec_carry, frame_base):
            return transducer_beam_from_enc(
                model, m, enc, mask, max_u, beam_size, max_symbols,
                carry=dec_carry, return_carry=True, lm=lm,
                lm_weight=lm_weight, ilm_weight=ilm_weight, bias=bias)[2]
    else:
        with torch.inference_mode():
            dec_carry0 = transducer_greedy_init(model, m, batch, max_u,
                                                device,
                                                track_frames=track_frames,
                                                bias=bias is not None)

        def decode_chunk(enc, mask, dec_carry, frame_base):
            return transducer_greedy_from_enc(
                model, m, enc, mask, max_u, max_symbols, carry=dec_carry,
                return_carry=True, track_frames=track_frames,
                frame_base=frame_base, bias=bias)[2]

    def features(a, n_samples):
        return featurize(cfg, a, n_samples, cmvn, backend=backend)

    def chunk_fn(enc_state, dec_carry, audio, frame_base):
        a = audio if audio.dim() == 2 else audio[None]
        n = torch.full((a.shape[0],), a.shape[1], dtype=torch.int32,
                       device=a.device)
        feats, _ = features(a, n)
        enc, enc_state = enc_stream(feats[:, :chunk_frames], enc_state)
        mask = torch.ones(enc.shape[:2], dtype=torch.bool, device=enc.device)
        return enc_state, decode_chunk(enc, mask, dec_carry, frame_base)

    def final_fn(enc_state, dec_carry, audio, n_samples, frame_base):
        a = audio if audio.dim() == 2 else audio[None]
        feats, flens = features(a, n_samples.reshape(-1))
        enc, _ = enc_stream(feats, enc_state, flens)
        enc_valid = flens
        for _ in range(m.conv_subsample if conformer else m.enc_layers):
            enc_valid = torch.div(enc_valid + 1, 2, rounding_mode="floor")
        steps = torch.arange(enc.shape[1], device=enc.device)
        mask = steps[None, :] < enc_valid[:, None]
        return decode_chunk(enc, mask, dec_carry, frame_base)

    return {"enc_state0": enc_state0, "dec_carry0": dec_carry0,
            "chunk_step": torch.inference_mode()(chunk_fn),
            "final_step": torch.inference_mode()(final_fn),
            "chunk_fn": chunk_fn, "final_fn": final_fn,
            "decode_chunk": decode_chunk, "chunk_frames": chunk_frames,
            "chunk_samples": chunk_samples, "conformer": conformer}


def carry_scores(dec_carry, *, ctc: bool, beam_size: int,
                 lm_weight: float = 0.0, bias=None):
    """The ranking scores of a decode carry -> (tokens, count, scores):
    [S, K, U], [S, K], [S, K] for the beams, [S, U], [S], [S] for the
    greedy walks.  A fused CTC beam's prefixes rank with ``lm_weight``
    times their LM score; under ``bias`` the committed bias ranks and the
    pending part is retracted (the CTC carries hold the bias apart, the
    transducer's inside their scores), as the offline decoders rank."""
    n_bias = 0 if bias is None else (2 if ctc else 1)
    if beam_size > 1 and ctc:
        toks, count, _, pb, pnb = dec_carry[:5]
        scores = torch.logaddexp(pb, pnb)
        if len(dec_carry) - n_bias > 5:
            scores = scores + lm_weight * dec_carry[5]
    elif beam_size > 1:
        _, _, toks, count, scores = dec_carry[:5]
    else:
        # the greedy carries: (prev, out, count, score[, frames]) and
        # (pred, state, out, count, score[, frames]), bias slots last
        toks, count, scores = dec_carry[1:4] if ctc else dec_carry[2:5]
    if bias is not None:
        if ctc:
            node, bsc = dec_carry[-2:]
            scores = scores + bsc - BZ.bias_pending(bias, node)
        else:
            scores = scores - BZ.bias_pending(bias, dec_carry[-1])
    return toks, count, scores


def _best_hyp(dec_carry, row: int, *, ctc: bool, beam_size: int,
              lm_weight: float = 0.0, bias=None) -> tuple[list[int], float]:
    """The best hypothesis of stream ``row`` in a decode carry -> (tokens,
    score): the one selection rule of both transcribers
    (:func:`carry_scores`)."""
    if dec_carry is None:
        return [], 0.0
    toks, count, scores = carry_scores(dec_carry, ctc=ctc,
                                       beam_size=beam_size,
                                       lm_weight=lm_weight, bias=bias)
    if beam_size > 1:
        k = int(torch.argmax(scores[row]))
        out = toks[row, k][: int(count[row, k])]
        return [int(x) for x in out.tolist()], float(scores[row, k])
    return ([int(x) for x in toks[row][: int(count[row])].tolist()],
            float(scores[row]))


def _audio_tensor(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _cmvn_on(cmvn: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in cmvn)


class StreamingTranscriber:
    """Incremental decoder of one utterance (batch 1).

    >>> st = StreamingTranscriber(model, cfg, cmvn, max_u=256)
    >>> for piece in audio_pieces:
    ...     st.feed(piece)           # runs every whole chunk it completes
    >>> tokens, score = st.finalize()
    """

    def __init__(self, model, cfg: Config, cmvn: tuple, max_u: int,
                 chunk_frames: int | None = None, max_symbols: int = 4,
                 beam_size: int = 1, max_stream_frames: int = 60_000,
                 backend: str | None = None, track_frames: bool = False,
                 lm=None, lm_weight: float = 0.0, ilm_weight: float = 0.0,
                 bias=None):
        self.device = next(model.parameters()).device
        fns = build_stream_fns(
            model, cfg, _cmvn_on(cmvn, self.device), max_u, chunk_frames,
            max_symbols, beam_size, max_stream_frames, backend=backend,
            track_frames=track_frames, lm=lm, lm_weight=lm_weight,
            ilm_weight=ilm_weight, bias=bias)
        self._lm_weight = lm_weight
        self._bias = bias
        self._track = track_frames
        self._conformer = fns["conformer"]
        self.chunk_frames = fns["chunk_frames"]
        self.cfg = cfg
        self.beam_size = beam_size
        self._hop, self._n_fft = cfg.frontend.hop_length, cfg.frontend.n_fft
        self._chunk_samples = fns["chunk_samples"]
        self._audio = np.zeros((0,), np.float32)
        self._enc_state = fns["enc_state0"]
        self._dec_carry = fns["dec_carry0"]
        self._chunk_step = fns["chunk_step"]
        self._final_step = fns["final_step"]
        # encoder frames already consumed: each chunk's frame_base
        self._enc_frames = 0

    def feed(self, samples: np.ndarray) -> None:
        """Append audio; run every whole chunk that becomes available."""
        self._audio = np.concatenate(
            [self._audio, np.asarray(samples, np.float32)])
        red = self.cfg.model.time_reduction
        while len(self._audio) >= self._chunk_samples:
            chunk = _audio_tensor(self._audio[: self._chunk_samples],
                                  self.device)
            self._enc_state, self._dec_carry = self._chunk_step(
                self._enc_state, self._dec_carry, chunk, self._enc_frames)
            self._enc_frames += self.chunk_frames // red
            # keep the n_fft - hop overlap the next frame window needs
            self._audio = self._audio[self.chunk_frames * self._hop:]

    def _best(self) -> tuple[list[int], float]:
        return _best_hyp(self._dec_carry, 0,
                         ctc=self.cfg.model.family == "ctc",
                         beam_size=self.beam_size, lm_weight=self._lm_weight,
                         bias=self._bias)

    def emission_frames(self) -> list[int]:
        """The utterance's encoder frame at which each emitted token first
        appeared (as many as the tokens): streaming timestamps, seconds =
        frame * hop_length * time_reduction / sample_rate.  Needs
        ``track_frames=True`` (greedy only)."""
        if not self._track:
            raise ValueError("construct with track_frames=True")
        # the frames sit at a fixed place of either greedy carry, the bias
        # slots trail
        ctc = self.cfg.model.family == "ctc"
        count = self._dec_carry[2 if ctc else 3]
        frames = self._dec_carry[4 if ctc else 5]
        return [int(x) for x in frames[0][: int(count[0])].tolist()]

    @property
    def tokens(self) -> list[int]:
        """The best tokens so far (greedy: they only grow; beam: the
        leading hypothesis, which may change -- only ``finalize``'s result
        is final)."""
        return self._best()[0]

    def finalize(self) -> tuple[list[int], float]:
        """Run the remainder, padded to a whole chunk (the conformer) or
        to the reduction (the LSTM listener) and length-masked as the batch
        path masks a padded row -> (tokens, score)."""
        m = self.cfg.model
        rem = len(self._audio)
        n_frames = 1 + (rem - self._n_fft) // self._hop \
            if rem >= self._n_fft else 0
        if n_frames > 0:
            red = self.chunk_frames if self._conformer else m.time_reduction
            pad_frames = -(-n_frames // red) * red
            need = (pad_frames - 1) * self._hop + self._n_fft
            audio = np.zeros((need,), np.float32)
            audio[:rem] = self._audio
            self._dec_carry = self._final_step(
                self._enc_state, self._dec_carry,
                _audio_tensor(audio, self.device),
                torch.tensor([rem], dtype=torch.int32, device=self.device),
                self._enc_frames)
            self._enc_frames += pad_frames // m.time_reduction
        toks, score = self._best()
        self._audio = np.zeros((0,), np.float32)
        return toks, score


class MultiStreamTranscriber:
    """``n_streams`` independent live utterances, advanced together by one
    chunk call a round.

    A fixed pool of ``n_streams`` rows in one carry: ``open()`` leases a
    free slot (its row reset to the initial carry), ``feed(sid, samples)``
    only buffers on the host, ``pump()`` runs one batched chunk step a
    round over every slot with a whole chunk buffered -- the other rows
    take part in the computation, but their carries are put back, bit for
    bit, so rows never interact -- and ``finalize(sid)`` runs the slot's
    remainder through the masked final chunk, frees the slot and returns
    ``(tokens, score)``: the tokens of a :class:`StreamingTranscriber` fed
    the same audio.  Each carry leaf has its stream axis first, except a
    fused beam's LM state, whose leaves hold K rows a stream on axis 1
    ([L, S*K, ...]); each leaf's stream axis and rows a stream are read
    off a carry built for S + 1 streams (the one axis whose size
    differs).

    >>> ms = MultiStreamTranscriber(model, cfg, cmvn, max_u, 8)
    >>> a, b = ms.open(), ms.open()
    >>> ms.feed(a, mic_a); ms.feed(b, mic_b)   # buffer only
    >>> ms.pump()                              # one call, both advance
    >>> ms.finalize(a)                         # -> (tokens, score)
    """

    def __init__(self, model, cfg: Config, cmvn: tuple, max_u: int,
                 n_streams: int, chunk_frames: int | None = None,
                 max_symbols: int = 4, beam_size: int = 1,
                 max_stream_frames: int = 60_000,
                 backend: str | None = None, lm=None,
                 lm_weight: float = 0.0, ilm_weight: float = 0.0,
                 bias=None):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        S = self.n_streams = n_streams
        self.device = next(model.parameters()).device
        self.beam_size = beam_size
        self.cfg = cfg
        self._lm_weight = lm_weight
        self._bias = bias

        def init(batch):
            fns = build_stream_fns(
                model, cfg, _cmvn_on(cmvn, self.device), max_u, chunk_frames,
                max_symbols, beam_size, max_stream_frames, batch=batch,
                backend=backend, lm=lm, lm_weight=lm_weight,
                ilm_weight=ilm_weight, bias=bias)
            dec0 = fns["dec_carry0"]
            if dec0 is None:
                # the beams build their carry on their first chunk; a
                # zero-frame decode builds it for every slot, so merges
                # always have both
                with torch.inference_mode():
                    dec0 = fns["decode_chunk"](
                        torch.zeros((batch, 0, cfg.model.enc_out_dim),
                                    device=self.device),
                        torch.zeros((batch, 0), dtype=torch.bool,
                                    device=self.device), None, 0)
            return fns, (fns["enc_state0"], dec0)

        fns, self._init = init(S)
        self.chunk_frames = fns["chunk_frames"]
        self._chunk_samples = fns["chunk_samples"]
        self._hop, self._n_fft = cfg.frontend.hop_length, cfg.frontend.n_fft
        self._fns = fns

        def stream_axis(a, p):
            diffs = [i for i, (x, y) in enumerate(zip(a.shape, p.shape))
                     if x != y]
            if len(diffs) != 1 or a.shape[diffs[0]] % S:
                raise ValueError(f"carry leaf {tuple(a.shape)} has no one "
                                 f"stream axis (probe {tuple(p.shape)})")
            return diffs[0], a.shape[diffs[0]] // S

        # (axis, rows a stream) of every carry leaf, in tree_leaves order
        self._axes = [stream_axis(a, p) for a, p in zip(
            tree_leaves(self._init), tree_leaves(init(S + 1)[1]))]
        self._state = self._init
        self._buf: list = [None] * S      # None = the slot is free
        self._dirty = [False] * S         # the row differs from the init

    def _merge(self, active: torch.Tensor, new, old):
        """``new``'s rows where ``active`` [S], ``old``'s elsewhere, along
        each leaf's stream axis (``old`` a whole carry or its decode
        part)."""
        axes = iter(self._axes[len(self._axes) - len(tree_leaves(old)):])

        def pick(n, o):
            ax, m = next(axes)
            mask = active.repeat_interleave(m)
            return torch.where(mask.reshape((1,) * ax + (-1,) + (1,) * (
                n.dim() - ax - 1)), n, o)

        return tree_map(pick, new, old)

    def _active(self, rows: list[int]) -> torch.Tensor:
        act = torch.zeros((self.n_streams,), dtype=torch.bool)
        act[rows] = True
        return act.to(self.device)

    def _check(self, sid: int) -> None:
        if not (0 <= sid < self.n_streams and self._buf[sid] is not None):
            raise ValueError(f"stream {sid} is not open")

    def open(self) -> int:
        """Lease a free slot -> its stream id (its carry row fresh)."""
        for sid in range(self.n_streams):
            if self._buf[sid] is None:
                if self._dirty[sid]:
                    self._state = self._merge(self._active([sid]),
                                              self._init, self._state)
                    self._dirty[sid] = False
                self._buf[sid] = np.zeros((0,), np.float32)
                return sid
        raise ValueError(
            f"all {self.n_streams} stream slots are in use — finalize one "
            "first (or construct with a larger n_streams)")

    def feed(self, sid: int, samples: np.ndarray) -> None:
        """Buffer audio for ``sid`` (on the host: no computation until
        :meth:`pump`)."""
        self._check(sid)
        self._buf[sid] = np.concatenate(
            [self._buf[sid], np.asarray(samples, np.float32)])

    def pump(self) -> int:
        """Advance every stream with a whole chunk buffered, one batched
        call a round, until none has one -> the number of rounds."""
        S, rounds = self.n_streams, 0
        consumed = self.chunk_frames * self._hop
        while True:
            ready = [i for i in range(S) if self._buf[i] is not None
                     and len(self._buf[i]) >= self._chunk_samples]
            if not ready:
                return rounds
            audio = np.zeros((S, self._chunk_samples), np.float32)
            for i in ready:
                audio[i] = self._buf[i][: self._chunk_samples]
                self._dirty[i] = True
            enc_state, dec = self._state
            new = self._fns["chunk_step"](
                enc_state, dec, _audio_tensor(audio, self.device), 0)
            self._state = self._merge(self._active(ready), new, self._state)
            for i in ready:
                # keep the n_fft - hop overlap the next window needs
                self._buf[i] = self._buf[i][consumed:]
            rounds += 1

    def tokens(self, sid: int) -> list[int]:
        """The best tokens of ``sid`` so far (call :meth:`pump` first)."""
        self._check(sid)
        return _best_hyp(self._state[1], sid,
                         ctc=self.cfg.model.family == "ctc",
                         beam_size=self.beam_size,
                         lm_weight=self._lm_weight, bias=self._bias)[0]

    def finalize(self, sid: int) -> tuple[list[int], float]:
        """Run ``sid``'s remainder through the masked final chunk and free
        its slot -> (tokens, score); the other streams are untouched."""
        self._check(sid)
        self.pump()
        S = self.n_streams
        rem = len(self._buf[sid])
        if rem >= self._n_fft:
            # one shape for every stream and length: the whole chunk
            # buffer, length-masked
            audio = np.zeros((S, self._chunk_samples), np.float32)
            audio[sid, :rem] = self._buf[sid]
            n_samples = np.zeros((S,), np.int32)
            n_samples[sid] = rem
            enc_state, dec = self._state
            new_dec = self._fns["final_step"](
                enc_state, dec, _audio_tensor(audio, self.device),
                torch.from_numpy(n_samples).to(self.device), 0)
            self._state = (enc_state, self._merge(self._active([sid]),
                                                  new_dec, dec))
            self._dirty[sid] = True
        out = _best_hyp(self._state[1], sid,
                        ctc=self.cfg.model.family == "ctc",
                        beam_size=self.beam_size, lm_weight=self._lm_weight,
                        bias=self._bias)
        self._buf[sid] = None
        return out


def stream_decode(model, cfg: Config, cmvn: tuple, audio: np.ndarray,
                  max_u: int, chunk_frames: int | None = None,
                  piece_samples: int | None = None, max_symbols: int = 4,
                  beam_size: int = 1, backend: str | None = None, lm=None,
                  lm_weight: float = 0.0, ilm_weight: float = 0.0,
                  bias=None) -> tuple[list[int], float]:
    """Decode ``audio`` by streaming it in ``piece_samples`` pieces."""
    st = StreamingTranscriber(model, cfg, cmvn, max_u, chunk_frames,
                              max_symbols, beam_size, backend=backend,
                              lm=lm, lm_weight=lm_weight,
                              ilm_weight=ilm_weight, bias=bias)
    n = piece_samples or len(audio)
    for s in range(0, len(audio), n):
        st.feed(audio[s: s + n])
    return st.finalize()
