"""Serving export of the PyTorch port: decode as a saved ``torch.export``
program.

Counterpart of ``semi_supervised_asr_tpu/export.py``.  A trained run
becomes a serving artifact: the whole decode of raw audio (the frontend,
the listener, the beam or greedy decoder, CTC rescoring, shallow LM fusion
and the contextual-biasing trie) traced by ``torch.export`` into an
``ExportedProgram`` whose weights and constants are baked into the file
(``torch.export.save``).  The hand-written kernels appear in the graph as
the custom ops of ``ops/library.py`` (namespace ``ssasr_torch``: K1, K2's
forward and K5's forward), so that the loaded program launches them on the
card and runs their plain versions on the CPU.  A loader needs ``torch``
and that op module imported, which registers the ops
(``import semi_supervised_asr_tpu_torch.ops.library``); it needs no config,
model code or checkpoint.

    python -m semi_supervised_asr_tpu_torch.export --config configs/timit.yaml \\
        --load-dir runs/timit --out runs/timit/export \\
        --batch 8 --frames 400 [--greedy] [--streaming] [--bf16] \\
        [--device cuda|cpu]

One program per [batch, frames] shape, as the reference's static shapes;
the decoders' loops are unrolled at export (``decode.max_decode_len``
steps of a beam), so a program holds one graph node per operation of
every step.  The program runs on the device it was exported on.
``--bf16`` stores the float weights in bfloat16 (half the file) and the
program casts them back to the model's dtype on entry, as the reference's
bfloat16 weights promote in float32 arithmetic; the CMVN statistics stay
float32.  ``--streaming`` also exports the streaming deployment: four
programs ``init``, ``chunk``, ``final`` and ``emit`` over explicit carries
(the frontend's overlap, the listener's caches, the decode carry with its
bias slots), served by :class:`StreamingArtifact`.  The manifest
(``manifest.json``) mirrors the reference's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from semi_supervised_asr_tpu_torch.decode import biasing as BZ
from semi_supervised_asr_tpu_torch.decode.beam import beam_decode_from_enc
from semi_supervised_asr_tpu_torch.decode.ctc import ctc_greedy_from_enc
from semi_supervised_asr_tpu_torch.decode.ctc_beam import ctc_beam_from_enc
from semi_supervised_asr_tpu_torch.decode.greedy import greedy_decode_from_enc
from semi_supervised_asr_tpu_torch.decode.streaming import (
    build_stream_fns, carry_scores,
)
from semi_supervised_asr_tpu_torch.decode.transducer_beam import (
    transducer_beam_from_enc,
)
from semi_supervised_asr_tpu_torch.decode.transducer_greedy import (
    transducer_greedy_from_enc,
)
from semi_supervised_asr_tpu_torch.ops import library  # noqa: F401 -- ops
from semi_supervised_asr_tpu_torch.training.train_step import featurize
from semi_supervised_asr_tpu_torch.transcribe import max_decode_steps


class _Weights(nn.Module):
    """A model's weights for the program: as they are, or with ``dtype``
    the float ones stored in that dtype (buffers) and cast back to the
    model's own dtype on entry (:meth:`bind`)."""

    def __init__(self, model: nn.Module | None, dtype=None):
        super().__init__()
        self.model = model
        self.cast = dtype is not None and model is not None
        self._names: list[tuple[str, torch.dtype]] = []
        if self.cast:
            for i, (name, p) in enumerate(
                    list(model.named_parameters())
                    + list(model.named_buffers())):
                if p.is_floating_point():
                    self.register_buffer(f"w{i}", p.detach().to(dtype))
                    self._names.append((name, p.dtype))
                else:
                    self._names.append((name, None))
                    self.register_buffer(f"w{i}", p.detach())
            # the model's own tensors leave the program: bind() puts the
            # stored ones in their place, as plain attributes
            for name, _ in self._names:
                mod, _, leaf = name.rpartition(".")
                owner = model.get_submodule(mod) if mod else model
                owner._parameters.pop(leaf, None)
                owner._buffers.pop(leaf, None)

    def bind(self) -> None:
        """Set the model's tensors from the stored ones (cast back)."""
        if not self.cast:
            return
        for i, (name, dtype) in enumerate(self._names):
            mod, _, leaf = name.rpartition(".")
            owner = self.model.get_submodule(mod) if mod else self.model
            w = getattr(self, f"w{i}")
            setattr(owner, leaf, w if dtype is None else w.to(dtype))


def _frozen(model: nn.Module | None) -> nn.Module | None:
    if model is not None:
        model.eval()
        for p in model.parameters():
            p.requires_grad_(False)
    return model


class DecodeProgram(nn.Module):
    """The offline serving function: ``forward(audio [B, S] float32,
    audio_lens [B] int32) -> (tokens, scores)`` (the live decoders'
    outputs), everything else held by the module."""

    def __init__(self, cfg, model, cmvn, mode: str, lm=None, bias=None,
                 param_dtype=None):
        super().__init__()
        self.cfg, self.mode = cfg, mode
        dev = _device_of(model)
        self.w = _Weights(_frozen(model), param_dtype)
        self.lm_w = _Weights(_frozen(lm), param_dtype)
        mean, inv_std = _cmvn_on(cmvn, dev)
        self.register_buffer("cmvn_mean", mean)
        self.register_buffer("cmvn_inv_std", inv_std)
        self.has_bias = bias is not None
        for name, x in zip(BZ.BiasTrie._fields, bias or ()):
            self.register_buffer(f"bias_{name}", x.to(dev))
        self.joint_ctc = (cfg.decode.ctc_weight > 0.0
                          and hasattr(model, "ctc"))

    def _trie(self):
        if not self.has_bias:
            return None
        return BZ.BiasTrie(*(getattr(self, f"bias_{n}")
                             for n in BZ.BiasTrie._fields))

    def forward(self, audio: torch.Tensor, audio_lens: torch.Tensor):
        self.w.bind()
        self.lm_w.bind()
        cfg, model, lm = self.cfg, self.w.model, self.lm_w.model
        d, bias = cfg.decode, self._trie()
        feats, flens = featurize(cfg, audio, audio_lens,
                                 (self.cmvn_mean, self.cmvn_inv_std))
        max_u = max(1, min(cfg.data.token_buckets[-1], d.max_decode_len))
        family = cfg.model.family
        if family == "transducer":
            enc, mask = model.encode(feats, flens)
            if self.mode == "greedy":
                return transducer_greedy_from_enc(model, cfg.model, enc, mask,
                                                  max_u, d.max_symbols)
            return transducer_beam_from_enc(
                model, cfg.model, enc, mask, max_u, d.beam_size,
                d.max_symbols, lm=lm, lm_weight=d.lm_weight,
                ilm_weight=d.ilm_weight, bias=bias)
        if family == "ctc":
            enc, mask = model.encode(feats, flens)
            if self.mode == "greedy":
                return ctc_greedy_from_enc(model.ctc, enc, mask)
            return ctc_beam_from_enc(model.ctc, enc, mask, max_u, d.beam_size,
                                     lm=lm, lm_weight=d.lm_weight, bias=bias)
        enc, mask, keys = model.encode(feats, flens)
        max_u = max_decode_steps(cfg, enc.shape[1])
        if self.mode == "greedy":
            toks, logp = greedy_decode_from_enc(model.speller, enc, mask, keys,
                                                max_u)
            return toks, logp.sum(dim=-1)
        return beam_decode_from_enc(
            model.speller, d, enc, mask, keys, max_u,
            ctc=model.ctc if self.joint_ctc else None, lm=lm, bias=bias)


def _bias_for(cfg, mode: str, bias, device, unbiased_greedy_ok: bool,
              vocab=None):
    """The trie a program bakes: the reference's rules (greedy decodes
    unbiased with ``unbiased_greedy_ok``, else refuses biasing keys)."""
    d = cfg.decode
    if bias is None and not (d.bias_phrases and d.bias_bonus != 0.0):
        return None
    if mode == "greedy":
        if unbiased_greedy_ok:
            print("note: offline greedy artifact bakes UNBIASED "
                  "(bias applies to beams and the streaming bundle)")
            return None
        raise SystemExit(
            "decode.bias_phrases applies to beam decode only — export "
            "--beam, add --streaming (biased greedy streams), or drop the "
            "biasing overrides")
    if bias is None:
        from semi_supervised_asr_tpu_torch.data.registry import build_vocab

        bias = BZ.bias_from_config(d, vocab or build_vocab(cfg), device)
    return bias


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _cmvn_on(cmvn, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, inv_std), numpy arrays or tensors, as float32 on ``device``."""
    return tuple(torch.as_tensor(x).to(device=device, dtype=torch.float32)
                 for x in cmvn)


def _warm_constants(cfg, device) -> None:
    """Build the frontend's cached device constants (the window, the mel
    bank, its runs, the DFT basis) before a trace: built inside one, the
    caches would keep the trace's fake tensors."""
    from semi_supervised_asr_tpu_torch.ops import frontend as F
    from semi_supervised_asr_tpu_torch.ops import fused_frontend as FF

    dev = str(torch.device(device))
    F.constants(cfg.frontend, dev)
    FF._mel_runs_on(cfg.frontend, dev)
    F._dft_basis_on(cfg.frontend.n_fft, dev)


def _export(module: nn.Module, args: tuple, cfg, device):
    """``torch.export.export`` without autograd, the caches warmed."""
    _warm_constants(cfg, device)
    with torch.no_grad(), warnings.catch_warnings():
        # bfloat16 weights are bound as plain attributes on entry, on
        # purpose (they are the stored buffers, cast)
        warnings.filterwarnings("ignore", "The tensor attributes")
        return torch.export.export(module, args)


def build_decode_fn(cfg, model, cmvn, mode: str = "beam", lm=None,
                    unbiased_greedy_ok: bool = False, bias=None,
                    param_dtype=None, vocab=None) -> DecodeProgram:
    """-> the module ``(audio [B, S], audio_lens [B]) -> (tokens,
    scores)``: the whole serving decode of raw audio with the weights
    held, as the reference's ``build_decode_fn``.  ``bias`` (a trie) or
    the config's ``decode.bias_phrases`` / ``bias_bonus`` bake the
    hotword trie into a beam; greedy refuses the keys unless
    ``unbiased_greedy_ok`` (a ``--streaming`` export, whose bundle bakes
    the biased greedy walk)."""
    if lm is not None and getattr(lm, "max_len", None) is not None \
            and cfg.decode.max_decode_len > cfg.lm.max_len:
        raise ValueError(
            f"decode.max_decode_len {cfg.decode.max_decode_len} exceeds the "
            f"transformer LM's lm.max_len {cfg.lm.max_len}; a fused artifact "
            "would corrupt LM scores silently")
    dev = _device_of(model)
    bias = _bias_for(cfg, mode, bias, dev, unbiased_greedy_ok, vocab)
    return DecodeProgram(cfg, model, cmvn, mode, lm, bias, param_dtype)


def export_decode(cfg, model, cmvn, batch: int, frames: int,
                  mode: str = "beam", lm=None, param_dtype=None,
                  unbiased_greedy_ok: bool = False, bias=None,
                  vocab=None) -> torch.export.ExportedProgram:
    """The decode program for a fixed [batch, frames] shape (the audio of
    ``frames`` feature frames, as the reference's).  ``param_dtype``
    (``torch.bfloat16``) stores the float weights in that dtype; the CMVN
    stays float32.  The model and LM are used in place (their weights
    frozen): pass copies to keep the originals."""
    fn = build_decode_fn(cfg, model, cmvn, mode, lm, unbiased_greedy_ok,
                         bias, param_dtype, vocab)
    s = samples_for_frames(cfg, frames)
    dev = _device_of_program(fn)
    args = (torch.zeros((batch, s), dtype=torch.float32, device=dev),
            torch.full((batch,), s, dtype=torch.int32, device=dev))
    return _export(fn, args, cfg, dev)


def _device_of_program(fn: nn.Module) -> torch.device:
    return next(iter(fn.buffers())).device


def samples_for_frames(cfg, frames: int) -> int:
    """The audio samples of ``frames`` feature frames."""
    s = (frames - 1) * cfg.frontend.hop_length
    return s + (0 if cfg.frontend.center else cfg.frontend.n_fft)


# ------------------------------------------------------------- streaming

class _Init(nn.Module):
    """``init()`` -> the fresh streaming state."""

    def __init__(self, state0):
        super().__init__()
        leaves, self.spec = pytree.tree_flatten(state0)
        for i, x in enumerate(leaves):
            self.register_buffer(f"s{i}", x.clone())
        self.n = len(leaves)

    def forward(self):
        return pytree.tree_unflatten(
            [getattr(self, f"s{i}").clone() for i in range(self.n)],
            self.spec)


class _Chunk(nn.Module):
    """``chunk(state, audio [chunk_samples])`` -> the next state."""

    def __init__(self, fns, weights):
        super().__init__()
        self.fns, self.weights = fns, weights

    def forward(self, state, audio):
        for w in self.weights:
            w.bind()
        enc_state, dec = state
        return self.fns["chunk_fn"](enc_state, dec, audio, 0)


class _Final(_Chunk):
    """``final(state, audio [chunk_samples], n_samples [])`` -> the decode
    carry after the masked last chunk."""

    def forward(self, state, audio, n_samples):
        for w in self.weights:
            w.bind()
        enc_state, dec = state
        return self.fns["final_fn"](enc_state, dec, audio, n_samples, 0)


class _Emit(nn.Module):
    """``emit(dec_carry)`` -> (tokens [max_u], count [], score []): the
    best hypothesis of the carry (``streaming.carry_scores``)."""

    def __init__(self, ctc: bool, beam_size: int, lm_weight: float, bias):
        super().__init__()
        self.ctc, self.beam_size, self.lm_weight = ctc, beam_size, lm_weight
        self.has_bias = bias is not None
        for name, x in zip(BZ.BiasTrie._fields, bias or ()):
            self.register_buffer(f"bias_{name}", x)

    def forward(self, dec_carry):
        bias = (BZ.BiasTrie(*(getattr(self, f"bias_{n}")
                              for n in BZ.BiasTrie._fields))
                if self.has_bias else None)
        toks, count, scores = carry_scores(
            dec_carry, ctc=self.ctc, beam_size=self.beam_size,
            lm_weight=self.lm_weight, bias=bias)
        if self.beam_size > 1:
            # the best row by a gather (no data-dependent indexing)
            k = torch.argmax(scores[0]).view(1)
            return (toks[0].index_select(0, k)[0],
                    count[0].index_select(0, k)[0],
                    scores[0].index_select(0, k)[0])
        return toks[0], count[0], scores[0]


def build_stream_export_fns(cfg, model, cmvn, mode: str = "beam", lm=None,
                            chunk_frames: int | None = None, bias=None,
                            param_dtype=None, vocab=None) -> dict:
    """The four serving modules of the streaming deployment and the chunk
    geometry, over ``decode/streaming.py::build_stream_fns`` (the live
    ``StreamingTranscriber``'s computation): ``init``, ``chunk``,
    ``final``, ``emit`` (see the classes above), ``state0`` and
    ``chunk_frames`` / ``chunk_samples`` / ``conformer``.  The beams'
    fresh carry is the zero-frame decode the live path runs on its first
    chunk.  The trie is baked at any beam size (biased greedy streams)."""
    m = cfg.model
    dev = _device_of(model)
    if cfg.decode.bias_phrases and cfg.decode.bias_bonus != 0.0 \
            and bias is None:
        from semi_supervised_asr_tpu_torch.data.registry import build_vocab

        bias = BZ.bias_from_config(cfg.decode, vocab or build_vocab(cfg), dev)
    weights = nn.ModuleList([_Weights(_frozen(model), param_dtype),
                             _Weights(_frozen(lm), param_dtype)])
    for w in weights:
        w.bind()
    beam_size = 1 if mode == "greedy" else cfg.decode.beam_size
    max_u = max(1, cfg.decode.max_decode_len)
    cmvn_dev = _cmvn_on(cmvn, dev)
    fns = build_stream_fns(
        model, cfg, cmvn_dev, max_u, chunk_frames, cfg.decode.max_symbols,
        beam_size, lm=lm, lm_weight=cfg.decode.lm_weight,
        ilm_weight=cfg.decode.ilm_weight, bias=bias)
    with torch.no_grad():
        dec0 = fns["dec_carry0"]
        if dec0 is None:
            dec0 = fns["decode_chunk"](
                torch.zeros((1, 0, m.enc_out_dim), device=dev),
                torch.zeros((1, 0), dtype=torch.bool, device=dev), None, 0)
        state0 = pytree.tree_map(lambda x: x.clone(),
                                 (fns["enc_state0"], dec0))
    return {"init": _Init(state0), "chunk": _Chunk(fns, weights),
            "final": _Final(fns, weights),
            "emit": _Emit(m.family == "ctc", beam_size,
                          cfg.decode.lm_weight, bias),
            "state0": state0, "chunk_frames": fns["chunk_frames"],
            "chunk_samples": fns["chunk_samples"],
            "conformer": fns["conformer"]}


def export_streaming(cfg, model, cmvn, mode: str = "beam", lm=None,
                     param_dtype=None, chunk_frames: int | None = None,
                     bias=None, vocab=None) -> dict:
    """The four streaming programs -> {"programs": {name:
    ExportedProgram}, "meta": the geometry the host driver needs}."""
    fns = build_stream_export_fns(cfg, model, cmvn, mode, lm, chunk_frames,
                                  bias, param_dtype, vocab)
    state0 = fns["state0"]
    dev = pytree.tree_leaves(state0)[0].device
    audio = torch.zeros((fns["chunk_samples"],), dtype=torch.float32,
                        device=dev)
    n = torch.tensor(fns["chunk_samples"], dtype=torch.int32, device=dev)
    programs = {
        "init": _export(fns["init"], (), cfg, dev),
        "chunk": _export(fns["chunk"], (state0, audio), cfg, dev),
        "final": _export(fns["final"], (state0, audio, n), cfg, dev),
        "emit": _export(fns["emit"], (state0[1],), cfg, dev),
    }
    m = cfg.model
    meta = {
        "chunk_frames": fns["chunk_frames"],
        "chunk_samples": fns["chunk_samples"],
        "hop_length": cfg.frontend.hop_length,
        "n_fft": cfg.frontend.n_fft,
        "time_reduction": m.time_reduction,
        # the final partial chunk pads to this frame granule (the
        # conformer's stream step takes one attention chunk)
        "pad_granule": (fns["chunk_frames"] if fns["conformer"]
                        else m.time_reduction),
        "mode": mode,
    }
    return {"programs": programs, "meta": meta}


# ---------------------------------------------------------------- serving

def program_device(ep: torch.export.ExportedProgram) -> torch.device:
    """The device an exported program's tensors live on."""
    for x in list(ep.state_dict.values()) + list(ep.constants.values()):
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


class StreamingArtifact:
    """Serve an exported streaming bundle: the host side only buffers audio
    and keeps the frame overlap; every decision is in the four programs.

    >>> sa = StreamingArtifact("runs/x/export")
    >>> for piece in audio_pieces:
    ...     sa.feed(piece)
    >>> tokens, score = sa.finalize()

    Feeding and the final chunk follow :class:`~.decode.streaming.
    StreamingTranscriber`, so the tokens are its tokens."""

    def __init__(self, out_dir: str | Path):
        out = Path(out_dir)
        manifest = json.loads((out / "manifest.json").read_text())
        meta = manifest.get("streaming")
        if not meta:
            raise ValueError(f"{out}: manifest has no streaming section — "
                             "export with --streaming")
        self.meta = meta
        progs = {n: torch.export.load(str(out / f)).module()
                 for n, f in meta["files"].items()}
        self._chunk, self._final, self._emit = (progs["chunk"],
                                                progs["final"],
                                                progs["emit"])
        self._state = progs["init"]()
        self.device = pytree.tree_leaves(self._state)[0].device
        self._dec = self._state[1]
        self._audio = np.zeros((0,), np.float32)
        self._hop, self._n_fft = meta["hop_length"], meta["n_fft"]
        self._chunk_samples = meta["chunk_samples"]
        self._chunk_frames = meta["chunk_frames"]
        self._done = False

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)

    def feed(self, samples: np.ndarray) -> None:
        if self._done:
            raise ValueError("finalize() already called")
        self._audio = np.concatenate([self._audio,
                                      np.asarray(samples, np.float32)])
        while len(self._audio) >= self._chunk_samples:
            self._state = self._chunk(
                self._state, self._tensor(self._audio[: self._chunk_samples]))
            self._dec = self._state[1]
            # keep the n_fft - hop overlap the next frame window needs
            self._audio = self._audio[self._chunk_frames * self._hop:]

    @property
    def tokens(self) -> list[int]:
        toks, count, _ = self._emit(self._dec)
        return [int(x) for x in toks[: int(count)].tolist()]

    def finalize(self) -> tuple[list[int], float]:
        rem = len(self._audio)
        n_frames = 1 + (rem - self._n_fft) // self._hop \
            if rem >= self._n_fft else 0
        if n_frames > 0:
            red = self.meta["pad_granule"]
            pad_frames = -(-n_frames // red) * red
            if pad_frames > self._chunk_frames:
                raise ValueError(f"remainder of {pad_frames} frames exceeds "
                                 f"the chunk's {self._chunk_frames}")
            audio = np.zeros((self._chunk_samples,), np.float32)
            audio[:rem] = self._audio
            self._dec = self._final(
                self._state, self._tensor(audio),
                torch.tensor(rem, dtype=torch.int32, device=self.device))
        toks, count, score = self._emit(self._dec)
        self._audio = np.zeros((0,), np.float32)
        self._done = True
        return ([int(x) for x in toks[: int(count)].tolist()], float(score))


def stream_artifact_decode(out_dir: str | Path, audio: np.ndarray,
                           piece_samples: int | None = None):
    """Decode ``audio`` through an exported streaming bundle."""
    sa = StreamingArtifact(out_dir)
    n = piece_samples or len(audio)
    for s in range(0, len(audio), n):
        sa.feed(audio[s: s + n])
    return sa.finalize()


def load_artifact(path: str | Path):
    """-> callable(audio, audio_lens) -> (tokens, scores), tensors on the
    program's device (numpy arrays are moved there)."""
    ep = torch.export.load(str(path))
    fn, dev = ep.module(), program_device(ep)

    def run(audio, audio_lens):
        return fn(torch.as_tensor(audio, dtype=torch.float32, device=dev),
                  torch.as_tensor(audio_lens, dtype=torch.int32, device=dev))
    return run


def run_artifact(path: str | Path, audio: np.ndarray,
                 audio_lens: np.ndarray):
    return load_artifact(path)(audio, audio_lens)


def _save(ep, path: Path) -> int:
    torch.export.save(ep, str(path))
    return path.stat().st_size


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="semi_supervised_asr_tpu_torch.export")
    p.add_argument("--config", required=True)
    p.add_argument("--load-dir", required=True,
                   help="a Solver's workdir (checkpoints + cmvn.npz), or a "
                        "directory holding params.npz and cmvn.npz")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--frames", type=str, default=None,
                   help="comma list of frame buckets (e.g. 200,400); "
                        "default: the config's data.frame_buckets")
    p.add_argument("--greedy", action="store_true",
                   help="export greedy instead of beam decode")
    p.add_argument("--streaming", action="store_true",
                   help="also export the streaming deployment: the init / "
                        "chunk / final / emit programs over explicit carries "
                        "(bias trie and fusion LM baked) and a manifest "
                        "section for StreamingArtifact; needs a streamable "
                        "config (frame-synchronous family, causal listener, "
                        "center=false, global CMVN)")
    p.add_argument("--stream-chunk", type=int, default=None,
                   help="streaming chunk size in feature frames (default: "
                        "the model's latency granule)")
    p.add_argument("--bf16", action="store_true",
                   help="store the baked float weights in bfloat16 (half the "
                        "artifact)")
    p.add_argument("--device", default="cuda",
                   help="the device the programs run on (default cuda; cpu "
                        "runs the kernels' plain versions)")
    p.add_argument("overrides", nargs="*", default=[])
    args = p.parse_args(argv)

    from semi_supervised_asr_tpu_torch import strict_fp32
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.data.bucketing import make_bucket_spec
    from semi_supervised_asr_tpu_torch.training.lm_trainer import LMNotFound
    from semi_supervised_asr_tpu_torch.transcribe import Recognizer

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu to "
                             "export the plain PyTorch versions")
        strict_fp32()
    cfg = load_config(args.config, args.overrides)
    load_dir = Path(args.load_dir)
    if not ((load_dir / cfg.train.ckpt_dir).is_dir()
            or (load_dir / "params.npz").exists()):
        raise SystemExit(
            f"{args.load_dir}: no checkpoint found — exporting untrained "
            "params would produce a garbage serving artifact (check the "
            "--load-dir path / train first)")
    try:
        rec = Recognizer.from_dir(cfg, load_dir, device)
        mode = "greedy" if args.greedy else "beam"
        cfg = rec.cfg
        biased = cfg.decode.bias_phrases and cfg.decode.bias_bonus != 0.0
        trie = rec.bias if biased and (mode == "beam" or args.streaming) \
            else None
    except (NotImplementedError, LMNotFound, FileNotFoundError) as e:
        raise SystemExit(str(e)) from None
    cmvn = (rec.mean, rec.inv_std)
    spec = make_bucket_spec(cfg.data, cfg.frontend, cfg.model.time_reduction)
    frames = ([int(f) for f in str(args.frames).split(",")]
              if args.frames else list(spec.frame_buckets))
    pdt = torch.bfloat16 if args.bf16 else None
    dtype_name = "bfloat16" if args.bf16 else "float32"
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    def fresh():
        import copy

        return (copy.deepcopy(rec.model),
                None if rec.lm is None else copy.deepcopy(rec.lm))

    manifest = []
    for fcount in frames:
        model, lm = fresh()
        t0 = time.perf_counter()
        ep = export_decode(cfg, model, cmvn, args.batch, fcount, mode, lm,
                           param_dtype=pdt, unbiased_greedy_ok=args.streaming,
                           bias=trie, vocab=rec.vocab)
        name = f"decode_{mode}_b{args.batch}_f{fcount}.pt2"
        size = _save(ep, out / name)
        manifest.append({
            "file": name, "mode": mode, "batch": args.batch,
            "param_dtype": dtype_name, "frames": fcount, "bytes": size,
            "samples": samples_for_frames(cfg, fcount),
            "device": device.type,
        })
        print(f"exported {name} ({size / 1e6:.1f} MB, "
              f"{time.perf_counter() - t0:.1f} s)")
    top = {"artifacts": manifest, "vocab_unit": cfg.data.unit,
           "hop_length": cfg.frontend.hop_length}
    if args.streaming:
        model, lm = fresh()
        try:
            bundle = export_streaming(cfg, model, cmvn, mode, lm,
                                      param_dtype=pdt,
                                      chunk_frames=args.stream_chunk,
                                      bias=trie, vocab=rec.vocab)
        except ValueError as e:      # the reference's streaming refusals
            raise SystemExit(str(e)) from None
        files = {}
        for name, ep in bundle["programs"].items():
            fname = f"stream_{mode}_{name}.pt2"
            size = _save(ep, out / fname)
            files[name] = fname
            print(f"exported {fname} ({size / 1e6:.1f} MB)")
        top["streaming"] = {**bundle["meta"], "files": files,
                            "param_dtype": dtype_name,
                            "device": device.type}
    (out / "manifest.json").write_text(json.dumps(top, indent=1))
    rec.vocab.save(out / "vocab.json")
    print(f"manifest + vocab -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
