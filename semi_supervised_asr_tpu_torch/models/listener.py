"""Listener: pyramidal BiLSTM encoder (Chan et al. 2015), and the conv stem.

Counterpart of ``semi_supervised_asr_tpu/models/listener.py``: an optional
stride-2 3x3 conv stem (``model.conv_subsample`` blocks, shared with the
transformer and conformer listeners), then ``enc_base_layers`` full-rate
BiLSTMs, then ``enc_layers`` pyramid stages (fold T -> T/2, feature dim
doubles, then a BiLSTM), with ``model.enc_dropout`` after every layer in
training (sites 0 ... base + pyramid - 1).  ``model.enc_bidirectional:
false`` (the streaming recipe's causal listener) gives every layer one
forward-only cell (``w_ih``, ``w_hh``, ``b``) in place of the pair.  Outputs
are float32 [B, T/2**(enc_layers + conv_subsample), enc_out_dim] (2H, or H
forward-only) with exact zeros on pad frames.

Every layer runs on the CUDA scan kernel (``ops/lstm_scan.py``) whatever
``model.lstm_backend`` says: the reference's ``xla`` scan exists for its
tensor-parallel mesh, which the port does not have.  CPU tensors take the
scan's plain version, as every kernel wrapper does; on the card only an
explicit ``backend="reference"`` does.

Chunked streaming (``decode/streaming.py``): the forward-only listener
resumes every layer's scan from its carried (h, c)
(:func:`listener_apply_stream`), and the chunk-causal conformer's stem
pads time (2, 0) (``conv_stem_apply(causal=True)``) so that it streams
with a 2-frame carry a block (:func:`conv_stem_stream`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.ops import recurrent as R
from semi_supervised_asr_tpu_torch.ops.dropout import dropout
from semi_supervised_asr_tpu_torch.ops.lstm_scan import (
    bilstm_kernel, lstm_kernel,
)


class Leaves(nn.Module):
    """A group of parameters named as the leaves of one JAX dict
    (``Leaves(g=(d,), b=(d,))`` holds ``.g`` and ``.b``)."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))


class LSTMWeights(nn.Module):
    """One LSTM cell's weights in the reference layout: w_ih [I, 4H],
    w_hh [H, 4H], b [4H], gates i, f, g, o."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.zeros(in_dim, 4 * hidden))
        self.w_hh = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.b = nn.Parameter(torch.zeros(4 * hidden))

    def as_dict(self) -> dict:
        return {"w_ih": self.w_ih, "w_hh": self.w_hh, "b": self.b}


class BiLSTMWeights(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.fwd = LSTMWeights(in_dim, hidden)
        self.bwd = LSTMWeights(in_dim, hidden)

    def as_dict(self) -> dict:
        return {"fwd": self.fwd.as_dict(), "bwd": self.bwd.as_dict()}


def check_supported(cfg: ModelConfig) -> None:
    """Refuse model options outside the ported slices with a clear
    message."""
    ported = {
        "model.family": (cfg.family, ("las", "ctc", "transducer")),
        "model.decoder_arch": (cfg.decoder_arch, ("lstm", "transformer")),
        "model.lm_fusion": (cfg.lm_fusion, ("none",)),
    }
    if cfg.family == "transducer" and cfg.lm_fusion != "none":
        # the reference's own refusal (its train step's)
        raise ValueError("model.family=transducer has no LM fusion yet")
    for key, (got, want) in ported.items():
        if got not in want:
            serves = " or ".join(f"{key}={w!r}" for w in want)
            raise NotImplementedError(
                f"{key}={got!r} is not ported yet (the PyTorch port serves "
                f"{serves})"
            )
    if cfg.lstm_backend not in ("pallas", "xla"):
        raise ValueError(f"unknown model.lstm_backend {cfg.lstm_backend!r}")
    if cfg.attn_backend not in ("xla", "flash"):
        raise ValueError(f"unknown model.attn_backend {cfg.attn_backend!r}")


def conv_stem_dims(cfg: ModelConfig) -> int:
    """Feature dim after the conv stem's reshape."""
    f = cfg.n_mels
    for _ in range(cfg.conv_subsample):
        f = (f + 1) // 2
    return f * cfg.conv_channels


def conv_stem_params(cfg: ModelConfig) -> nn.ModuleList:
    """The stem's blocks: w [3, 3, C_in, C] (HWIO, as in JAX), b [C]."""
    blocks, c_in = [], 1
    for _ in range(cfg.conv_subsample):
        blocks.append(Leaves(w=(3, 3, c_in, cfg.conv_channels),
                             b=(cfg.conv_channels,)))
        c_in = cfg.conv_channels
    return nn.ModuleList(blocks)


def stem_frames(t: int, conv_subsample: int) -> int:
    """Frames after the conv stem: each stride-2 block gives ceil(t / 2)."""
    for _ in range(conv_subsample):
        t = -(-t // 2)
    return t


def _same_pad(n: int) -> tuple[int, int]:
    """XLA's SAME padding of a length-n axis for kernel 3, stride 2: (0, 1)
    for even n, (1, 1) for odd n."""
    out = -(-n // 2)
    tot = max((out - 1) * 2 + 3 - n, 0)
    return tot // 2, tot - tot // 2


def _stem_block(hp: torch.Tensor, p: Leaves,
                compute: torch.dtype) -> torch.Tensor:
    """One stem block on its time-padded input hp [B, T+pad, F, C_in] in the
    compute dtype: the freq axis SAME-padded here, the stride-2 3x3 conv as
    the windows (``unfold``) times the [9 * C_in, C] filter, float32 bias,
    ReLU -> [B, T', F', C] float32."""
    hp = Fn.pad(hp, (0, 0, *_same_pad(hp.shape[2])))
    # [B, T', F', C_in, 3, 3] -> [B, T', F', 3, 3, C_in], HWI-major as the
    # HWIO filter's rows
    win = hp.unfold(1, 3, 2).unfold(2, 3, 2).permute(0, 1, 2, 4, 5, 3)
    w = p.w.to(compute).reshape(-1, p.w.shape[-1])      # [9 * C_in, C]
    y = torch.matmul(win.reshape(*win.shape[:3], -1), w).float()
    return torch.relu(y + p.b.float())


def _zero_pads(y: torch.Tensor, lens: torch.Tensor):
    """Halve the valid counts and zero the frames past them -> (y, lens)."""
    lens = torch.div(lens + 1, 2, rounding_mode="floor")
    keep = torch.arange(y.shape[1], device=y.device)[None, :] < lens[:, None]
    return torch.where(keep[:, :, None, None], y, 0.0), lens


def conv_stem_apply(
    convs: nn.ModuleList,
    x: torch.Tensor,            # [B, T, F], zeros on pad frames
    lens: torch.Tensor,         # [B]
    compute: torch.dtype,
    causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ([B, ceil(T/2^N), F'*C] float32, new lens), features F-major and
    C-minor as JAX's NHWC reshape gives them.  Each block: SAME-padded
    stride-2 3x3 conv in the compute dtype, float32 bias, ReLU, then the
    pad frames are zeroed again (bias + ReLU would leak into them).  The
    conv is the 3x3 windows of the padded input (``unfold``) times the
    [9 * C_in, C] filter: its backward is a gather and a matmul, with no
    atomics, so that a step's bits do not depend on the run (cuDNN's
    default backward algorithms for a conv sum with atomics on the
    card).  ``causal`` (the chunk-causal conformer) pads time (2, 0) in
    place of SAME's, so that output frame t reads inputs 2t-2 ... 2t and
    the stem streams (:func:`conv_stem_stream`); lengths are unchanged."""
    h = x.float()[:, None, :, :].permute(0, 2, 3, 1)   # [B, T, F, 1] NHWC
    for p in convs:
        pt = (2, 0) if causal else _same_pad(h.shape[1])
        y = _stem_block(Fn.pad(h.to(compute), (0, 0, 0, 0, *pt)), p, compute)
        h, lens = _zero_pads(y, lens)
    b, t, f, c = h.shape
    return h.reshape(b, t, f * c), lens


def conv_stem_stream_init(cfg: ModelConfig, b: int, device) -> tuple:
    """The causal stem's zero carries: per block its last 2 input frames
    [B, 2, F, C_in] in the compute dtype (zeros = the offline left
    padding)."""
    compute = R.dtype_of(cfg.compute_dtype)
    carries, f, c_in = [], cfg.n_mels, 1
    for _ in range(cfg.conv_subsample):
        carries.append(torch.zeros((b, 2, f, c_in), dtype=compute,
                                   device=device))
        f, c_in = (f + 1) // 2, cfg.conv_channels
    return tuple(carries)


def conv_stem_stream(
    convs: nn.ModuleList,
    x: torch.Tensor,            # [B, Tc, F], Tc a multiple of 2^N
    compute: torch.dtype,
    carry: tuple,
    lens: torch.Tensor | None = None,   # [B]: the final partial chunk only
):
    """One chunk of the causal stem -> ([B, Tc/2^N, F'*C] float32, the new
    carry, new lens): each block convolves (its carry ++ the chunk) with no
    time padding, which is ``conv_stem_apply(causal=True)`` resumed, bit for
    bit; pad frames are zeroed as offline when ``lens`` is given."""
    h = x.float()[..., None]
    new_carry = []
    for p, cin in zip(convs, carry):
        hp = torch.cat([cin.to(compute), h.to(compute)], dim=1)
        new_carry.append(hp[:, -2:].to(cin.dtype))
        h = _stem_block(hp, p, compute)
        if lens is not None:
            h, lens = _zero_pads(h, lens)
    b, t, f, c = h.shape
    return h.reshape(b, t, f * c), tuple(new_carry), lens


class Listener(nn.Module):
    """The pyramidal BiLSTM listener (``encoder_arch: blstm``), or its
    forward-only variant (``model.enc_bidirectional: false``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        in_dim = cfg.n_mels
        if cfg.conv_subsample > 0:
            self.conv = conv_stem_params(cfg)
            in_dim = conv_stem_dims(cfg)
        cell = BiLSTMWeights if cfg.enc_bidirectional else LSTMWeights
        layers = []
        for _ in range(cfg.enc_base_layers):
            layers.append(cell(in_dim, cfg.enc_hidden))
            in_dim = cfg.enc_out_dim
        for _ in range(cfg.enc_layers):
            # the pyramid fold doubles the feature dim before the (Bi)LSTM
            layers.append(cell(2 * in_dim, cfg.enc_hidden))
            in_dim = cfg.enc_out_dim
        self.layers = nn.ModuleList(layers)

    def dropout_shapes(self, b: int, t: int) -> list[tuple[int, ...]]:
        """The shape of each ``model.enc_dropout`` site for features
        [b, t, n_mels]: every BiLSTM layer's output, base and pyramid."""
        t = stem_frames(t, self.cfg.conv_subsample)
        shapes = []
        for li in range(len(self.layers)):
            if li >= self.cfg.enc_base_layers:
                t //= 2
            shapes.append((b, t, self.cfg.enc_out_dim))
        return shapes

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                backend: str | None = None,
                masks: list[torch.Tensor] | None = None):
        """[B, T, n_mels], [B] -> (enc [B, T', enc_out_dim], enc_lens [B]).
        ``masks`` (training): the keep masks of the dropout sites
        (:meth:`dropout_shapes`), applied after each layer's kernels."""
        compute = R.dtype_of(self.cfg.compute_dtype)
        x, lens = feats.float(), feat_lens
        if self.cfg.conv_subsample > 0:
            x, lens = conv_stem_apply(self.conv, x, lens, compute)
        for li, layer in enumerate(self.layers):
            if li >= self.cfg.enc_base_layers:
                x, lens = R.pyramid_fold(x, lens)
            if self.cfg.enc_bidirectional:
                x = bilstm_kernel(layer.as_dict(), x, lens, compute, backend)
            else:
                x = lstm_kernel(layer.as_dict(), x, lens, False, compute,
                                backend)
            if masks is not None:
                x = dropout(x, masks[li], self.cfg.enc_dropout)
        return x, lens


def listener_stream_init(cfg: ModelConfig, b: int, device) -> tuple:
    """Zero (h, c) [B, H] float32 carries, one pair a layer: the state
    :func:`listener_apply_stream` resumes from."""
    if cfg.enc_bidirectional:
        raise ValueError("streaming needs a causal listener")
    z = torch.zeros((b, cfg.enc_hidden), dtype=torch.float32, device=device)
    return tuple((z, z) for _ in range(cfg.enc_base_layers + cfg.enc_layers))


@torch.no_grad()
def listener_apply_stream(
    listener: Listener,
    feats: torch.Tensor,        # [B, Tc, n_mels], Tc % time_reduction == 0
    state: tuple,               # listener_stream_init / the previous chunk
    frame_lens: torch.Tensor | None = None,   # the final chunk's lengths
    backend: str | None = None,
) -> tuple[torch.Tensor, tuple]:
    """One streaming chunk of the forward-only listener -> (enc [B,
    Tc/red, H], the new state).  Every layer's scan (K2 on the card)
    resumes from its carried (h, c), and the pyramid folds stay aligned
    because every chunk folds to whole output frames, so the chunks'
    outputs are the whole utterance's; ``frame_lens`` masks the final
    partial chunk as the batch path masks a padded row (invalid steps pass
    the carry through and emit zeros)."""
    cfg = listener.cfg
    if cfg.enc_bidirectional:
        raise ValueError("streaming needs a causal listener")
    if cfg.conv_subsample != 0:
        raise ValueError("streaming chunk path supports conv_subsample=0 "
                         "(the conv stem spans chunk boundaries)")
    compute = R.dtype_of(cfg.compute_dtype)
    x, lens = feats.float(), frame_lens
    new_state = []
    for li, (layer, (h0, c0)) in enumerate(zip(listener.layers, state)):
        if li >= cfg.enc_base_layers:
            x, lens = R.pyramid_fold(x, lens)
        x, st = lstm_kernel(layer.as_dict(), x, lens, False, compute,
                            backend, h0=h0, c0=c0, return_state=True)
        new_state.append(st)
    return x, tuple(new_state)
