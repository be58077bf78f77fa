"""Listener: pyramidal BiLSTM encoder (Chan et al. 2015), and the conv stem.

Counterpart of ``semi_supervised_asr_tpu/models/listener.py``: an optional
stride-2 3x3 conv stem (``model.conv_subsample`` blocks, shared with the
transformer and conformer listeners), then ``enc_base_layers`` full-rate
BiLSTMs, then ``enc_layers`` pyramid stages (fold T -> T/2, feature dim
doubles, then a BiLSTM); bidirectional, no dropout.  Outputs are float32
[B, T/2**(enc_layers + conv_subsample), 2*enc_hidden] with exact zeros on
pad frames.

Every layer runs on the CUDA scan kernel (``ops/lstm_scan.py``) whatever
``model.lstm_backend`` says: the reference's ``xla`` scan exists for its
tensor-parallel mesh, which the port does not have.  CPU tensors take the
scan's plain version, as every kernel wrapper does; on the card only an
explicit ``backend="reference"`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.ops import recurrent as R
from semi_supervised_asr_tpu_torch.ops.lstm_scan import bilstm_kernel


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
    unsupported = {
        "model.family": (cfg.family, "las"),
        "model.decoder_arch": (cfg.decoder_arch, "lstm"),
        "model.enc_bidirectional": (cfg.enc_bidirectional, True),
        "model.enc_attn_chunk": (cfg.enc_attn_chunk, 0),
        "model.lm_fusion": (cfg.lm_fusion, "none"),
        "model.ctc_head": (cfg.ctc_head, False),
    }
    for key, (got, want) in unsupported.items():
        if got != want:
            raise NotImplementedError(
                f"{key}={got!r} is not ported yet (the PyTorch port serves "
                f"{key}={want!r})"
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


def _same_pad(n: int) -> tuple[int, int]:
    """XLA's SAME padding of a length-n axis for kernel 3, stride 2: (0, 1)
    for even n, (1, 1) for odd n."""
    out = -(-n // 2)
    tot = max((out - 1) * 2 + 3 - n, 0)
    return tot // 2, tot - tot // 2


def conv_stem_apply(
    convs: nn.ModuleList,
    x: torch.Tensor,            # [B, T, F], zeros on pad frames
    lens: torch.Tensor,         # [B]
    compute: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ([B, ceil(T/2^N), F'*C] float32, new lens), features F-major and
    C-minor as JAX's NHWC reshape gives them.  Each block: SAME-padded
    stride-2 conv in the compute dtype, float32 bias, ReLU, then the pad
    frames are zeroed again (bias + ReLU would leak into them)."""
    h = x.float()[:, None]                             # [B, 1, T, F]
    for p in convs:
        pt, pf = _same_pad(h.shape[2]), _same_pad(h.shape[3])
        hp = Fn.pad(h.to(compute), (*pf, *pt))
        w = p.w.to(compute).permute(3, 2, 0, 1)        # HWIO -> OIHW
        y = Fn.conv2d(hp, w, stride=2).float() + p.b.float()[:, None, None]
        y = torch.relu(y)
        lens = torch.div(lens + 1, 2, rounding_mode="floor")
        keep = torch.arange(y.shape[2], device=y.device)[None, :] < \
            lens[:, None]
        h = torch.where(keep[:, None, :, None], y, 0.0)
    b, c, t, f = h.shape
    return h.permute(0, 2, 3, 1).reshape(b, t, f * c), lens


class Listener(nn.Module):
    """The pyramidal BiLSTM listener (``encoder_arch: blstm``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        in_dim = cfg.n_mels
        if cfg.conv_subsample > 0:
            self.conv = conv_stem_params(cfg)
            in_dim = conv_stem_dims(cfg)
        layers = []
        for _ in range(cfg.enc_base_layers):
            layers.append(BiLSTMWeights(in_dim, cfg.enc_hidden))
            in_dim = cfg.enc_out_dim
        for _ in range(cfg.enc_layers):
            # the pyramid fold doubles the feature dim before the BiLSTM
            layers.append(BiLSTMWeights(2 * in_dim, cfg.enc_hidden))
            in_dim = cfg.enc_out_dim
        self.layers = nn.ModuleList(layers)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                backend: str | None = None):
        """[B, T, n_mels], [B] -> (enc [B, T', 2H], enc_lens [B])."""
        compute = R.dtype_of(self.cfg.compute_dtype)
        x, lens = feats.float(), feat_lens
        if self.cfg.conv_subsample > 0:
            x, lens = conv_stem_apply(self.conv, x, lens, compute)
        for li, layer in enumerate(self.layers):
            if li >= self.cfg.enc_base_layers:
                x, lens = R.pyramid_fold(x, lens)
            x = bilstm_kernel(layer.as_dict(), x, lens, compute, backend)
        return x, lens
