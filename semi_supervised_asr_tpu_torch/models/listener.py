"""Listener: pyramidal BiLSTM encoder (Chan et al. 2015).

Counterpart of ``semi_supervised_asr_tpu/models/listener.py`` for the
serving path: ``conv_subsample=0``, bidirectional, no dropout.
``enc_base_layers`` full-rate BiLSTMs, then ``enc_layers`` pyramid stages
(fold T -> T/2, feature dim doubles, then a BiLSTM).  Outputs are float32
[B, T/2**enc_layers, 2*enc_hidden] with exact zeros on pad frames.

Every layer runs on the CUDA scan kernel (``ops/lstm_scan.py``) whatever
``model.lstm_backend`` says: the reference's ``xla`` scan exists for its
tensor-parallel mesh, which the port does not have.  CPU tensors take the
scan's plain version, as every kernel wrapper does; on the card only an
explicit ``backend="reference"`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from semi_supervised_asr_tpu.config import ModelConfig
from semi_supervised_asr_tpu_torch.ops import recurrent as R
from semi_supervised_asr_tpu_torch.ops.lstm_scan import bilstm_kernel


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
    """Refuse model options outside this slice with a clear message."""
    unsupported = {
        "model.family": (cfg.family, "las"),
        "model.encoder_arch": (cfg.encoder_arch, "blstm"),
        "model.decoder_arch": (cfg.decoder_arch, "lstm"),
        "model.conv_subsample": (cfg.conv_subsample, 0),
        "model.enc_bidirectional": (cfg.enc_bidirectional, True),
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


class Listener(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        layers = []
        in_dim = cfg.n_mels
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
        """[B, T, n_mels], [B] -> (enc [B, T/2**L, 2H], enc_lens [B])."""
        compute = R.dtype_of(self.cfg.compute_dtype)
        x, lens = feats.float(), feat_lens
        for li, layer in enumerate(self.layers):
            if li >= self.cfg.enc_base_layers:
                x, lens = R.pyramid_fold(x, lens)
            x = bilstm_kernel(layer.as_dict(), x, lens, compute, backend)
        return x, lens
