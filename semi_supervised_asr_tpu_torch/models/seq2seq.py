"""Seq2seq model tying the Listener and the Speller.

Counterpart of ``semi_supervised_asr_tpu/models/seq2seq.py``.  Parameter
names mirror the JAX parameter tree's paths (``listener.layers.0.fwd.w_hh``,
``listener.blocks.3.attn.wq``, ``speller.attention.conv``, ...), so
``weights.py`` moves weights between the two packages by name.  The
listener is the pyramidal BiLSTM, the transformer or the conformer, after
``model.encoder_arch``.
"""

from __future__ import annotations

import torch
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models.conformer_listener import (
    ConformerListener,
)
from semi_supervised_asr_tpu_torch.models.listener import Listener
from semi_supervised_asr_tpu_torch.models.speller import Speller
from semi_supervised_asr_tpu_torch.models.transformer_listener import (
    TransformerListener,
)
from semi_supervised_asr_tpu_torch.ops.frontend import frame_mask


def listener_class(cfg: ModelConfig) -> type[nn.Module]:
    """The listener of the configured encoder architecture (the
    reference's ``_listener_fns``, with its two checks)."""
    if not (cfg.enc_bidirectional or cfg.encoder_arch == "blstm"):
        raise ValueError(
            "model.enc_bidirectional=false (streaming encoder) is only "
            "meaningful for encoder_arch=blstm -- the attention listeners "
            f"are inherently full-context (got {cfg.encoder_arch!r})")
    if not (cfg.enc_attn_chunk == 0 or cfg.encoder_arch == "conformer"):
        raise ValueError(
            "model.enc_attn_chunk (chunk-causal attention) is conformer-only "
            f"(got encoder_arch={cfg.encoder_arch!r})")
    archs = {"blstm": Listener, "transformer": TransformerListener,
             "conformer": ConformerListener}
    if cfg.encoder_arch not in archs:
        raise ValueError(f"unknown model.encoder_arch {cfg.encoder_arch!r}")
    return archs[cfg.encoder_arch]


class Seq2Seq(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.listener = listener_class(cfg)(cfg)
        self.speller = Speller(cfg)

    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor,
               backend: str | None = None):
        """-> (enc [B, T', 2H], enc_mask [B, T'] bool, keys [B, T', A]),
        the decode cache."""
        enc, enc_lens = self.listener(feats, feat_lens, backend)
        enc_mask = frame_mask(enc_lens, enc.shape[1])
        keys = self.speller.precompute_decode_cache(enc)
        return enc, enc_mask, keys

    def forward_teacher(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                        tokens_in: torch.Tensor, tf_rate: float = 1.0,
                        gen: torch.Generator | None = None,
                        backend: str | None = None):
        """Full teacher-forced pass -> (logits [B, U, V], alphas
        [B, U, T'])."""
        enc, enc_lens = self.listener(feats, feat_lens, backend)
        enc_mask = frame_mask(enc_lens, enc.shape[1])
        return self.speller.forward_teacher(enc, enc_mask, tokens_in,
                                            tf_rate, gen)
