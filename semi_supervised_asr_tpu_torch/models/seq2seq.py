"""Seq2seq model tying the Listener and the Speller.

Counterpart of ``semi_supervised_asr_tpu/models/seq2seq.py``.  Parameter
names mirror the JAX parameter tree's paths (``listener.layers.0.fwd.w_hh``,
``speller.attention.conv``, ...), so ``weights.py`` moves weights between
the two packages by name.
"""

from __future__ import annotations

import torch
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models.listener import Listener
from semi_supervised_asr_tpu_torch.models.speller import Speller
from semi_supervised_asr_tpu_torch.ops.frontend import frame_mask


class Seq2Seq(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.listener = Listener(cfg)
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
