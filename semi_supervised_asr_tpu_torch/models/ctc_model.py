"""The CTC model family (``model.family: ctc``).

Counterpart of ``semi_supervised_asr_tpu/models/ctc_model.py``: an
encoder-only model, the listener of ``model.encoder_arch`` and one linear
head to per-frame label posteriors (``ctc.{w, b}``, the same head the LAS
family's joint CTC-attention term uses, ``decode/ctc.py``), with the blank
at PAD (0).  It trains on the CTC NLL (``objectives/losses.py``) and
decodes by best path (``decode/ctc.py``) or the prefix beam
(``decode/ctc_beam.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models.seq2seq import (
    ctc_head, listener_class, run_listener,
)
from semi_supervised_asr_tpu_torch.ops.dropout import draw_keep_masks
from semi_supervised_asr_tpu_torch.ops.frontend import frame_mask


class CTCModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.listener = listener_class(cfg)(cfg)
        self.ctc = ctc_head(cfg)

    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor,
               backend: str | None = None, remat: bool = False,
               masks: list | None = None):
        """-> (enc [B, T', enc_out] float32, enc_mask [B, T'] bool);
        ``remat`` and ``masks`` (the listener's dropout) as in
        ``seq2seq.run_listener``."""
        enc, enc_lens = run_listener(self.listener, feats, feat_lens,
                                     backend, masks, remat)
        return enc, frame_mask(enc_lens, enc.shape[1])

    def dropout_masks(self, gen: torch.Generator, b: int, t: int, u: int,
                      device, rows: tuple[int, int, int] | None = None):
        """The listener's keep masks of one training pass (``model
        .enc_dropout``), or None; there is no speller -> (masks, None)."""
        enc = None
        if self.cfg.enc_dropout > 0.0:
            enc = draw_keep_masks(gen, self.listener.dropout_shapes(b, t),
                                  self.cfg.enc_dropout, device, rows)
        return enc, None
