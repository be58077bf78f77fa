"""Speller: attention LSTM decoder, one step at a time.

Counterpart of the decode side of ``semi_supervised_asr_tpu/models/
speller.py``: ``precompute_decode_cache``, ``init_state`` and
``speller_step`` for the LSTM speller, with tied or untied output.  The
decoder state is a dict of tensors whose lattice-row axis is 0 (``h`` and
``c`` are layer-stacked [L, B*, H], row axis 1), so the beam reorders it
with one index per leaf.  Training (teacher forcing, scheduled sampling,
dropout) comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from semi_supervised_asr_tpu.config import ModelConfig
from semi_supervised_asr_tpu_torch.models.attention import (
    Attention, initial_alpha,
)
from semi_supervised_asr_tpu_torch.models.listener import (
    LSTMWeights, check_supported,
)
from semi_supervised_asr_tpu_torch.ops import recurrent as R


class Speller(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                  cfg.embed_dim))
        cells = []
        in_dim = cfg.embed_dim + cfg.enc_out_dim
        for _ in range(cfg.dec_layers):
            cells.append(LSTMWeights(in_dim, cfg.dec_hidden))
            in_dim = cfg.dec_hidden
        self.cells = nn.ModuleList(cells)
        self.attention = Attention(cfg)
        self.b_out = nn.Parameter(torch.zeros(cfg.vocab_size))
        out_in = cfg.dec_hidden + cfg.enc_out_dim
        if cfg.tie_embedding:
            self.w_tie = nn.Parameter(torch.zeros(out_in, cfg.embed_dim))
        else:
            self.w_out = nn.Parameter(torch.zeros(out_in, cfg.vocab_size))

    def precompute_decode_cache(self, enc: torch.Tensor) -> torch.Tensor:
        """Attention key projections [B, T, A], computed once per batch."""
        return self.attention.precompute_keys(enc)

    def init_state(self, batch: int, mask: torch.Tensor) -> dict:
        """Fresh decoder state for ``batch`` lattice rows."""
        cfg, dev = self.cfg, mask.device
        zeros = torch.zeros((cfg.dec_layers, batch, cfg.dec_hidden),
                            dtype=torch.float32, device=dev)
        return {
            "h": zeros,
            "c": zeros.clone(),
            "context": torch.zeros((batch, cfg.enc_out_dim),
                                   dtype=torch.float32, device=dev),
            "alpha": initial_alpha(mask),
        }

    def step(
        self,
        state: dict,
        tokens: torch.Tensor,     # [B*] previous tokens
        keys: torch.Tensor,       # [B*, T, A]
        values: torch.Tensor,     # [B*, T, enc_out]
        mask: torch.Tensor,       # [B*, T] bool
    ) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """-> (new_state, logits [B*, V] float32, alpha [B*, T])."""
        cfg = self.cfg
        compute = R.dtype_of(cfg.compute_dtype)
        emb = self.embedding[tokens.long()].float()
        x = torch.cat([emb, state["context"]], dim=-1)
        hs, cs = [], []
        for i, cell in enumerate(self.cells):
            h, c = R.lstm_single_step(cell.as_dict(), x, state["h"][i],
                                      state["c"][i], compute)
            hs.append(h)
            cs.append(c)
            x = h
        h_top = hs[-1]
        context, alpha = self.attention.attend(
            h_top, state["alpha"], keys, values, mask, cfg.attn_sharpening,
        )
        out_in = torch.cat([h_top, context], dim=-1)
        if cfg.tie_embedding:
            proj = R.mm(out_in, self.w_tie, compute)
            logits = R.mm(proj, self.embedding.t(), compute)
        else:
            logits = R.mm(out_in, self.w_out, compute)
        logits = logits + self.b_out.float()
        new_state = {"h": torch.stack(hs), "c": torch.stack(cs),
                     "context": context, "alpha": alpha}
        return new_state, logits, alpha
