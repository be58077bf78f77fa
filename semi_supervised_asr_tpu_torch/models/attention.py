"""Attention for the speller: location-aware, additive or dot product.

Counterpart of ``semi_supervised_asr_tpu/models/attention.py`` (same
parameter names and layouts; ``conv`` stays [W, 1, C]).  Location-aware
scoring (Chorowski et al. 2015):
score_t = v . tanh(W_q s + W_k h_t + W_f f_t + b), f = conv over the
previous alignment with SAME padding.  Pad frames score -1e30 before the
softmax and get exact zeros after it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        a = cfg.attn_dim
        self.w_query = nn.Parameter(torch.zeros(cfg.dec_hidden, a))
        self.w_key = nn.Parameter(torch.zeros(cfg.enc_out_dim, a))
        if cfg.attn_type not in ("location", "additive", "dot"):
            raise ValueError(f"unknown attn_type {cfg.attn_type!r}")
        self.kind = cfg.attn_type
        if cfg.attn_type != "dot":
            self.bias = nn.Parameter(torch.zeros(a))
            self.v = nn.Parameter(torch.zeros(a))
        if cfg.attn_type == "location":
            c = cfg.attn_conv_channels
            self.w_loc = nn.Parameter(torch.zeros(c, a))
            self.conv = nn.Parameter(torch.zeros(cfg.attn_conv_width, 1, c))

    def precompute_keys(self, enc: torch.Tensor) -> torch.Tensor:
        """[B, T, enc_out] -> [B, T, A]; computed once per utterance."""
        # .float(): a bf16 weight (train.bf16_weight_stream) widens to the
        # float32 activations, as JAX promotes it
        return torch.matmul(enc, self.w_key.float())

    def location_features(self, alpha: torch.Tensor) -> torch.Tensor:
        """Conv over the previous alignment: [B, T] -> [B, T, C], with lax
        SAME padding (an even width W pads (W-1)//2 left, the rest right).
        Computed as the W-tap windows times the [W, C] filter: its backward
        is a gather and a matmul, with no atomics, so that a step's bits do
        not depend on the run (cuDNN's default backward-filter algorithm
        for a conv sums with atomics on the card)."""
        width = self.conv.shape[0]
        left = (width - 1) // 2
        x = Fn.pad(alpha, (left, width - 1 - left))
        windows = x.unfold(1, width, 1)                       # [B, T, W]
        return torch.matmul(windows, self.conv.to(alpha.dtype)[:, 0])

    def attend(
        self,
        query: torch.Tensor,        # [B*, dec_hidden]
        prev_alpha: torch.Tensor,   # [B*, T]
        keys: torch.Tensor,         # [B*, T, A]
        values: torch.Tensor,       # [B*, T, enc_out]
        mask: torch.Tensor,         # [B*, T] bool, True on valid frames
        sharpening: float = 1.0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One attention step -> (context [B*, enc_out], alpha [B*, T])."""
        q = torch.matmul(query, self.w_query.float())
        if self.kind == "dot":
            scores = torch.einsum("ba,bta->bt", q, keys) / math.sqrt(q.shape[-1])
        else:
            e = q[:, None, :] + keys + self.bias
            if self.kind == "location":
                f = self.location_features(prev_alpha)
                e = e + torch.matmul(f, self.w_loc.float())
            scores = torch.matmul(torch.tanh(e), self.v.float())
        scores = torch.where(mask, scores * sharpening,
                             torch.full((), NEG_INF, device=scores.device))
        alpha = torch.softmax(scores, dim=-1)
        alpha = torch.where(mask, alpha, torch.zeros((), device=alpha.device))
        context = torch.bmm(alpha[:, None, :], values)[:, 0]
        return context, alpha


def initial_alpha(mask: torch.Tensor) -> torch.Tensor:
    """Uniform alignment over valid frames: [B*, T]."""
    m = mask.float()
    return m / torch.clamp_min(m.sum(dim=-1, keepdim=True), 1.0)
