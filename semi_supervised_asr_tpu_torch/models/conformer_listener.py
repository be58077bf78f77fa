"""Conformer listener: convolution-augmented transformer encoder.

Counterpart of the offline part of
``semi_supervised_asr_tpu/models/conformer_listener.py``
(``model.encoder_arch: conformer``, Gulati et al. 2020).  After the conv
stem and the projection to d_model = ``cfg.enc_out_dim``, each block is,
in macaron order:

* half-step feed-forward:  x += 0.5 * FF(LN(x))     (SiLU, enc_ff_dim)
* self-attention:          x += MHSA(LN(x))          (rotary q and k)
* convolution module:      x += Conv(LN(x))          (pointwise d -> 2d,
  GLU, pad frames zeroed, depthwise conv of ``conformer_conv_width`` taps,
  LayerNorm, SiLU, pointwise d -> d)
* half-step feed-forward:  x += 0.5 * FF(LN(x))
* the block's output LayerNorm

Rotary positions rotate interleaved pairs (x[..., 0::2], x[..., 1::2]) by
angles computed in float64 on the host; q and k leave the rotation in
float32 and reach the compute dtype only in the score product (inside
``ops/flash_mhsa.py`` for ``attn_backend: flash``, kernel K5 on the card).
The depthwise conv is the reference's shifted multiply-adds: taps in the
compute dtype, accumulated in float32 in tap order, SAME left padding
(width-1)//2.  Outputs are float32 with exact zeros on pad frames.

In training, ``model.enc_dropout`` drops each block's ff1, attention,
conv-module and ff2 outputs (sites 4i ... 4i + 3) before their residuals,
with keep masks the caller draws (``ops/dropout.py``); none of them is
inside K5.  The chunk-causal and streaming conformer
(``model.enc_attn_chunk > 0``) is not ported: the model refuses it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models.listener import Leaves
from semi_supervised_asr_tpu_torch.models.transformer_listener import (
    AttentionListener, attention_core, attn_params, layer_norm, linear,
    ln_params,
)
from semi_supervised_asr_tpu_torch.ops import recurrent as R


def _rope_angles(t: int, hd: int) -> np.ndarray:
    """Rotation angles [t, hd//2], float64 on the host, then float32."""
    pos = np.arange(t, dtype=np.float64)[:, None]
    i = np.arange(hd // 2, dtype=np.float64)[None, :]
    return (pos / np.power(10000.0, 2.0 * i / hd)).astype(np.float32)


def _rope(x: torch.Tensor, cos: torch.Tensor,
          sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of x [b, t, h, hd] by position (cos, sin
    [t, hd//2])."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                       dim=-1).reshape(x.shape)


def _mhsa_rope(p: nn.Module, x: torch.Tensor, key_mask: torch.Tensor,
               n_heads: int, compute: torch.dtype, attn_backend: str,
               backend: str | None) -> torch.Tensor:
    """MHSA with rotary q and k, pad keys masked -> float32 [B, T, d]."""
    b, t, d = x.shape
    hd = d // n_heads

    def proj(w, bias):
        return linear(x, w, bias, compute).reshape(b, t, n_heads, hd)

    ang = torch.from_numpy(_rope_angles(t, hd)).to(x.device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    q = _rope(proj(p.wq, p.bq).float(), cos, sin)
    k = _rope(proj(p.wk, p.bk).float(), cos, sin)
    ctx = attention_core(q, k, proj(p.wv, p.bv), key_mask, compute,
                         attn_backend, backend)
    return linear(ctx, p.wo, p.bo, compute).float()


def _ff(p: nn.Module, x: torch.Tensor, compute: torch.dtype) -> torch.Tensor:
    h = Fn.silu(linear(layer_norm(x, p.ln), p.w1, p.b1, compute))
    return (h @ p.w2.to(compute)).float() + p.b2.float()


def _conv_module(p: nn.Module, x: torch.Tensor, mask: torch.Tensor,
                 compute: torch.dtype) -> torch.Tensor:
    """LN -> pointwise 2d + GLU -> masked depthwise conv -> LN -> SiLU ->
    pointwise; the elementwise chain in the compute dtype, the conv's
    accumulator and the LayerNorms in float32."""
    h = linear(layer_norm(x, p.ln), p.w_pw1, p.b_pw1, compute)
    a, g = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(g)                           # GLU -> [B, T, d]
    h = h.masked_fill(~mask[:, :, None], 0.0)
    w = p.w_dw.float()                                 # [W, d]
    width, t = w.shape[0], h.shape[1]
    left = (width - 1) // 2
    hp = Fn.pad(h, (0, 0, left, width - 1 - left))
    acc = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for i in range(width):
        acc = acc + hp[:, i:i + t].float() * w[i]
    h = layer_norm(acc + p.b_dw.float(), p.ln2).to(compute)
    h = Fn.silu(h)
    return (h @ p.w_pw2.to(compute)).float() + p.b_pw2.float()


def _ff_params(d: int, ff: int) -> Leaves:
    p = Leaves(w1=(d, ff), b1=(ff,), w2=(ff, d), b2=(d,))
    p.ln = ln_params(d)
    return p


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, d: int):
        super().__init__()
        self.ff1 = _ff_params(d, cfg.enc_ff_dim)
        self.attn = attn_params(d)
        self.attn.ln = ln_params(d)
        self.conv = Leaves(w_pw1=(d, 2 * d), b_pw1=(2 * d,),
                           w_dw=(cfg.conformer_conv_width, d), b_dw=(d,),
                           w_pw2=(d, d), b_pw2=(d,))
        self.conv.ln = ln_params(d)
        self.conv.ln2 = ln_params(d)
        self.ff2 = _ff_params(d, cfg.enc_ff_dim)
        self.ln_out = ln_params(d)


class ConformerListener(AttentionListener):
    SITES_PER_BLOCK = 4

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d = cfg.enc_out_dim
        if (d // cfg.enc_heads) % 2:
            raise ValueError(f"RoPE rotates pairs: head dim "
                             f"{d // cfg.enc_heads} must be even")
        self.blocks = nn.ModuleList([ConformerBlock(cfg, d)
                                     for _ in range(cfg.enc_blocks)])

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                backend: str | None = None,
                masks: list[torch.Tensor] | None = None):
        """[B, T, n_mels], [B] -> (enc [B, T/2**conv_subsample, d] float32,
        enc_lens [B]); ``masks``: the dropout sites' keep masks (ff1,
        attention, conv module and ff2 of block i at 4i ... 4i + 3)."""
        cfg = self.cfg
        compute = R.dtype_of(cfg.compute_dtype)
        x, lens, mask = self.input_projection(feats, feat_lens, compute)
        for i, blk in enumerate(self.blocks):
            x = x + 0.5 * self.drop(_ff(blk.ff1, x, compute), masks, 4 * i)
            h = _mhsa_rope(blk.attn, layer_norm(x, blk.attn.ln), mask,
                           cfg.enc_heads, compute, cfg.attn_backend, backend)
            x = x + self.drop(h, masks, 4 * i + 1)
            x = x + self.drop(_conv_module(blk.conv, x, mask, compute),
                              masks, 4 * i + 2)
            x = x + 0.5 * self.drop(_ff(blk.ff2, x, compute), masks,
                                    4 * i + 3)
            x = layer_norm(x, blk.ln_out)
        # listener contract: exact zeros on pad frames
        return torch.where(mask[:, :, None], x, 0.0), lens
