"""Transformer listener: conv-subsampled self-attention encoder.

Counterpart of ``semi_supervised_asr_tpu/models/transformer_listener.py``
(``model.encoder_arch: transformer``): the optional stride-2 conv stem
(``listener.conv_stem_apply``), a projection to d_model =
``cfg.enc_out_dim`` scaled by sqrt(d) plus sinusoidal positions, then
``enc_blocks`` pre-LN blocks -- multi-head self-attention with pad keys
masked, and a GELU (tanh) feed-forward -- each with a residual, and a final
LayerNorm.  Outputs are float32 with exact zeros on pad frames.

Products take operands in the compute dtype and give the compute dtype, as
the reference's ``x.astype(compute) @ w.astype(compute)`` does; LayerNorm
statistics, residuals and the softmax are float32.  ``model.attn_backend``
picks the attention core: ``flash`` goes through ``ops/flash_mhsa.py``
(kernel K5 on the card), ``xla`` through the materialised scores (plain
products).  Each keeps the reference's own scale operation (a multiply by
1/sqrt(hd) in ``flash``, a divide in ``xla``).  In training,
``model.enc_dropout`` drops each block's attention output (site 2i) and
feed-forward output (site 2i + 1) before its residual, with keep masks
the caller draws (``ops/dropout.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models.listener import (
    Leaves, check_supported, conv_stem_apply, conv_stem_dims,
    conv_stem_params, stem_frames,
)
from semi_supervised_asr_tpu_torch.ops import flash_mhsa as FM
from semi_supervised_asr_tpu_torch.ops import recurrent as R
from semi_supervised_asr_tpu_torch.ops.dropout import dropout


def ln_params(d: int) -> Leaves:
    return Leaves(g=(d,), b=(d,))


def attn_params(d: int) -> Leaves:
    return Leaves(wq=(d, d), wk=(d, d), wv=(d, d), wo=(d, d), bq=(d,),
                  bk=(d,), bv=(d,), bo=(d,))


def layer_norm(x: torch.Tensor, p: Leaves) -> torch.Tensor:
    """float32 LayerNorm, population variance, eps 1e-6."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p.g.float() + p.b.float()


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           compute: torch.dtype) -> torch.Tensor:
    """x @ w + b, all in the compute dtype."""
    return x.to(compute) @ w.to(compute) + b.to(compute)


def sinusoidal_positions(t: int, d: int) -> np.ndarray:
    """Fixed positions [t, d] (Vaswani 2017), float64 on the host, then
    float32."""
    pos = np.arange(t, dtype=np.float64)[:, None]
    i = np.arange(d // 2, dtype=np.float64)[None, :]
    ang = pos / np.power(10000.0, 2.0 * i / d)
    pe = np.zeros((t, d), np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe


def attention_core(q, k, v, key_mask, compute, attn_backend: str,
                   backend: str | None,
                   chunk_mask: torch.Tensor | None = None) -> torch.Tensor:
    """[B, T, H, hd] q, k, v -> context [B, T, H*hd] in the compute dtype.
    q and k may be float32 (the conformer's rotated ones): ``xla`` casts
    them inside the score product, ``flash`` in the wrapper.  ``chunk_mask``
    [T, T] (``xla`` only) also hides the keys a query may not see."""
    b, t, h, hd = v.shape
    if attn_backend == "flash":
        ctx = FM.mhsa(q, k, v, key_mask, sm_scale=float(1.0 / np.sqrt(hd)),
                      compute=compute, backend=backend)
        return ctx.reshape(b, t, h * hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(compute),
                          k.to(compute)).float()
    scores = scores / np.sqrt(hd)
    vis = key_mask[:, None, None, :]
    if chunk_mask is not None:
        vis = vis & chunk_mask[None, None, :, :]
    scores = scores.masked_fill(~vis, FM.MASKED)
    alpha = torch.softmax(scores, dim=-1).to(compute)
    return torch.einsum("bhqk,bkhd->bqhd", alpha, v).reshape(b, t, h * hd)


def mhsa(p: Leaves, x: torch.Tensor, key_mask: torch.Tensor, n_heads: int,
         compute: torch.dtype, attn_backend: str,
         backend: str | None = None) -> torch.Tensor:
    """Multi-head self-attention, pad keys masked -> float32 [B, T, d]."""
    b, t, d = x.shape
    hd = d // n_heads

    def proj(w, bias):
        return linear(x, w, bias, compute).reshape(b, t, n_heads, hd)

    ctx = attention_core(proj(p.wq, p.bq), proj(p.wk, p.bk),
                         proj(p.wv, p.bv), key_mask, compute, attn_backend,
                         backend)
    return linear(ctx, p.wo, p.bo, compute).float()


class AttentionListener(nn.Module):
    """What the transformer and conformer listeners share: the conv stem
    (``conv``, when ``model.conv_subsample`` > 0) and the projection to
    d_model (``proj``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        d = cfg.enc_out_dim
        if d % cfg.enc_heads:
            raise ValueError(f"d_model {d} (=2*enc_hidden) must divide "
                             f"enc_heads {cfg.enc_heads}")
        self.cfg = cfg
        in_dim = cfg.n_mels
        if cfg.conv_subsample > 0:
            self.conv = conv_stem_params(cfg)
            in_dim = conv_stem_dims(cfg)
        self.proj = Leaves(w=(in_dim, d), b=(d,))

    # model.enc_dropout sites per block
    SITES_PER_BLOCK = 0

    def dropout_shapes(self, b: int, t: int) -> list[tuple[int, ...]]:
        """The shape of each ``model.enc_dropout`` site for features
        [b, t, n_mels]: [b, T', d] each, site ``SITES_PER_BLOCK * i + j``
        the j-th of block i."""
        cfg = self.cfg
        shape = (b, stem_frames(t, cfg.conv_subsample), cfg.enc_out_dim)
        return [shape] * (self.SITES_PER_BLOCK * cfg.enc_blocks)

    def drop(self, h: torch.Tensor, masks: list[torch.Tensor] | None,
             i: int) -> torch.Tensor:
        """Site ``i``'s dropout of ``h`` when ``masks`` are given."""
        if masks is None:
            return h
        return dropout(h, masks[i], self.cfg.enc_dropout)

    def input_projection(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                         compute: torch.dtype, causal: bool = False):
        """The stem (if any; ``causal``: padded (2, 0) in time) and the
        projection -> (x float32 [B, T', d], lens, key mask [B, T'])."""
        x, lens = feats.float(), feat_lens
        if self.cfg.conv_subsample > 0:
            x, lens = conv_stem_apply(self.conv, x, lens, compute, causal)
        x = (x.to(compute) @ self.proj.w.to(compute)).float() \
            + self.proj.b.float()
        t = x.shape[1]
        mask = torch.arange(t, device=x.device)[None, :] < lens[:, None]
        return x, lens, mask


class TransformerBlock(nn.Module):
    def __init__(self, d: int, ff: int):
        super().__init__()
        self.ln1 = ln_params(d)
        self.attn = attn_params(d)
        self.ln2 = ln_params(d)
        self.ffn = Leaves(w1=(d, ff), b1=(ff,), w2=(ff, d), b2=(d,))


class TransformerListener(AttentionListener):
    SITES_PER_BLOCK = 2

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d = cfg.enc_out_dim
        self.blocks = nn.ModuleList([TransformerBlock(d, cfg.enc_ff_dim)
                                     for _ in range(cfg.enc_blocks)])
        self.ln_f = ln_params(d)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                backend: str | None = None,
                masks: list[torch.Tensor] | None = None):
        """[B, T, n_mels], [B] -> (enc [B, T/2**conv_subsample, d] float32,
        enc_lens [B]); ``masks``: the dropout sites' keep masks."""
        cfg = self.cfg
        compute = R.dtype_of(cfg.compute_dtype)
        d = cfg.enc_out_dim
        x, lens, mask = self.input_projection(feats, feat_lens, compute)
        pos = torch.from_numpy(sinusoidal_positions(x.shape[1], d))
        x = x * np.sqrt(d) + pos.to(x.device)
        for i, blk in enumerate(self.blocks):
            h = mhsa(blk.attn, layer_norm(x, blk.ln1), mask, cfg.enc_heads,
                     compute, cfg.attn_backend, backend)
            x = x + self.drop(h, masks, 2 * i)
            f = blk.ffn
            h = Fn.gelu(linear(layer_norm(x, blk.ln2), f.w1, f.b1, compute),
                        approximate="tanh")
            h = (h @ f.w2.to(compute)).float() + f.b2.float()
            x = x + self.drop(h, masks, 2 * i + 1)
        x = layer_norm(x, self.ln_f)
        # listener contract: exact zeros on pad frames
        return torch.where(mask[:, :, None], x, 0.0), lens
