"""Conformer listener: convolution-augmented transformer encoder.

Counterpart of ``semi_supervised_asr_tpu/models/conformer_listener.py``
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
inside K5.

The chunk-causal conformer (``model.enc_attn_chunk`` > 0, WeNet-U2): a
query in chunk c sees the keys of chunks c - ``enc_attn_left_chunks`` ... c
(:func:`_chunk_mask`; all past chunks at -1), the depthwise conv pads only
on the left (width - 1 taps) and the stem pads time (2, 0), so that nothing
reads ahead of its chunk.  Its attention takes the materialised scores
(``attn_backend: xla``, plain products, as the reference computes them
outside any kernel); ``flash`` with a chunk mask is refused.
:func:`conformer_listener_apply_stream` runs one chunk at a time from
per-block caches of the last ``left_chunks * chunk`` rotated keys and
values and the conv's last width - 1 GLU frames, with rotary angles from a
float64 host table at each row's absolute position: the same function as
the offline chunked forward, the conv, feed-forward and LayerNorm chains
bit for bit, the attention within float32 rounding (its softmax sums the
cache's keys where the offline row also sums exact zeros).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models.listener import (
    Leaves, conv_stem_stream, conv_stem_stream_init,
)
from semi_supervised_asr_tpu_torch.models.transformer_listener import (
    AttentionListener, attention_core, attn_params, layer_norm, linear,
    ln_params,
)
from semi_supervised_asr_tpu_torch.ops import flash_mhsa as FM
from semi_supervised_asr_tpu_torch.ops import recurrent as R


def _rope_angles(t: int, hd: int) -> np.ndarray:
    """Rotation angles [t, hd//2], float64 on the host, then float32."""
    pos = np.arange(t, dtype=np.float64)[:, None]
    i = np.arange(hd // 2, dtype=np.float64)[None, :]
    return (pos / np.power(10000.0, 2.0 * i / hd)).astype(np.float32)


def _rope(x: torch.Tensor, cos: torch.Tensor,
          sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of x [b, t, h, hd] by position: cos, sin
    [t, hd//2] (one grid for the batch) or [b, t, hd//2] (streaming: each
    row at its own absolute positions)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    if cos.dim() == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                       dim=-1).reshape(x.shape)


# the reference's refusal of the chunk mask on the flash route
_FLASH_CHUNK = ("enc_attn_chunk needs attn_backend=xla — the flash kernel's "
                "segment ids cannot express a sliding left-context window")


def _chunk_mask(t: int, chunk: int, left_chunks: int) -> np.ndarray:
    """[t, t] bool: query i sees key j when j's chunk is i's or one of the
    ``left_chunks`` before it (every earlier one at -1), nothing ahead."""
    c = np.arange(t) // chunk
    vis = c[None, :] <= c[:, None]
    if left_chunks >= 0:
        vis &= c[:, None] - c[None, :] <= left_chunks
    return vis


def _mhsa_rope(p: nn.Module, x: torch.Tensor, key_mask: torch.Tensor,
               n_heads: int, compute: torch.dtype, attn_backend: str,
               backend: str | None,
               chunk_mask: torch.Tensor | None = None) -> torch.Tensor:
    """MHSA with rotary q and k, pad keys masked, and keys outside
    ``chunk_mask`` [T, T] too -> float32 [B, T, d]."""
    b, t, d = x.shape
    hd = d // n_heads

    def proj(w, bias):
        return linear(x, w, bias, compute).reshape(b, t, n_heads, hd)

    ang = torch.from_numpy(_rope_angles(t, hd)).to(x.device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    q = _rope(proj(p.wq, p.bq).float(), cos, sin)
    k = _rope(proj(p.wk, p.bk).float(), cos, sin)
    if chunk_mask is not None and attn_backend != "xla":
        raise ValueError(_FLASH_CHUNK)
    ctx = attention_core(q, k, proj(p.wv, p.bv), key_mask, compute,
                         attn_backend, backend, chunk_mask)
    return linear(ctx, p.wo, p.bo, compute).float()


def _ff(p: nn.Module, x: torch.Tensor, compute: torch.dtype) -> torch.Tensor:
    h = Fn.silu(linear(layer_norm(x, p.ln), p.w1, p.b1, compute))
    return (h @ p.w2.to(compute)).float() + p.b2.float()


def _glu(p: nn.Module, x: torch.Tensor, mask: torch.Tensor,
         compute: torch.dtype) -> torch.Tensor:
    """The conv module's LN -> pointwise 2d -> GLU, pad frames zeroed."""
    h = linear(layer_norm(x, p.ln), p.w_pw1, p.b_pw1, compute)
    a, g = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(g)                           # GLU -> [B, T, d]
    return h.masked_fill(~mask[:, :, None], 0.0)


def _conv_tail(p: nn.Module, hp: torch.Tensor, t: int,
               compute: torch.dtype) -> torch.Tensor:
    """The depthwise conv over the time-padded GLU frames hp [B, t + W - 1,
    d] (taps in order, float32 accumulator) -> LN -> SiLU -> pointwise."""
    w = p.w_dw.float()                                 # [W, d]
    acc = torch.zeros((hp.shape[0], t, hp.shape[2]), dtype=torch.float32,
                      device=hp.device)
    for i in range(w.shape[0]):
        acc = acc + hp[:, i:i + t].float() * w[i]
    h = layer_norm(acc + p.b_dw.float(), p.ln2).to(compute)
    h = Fn.silu(h)
    return (h @ p.w_pw2.to(compute)).float() + p.b_pw2.float()


def _conv_module(p: nn.Module, x: torch.Tensor, mask: torch.Tensor,
                 compute: torch.dtype, causal: bool = False) -> torch.Tensor:
    """LN -> pointwise 2d + GLU -> masked depthwise conv -> LN -> SiLU ->
    pointwise; the elementwise chain in the compute dtype, the conv's
    accumulator and the LayerNorms in float32.  ``causal`` pads the conv
    with all width - 1 taps on the left (frame t reads frames <= t)."""
    h = _glu(p, x, mask, compute)
    width = p.w_dw.shape[0]
    left = width - 1 if causal else (width - 1) // 2
    return _conv_tail(p, Fn.pad(h, (0, 0, left, width - 1 - left)),
                      h.shape[1], compute)


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
        if cfg.enc_attn_chunk > 0 and cfg.attn_backend != "xla":
            raise ValueError(_FLASH_CHUNK)
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
        chunked = cfg.enc_attn_chunk > 0
        x, lens, mask = self.input_projection(feats, feat_lens, compute,
                                              causal=chunked)
        cmask = None
        if chunked:
            cmask = torch.from_numpy(_chunk_mask(
                x.shape[1], cfg.enc_attn_chunk,
                cfg.enc_attn_left_chunks)).to(x.device)
        for i, blk in enumerate(self.blocks):
            x = x + 0.5 * self.drop(_ff(blk.ff1, x, compute), masks, 4 * i)
            h = _mhsa_rope(blk.attn, layer_norm(x, blk.attn.ln), mask,
                           cfg.enc_heads, compute, cfg.attn_backend, backend,
                           cmask)
            x = x + self.drop(h, masks, 4 * i + 1)
            x = x + self.drop(_conv_module(blk.conv, x, mask, compute,
                                           chunked), masks, 4 * i + 2)
            x = x + 0.5 * self.drop(_ff(blk.ff2, x, compute), masks,
                                    4 * i + 3)
            x = layer_norm(x, blk.ln_out)
        # listener contract: exact zeros on pad frames
        return torch.where(mask[:, :, None], x, 0.0), lens


# ---- chunked streaming (enc_attn_chunk > 0, enc_attn_left_chunks >= 0) ----

def conformer_rope_table(cfg: ModelConfig, max_frames: int,
                         device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [max_frames, hd//2] float32: the absolute-position
    rotation table streaming indexes at each row's position, from the same
    float64 host angles as the offline path's."""
    hd = cfg.enc_out_dim // cfg.enc_heads
    ang = torch.from_numpy(_rope_angles(max_frames, hd)).to(device)
    return torch.cos(ang), torch.sin(ang)


def _stream_asserts(cfg: ModelConfig) -> None:
    if cfg.encoder_arch != "conformer":
        raise ValueError(f"conformer streaming needs encoder_arch="
                         f"conformer, got {cfg.encoder_arch!r}")
    if cfg.enc_attn_chunk <= 0:
        raise ValueError("conformer streaming needs model.enc_attn_chunk > 0 "
                         "(chunk-causal attention)")
    if cfg.enc_attn_left_chunks < 0:
        raise ValueError("conformer streaming needs model.enc_attn_left_chunks"
                         " >= 0 — unlimited left context would need an "
                         "unbounded cache")


def conformer_stream_init(cfg: ModelConfig, b: int, device) -> dict:
    """Zero caches: per block the last W = left_chunks * chunk frames of
    rotated keys (float32) and values (compute dtype) and the causal
    conv's width - 1 GLU frames; the causal stem's 2-frame carries; and
    each row's absolute frame position."""
    _stream_asserts(cfg)
    compute = R.dtype_of(cfg.compute_dtype)
    d = cfg.enc_out_dim
    hd = d // cfg.enc_heads
    w_ctx = cfg.enc_attn_left_chunks * cfg.enc_attn_chunk

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    blocks = tuple(
        {"k": zeros((b, w_ctx, cfg.enc_heads, hd), torch.float32),
         "v": zeros((b, w_ctx, cfg.enc_heads, hd), compute),
         "conv": zeros((b, cfg.conformer_conv_width - 1, d), compute)}
        for _ in range(cfg.enc_blocks))
    return {"pos": zeros((b,), torch.int64),
            "stem": conv_stem_stream_init(cfg, b, device),
            "blocks": blocks}


def _mhsa_rope_stream(p: nn.Module, x: torch.Tensor, st: dict,
                      cache_valid: torch.Tensor, cur_mask: torch.Tensor,
                      n_heads: int, compute: torch.dtype, cos: torch.Tensor,
                      sin: torch.Tensor):
    """One chunk of chunk-causal MHSA over (cache ++ chunk) keys -> (out
    [B, t, d] float32, the new key and value caches)."""
    b, t, d = x.shape
    hd = d // n_heads

    def proj(w, bias):
        return linear(x, w, bias, compute).reshape(b, t, n_heads, hd)

    q = _rope(proj(p.wq, p.bq).float(), cos, sin)
    k_all = torch.cat([st["k"], _rope(proj(p.wk, p.bk).float(), cos, sin)],
                      dim=1)
    v_all = torch.cat([st["v"].to(compute), proj(p.wv, p.bv)], dim=1)
    key_mask = torch.cat([cache_valid, cur_mask], dim=1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(compute),
                          k_all.to(compute)).float() / np.sqrt(hd)
    scores = scores.masked_fill(~key_mask[:, None, None, :], FM.MASKED)
    alpha = torch.softmax(scores, dim=-1).to(compute)
    ctx = torch.einsum("bhqk,bkhd->bqhd", alpha, v_all).reshape(b, t, d)
    out = linear(ctx, p.wo, p.bo, compute).float()
    w_ctx = st["k"].shape[1]
    keep = k_all.shape[1] - w_ctx
    return out, k_all[:, keep:], v_all[:, keep:].to(st["v"].dtype)


@torch.no_grad()
def conformer_listener_apply_stream(
    listener: ConformerListener,
    feats: torch.Tensor,    # [B, enc_attn_chunk * 2**conv_subsample, n_mels]
    state: dict,            # conformer_stream_init / the previous chunk
    rope: tuple[torch.Tensor, torch.Tensor],    # conformer_rope_table
    frame_lens: torch.Tensor | None = None,     # [B], the final chunk only
) -> tuple[torch.Tensor, dict]:
    """One streaming chunk -> (enc [B, chunk, d] float32, the new state):
    one attention chunk of feature frames through the causal stem (resumed
    from its carries), the projection and every block (attention over the
    cached keys, the causal conv resumed from its cached frames).  Cached
    frames count as valid, which holds for each stream on its own."""
    cfg = listener.cfg
    _stream_asserts(cfg)
    compute = R.dtype_of(cfg.compute_dtype)
    chunk = cfg.enc_attn_chunk
    b, t_in, _ = feats.shape
    if t_in != chunk * 2 ** cfg.conv_subsample:
        raise ValueError(f"stream chunks must be exactly enc_attn_chunk * "
                         f"2**conv_subsample feature frames (got {t_in}, want "
                         f"{chunk * 2 ** cfg.conv_subsample})")
    x, lens, new_stem = feats.float(), frame_lens, state["stem"]
    if cfg.conv_subsample > 0:
        x, new_stem, lens = conv_stem_stream(listener.conv, x, compute,
                                             state["stem"], lens)
    x = (x.to(compute) @ listener.proj.w.to(compute)).float() \
        + listener.proj.b.float()
    steps = torch.arange(chunk, device=x.device)
    mask = (torch.ones((b, chunk), dtype=torch.bool, device=x.device)
            if lens is None else steps[None, :] < lens[:, None])
    pos = state["pos"]                              # [B] absolute frames
    idx = pos[:, None] + steps[None, :]
    cos, sin = rope[0][idx], rope[1][idx]           # [B, chunk, hd//2]
    w_ctx = cfg.enc_attn_left_chunks * chunk
    cache_valid = torch.arange(w_ctx, device=x.device)[None, :] \
        >= w_ctx - torch.clamp_max(pos, w_ctx)[:, None]
    new_blocks = []
    for blk, st in zip(listener.blocks, state["blocks"]):
        x = x + 0.5 * _ff(blk.ff1, x, compute)
        h, new_k, new_v = _mhsa_rope_stream(
            blk.attn, layer_norm(x, blk.attn.ln), st, cache_valid, mask,
            cfg.enc_heads, compute, cos, sin)
        x = x + h
        g = _glu(blk.conv, x, mask, compute)
        hp = torch.cat([st["conv"].to(compute), g], dim=1)
        x = x + _conv_tail(blk.conv, hp, chunk, compute)
        x = x + 0.5 * _ff(blk.ff2, x, compute)
        x = layer_norm(x, blk.ln_out)
        new_blocks.append({"k": new_k, "v": new_v,
                           "conv": hp[:, chunk:].to(st["conv"].dtype)})
    out = torch.where(mask[:, :, None], x, 0.0)
    return out, {"pos": pos + chunk, "stem": new_stem,
                 "blocks": tuple(new_blocks)}
