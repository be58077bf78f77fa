"""Transformer speller: causal self-attention decoder with cross-attention.

Counterpart of ``semi_supervised_asr_tpu/models/transformer_speller.py``
(``model.decoder_arch: transformer``).  d_model is ``model.dec_hidden``;
the embedding table is [V, d_model] (``model.embed_dim`` is unused) and
learned positions [``model.dec_max_len``, d_model] are added to it.  Each
of the ``model.dec_blocks`` pre-LN blocks runs causal self-attention,
cross-attention over the encoder and a GELU (tanh) feed-forward, each with
a residual; a final LayerNorm, then the output projection (the embedding's
transpose with ``model.tie_embedding``).

The parameters keep the reference's names and layout: ``blocks.<i>.wq`` /
``wk`` / ``wv`` / ``cq`` / ``ck`` / ``cv`` are [in, heads, d_head], the
head count living in the shape, and ``wo`` / ``co`` / ``w1`` / ``w2`` are
plain matrices.

The interface is the LSTM speller's (``models/speller.py``), so that greedy
and beam decoding do not branch on the architecture:

* ``precompute_decode_cache``: every block's cross-attention K and V of the
  encoder outputs, ``{"ck", "cv"}`` [B, L, T, d] float32, computed once
  (the reference's ``precompute_cross``);
* ``init_state`` / ``step``: the KV-cache decode step.  Each lattice row
  keeps its own position ``dpos``; a step writes its key and value at that
  slot by index (the reference selects it with a one-hot ``where`` over
  the whole cache, which computes the same and touches every slot) and
  attends to the slots up to it.  Every state leaf has its lattice row on
  axis 0, so the beam reorders them as any leaf;
* ``forward_teacher``: ONE parallel causal pass over the U targets.  In
  training ``model.dec_dropout`` drops the three residual branches of
  every block (site 3i: self-attention, 3i + 1: cross-attention, 3i + 2:
  feed-forward) with keep masks the caller draws (``ops/dropout.py``),
  stacked as [B, 3L, U, d].

Products take operands rounded to the compute dtype and sum in float32, as
the reference's ``preferred_element_type=float32`` products do, except the
feed-forward's, which stay in the compute dtype as in the reference; the
LayerNorm statistics, the residual stream and the softmax are float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models.listener import Leaves
from semi_supervised_asr_tpu_torch.ops import recurrent as R
from semi_supervised_asr_tpu_torch.ops.dropout import dropout

NEG_INF = -1e30


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 LayerNorm, population variance, eps 1e-6."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g.float() + b.float()


def _proj(x: torch.Tensor, w: torch.Tensor, compute) -> torch.Tensor:
    """x [..., in] . w [in, H, dh] -> float32 [..., H, dh]."""
    i, h, dh = w.shape
    return R.mm(x, w.reshape(i, h * dh), compute).unflatten(-1, (h, dh))


def _scores(a: torch.Tensor, b: torch.Tensor, spec: str,
            compute) -> torch.Tensor:
    """An attention product of operands rounded to ``compute``, summed in
    float32."""
    return torch.einsum(spec, a.to(compute).float(), b.to(compute).float())


class TransformerSpeller(nn.Module):
    # the state leaves whose lattice row is axis 1 (none: every leaf's is 0)
    ROW_AXIS1: tuple[str, ...] = ()

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, e, ff = cfg.dec_hidden, cfg.enc_out_dim, cfg.dec_ff_dim
        if d % cfg.dec_heads:
            raise ValueError(f"d_model {d} (=dec_hidden) must divide "
                             f"dec_heads {cfg.dec_heads}")
        if cfg.lm_fusion != "none":
            raise ValueError(
                "deep/cold LM fusion is wired into the LSTM speller's step; "
                "with decoder_arch=transformer use SHALLOW fusion at decode "
                "time (decode.lm_weight)")
        h, dh = cfg.dec_heads, d // cfg.dec_heads
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.zeros(cfg.vocab_size, d))
        self.pos = nn.Parameter(torch.zeros(cfg.dec_max_len, d))
        self.b_out = nn.Parameter(torch.zeros(cfg.vocab_size))
        if not cfg.tie_embedding:
            self.w_out = nn.Parameter(torch.zeros(d, cfg.vocab_size))
        self.blocks = nn.ModuleList([Leaves(
            ln1_g=(d,), ln1_b=(d,), wq=(d, h, dh), wk=(d, h, dh),
            wv=(d, h, dh), wo=(d, d), ln2_g=(d,), ln2_b=(d,),
            cq=(d, h, dh), ck=(e, h, dh), cv=(e, h, dh), co=(d, d),
            ln3_g=(d,), ln3_b=(d,), w1=(d, ff), b1=(ff,), w2=(ff, d),
            b2=(d,)) for _ in range(cfg.dec_blocks)])
        self.lnf_g = nn.Parameter(torch.zeros(d))
        self.lnf_b = nn.Parameter(torch.zeros(d))

    @property
    def compute(self) -> torch.dtype:
        return R.dtype_of(self.cfg.compute_dtype)

    def precompute_decode_cache(self, enc: torch.Tensor) -> dict:
        """Every block's cross-attention K and V of ``enc`` [B, T, e] ->
        {"ck", "cv"}: [B, L, T, d] float32, row axis 0."""
        b, t = enc.shape[:2]
        ck = [_proj(enc, blk.ck, self.compute).reshape(b, t, -1)
              for blk in self.blocks]
        cv = [_proj(enc, blk.cv, self.compute).reshape(b, t, -1)
              for blk in self.blocks]
        return {"ck": torch.stack(ck, dim=1), "cv": torch.stack(cv, dim=1)}

    def init_state(self, batch: int, mask: torch.Tensor,
                   max_steps: int | None = None) -> dict:
        """Fresh KV-cache state for ``batch`` lattice rows; ``max_steps``
        (the decode loop's length) sizes the cache and must fit under the
        learned positions."""
        cfg = self.cfg
        if max_steps is None:
            raise ValueError("decoder_arch=transformer needs max_steps to "
                             "size the KV cache")
        if max_steps > cfg.dec_max_len:
            raise ValueError(
                f"decode needs {max_steps} steps but model.dec_max_len is "
                f"{cfg.dec_max_len} — raise dec_max_len (retrain) or lower "
                "decode.max_decode_len")
        shape = (batch, cfg.dec_blocks, max_steps, cfg.dec_hidden)
        dev = mask.device
        return {"kv_k": torch.zeros(shape, device=dev),
                "kv_v": torch.zeros(shape, device=dev),
                "dpos": torch.zeros((batch,), dtype=torch.int32, device=dev)}

    def step(
        self,
        state: dict,
        tokens: torch.Tensor,     # [B*] previous tokens
        cache: dict,              # precompute_decode_cache, tiled to B*
        values: torch.Tensor,     # [B*, T, e] (unused: the cache holds them)
        mask: torch.Tensor,       # [B*, T] bool
        drop_mask: torch.Tensor | None = None,
    ) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """One decode step -> (new_state, logits [B*, V] float32, alpha
        [B*, T]: the last block's cross-attention, mean over heads).  The
        state's cache is written in place at each row's ``dpos`` (the
        returned state holds the same cache tensors); decoding does not
        drop."""
        compute, nh = self.compute, self.cfg.dec_heads
        b = tokens.shape[0]
        kv_k, kv_v, pos = state["kv_k"], state["kv_v"], state["dpos"]
        ucap = kv_k.shape[2]
        pos_l = pos.long()
        live = (torch.arange(ucap, device=tokens.device)[None, :]
                <= pos_l[:, None])                             # [B, Ucap]
        x = self.embedding[tokens.long()].float() + self.pos.float()[pos_l]
        alpha = None
        for li, blk in enumerate(self.blocks):
            h = _ln(x, blk.ln1_g, blk.ln1_b)
            q = _proj(h, blk.wq, compute)                      # [B, H, dh]
            dh = q.shape[-1]
            self.write_kv(kv_k, li, pos_l,
                          _proj(h, blk.wk, compute).reshape(b, -1))
            self.write_kv(kv_v, li, pos_l,
                          _proj(h, blk.wv, compute).reshape(b, -1))
            scale = 1.0 / np.sqrt(dh)
            s = _scores(q, kv_k[:, li].unflatten(-1, (nh, dh)),
                        "bhd,buhd->bhu", compute) * scale
            s = s.masked_fill(~live[:, None, :], NEG_INF)
            a = torch.softmax(s, dim=-1)
            out = _scores(a, kv_v[:, li].unflatten(-1, (nh, dh)),
                          "bhu,buhd->bhd", compute)
            x = x + R.mm(out.reshape(b, -1), blk.wo, compute)
            h = _ln(x, blk.ln2_g, blk.ln2_b)
            q = _proj(h, blk.cq, compute)
            s = _scores(q, cache["ck"][:, li].unflatten(-1, (nh, dh)),
                        "bhd,bthd->bht", compute) * scale
            s = s.masked_fill(~mask[:, None, :], NEG_INF)
            a = torch.softmax(s, dim=-1)                       # [B, H, T]
            alpha = a.mean(dim=1)
            out = _scores(a, cache["cv"][:, li].unflatten(-1, (nh, dh)),
                          "bht,bthd->bhd", compute)
            x = x + R.mm(out.reshape(b, -1), blk.co, compute)
            x = x + self._ffn(blk, x)
        logits = self._output_logits(_ln(x, self.lnf_g, self.lnf_b))
        return {"kv_k": kv_k, "kv_v": kv_v, "dpos": pos + 1}, logits, alpha

    @staticmethod
    def write_kv(kv: torch.Tensor, li: int, pos: torch.Tensor,
                 new: torch.Tensor) -> None:
        """Write ``new`` [B, d] into block ``li``'s cache ``kv`` [B, L, Ucap,
        d] at each row's slot ``pos`` [B], in place: one slot a row."""
        kv[torch.arange(kv.shape[0], device=kv.device), li, pos] = new

    def _ffn(self, blk: Leaves, x: torch.Tensor) -> torch.Tensor:
        compute = self.compute
        h = _ln(x, blk.ln3_g, blk.ln3_b).to(compute)
        h = Fn.gelu(h @ blk.w1.to(compute) + blk.b1.to(compute),
                    approximate="tanh")
        return (h @ blk.w2.to(compute)).float() + blk.b2.float()

    def _output_logits(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.embedding.t() if self.cfg.tie_embedding else self.w_out)
        return R.mm(x, w, self.compute) + self.b_out.float()

    def forward_teacher(
        self,
        enc: torch.Tensor,          # [B, T, e]
        enc_mask: torch.Tensor,     # [B, T] bool
        tokens_in: torch.Tensor,    # [B, U] decoder inputs (<sos> first)
        tf_rate: float = 1.0,
        gen: torch.Generator | None = None,
        rows: tuple[int, int, int] | None = None,
        drop_masks: torch.Tensor | None = None,   # [B, 3L, U, d]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced pass -> (logits [B, U, V], alphas [B, U, T]: the
        last block's cross-attention, mean over heads), one parallel causal
        pass.  ``tf_rate`` must be 1 (the train step refuses scheduled
        sampling with this speller), so ``gen`` and ``rows`` draw
        nothing; ``drop_masks[:, i]`` is dropout site i's keep mask
        (training)."""
        cfg, compute, nh = self.cfg, self.compute, self.cfg.dec_heads
        b, u = tokens_in.shape
        t = enc.shape[1]
        if u > cfg.dec_max_len:
            raise ValueError(
                f"target length {u} exceeds model.dec_max_len "
                f"{cfg.dec_max_len} — raise dec_max_len or lower "
                "data.token_buckets")
        if tf_rate < 1.0:
            raise ValueError("decoder_arch=transformer trains with one "
                             "parallel causal pass: tf_rate must be 1.0")
        dev = tokens_in.device
        x = self.embedding[tokens_in.long()].float() \
            + self.pos.float()[None, :u]
        causal = torch.ones((u, u), dtype=torch.bool, device=dev).tril()

        def drop(h, i):
            if drop_masks is None:
                return h
            return dropout(h, drop_masks[:, i], cfg.dec_dropout)

        alphas = None
        for li, blk in enumerate(self.blocks):
            h = _ln(x, blk.ln1_g, blk.ln1_b)
            q = _proj(h, blk.wq, compute)                  # [B, U, H, dh]
            k = _proj(h, blk.wk, compute)
            v = _proj(h, blk.wv, compute)
            scale = 1.0 / np.sqrt(q.shape[-1])
            s = _scores(q, k, "bqhd,bkhd->bhqk", compute) * scale
            s = s.masked_fill(~causal, NEG_INF)
            a = torch.softmax(s, dim=-1)
            out = _scores(a, v, "bhqk,bkhd->bqhd", compute)
            x = x + drop(R.mm(out.reshape(b, u, -1), blk.wo, compute),
                         3 * li)
            h = _ln(x, blk.ln2_g, blk.ln2_b)
            q = _proj(h, blk.cq, compute)
            ck = _proj(enc, blk.ck, compute)               # [B, T, H, dh]
            cv = _proj(enc, blk.cv, compute)
            s = _scores(q, ck, "bqhd,bthd->bhqt", compute) * scale
            s = s.masked_fill(~enc_mask[:, None, None, :], NEG_INF)
            a = torch.softmax(s, dim=-1)                   # [B, H, U, T]
            alphas = a.mean(dim=1)
            out = _scores(a, cv, "bhqt,bthd->bqhd", compute)
            x = x + drop(R.mm(out.reshape(b, u, -1), blk.co, compute),
                         3 * li + 1)
            x = x + drop(self._ffn(blk, x), 3 * li + 2)
        logits = self._output_logits(_ln(x, self.lnf_g, self.lnf_b))
        if alphas is None:
            alphas = torch.zeros((b, u, t), device=dev)
        return logits, alphas

    def dropout_shape(self, b: int, u: int) -> tuple[int, int, int, int]:
        """The shape of :meth:`forward_teacher`'s ``drop_masks``."""
        return (b, 3 * self.cfg.dec_blocks, u, self.cfg.dec_hidden)
