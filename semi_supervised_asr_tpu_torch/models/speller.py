"""Speller: attention LSTM decoder, one step at a time.

Counterpart of ``semi_supervised_asr_tpu/models/speller.py`` for the LSTM
speller, with tied or untied output: ``precompute_decode_cache``,
``init_state`` and ``step`` (``speller_step``) for decoding,
``forward_teacher`` for training (teacher forcing with scheduled
sampling), and ``text_autoencoder_logits``, the text autoencoder's pass
over unlabeled text.  The decoder state is a dict of tensors whose
lattice-row axis is 0 (``h`` and ``c`` are layer-stacked [L, B*, H], row
axis 1), so the beam reorders it with one index per leaf.  In training,
``model.dec_dropout`` drops the [h_top, context] concat before the output
projection at every teacher-forced step, with keep masks the caller draws
(``ops/dropout.py``); decoding never drops.
"""

from __future__ import annotations

import torch
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models.attention import (
    Attention, initial_alpha,
)
from semi_supervised_asr_tpu_torch.models.listener import (
    LSTMWeights, check_supported,
)
from semi_supervised_asr_tpu_torch.ops import recurrent as R
from semi_supervised_asr_tpu_torch.ops.dropout import dropout


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
        drop_mask: torch.Tensor | None = None,   # [B*, dec_hidden + enc_out]
    ) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """-> (new_state, logits [B*, V] float32, alpha [B*, T]).
        ``drop_mask`` (training): the keep mask of ``model.dec_dropout`` on
        the [h_top, context] concat."""
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
        if drop_mask is not None:
            out_in = dropout(out_in, drop_mask, cfg.dec_dropout)
        if cfg.tie_embedding:
            proj = R.mm(out_in, self.w_tie, compute)
            logits = R.mm(proj, self.embedding.t(), compute)
        else:
            logits = R.mm(out_in, self.w_out, compute)
        logits = logits + self.b_out.float()
        new_state = {"h": torch.stack(hs), "c": torch.stack(cs),
                     "context": context, "alpha": alpha}
        return new_state, logits, alpha

    def forward_teacher(
        self,
        enc: torch.Tensor,          # [B, T, enc_out]
        enc_mask: torch.Tensor,     # [B, T] bool
        tokens_in: torch.Tensor,    # [B, U] decoder inputs (<sos> first)
        tf_rate: float = 1.0,
        gen: torch.Generator | None = None,
        rows: tuple[int, int, int] | None = None,
        drop_masks: torch.Tensor | None = None,   # [B, U, dec_hidden + enc]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced decode -> (logits [B, U, V], alphas [B, U, T]).

        Step 0 runs on the ground-truth <sos>.  Each later step takes the
        ground truth with probability ``tf_rate``, else the argmax (first
        maximum, as ``jnp.argmax``) of the previous step's logits: one
        Bernoulli draw per (step, row) from ``gen`` (a CPU generator; the
        draws move to the device once).  ``rows=(r0, r1, n)``: the batch is
        rows [r0, r1) of a global batch of n (a data-parallel rank's), so
        the draws are made for n rows and these kept (as
        ``frontend.sample_specaug_params`` does).  ``model.speller_grad`` is
        accepted and has no effect: ``stacked`` reroutes JAX's scan
        autodiff, which a Python loop under autograd does not have.
        ``drop_masks[:, s]`` is step s's decoder dropout mask (training;
        :meth:`dropout_shape`), step 0 included.
        """
        cfg = self.cfg
        if cfg.speller_grad not in ("scan", "stacked"):
            raise ValueError(f"unknown model.speller_grad "
                             f"{cfg.speller_grad!r}")
        b, u = tokens_in.shape
        keys = self.precompute_decode_cache(enc)
        state = self.init_state(b, enc_mask)
        use_gt = None
        if u > 1 and tf_rate < 1.0:
            r0, r1, n = rows if rows is not None else (0, b, b)
            draws = torch.rand((u - 1, n), generator=gen)[:, r0:r1]
            use_gt = (draws < tf_rate).to(enc.device)
        logits_all, alphas = [], []
        tok = tokens_in[:, 0]
        for s in range(u):
            if s > 0:
                tok = tokens_in[:, s]
                if use_gt is not None:
                    sampled = torch.argmax(logits_all[-1].detach(), dim=-1)
                    tok = torch.where(use_gt[s - 1], tok,
                                      sampled.to(tok.dtype))
            state, logits, alpha = self.step(
                state, tok, keys, enc, enc_mask,
                None if drop_masks is None else drop_masks[:, s])
            logits_all.append(logits)
            alphas.append(alpha)
        return torch.stack(logits_all, dim=1), torch.stack(alphas, dim=1)

    def dropout_shape(self, b: int, u: int) -> tuple[int, int, int]:
        """The shape of :meth:`forward_teacher`'s ``drop_masks``."""
        return (b, u, self.cfg.dec_hidden + self.cfg.enc_out_dim)

    def text_autoencoder_logits(
        self,
        tokens_in: torch.Tensor,    # [B, U] decoder inputs (<sos> first)
    ) -> torch.Tensor:
        """The text autoencoder: the shared speller at teacher-forcing rate
        1 over one zero frame with an all-true mask -> logits [B, U, V].
        The attention context is zero, so the gradient reaches the
        speller's own weights only (the reference's
        ``text_autoencoder_logits``)."""
        b, dev = tokens_in.shape[0], tokens_in.device
        enc = torch.zeros((b, 1, self.cfg.enc_out_dim), dtype=torch.float32,
                          device=dev)
        mask = torch.ones((b, 1), dtype=torch.bool, device=dev)
        logits, _ = self.forward_teacher(enc, mask, tokens_in, 1.0)
        return logits
