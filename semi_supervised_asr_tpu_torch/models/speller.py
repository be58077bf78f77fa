"""Speller: attention LSTM decoder, one step at a time.

Counterpart of ``semi_supervised_asr_tpu/models/speller.py`` for the LSTM
speller, with tied or untied output: ``precompute_decode_cache``,
``init_state`` and ``step`` (``speller_step``) for decoding,
``forward_teacher`` for training (teacher forcing with scheduled
sampling); ``text_autoencoder_logits``, the text autoencoder's pass over
unlabeled text, serves either speller.  The decoder state is a dict of
tensors whose lattice-row axis is 0 (``h`` and ``c`` are layer-stacked
[L, B*, H], row axis 1: ``ROW_AXIS1``), so the beam reorders it with one
index per leaf.  In training,
``model.dec_dropout`` drops the [h_top, context] concat before the output
projection at every teacher-forced step, with keep masks the caller draws
(``ops/dropout.py``); decoding never drops.

Deep and cold LM fusion (``model.lm_fusion``): a frozen LSTM LM
(``fusion_lm``, ``model.lm_fusion_{embed,hidden,layers}``; the Solver
grafts a trained one with :func:`attach_fusion_lm`) steps in lockstep with
the speller on the same previous tokens, its (h, c) riding the decoder
state as ``lm_h`` / ``lm_c`` [L, B*, H].  Deep fusion (Gulcehre et al.
2015) concatenates ``sigmoid(s_lm . w_g + b_g) * s_lm`` (the LM's top
hidden state under a scalar gate) to the output projection's input; cold
fusion (Sriram et al. 2017) concatenates ``g * relu(logits_lm . w_l +
b_l)``, ``g = sigmoid([h_top, context, that] . w_g + b_g)`` a gate a unit.
The LM runs outside autograd (the reference's ``stop_gradient``): its
leaves get exactly-zero gradients, so the optimizer leaves them as they
are.
"""

from __future__ import annotations

import torch
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models import lm as LM
from semi_supervised_asr_tpu_torch.models.attention import (
    Attention, initial_alpha,
)
from semi_supervised_asr_tpu_torch.models.listener import (
    Leaves, LSTMWeights, check_supported,
)
from semi_supervised_asr_tpu_torch.ops import recurrent as R
from semi_supervised_asr_tpu_torch.ops.dropout import dropout


class Speller(nn.Module):
    # the state leaves whose lattice row is axis 1 (layer-stacked)
    ROW_AXIS1: tuple[str, ...] = ("h", "c", "lm_h", "lm_c")

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
        base = cfg.dec_hidden + cfg.enc_out_dim
        # LM fusion widens the output projection's input by its feature
        out_in = base + {"deep": cfg.lm_fusion_hidden,
                         "cold": cfg.lm_fusion_dim}.get(cfg.lm_fusion, 0)
        if cfg.tie_embedding:
            self.w_tie = nn.Parameter(torch.zeros(out_in, cfg.embed_dim))
        else:
            self.w_out = nn.Parameter(torch.zeros(out_in, cfg.vocab_size))
        self.fusion_lm = None
        if cfg.lm_fusion == "deep":
            self.fusion = Leaves(w_g=(cfg.lm_fusion_hidden, 1), b_g=(1,))
        elif cfg.lm_fusion == "cold":
            dim = cfg.lm_fusion_dim
            self.fusion = Leaves(w_l=(cfg.vocab_size, dim), b_l=(dim,),
                                 w_g=(base + dim, dim), b_g=(dim,))
        if cfg.lm_fusion != "none":
            # a stand-in until the Solver grafts a trained LM
            self.fusion_lm = LM.LSTMLM(cfg.vocab_size, cfg.lm_fusion_embed,
                                       cfg.lm_fusion_hidden,
                                       cfg.lm_fusion_layers)

    def precompute_decode_cache(self, enc: torch.Tensor) -> torch.Tensor:
        """Attention key projections [B, T, A], computed once per batch."""
        return self.attention.precompute_keys(enc)

    def init_state(self, batch: int, mask: torch.Tensor,
                   max_steps: int | None = None) -> dict:
        """Fresh decoder state for ``batch`` lattice rows (the state does
        not depend on ``max_steps``, which sizes the transformer speller's
        cache)."""
        cfg, dev = self.cfg, mask.device
        zeros = torch.zeros((cfg.dec_layers, batch, cfg.dec_hidden),
                            dtype=torch.float32, device=dev)
        state = {
            "h": zeros,
            "c": zeros.clone(),
            "context": torch.zeros((batch, cfg.enc_out_dim),
                                   dtype=torch.float32, device=dev),
            "alpha": initial_alpha(mask),
        }
        if self.fusion_lm is not None:
            lm_zeros = torch.zeros((cfg.lm_fusion_layers, batch,
                                    cfg.lm_fusion_hidden),
                                   dtype=torch.float32, device=dev)
            state.update(lm_h=lm_zeros, lm_c=lm_zeros.clone())
        return state

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
        lm_leaves = {}
        if self.fusion_lm is not None:
            out_in, lm_leaves = self._fuse(state, tokens, out_in)
        if cfg.tie_embedding:
            proj = R.mm(out_in, self.w_tie, compute)
            logits = R.mm(proj, self.embedding.t(), compute)
        else:
            logits = R.mm(out_in, self.w_out, compute)
        logits = logits + self.b_out.float()
        new_state = {"h": torch.stack(hs), "c": torch.stack(cs),
                     "context": context, "alpha": alpha, **lm_leaves}
        return new_state, logits, alpha

    def _fuse(self, state: dict, tokens: torch.Tensor,
              out_in: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The frozen LM's step on the same tokens and the fused feature ->
        (out_in with the feature concatenated, the LM's state leaves)."""
        with torch.no_grad():
            lm_state, lm_logits = LM.lm_step(
                self.fusion_lm, {"h": state["lm_h"], "c": state["lm_c"]},
                tokens)
        fus = self.fusion
        if self.cfg.lm_fusion == "deep":
            s_lm = lm_state["h"][-1]
            g = torch.sigmoid(s_lm @ fus.w_g.float() + fus.b_g)
            extra = g * s_lm
        else:
            h_lm = torch.relu(lm_logits @ fus.w_l.float() + fus.b_l)
            g = torch.sigmoid(torch.cat([out_in, h_lm], dim=-1)
                              @ fus.w_g.float() + fus.b_g)
            extra = g * h_lm
        return (torch.cat([out_in, extra], dim=-1),
                {"lm_h": lm_state["h"], "lm_c": lm_state["c"]})

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


@torch.no_grad()
def attach_fusion_lm(speller: Speller, lm: LM.LSTMLM) -> None:
    """Graft a trained LSTM LM into the speller's frozen ``fusion_lm`` in
    place; its names and shapes must match (``model.lm_fusion_*`` must be
    the trained LM's architecture)."""
    if speller.fusion_lm is None:
        raise ValueError("model.lm_fusion is off: no fusion LM to attach")
    old = dict(speller.fusion_lm.named_parameters())
    new = dict(lm.named_parameters())
    if set(old) != set(new):
        raise ValueError(
            f"fusion LM mismatch: the speller's LM has {sorted(old)}, the "
            f"trained LM {sorted(new)} — model.lm_fusion_* must match the "
            "trained LM's architecture")
    for name, p in old.items():
        if p.shape != new[name].shape:
            raise ValueError(
                f"fusion LM mismatch at {name}: {tuple(p.shape)} vs "
                f"{tuple(new[name].shape)} — model.lm_fusion_* must match "
                "the trained LM's architecture")
    for name, p in old.items():
        p.copy_(new[name])


def text_autoencoder_logits(speller: nn.Module,
                            tokens_in: torch.Tensor) -> torch.Tensor:
    """The text autoencoder: the shared ``speller`` (either architecture)
    at teacher-forcing rate 1 over one zero frame with an all-true mask ->
    logits [B, U, V].  The attention context is zero, so the gradient
    reaches the speller's own weights only (the reference's
    ``text_autoencoder_logits``)."""
    b, dev = tokens_in.shape[0], tokens_in.device
    enc = torch.zeros((b, 1, speller.cfg.enc_out_dim), dtype=torch.float32,
                      device=dev)
    mask = torch.ones((b, 1), dtype=torch.bool, device=dev)
    logits, _ = speller.forward_teacher(enc, mask, tokens_in, 1.0)
    return logits
