"""Seq2seq model tying the Listener and the Speller.

Counterpart of ``semi_supervised_asr_tpu/models/seq2seq.py``.  Parameter
names mirror the JAX parameter tree's paths (``listener.layers.0.fwd.w_hh``,
``listener.blocks.3.attn.wq``, ``speller.attention.conv``, ...), so
``weights.py`` moves weights between the two packages by name.  The
listener is the pyramidal BiLSTM, the transformer or the conformer, after
``model.encoder_arch``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models.conformer_listener import (
    ConformerListener,
)
from semi_supervised_asr_tpu_torch.models.listener import Listener
from semi_supervised_asr_tpu_torch.models.speller import Speller
from semi_supervised_asr_tpu_torch.models.transformer_listener import (
    TransformerListener,
)
from semi_supervised_asr_tpu_torch.ops.dropout import draw_keep_masks
from semi_supervised_asr_tpu_torch.ops.frontend import frame_mask


def listener_class(cfg: ModelConfig) -> type[nn.Module]:
    """The listener of the configured encoder architecture (the
    reference's ``_listener_fns``, with its two checks)."""
    if not (cfg.enc_bidirectional or cfg.encoder_arch == "blstm"):
        raise ValueError(
            "model.enc_bidirectional=false (streaming encoder) is only "
            "meaningful for encoder_arch=blstm -- the attention listeners "
            f"are inherently full-context (got {cfg.encoder_arch!r})")
    if not (cfg.enc_attn_chunk == 0 or cfg.encoder_arch == "conformer"):
        raise ValueError(
            "model.enc_attn_chunk (chunk-causal attention) is conformer-only "
            f"(got encoder_arch={cfg.encoder_arch!r})")
    archs = {"blstm": Listener, "transformer": TransformerListener,
             "conformer": ConformerListener}
    if cfg.encoder_arch not in archs:
        raise ValueError(f"unknown model.encoder_arch {cfg.encoder_arch!r}")
    return archs[cfg.encoder_arch]


class Seq2Seq(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.listener = listener_class(cfg)(cfg)
        self.speller = Speller(cfg)

    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor,
               backend: str | None = None):
        """-> (enc [B, T', 2H], enc_mask [B, T'] bool, keys [B, T', A]),
        the decode cache."""
        enc, enc_lens = self.listener(feats, feat_lens, backend)
        enc_mask = frame_mask(enc_lens, enc.shape[1])
        keys = self.speller.precompute_decode_cache(enc)
        return enc, enc_mask, keys

    def dropout_masks(self, gen: torch.Generator, b: int, t: int, u: int,
                      device, rows: tuple[int, int, int] | None = None
                      ) -> tuple[list[torch.Tensor] | None,
                                 torch.Tensor | None]:
        """The keep masks of one training pass over features [b, t, n_mels]
        and u decoder steps -> (the listener's, one per
        ``model.enc_dropout`` site, or None; the speller's [b, u, D] for
        ``model.dec_dropout``, or None), drawn from ``gen`` on ``device``
        in that order (``rows`` as in :func:`draw_keep_masks`)."""
        cfg = self.cfg
        enc = dec = None
        if cfg.enc_dropout > 0.0:
            enc = draw_keep_masks(gen, self.listener.dropout_shapes(b, t),
                                  cfg.enc_dropout, device, rows)
        if cfg.dec_dropout > 0.0:
            dec, = draw_keep_masks(gen, [self.speller.dropout_shape(b, u)],
                                   cfg.dec_dropout, device, rows)
        return enc, dec

    def forward_teacher(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                        tokens_in: torch.Tensor, tf_rate: float = 1.0,
                        gen: torch.Generator | None = None,
                        backend: str | None = None, remat: bool = False,
                        rows: tuple[int, int, int] | None = None,
                        masks: tuple | None = None):
        """Full teacher-forced pass -> (logits [B, U, V], alphas
        [B, U, T']).  ``remat`` (``train.remat_encoder``) keeps none of the
        listener's activations for the backward and runs the listener again
        there, as the reference's ``jax.checkpoint``; ``rows`` places the
        batch in a data-parallel global batch (``Speller.forward_teacher``);
        ``masks`` = (listener masks, speller masks) of
        :meth:`dropout_masks` (training), each None for no dropout."""
        enc_masks, dec_masks = masks if masks is not None else (None, None)
        if remat:
            enc, enc_lens = self._listener_remat(feats, feat_lens, backend,
                                                 enc_masks)
        else:
            enc, enc_lens = self.listener(feats, feat_lens, backend,
                                          enc_masks)
        enc_mask = frame_mask(enc_lens, enc.shape[1])
        return self.speller.forward_teacher(enc, enc_mask, tokens_in,
                                            tf_rate, gen, rows, dec_masks)

    def _listener_remat(self, feats, feat_lens, backend, masks):
        """The listener under a non-reentrant checkpoint.  Its parameters
        and its dropout masks go in as explicit inputs, so that the
        backward's recomputation uses the tensors this call saw: the
        parameters also when they are stand-ins given by
        ``torch.func.functional_call`` (``train.bf16_weight_stream``), which
        are gone from the module by the time the backward runs, and the
        masks, which were drawn from a generator that has moved on since
        (``preserve_rng_state`` restores the default generators only).  So
        no RNG state is kept."""
        names, leaves = zip(*self.listener.named_parameters())
        masks = list(masks) if masks is not None else []
        n_masks = len(masks)

        def run(f, n, *rest):
            ms, ws = rest[:n_masks], rest[n_masks:]
            return torch.func.functional_call(
                self.listener, dict(zip(names, ws)),
                (f, n, backend, list(ms) if n_masks else None))

        return checkpoint(run, feats, feat_lens, *masks, *leaves,
                          use_reentrant=False, preserve_rng_state=False)
