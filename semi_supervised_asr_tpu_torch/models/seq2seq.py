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

    def forward_teacher(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                        tokens_in: torch.Tensor, tf_rate: float = 1.0,
                        gen: torch.Generator | None = None,
                        backend: str | None = None, remat: bool = False,
                        rows: tuple[int, int, int] | None = None):
        """Full teacher-forced pass -> (logits [B, U, V], alphas
        [B, U, T']).  ``remat`` (``train.remat_encoder``) keeps none of the
        listener's activations for the backward and runs the listener again
        there, as the reference's ``jax.checkpoint``; ``rows`` places the
        batch in a data-parallel global batch (``Speller.forward_teacher``)."""
        if remat:
            enc, enc_lens = self._listener_remat(feats, feat_lens, backend)
        else:
            enc, enc_lens = self.listener(feats, feat_lens, backend)
        enc_mask = frame_mask(enc_lens, enc.shape[1])
        return self.speller.forward_teacher(enc, enc_mask, tokens_in,
                                            tf_rate, gen, rows)

    def _listener_remat(self, feats, feat_lens, backend):
        """The listener under a non-reentrant checkpoint.  Its parameters
        go in as explicit inputs, so that the backward's recomputation uses
        the tensors this call saw, also when they are stand-ins given by
        ``torch.func.functional_call`` (``train.bf16_weight_stream``), which
        are gone from the module by the time the backward runs.  The
        listener draws nothing at random, so no RNG state is kept."""
        names, leaves = zip(*self.listener.named_parameters())

        def run(f, n, *ws):
            return torch.func.functional_call(
                self.listener, dict(zip(names, ws)), (f, n, backend))

        return checkpoint(run, feats, feat_lens, *leaves,
                          use_reentrant=False, preserve_rng_state=False)
