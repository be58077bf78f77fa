"""Seq2seq model tying the Listener and the Speller.

Counterpart of ``semi_supervised_asr_tpu/models/seq2seq.py``.  Parameter
names mirror the JAX parameter tree's paths (``listener.layers.0.fwd.w_hh``,
``listener.blocks.3.attn.wq``, ``speller.attention.conv``, ...), so
``weights.py`` moves weights between the two packages by name.  The
listener is the pyramidal BiLSTM, the transformer or the conformer, after
``model.encoder_arch``; the speller the LSTM or the transformer speller,
after ``model.decoder_arch``; ``model.ctc_head`` adds the joint
CTC-attention head ``ctc.{w, b}`` on the encoder (``decode/ctc.py``).
:func:`build_model` builds this model, the CTC family's
(``models/ctc_model.py``) or the transducer (``models/transducer.py``)
after ``model.family``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.models.conformer_listener import (
    ConformerListener,
)
from semi_supervised_asr_tpu_torch.models.listener import (
    Leaves, Listener, check_supported,
)
from semi_supervised_asr_tpu_torch.models.speller import Speller
from semi_supervised_asr_tpu_torch.models.transformer_speller import (
    TransformerSpeller,
)
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
            "meaningful for encoder_arch=blstm — the attention listeners "
            f"are inherently full-context (got {cfg.encoder_arch!r}); the "
            "conformer streams via model.enc_attn_chunk instead")
    if not (cfg.enc_attn_chunk == 0 or cfg.encoder_arch == "conformer"):
        raise ValueError(
            "model.enc_attn_chunk (chunk-causal attention) is conformer-only "
            f"(got encoder_arch={cfg.encoder_arch!r})")
    archs = {"blstm": Listener, "transformer": TransformerListener,
             "conformer": ConformerListener}
    if cfg.encoder_arch not in archs:
        raise ValueError(f"unknown model.encoder_arch {cfg.encoder_arch!r}")
    return archs[cfg.encoder_arch]


def speller_class(cfg: ModelConfig) -> type[nn.Module]:
    """The speller of the configured decoder architecture."""
    archs = {"lstm": Speller, "transformer": TransformerSpeller}
    if cfg.decoder_arch not in archs:
        raise ValueError(f"unknown model.decoder_arch {cfg.decoder_arch!r}")
    return archs[cfg.decoder_arch]


def ctc_head(cfg: ModelConfig) -> Leaves:
    """The CTC head's leaves: w [enc_out, V], b [V]."""
    return Leaves(w=(cfg.enc_out_dim, cfg.vocab_size), b=(cfg.vocab_size,))


def run_listener(listener: nn.Module, feats: torch.Tensor,
                 feat_lens: torch.Tensor, backend: str | None,
                 masks: list | None, remat: bool):
    """The listener's pass -> (enc, enc_lens).  ``remat``
    (``train.remat_encoder``) keeps none of its activations for the
    backward and runs it again there, as the reference's
    ``jax.checkpoint``: under a non-reentrant checkpoint whose explicit
    inputs are the listener's parameters and dropout masks, so that the
    backward's recomputation uses the tensors this call saw -- the
    parameters also when they are stand-ins given by
    ``torch.func.functional_call`` (``train.bf16_weight_stream``), which
    are gone from the module by the time the backward runs, and the masks,
    which were drawn from a generator that has moved on since
    (``preserve_rng_state`` restores the default generators only).  So no
    RNG state is kept."""
    if not remat:
        return listener(feats, feat_lens, backend, masks)
    names, leaves = zip(*listener.named_parameters())
    masks = list(masks) if masks is not None else []
    n_masks = len(masks)

    def run(f, n, *rest):
        ms, ws = rest[:n_masks], rest[n_masks:]
        return torch.func.functional_call(
            listener, dict(zip(names, ws)),
            (f, n, backend, list(ms) if n_masks else None))

    return checkpoint(run, feats, feat_lens, *masks, *leaves,
                      use_reentrant=False, preserve_rng_state=False)


def build_model(cfg: ModelConfig) -> nn.Module:
    """The model of ``model.family``: :class:`Seq2Seq` (``las``), the
    encoder-only CTC model (``ctc``) or the RNN-T transducer
    (``transducer``)."""
    check_supported(cfg)
    if cfg.family == "ctc":
        from semi_supervised_asr_tpu_torch.models.ctc_model import CTCModel

        return CTCModel(cfg)
    if cfg.family == "transducer":
        from semi_supervised_asr_tpu_torch.models.transducer import (
            Transducer,
        )

        return Transducer(cfg)
    return Seq2Seq(cfg)


class Seq2Seq(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.listener = listener_class(cfg)(cfg)
        self.speller = speller_class(cfg)(cfg)
        if cfg.ctc_head:
            # joint CTC-attention (objective.lambda_ctc, decode.ctc_weight)
            self.ctc = ctc_head(cfg)

    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor,
               backend: str | None = None):
        """-> (enc [B, T', 2H], enc_mask [B, T'] bool, the speller's decode
        cache: keys [B, T', A] or the transformer's cross K/V)."""
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
                        masks: tuple | None = None,
                        return_enc: bool = False):
        """Full teacher-forced pass -> (logits [B, U, V], alphas
        [B, U, T']), and (enc, enc_mask) with ``return_enc`` (the CTC aux
        term reads them).  ``remat``: :func:`run_listener`; ``rows``
        places the batch in a data-parallel global batch
        (``Speller.forward_teacher``); ``masks`` = (listener masks, speller
        masks) of :meth:`dropout_masks` (training), each None for no
        dropout."""
        enc_masks, dec_masks = masks if masks is not None else (None, None)
        enc, enc_lens = run_listener(self.listener, feats, feat_lens, backend,
                                     enc_masks, remat)
        enc_mask = frame_mask(enc_lens, enc.shape[1])
        logits, alphas = self.speller.forward_teacher(
            enc, enc_mask, tokens_in, tf_rate, gen, rows, dec_masks)
        if return_enc:
            return logits, alphas, enc, enc_mask
        return logits, alphas
