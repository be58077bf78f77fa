"""The RNN-T transducer family (``model.family: transducer``).

Counterpart of ``semi_supervised_asr_tpu/models/transducer.py``: the
listener of ``model.encoder_arch`` (the pyramidal BiLSTM, or its
forward-only variant under ``model.enc_bidirectional: false``), a
predictor (an embedding and ``pred_layers`` forward LSTMs of
``pred_hidden`` over [SOS, y_1 .. y_U]) and a joint ``tanh(enc . w_enc +
pred . w_pred + b) . w_out + b_out`` broadcast over the [T', U+1] grid, with
the blank at PAD (0).  Parameter names are the JAX tree's paths
(``predictor.embed``, ``predictor.layers.0.w_hh``, ``joint.w_enc``, ...).

The predictor's training pass runs each layer on the LSTM scan kernels
(K2 forward, K3 backward, ``ops/lstm_scan.py``) with every step valid;
decoding steps it with the plain cell (``recurrent.lstm_single_step``), as
the reference does.  Products take operands rounded to
``model.compute_dtype`` and sum in float32; the ``tanh`` and the biases stay
float32.  The token embedding is read by row index, as the speller reads
its own.

The lattice loss is ``objectives/transducer_loss.py``; decoding is
``decode/transducer_greedy.py`` and ``decode/transducer_beam.py``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as Fn
from torch import nn
from torch.utils.checkpoint import checkpoint

from semi_supervised_asr_tpu_torch.config import ModelConfig
from semi_supervised_asr_tpu_torch.data.vocab import PAD, SOS
from semi_supervised_asr_tpu_torch.models.listener import Leaves, LSTMWeights
from semi_supervised_asr_tpu_torch.models.seq2seq import (
    listener_class, run_listener,
)
from semi_supervised_asr_tpu_torch.ops import recurrent as R
from semi_supervised_asr_tpu_torch.ops.dropout import draw_keep_masks
from semi_supervised_asr_tpu_torch.ops.frontend import frame_mask
from semi_supervised_asr_tpu_torch.ops.lstm_scan import lstm_kernel

JOINT_LEAVES = ("w_enc", "w_pred", "b", "w_out", "b_out")


class Predictor(nn.Module):
    """embed [V, embed_dim] and ``pred_layers`` LSTM cells."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.embed_dim))
        layers, in_dim = [], cfg.embed_dim
        for _ in range(cfg.pred_layers):
            layers.append(LSTMWeights(in_dim, cfg.pred_hidden))
            in_dim = cfg.pred_hidden
        self.layers = nn.ModuleList(layers)


class Transducer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.listener = listener_class(cfg)(cfg)
        self.predictor = Predictor(cfg)
        j = cfg.joint_dim
        self.joint = Leaves(w_enc=(cfg.enc_out_dim, j),
                            w_pred=(cfg.pred_hidden, j), b=(j,),
                            w_out=(j, cfg.vocab_size),
                            b_out=(cfg.vocab_size,))

    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor,
               backend: str | None = None, remat: bool = False,
               masks: list | None = None):
        """-> (enc [B, T', enc_out] float32, enc_mask [B, T'] bool);
        ``remat`` and ``masks`` (the listener's dropout) as in
        ``seq2seq.run_listener``."""
        enc, enc_lens = run_listener(self.listener, feats, feat_lens,
                                     backend, masks, remat)
        return enc, frame_mask(enc_lens, enc.shape[1])

    def dropout_masks(self, gen: torch.Generator, b: int, t: int, u: int,
                      device, rows: tuple[int, int, int] | None = None):
        """The listener's keep masks of one training pass (``model
        .enc_dropout``), or None; the predictor does not drop -> (masks,
        None)."""
        enc = None
        if self.cfg.enc_dropout > 0.0:
            enc = draw_keep_masks(gen, self.listener.dropout_shapes(b, t),
                                  self.cfg.enc_dropout, device, rows)
        return enc, None


def embed_tokens(predictor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the token embedding, float32."""
    return predictor.embed[tokens.long()].float()


def predictor_train(predictor, labels: torch.Tensor, cfg: ModelConfig,
                    backend: str | None = None) -> torch.Tensor:
    """The predictor over [SOS, y_1 .. y_U] -> [B, U+1, pred_hidden]; row u
    is g(y_<u).  Every step is valid (no lengths), as in the reference."""
    compute = R.dtype_of(cfg.compute_dtype)
    sos = torch.full((labels.shape[0], 1), SOS, dtype=labels.dtype,
                     device=labels.device)
    x = embed_tokens(predictor, torch.cat([sos, labels], dim=1))
    for layer in predictor.layers:
        x = lstm_kernel(layer.as_dict(), x, None, False, compute, backend)
    return x


def predictor_step(predictor, tok: torch.Tensor, state: tuple,
                   cfg: ModelConfig) -> tuple[torch.Tensor, tuple]:
    """One decoding step of the predictor: tokens [B], ((h, c) per layer)
    -> (pred [B, P], the new state)."""
    compute = R.dtype_of(cfg.compute_dtype)
    x = embed_tokens(predictor, tok)
    new_state = []
    for layer, (h, c) in zip(predictor.layers, state):
        h, c = R.lstm_single_step(layer.as_dict(), x, h, c, compute)
        new_state.append((h, c))
        x = h
    return x, tuple(new_state)


def predictor_init_state(cfg: ModelConfig, b: int, device) -> tuple:
    z = torch.zeros((b, cfg.pred_hidden), dtype=torch.float32, device=device)
    return tuple((z, z) for _ in range(cfg.pred_layers))


def joint_logits(joint, enc: torch.Tensor, pred: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The full grid: enc [B, T, E] x pred [B, U1, P] -> logits
    [B, T, U1, V] float32."""
    compute = R.dtype_of(cfg.compute_dtype)
    he = R.mm(enc, joint.w_enc, compute)                     # [B, T, J]
    hp = R.mm(pred, joint.w_pred, compute)                   # [B, U1, J]
    h = torch.tanh(he[:, :, None, :] + hp[:, None, :, :] + joint.b.float())
    return R.mm(h, joint.w_out, compute) + joint.b_out.float()


def joint_lattice_terms(joint, enc: torch.Tensor, pred: torch.Tensor,
                        labels: torch.Tensor, cfg: ModelConfig,
                        blank: int = PAD, chunk_frames: int = 8
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(blank_lp, emit_lp) [B, T, U+1] computed ``chunk_frames`` encoder
    frames at a time (``model.joint_chunk_frames``), each chunk's joint
    grid recomputed in the backward (``torch.utils.checkpoint``, its joint
    leaves passed in, so that stand-in weights of
    ``train.bf16_weight_stream`` are the ones recomputed), so that no more
    than [B, chunk, U+1, V] logits live at once.  The frames are padded to
    whole chunks, as the reference pads them."""
    from semi_supervised_asr_tpu_torch.objectives.transducer_loss import (
        lattice_terms,
    )

    b, t, e = enc.shape
    c = max(1, min(int(chunk_frames), t))
    n = -(-t // c)
    enc_p = Fn.pad(enc, (0, 0, 0, n * c - t))
    leaves = tuple(getattr(joint, k) for k in JOINT_LEAVES)

    def chunk(enc_c, *ws):
        j = SimpleNamespace(**dict(zip(JOINT_LEAVES, ws)))
        return lattice_terms(joint_logits(j, enc_c, pred, cfg), labels,
                             blank)

    parts = [checkpoint(chunk, enc_p[:, i * c:(i + 1) * c], *leaves,
                        use_reentrant=False, preserve_rng_state=False)
             for i in range(n)]
    blank_lp = torch.cat([p[0] for p in parts], dim=1)[:, :t]
    emit_lp = torch.cat([p[1] for p in parts], dim=1)[:, :t]
    return blank_lp, emit_lp


def joint_row(joint, enc_t: torch.Tensor, pred: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """The decoding joint of one (frame, prefix) pair a row: enc_t [N, E],
    pred [N, P] -> logits [N, V] float32."""
    compute = R.dtype_of(cfg.compute_dtype)
    he = R.mm(enc_t, joint.w_enc, compute)
    hp = R.mm(pred, joint.w_pred, compute)
    h = torch.tanh(he + hp + joint.b.float())
    return R.mm(h, joint.w_out, compute) + joint.b_out.float()
