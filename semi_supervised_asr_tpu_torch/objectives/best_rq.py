"""BEST-RQ self-supervised encoder pretraining (Chiu et al. 2022,
arXiv:2202.01855): masked speech prediction against a frozen
random-projection quantizer.

Counterpart of ``semi_supervised_asr_tpu/objectives/best_rq.py``:

1. **Targets** come from the clean features: ``r = time_reduction``
   consecutive CMVN'd log-mel frames stacked (the listener's output rate),
   projected through a frozen random matrix, normalized, and labelled with
   the nearest (cosine) row of a frozen random codebook
   (:func:`make_quantizer`, numpy, the reference's arrays bit for bit).
   In float32 with no TF32 (``strict_fp32``).
2. **Inputs** are the same features with random spans replaced by
   Gaussian noise.  As every random choice of the port this is a draw and
   an apply: :func:`draw_masking` makes the Bernoulli(``mask_prob``) span
   starts on valid frames, one forced start at a uniform valid position of
   each row, the standard-normal noise and the listener's dropout masks
   (at a global batch's shape, a rank keeping its rows);
   :func:`apply_masking` dilates the starts to ``mask_span`` frames
   (:func:`dilate_spans`), keeps the valid frames and puts
   ``mask_noise_std`` times the noise in their place.
3. **Loss**: a linear head (:class:`BestRQModel`'s ``head.{w, b}``, the
   reference's ``params["head"]``) on the encoder output predicts the
   codebook index at every masked output position: one of its r input
   frames masked, within the reduced length, on a real row.  The
   cross-entropy is the mean over those positions (:func:`prediction_ce`),
   over the global batch's count under data parallelism.

The listener runs through the port's own dispatch
(``models/seq2seq.py::run_listener``): K2 / K3, the conv stems and K5
pretrain on their production routes, with the listener's dropout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig, PretrainConfig
from semi_supervised_asr_tpu_torch.models.listener import Leaves
from semi_supervised_asr_tpu_torch.models.seq2seq import (
    listener_class, run_listener,
)
from semi_supervised_asr_tpu_torch.ops.dropout import draw_keep_masks
from semi_supervised_asr_tpu_torch.parallel import dp as DP


def make_quantizer(n_mels: int, time_reduction: int, pcfg: PretrainConfig
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Frozen (projection [r*n_mels, dim], codebook [size, dim]) float32,
    from ``pretrain.quantizer_seed`` alone; codebook rows unit-norm."""
    rng = np.random.default_rng(pcfg.quantizer_seed)
    d_in = time_reduction * n_mels
    proj = rng.standard_normal((d_in, pcfg.codebook_dim)) / np.sqrt(d_in)
    cb = rng.standard_normal((pcfg.codebook_size, pcfg.codebook_dim))
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    return proj.astype(np.float32), cb.astype(np.float32)


def bestrq_scores(feats: torch.Tensor, proj: torch.Tensor,
                  codebook: torch.Tensor, time_reduction: int
                  ) -> torch.Tensor:
    """[B, T, M] clean features -> [B, T/r, V_cb] cosine scores of every
    stacked frame against every codebook row."""
    b, t, m = feats.shape
    if t % time_reduction:
        raise ValueError(f"{t} frames do not stack by {time_reduction}")
    stacked = feats.reshape(b, t // time_reduction, time_reduction * m)
    z = stacked.float() @ proj
    z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)
    return z @ codebook.T


def bestrq_targets(feats: torch.Tensor, proj: torch.Tensor,
                   codebook: torch.Tensor, time_reduction: int
                   ) -> torch.Tensor:
    """-> [B, T/r] int64 codebook indices at the encoder output rate."""
    return torch.argmax(bestrq_scores(feats, proj, codebook,
                                      time_reduction), dim=-1)


def dilate_spans(starts: torch.Tensor, span: int) -> torch.Tensor:
    """[B, T] bool span starts -> the frames covered by a span of ``span``
    frames from any start (start included, extending forward): a window
    sum of the starts over the last ``span`` frames, by a cumulative sum
    (integers, so exact)."""
    c = torch.cumsum(starts.to(torch.int32), dim=1)
    before = torch.nn.functional.pad(c, (span, 0))[:, :c.shape[1]]
    return (c - before) > 0


@dataclass
class MaskDraws:
    """One step's random draws: span starts [B, T] bool (the forced one
    included, before dilation), standard-normal noise [B, T, M], and the
    listener's dropout keep masks (None without ``model.enc_dropout``)."""

    starts: torch.Tensor
    noise: torch.Tensor
    masks: list | None = None


def draw_masking(gen: torch.Generator, listener: nn.Module,
                 mcfg: ModelConfig, pcfg: PretrainConfig,
                 shape: tuple[int, int, int], feat_lens: torch.Tensor,
                 rows: tuple[int, int, int] | None = None) -> MaskDraws:
    """The draws of one pass over features of ``shape`` [B, T, M], made in
    order from ``gen`` on its device: uniforms for the Bernoulli starts
    [n, T], for the forced start [n], the noise [n, T, M], then the
    listener's dropout masks, each at the global batch's n rows of
    ``rows`` = (r0, r1, n) and rows [r0, r1) kept (n = B without)."""
    b, t, m = shape
    dev = feat_lens.device
    r0, r1, n = rows if rows is not None else (0, b, b)
    if r1 - r0 != b:
        raise ValueError(f"rows {rows} do not hold a batch of {b}")
    valid = torch.arange(t, device=dev)[None, :] < feat_lens[:, None]
    u = torch.rand((n, t), generator=gen, device=dev)[r0:r1]
    starts = (u < pcfg.mask_prob) & valid
    up = torch.rand((n,), generator=gen, device=dev)[r0:r1]
    if pcfg.mask_prob > 0:
        # one start at a uniform valid position of each row (a row with no
        # frame forces position 0, which the apply's valid mask clears)
        hi = torch.clamp_min(feat_lens, 1)
        pos = torch.minimum((up * hi).long(), hi - 1)
        starts = starts | (torch.arange(t, device=dev)[None, :]
                           == pos[:, None])
    noise = torch.randn((n, t, m), generator=gen, device=dev)[r0:r1]
    masks = None
    if mcfg.enc_dropout > 0.0:
        masks = draw_keep_masks(gen, listener.dropout_shapes(b, t),
                                mcfg.enc_dropout, dev, rows)
    return MaskDraws(starts, noise, masks)


def apply_masking(feats: torch.Tensor, feat_lens: torch.Tensor,
                  draws: MaskDraws, pcfg: PretrainConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (the masked inputs [B, T, M], the mask [B, T] bool): the starts
    dilated to ``mask_span`` frames on valid frames, those frames replaced
    by ``mask_noise_std`` times the noise."""
    t = feats.shape[1]
    valid = torch.arange(t, device=feats.device)[None, :] \
        < feat_lens[:, None]
    mask = dilate_spans(draws.starts, pcfg.mask_span) & valid
    noise = pcfg.mask_noise_std * draws.noise.to(feats.dtype)
    return torch.where(mask[..., None], noise, feats), mask


def code_hits(labels: torch.Tensor, pos_mask: torch.Tensor,
              v: int) -> torch.Tensor:
    """[V] float32: how many counted positions each code labels (integer
    sums, exact in any order; no host sync)."""
    hits = torch.zeros(v, dtype=torch.float32, device=labels.device)
    return hits.index_add_(0, torch.where(pos_mask, labels, 0).reshape(-1),
                           pos_mask.float().reshape(-1))


def codes_used(hits: torch.Tensor) -> torch.Tensor:
    """The share of the codebook the counted targets hit."""
    return (hits > 0).sum() / hits.numel()


def prediction_ce(logits: torch.Tensor, labels: torch.Tensor,
                  pos_mask: torch.Tensor, den: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """Mean CE over the ``pos_mask`` positions of logits [B, T', V] and
    labels [B, T'] -> (loss, {"mask_acc", "codes_used", "masked_positions",
    "code_hits"}).  ``den``: the count to divide by (the global batch's
    under data parallelism), else this batch's, at least 1.  Positions
    outside the mask contribute exactly nothing."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    n = den if den is not None else torch.clamp_min(pos_mask.sum(), 1)
    loss = torch.where(pos_mask, nll, 0.0).sum() / n
    pred = torch.argmax(logits, dim=-1)
    acc = (pos_mask & (pred == labels)).sum() / n
    hits = code_hits(labels, pos_mask, logits.shape[-1])
    return loss, {"mask_acc": acc, "codes_used": codes_used(hits),
                  "masked_positions": n.float(), "code_hits": hits}


class BestRQModel(nn.Module):
    """The pretrained listener and the prediction head, named as the
    reference's ``{"listener": ..., "head": {"w", "b"}}`` tree
    (``weights.py``: ``head.w`` draws glorot, ``head.b`` zeros)."""

    def __init__(self, mcfg: ModelConfig, pcfg: PretrainConfig):
        super().__init__()
        self.cfg = mcfg
        self.listener = listener_class(mcfg)(mcfg)
        self.head = Leaves(w=(mcfg.enc_out_dim, pcfg.codebook_size),
                           b=(pcfg.codebook_size,))


def bestrq_loss(
    model: BestRQModel,
    pcfg: PretrainConfig,
    feats: torch.Tensor,          # [B, T, M] clean features, pad zeros
    feat_lens: torch.Tensor,      # [B]
    real: torch.Tensor,           # [B] bool
    proj: torch.Tensor,
    codebook: torch.Tensor,
    draws: MaskDraws,
    backend: str | None = None,
    remat: bool = False,
    dp: DP.DataParallel | None = None,
    labels: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """One masked-prediction loss of a featurized batch -> (loss, the
    metrics of :func:`prediction_ce` and ``mask_frac``).  ``remat``
    (``train.remat_encoder``): ``run_listener``'s; ``labels``: given
    targets [B, T/r] in place of :func:`bestrq_targets` of ``feats``.  Under ``dp`` the batch
    is this rank's rows: the counted positions, the masked frames and the
    frames are summed over the ranks first, and the loss, ``mask_acc`` and
    ``code_hits`` are this rank's parts of the global batch's (their sums
    over the ranks are the global values; ``codes_used`` is then
    recomputed from the summed hits)."""
    r = model.cfg.time_reduction
    b, t, _ = feats.shape
    if labels is None:
        with torch.no_grad():
            labels = bestrq_targets(feats, proj, codebook, r)
    x, mask = apply_masking(feats, feat_lens, draws, pcfg)
    enc, enc_lens = run_listener(model.listener, x, feat_lens, backend,
                                 draws.masks, remat)
    head = model.head
    logits = enc.float() @ head.w.float() + head.b.float()
    t_out = enc.shape[1]
    pos = mask.reshape(b, t // r, r).any(dim=-1)[:, :t_out]
    valid = torch.arange(t_out, device=enc.device)[None, :] \
        < enc_lens[:, None]
    pos = pos & valid & real[:, None]
    counts = torch.stack([pos.sum(), mask.sum(), feat_lens.sum()]).double()
    if dp is not None:
        counts = DP.all_reduce_counts(counts)
    den = torch.clamp_min(counts[0], 1.0).float()
    loss, metrics = prediction_ce(logits, labels[:, :t_out], pos, den)
    metrics["mask_frac"] = (counts[1] / torch.clamp_min(counts[2], 1.0)
                            ).float()
    return loss, metrics
