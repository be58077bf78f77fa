"""The CTC head and best-path decoding.

Counterpart of ``semi_supervised_asr_tpu/decode/ctc.py``
(``ctc_head_logits``, ``ctc_greedy_from_enc``; the streaming variants are
not ported).  :func:`ctc_head_logits` is the one definition of the head's
logits, shared by the loss, greedy decoding, the prefix beam and the
joint CTC-attention beam.  Best path: per-frame argmax, repeats collapsed,
blanks (PAD) dropped; the rows come out as the attention decoders' do,
tokens then EOS then PADs.
"""

from __future__ import annotations

import torch

from semi_supervised_asr_tpu_torch.data.vocab import EOS, PAD


def ctc_head_logits(ctc, enc: torch.Tensor) -> torch.Tensor:
    """The CTC head (``ctc.w`` [e, V], ``ctc.b`` [V]) on ``enc`` [B, T', e]
    -> float32 logits [B, T', V], whatever the compute dtype."""
    return enc.float() @ ctc.w.float() + ctc.b.float()


def ctc_greedy_from_enc(ctc, enc: torch.Tensor, enc_mask: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens [B, T'] int32: the best path collapsed, then EOS, then
    PADs (no EOS when the path fills every frame), the best path's log-prob
    [B])."""
    logits = ctc_head_logits(ctc, enc)
    logp = torch.log_softmax(logits, dim=-1)
    path = torch.argmax(logits, dim=-1)                   # [B, T']
    path = torch.where(enc_mask, path, PAD)
    best_lp = (logp.max(dim=-1).values * enc_mask.float()).sum(dim=-1)
    b, t = path.shape
    prev = torch.cat([torch.full((b, 1), -1, dtype=path.dtype,
                                 device=path.device), path[:, :-1]], dim=1)
    keep = (path != PAD) & (path != prev)
    # compaction by a stable partition: kept frames first, in order
    pos = torch.arange(t, device=path.device)[None, :]
    order = torch.argsort(torch.where(keep, pos, t + pos), dim=1,
                          stable=True)
    compacted = torch.gather(torch.where(keep, path, PAD), 1, order)
    n_out = keep.sum(dim=1)
    widened = torch.cat([compacted, torch.full((b, 1), PAD, dtype=path.dtype,
                                               device=path.device)], dim=1)
    cols = torch.arange(t + 1, device=path.device)[None, :]
    out = torch.where(cols == n_out[:, None], EOS, widened)
    return out[:, :t].to(torch.int32), best_lp
