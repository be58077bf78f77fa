"""Batched Levenshtein distance on the device, without gradients.

Counterpart of ``semi_supervised_asr_tpu/ops/edit_distance.py``
(``batched_edit_distance``): the host scorer (``utils/metrics.py``) serves
validation; this one gives the sequence-level objectives (MWER,
``objectives/losses.py::mwer_loss_from_enc`` and its CTC and transducer
counterparts) their per-hypothesis risks inside the train step, with no
copy to the host.

A loop over hypothesis positions carries one DP row [..., U2+1]; the
within-row insertion recurrence ``D[i, j] <- D[i, j-1] + 1`` is closed by a
running minimum, ``cummin(base - j) + j`` (the reference's associative
min-scan).  The answer ``D[hyp_len, ref_len]`` is kept as the loop passes
each row's length.  Plain torch: the reference is an XLA scan, not a
Pallas kernel.
"""

from __future__ import annotations

import torch


def batched_edit_distance(
    hyp: torch.Tensor,        # [..., U1] int tokens
    hyp_lens: torch.Tensor,   # [...] valid lengths
    ref: torch.Tensor,        # [..., U2] int tokens
    ref_lens: torch.Tensor,   # [...] valid lengths
) -> torch.Tensor:
    """-> int32 Levenshtein distances [...] between the valid prefixes.

    Tokens past the given lengths are ignored (any padding value will do).
    The batch dims broadcast: ``hyp [B, K, U1]`` against ``ref [B, 1, U2]``
    scores an n-best against its reference."""
    dev = hyp.device
    batch = torch.broadcast_shapes(hyp.shape[:-1], ref.shape[:-1],
                                   hyp_lens.shape, ref_lens.shape)
    u1, u2 = hyp.shape[-1], ref.shape[-1]
    hyp = hyp.to(torch.int32).expand(batch + (u1,))
    ref = ref.to(torch.int32).expand(batch + (u2,))
    hyp_lens = hyp_lens.to(torch.int64).expand(batch)
    ref_lens = ref_lens.to(torch.int64).expand(batch)
    j = torch.arange(u2 + 1, dtype=torch.int32, device=dev)
    row = j.expand(batch + (u2 + 1,))          # D[0, j] = j
    picked = row
    for i in range(1, u1 + 1):
        sub = row[..., :-1] + (ref != hyp[..., i - 1, None]).to(torch.int32)
        base = torch.minimum(sub, row[..., 1:] + 1)
        base = torch.cat([torch.full(batch + (1,), i, dtype=torch.int32,
                                     device=dev), base], dim=-1)
        # insertion closure: new[j] = min_{k <= j} (base[k] + (j - k))
        row = torch.cummin(base - j, dim=-1).values + j
        picked = torch.where((hyp_lens == i)[..., None], row, picked)
    return torch.gather(picked, -1, ref_lens[..., None])[..., 0].to(
        torch.int32)
