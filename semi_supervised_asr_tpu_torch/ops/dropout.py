"""Dropout with explicit keep masks.

The reference drops at a site with ``bernoulli(fold_in(rng, i), keep,
h.shape)`` and returns ``where(m, h / keep, 0)``.  Here the masks are
tensors of their own: :func:`draw_keep_masks` draws them from an explicit
generator on the device (a conformer step has 64 sites of [B, T', d], too
much to draw on the host), and :func:`dropout` applies one.  So a test can
hand in the reference's masks, a remat region takes them as inputs (its
recomputation in the backward sees the same masks), and a data-parallel
rank draws the global batch's masks and keeps its rows.
"""

from __future__ import annotations

import torch


def dropout(h: torch.Tensor, keep_mask: torch.Tensor,
            rate: float) -> torch.Tensor:
    """``h`` where ``keep_mask`` holds, scaled by 1 / (1 - ``rate``); 0
    elsewhere."""
    return torch.where(keep_mask, h / (1.0 - rate), 0.0)


def draw_keep_masks(
    gen: torch.Generator,
    shapes: list[tuple[int, ...]],
    rate: float,
    device,
    rows: tuple[int, int, int] | None = None,
) -> list[torch.Tensor]:
    """One bool mask per shape (batch axis first), True with probability
    1 - ``rate``, drawn in order from ``gen`` on ``device``.  ``rows=(r0,
    r1, n)``: each mask is drawn for a global batch of n rows and rows
    [r0, r1) kept."""
    keep = 1.0 - rate
    out = []
    for shape in shapes:
        r0, r1, n = rows if rows is not None else (0, shape[0], shape[0])
        if r1 - r0 != shape[0]:
            raise ValueError(f"rows {rows} do not hold a batch of "
                             f"{shape[0]}")
        u = torch.rand((n, *shape[1:]), generator=gen, device=device)
        out.append((u < keep)[r0:r1])
    return out
