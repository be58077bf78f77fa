"""The fused frontend kernel's (K1) tiling and its input checks, on the CPU.

The kernel streams tiles of ``rows`` rows of the flattened [B*T, F] power
spectrum into shared memory by bulk copies, which need 16-byte aligned
starts and sizes; ``fused_frontend.tile_spans`` is that tiling.  The
kernel itself runs only on the card (chip_smoke.py phase 2 holds it
against its plain version there).
"""

import pytest
import torch

from semi_supervised_asr_tpu_torch.ops import fused_frontend as TFF

N_FREQ = 257        # n_fft 512: every shipped config


@pytest.mark.parametrize("rows", [8, 16, 32])
def test_tiles_cover_every_row_once_with_16_byte_bulk_copies(rows):
    for n_rows in range(1, 300):
        spans = TFF.tile_spans(n_rows, N_FREQ, rows)
        covered = [r for row0, n, _, _ in spans for r in range(row0, row0 + n)]
        assert covered == list(range(n_rows))
        for i, (row0, n, bulk, plain) in enumerate(spans):
            assert (row0 * N_FREQ * 4) % 16 == 0      # the copy's start
            assert bulk % 16 == 0                     # and its size
            assert bulk // 4 + plain == n * N_FREQ    # every float once
            assert 0 <= plain < 4
            if i < len(spans) - 1:                    # whole tiles: no tail
                assert n == rows and plain == 0


def test_default_plan_is_one_the_kernel_takes():
    rows, groups, stages, blocks_per_sm = TFF.PLAN
    assert rows in (8, 16, 32) and groups in (2, 4)
    assert rows % groups == 0 and rows // groups <= 8
    assert stages >= 1 and blocks_per_sm >= 1


def test_wrapper_refuses_views_off_16_bytes():
    base = torch.zeros(4 * 3 * N_FREQ + 8)
    for offset in range(6):
        view = base[offset:offset + 3 * N_FREQ].view(1, 3, N_FREQ)
        if offset % 4:
            with pytest.raises(ValueError, match="16 bytes"):
                TFF.require_aligned("pspec", view)
        else:
            TFF.require_aligned("pspec", view)
    strided = torch.zeros(2, 3, 2 * N_FREQ)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        TFF.require_aligned("pspec", strided)
