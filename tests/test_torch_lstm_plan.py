"""The LSTM scans' launch plan and the cluster route's weight layout.

``cluster_plan`` picks, by shape, the route K2 and K3 run on: clusters of
blocks holding w_hh in shared memory (bfloat16, H <= 512) or the CUDA-core
kernels (float32, and bfloat16 where no cluster fits).  ``cluster_weights``
lays w_hh out in the cluster kernels' fragment order; the product computed
from that layout the way the kernels arrange it must be exactly h . w_hh
(and dgates . w_hh^T) in float32, on integer-valued inputs, where the order
of the sums cannot matter.  The wrapper tests run the kernel entries
against a fake library that records their arguments: these run on the CPU
and check what reaches the C entry, not the kernels (those are compared
with their plain versions on the card by chip_smoke.py).
"""

from pathlib import Path

import pytest
import torch

from semi_supervised_asr_tpu_torch import _native
from semi_supervised_asr_tpu_torch.config import load_config
from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs")
                 .glob("*.yaml"))


def pallas_widths():
    """enc_hidden of every shipped config that sets lstm_backend: pallas."""
    out = {}
    for path in CONFIGS:
        model = load_config(path).model
        if model.lstm_backend == "pallas":
            out[path.stem] = model.enc_hidden
    return out


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_cluster_plan_fits_every_shipped_width(kernel):
    widths = pallas_widths()
    assert widths["timit"] == 256 and widths["ls960_dp"] == 512
    assert widths["ls100_semi"] == 384
    for name, hidden in widths.items():
        for batch in (1, 5, 32, 256):
            plan = K.cluster_plan(kernel, hidden, batch, torch.bfloat16)
            if hidden > K.CLUSTER_MAX_HIDDEN:
                assert plan == K.Plan("simt"), (name, plan)
                continue
            assert plan.route == "cluster", (name, batch)
            granule = 8 if kernel == "fwd" else 16
            assert plan.units * plan.cluster == hidden, (name, plan)
            assert plan.units % granule == 0
            assert plan.cluster in K.CLUSTER_SIZES
            assert plan.rows == K.CLUSTER_ROWS == 8
            assert plan.smem == K.cluster_smem(kernel, hidden, plan.cluster,
                                               plan.rows)
            assert plan.smem <= K.MAX_SMEM == 232_448
            assert 32 <= plan.threads <= K.CLUSTER_THREADS
    # timit's shape: clusters of 8 blocks (the portable maximum)
    timit = K.cluster_plan(kernel, 256, 32, torch.bfloat16)
    assert (timit.cluster, timit.rows) == (8, 8)


def test_float32_and_wide_bfloat16_take_the_cuda_core_route():
    simt = K.Plan("simt")
    for kernel in ("fwd", "bwd"):
        assert K.cluster_plan(kernel, 256, 32, torch.float32) == simt
        # ls100_transducer_streaming's enc_hidden: 4.7 MB of w_hh a
        # direction, which fits no cluster
        assert K.cluster_plan(kernel, 768, 32, torch.bfloat16) == simt
        assert K.cluster_plan(kernel, 520, 32, torch.bfloat16) == simt
    with pytest.raises(ValueError, match="kernel"):
        K.cluster_plan("both", 256, 32, torch.bfloat16)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("hidden", [64, 256, 384, 512])
def test_cluster_weights_are_a_permutation(kernel, hidden):
    plan = K.cluster_plan(kernel, hidden, 32, torch.bfloat16)
    g = torch.Generator().manual_seed(hidden)
    w = torch.randint(-4, 5, (2, hidden, 4 * hidden), generator=g).float()
    frag = K.cluster_weights(w, kernel, plan)
    assert frag.dtype == torch.bfloat16 and frag.shape == (2, 4 * hidden**2)
    # every entry once: the sorted values of each direction agree
    for d in range(2):
        assert torch.equal(frag[d].float().sort().values,
                           w[d].reshape(-1).sort().values)
    width = hidden if kernel == "fwd" else 4 * hidden
    x = torch.randint(-4, 5, (2, 3, width), generator=g).float()
    want = torch.bmm(x, w if kernel == "fwd" else w.transpose(1, 2))
    got = K.cluster_product_reference(frag, x, kernel, plan)
    assert torch.equal(got, want)


class _Entry:
    """A stand-in for the kernel library: records each entry's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32])
def test_wrappers_pass_the_plan_and_count_the_route(compute, monkeypatch):
    fake = _Entry()
    monkeypatch.setattr(_native, "lib", lambda: fake)
    monkeypatch.setattr(_native, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_native, "use_kernel", lambda t, backend: True)
    laid = []
    relay = K.cluster_weights
    monkeypatch.setattr(K, "cluster_weights",
                        lambda *a: laid.append(relay(*a)) or laid[-1])
    for key in _native.LAUNCHES:
        monkeypatch.setitem(_native.LAUNCHES, key, 0)
    d, t, b, h = 2, 3, 32, 256
    gx = torch.zeros((d, t, b, 4 * h))
    w = torch.zeros((d, h, 4 * h))
    valid = torch.ones((t, b))
    with torch.inference_mode():
        K.lstm_scan(gx, w, valid, compute, (False, True))
        K.lstm_scan_bwd(w, valid, gx, gx[..., :h], gx[..., :h], compute,
                        (False, True))
    route = "cluster" if compute == torch.bfloat16 else "simt"
    for kernel in ("fwd", "bwd"):
        args = fake.calls[f"lstm_scan_{kernel}"]
        plan = K.cluster_plan(kernel, h, b, compute)
        assert args[-3:-1] == (plan.cluster, plan.rows)
        assert args[-4] == int(compute == torch.bfloat16)
        assert _native.LAUNCHES[f"lstm_scan_{kernel}"] == 1
        assert _native.LAUNCHES[f"lstm_scan_{kernel}_{route}"] == 1
    if route == "cluster":
        assert (fake.calls["lstm_scan_fwd"][1], fake.calls["lstm_scan_bwd"][0]
                ) == tuple(x.data_ptr() for x in laid)
    else:
        assert not laid and _native.LAUNCHES["lstm_scan_fwd_cluster"] == 0
