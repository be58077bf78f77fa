"""The LSTM scans' launch plan and the weight layout of the cluster and
grid routes.

``cluster_plan`` picks, by shape, the route K2 and K3 run on: clusters of
blocks holding w_hh in shared memory (bfloat16, H <= 512), one co-resident
grid of blocks holding it (bfloat16 above H = 512, ``grid_plan``; float32
from ``GRID_F32_MIN_HIDDEN`` up, the float32 grid) or the CUDA-core kernels
(the shapes no grid fits).  ``fragment_weights`` lays w_hh out in those
kernels' order; the product computed from that layout the way the kernels
arrange it must be exactly h . w_hh (and dgates . w_hh^T) in float32, on
integer-valued inputs, where the order of the sums cannot matter.  The wrapper tests run
the kernel entries against a fake library that records their arguments:
these run on the CPU and check what reaches the C entry, not the kernels
(those are compared with their plain versions on the card by
chip_smoke.py).
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
                assert plan.route == "grid", (name, plan)
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
    narrow = K.GRID_F32_MIN_HIDDEN // 2
    for kernel in ("fwd", "bwd"):
        # float32 takes the float32 grid where it fits the card (timit's
        # listener; the streaming listener) ...
        assert K.cluster_plan(kernel, 256, 32, torch.float32).route == \
            "grid_f32"
        assert K.cluster_plan(kernel, 768, 64, torch.float32).route == \
            "grid_f32"
        # ... and the CUDA cores below GRID_F32_MIN_HIDDEN and where no
        # grid fits: D=2 at H=1024 (2 x 128 blocks) and at H=768 (192);
        # H not a multiple of the 8 units a block
        assert K.cluster_plan(kernel, narrow, 32, torch.float32) == simt
        assert K.cluster_plan(kernel, 1024, 64, torch.float32, 2) == simt
        assert K.cluster_plan(kernel, 768, 64, torch.float32, 2) == simt
        assert K.cluster_plan(kernel, 260, 32, torch.float32) == simt
        # ls100_transducer_streaming's enc_hidden: 4.7 MB of w_hh a
        # direction fits no cluster, but the card's grid
        assert K.cluster_plan(kernel, 768, 32, torch.bfloat16).route == "grid"
        # no whole k-steps (H % 16); no grid holds 2 x 33.6 MB of w_hh
        assert K.cluster_plan(kernel, 520, 32, torch.bfloat16) == simt
        assert K.cluster_plan(kernel, 2048, 64, torch.bfloat16, 2) == simt
    with pytest.raises(ValueError, match="kernel"):
        K.cluster_plan("both", 256, 32, torch.bfloat16)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_grid_plan_takes_every_wide_bfloat16_shape(kernel):
    assert pallas_widths()["ls100_transducer_streaming"] == 768
    bwd = kernel == "bwd"
    for hidden in (528, 640, 768, 1024):
        k = 4 * hidden if bwd else hidden
        for d in (1, 2):
            for batch in (1, 5, 64, 256):
                plan = K.cluster_plan(kernel, hidden, batch, torch.bfloat16,
                                      d)
                assert plan.route == "grid", (hidden, d, batch, plan)
                assert plan == K.grid_plan(kernel, hidden, batch, d)
                u = plan.units
                assert u in K.GRID_UNITS[kernel] and hidden % u == 0
                # every block resident at once, one an SM
                assert hidden // u * plan.groups * d <= K.GRID_SMS == 132
                assert plan.groups * plan.rows >= batch
                assert plan.rows - plan.sub < -(-batch // plan.groups)
                assert plan.rows % plan.sub == 0 and plan.sub % 8 == 0
                # the sub-tile's work units divide the 8 warps
                work = u // (16 if bwd else 8) * (plan.sub // 8)
                assert K.GRID_WARPS % work == 0
                assert plan.chunk % 16 == 0 and k % plan.chunk == 0
                assert plan.chunk <= K.GRID_MAX_CHUNK
                assert plan.stages in (2, 3)
                assert plan.threads == K.GRID_THREADS == 256
                assert plan.smem == K.grid_smem(
                    kernel, hidden, u, plan.rows, plan.sub, plan.chunk,
                    plan.stages) <= K.MAX_SMEM
    # the streaming listener: two row groups of 32, 96 blocks
    plan = K.cluster_plan(kernel, 768, 64, torch.bfloat16, 1)
    assert (plan.units, plan.groups, plan.rows) == (16, 2, 32)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_grid_plan_takes_every_float32_shape_that_fits(kernel):
    f32 = torch.float32
    k_of = {"fwd": 1, "bwd": 4}[kernel]
    # the LM (D=1, H=1024), the fusion and timit listeners (D=2, H=384 and
    # 256), the predictor and the streaming listener (D=1, H=512 and 768)
    for hidden, d in ((1024, 1), (384, 2), (256, 2), (512, 1), (768, 1)):
        k = k_of * hidden
        for batch in (1, 5, 64, 256):
            plan = K.cluster_plan(kernel, hidden, batch, f32, d)
            assert plan.route == "grid_f32", (hidden, d, batch, plan)
            assert plan == K.grid_plan(kernel, hidden, batch, d, f32)
            u = plan.units
            assert u == K.GRID_F32_UNITS == 8 and hidden % u == 0
            # every block resident at once, one an SM
            assert hidden // u * plan.groups * d <= K.GRID_SMS == 132
            assert plan.groups * plan.rows >= batch
            assert plan.rows - plan.sub < -(-batch // plan.groups)
            assert plan.sub == K.GRID_F32_SUB == 64
            assert plan.rows % plan.sub == 0
            assert k % plan.chunk == 0 and plan.chunk <= K.GRID_F32_MAX_CHUNK
            assert plan.stages in (2, 3)
            # 8 warps of products and gate math, and the ring's feeder
            assert plan.threads == K.GRID_F32_THREADS == 288
            assert plan.smem == K.grid_smem(
                kernel, hidden, u, plan.rows, plan.sub, plan.chunk,
                plan.stages, f32) <= K.MAX_SMEM
    # the LM and the fusion listener: 128 and 2 x 48 blocks, one row group
    # of one 64-row sub-tile
    for hidden, d in ((1024, 1), (384, 2)):
        plan = K.cluster_plan(kernel, hidden, 64, f32, d)
        assert (plan.units, plan.groups, plan.rows) == (8, 1, 64)


def check_layout(kernel: str, hidden: int, plan: K.Plan) -> None:
    """The fragment order of ``plan`` is a permutation of w_hh (bf16, or
    float32 on the float32 grid), and the product reference from it equals
    h . w_hh (dgates . w_hh^T) exactly on integer-valued inputs."""
    g = torch.Generator().manual_seed(hidden)
    w = torch.randint(-4, 5, (2, hidden, 4 * hidden), generator=g).float()
    frag = K.fragment_weights(w, kernel, plan)
    dtype = torch.float32 if plan.route == "grid_f32" else torch.bfloat16
    assert frag.dtype == dtype and frag.shape == (2, 4 * hidden**2)
    # every entry once: the counts of each of the 9 values of each
    # direction agree (the sorted values would, at a sort's cost)
    for d in range(2):
        assert torch.equal(torch.bincount(frag[d].long() + 4, minlength=9),
                           torch.bincount(w[d].reshape(-1).long() + 4,
                                          minlength=9))
    width = hidden if kernel == "fwd" else 4 * hidden
    x = torch.randint(-4, 5, (2, 3, width), generator=g).float()
    want = torch.bmm(x, w if kernel == "fwd" else w.transpose(1, 2))
    got = K.fragment_product_reference(frag, x, kernel, plan)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("hidden", [64, 256, 384, 512])
def test_cluster_weights_are_a_permutation(kernel, hidden):
    check_layout(kernel, hidden,
                 K.cluster_plan(kernel, hidden, 32, torch.bfloat16))


# the grid route's layouts: the default plan's 16 units a block at the
# streaming listener's 768, and the other unit counts GRID_UNITS allows
@pytest.mark.parametrize("kernel,hidden,units",
                         [("fwd", 640, 8), ("fwd", 768, 16), ("fwd", 640, 32),
                          ("bwd", 768, 16), ("bwd", 640, 32)])
def test_grid_weights_are_a_permutation(kernel, hidden, units):
    plan = K.cluster_plan(kernel, hidden, 32, torch.bfloat16, 2)
    assert plan.route == "grid"
    check_layout(kernel, hidden, plan._replace(units=units))


# the float32 grid's layout at the fusion listener's width and the LM's
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("hidden", [384, 1024])
def test_grid_f32_weights_are_a_permutation(kernel, hidden):
    plan = K.cluster_plan(kernel, hidden, 64, torch.float32)
    assert plan.route == "grid_f32"
    check_layout(kernel, hidden, plan)


class _Entry:
    """A stand-in for the kernel library: records each entry's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


def run_wrappers(monkeypatch, compute, h):
    """K2 and K3 wrappers at D=2, T=3, B=32 against a fake library ->
    (its calls, the laid-out weights, the grid scratch handed over)."""
    fake = _Entry()
    monkeypatch.setattr(_native, "lib", lambda: fake)
    monkeypatch.setattr(_native, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_native, "use_kernel", lambda t, backend: True)
    # the forward reaches K2 through the custom op, whose CPU body is the
    # plain version: give CPU tensors its CUDA body, the launch
    monkeypatch.setattr(
        K.LIB, "lstm_scan_fwd",
        lambda gx, w, v, c, mask, *rest: K.launch_scan_fwd(
            gx, w, v, c, K.reverse_of(mask, gx.shape[0]), *rest))
    laid, scratch = [], []
    relay, alloc = K.fragment_weights, K._grid_scratch
    monkeypatch.setattr(K, "fragment_weights",
                        lambda *a: laid.append(relay(*a)) or laid[-1])
    monkeypatch.setattr(K, "_grid_scratch",
                        lambda *a: scratch.append(alloc(*a)) or scratch[-1])
    for key in _native.LAUNCHES:
        monkeypatch.setitem(_native.LAUNCHES, key, 0)
    d, t, b = 2, 3, 32
    gx = torch.zeros((d, t, b, 4 * h))
    w = torch.zeros((d, h, 4 * h))
    valid = torch.ones((t, b))
    with torch.inference_mode():
        K.lstm_scan(gx, w, valid, compute, (False, True))
        K.lstm_scan_bwd(w, valid, gx, gx[..., :h], gx[..., :h], compute,
                        (False, True))
    return fake, laid, scratch


def counted_once(kernel: str, route: str) -> None:
    assert _native.LAUNCHES[f"lstm_scan_{kernel}"] == 1
    for other in ("cluster", "grid", "grid_f32", "simt"):
        assert _native.LAUNCHES[f"lstm_scan_{kernel}_{other}"] == (
            other == route)


# bf16 at timit's width: the cluster route; float32 there: the float32
# grid; float32 below GRID_F32_MIN_HIDDEN: the CUDA cores
@pytest.mark.parametrize("compute,h,route", [
    (torch.bfloat16, 256, "cluster"), (torch.float32, 256, "grid_f32"),
    (torch.float32, K.GRID_F32_MIN_HIDDEN // 2, "simt")])
def test_wrappers_pass_the_plan_and_count_the_route(compute, h, route,
                                                     monkeypatch):
    d, b = 2, 32
    fake, laid, scratch = run_wrappers(monkeypatch, compute, h)
    for i, kernel in enumerate(("fwd", "bwd")):
        plan = K.cluster_plan(kernel, h, b, compute, d)
        assert plan.route == route
        counted_once(kernel, route)
        if route == "grid_f32":
            args = fake.calls[f"lstm_scan_{kernel}_grid_f32"]
            assert args[-7:-1] == (plan.units, plan.groups, plan.rows,
                                   plan.sub, plan.chunk, plan.stages)
            assert scratch[i][0].dtype == torch.float32
            continue
        args = fake.calls[f"lstm_scan_{kernel}"]
        assert args[-3:-1] == (plan.cluster, plan.rows)
        assert args[-4] == int(compute == torch.bfloat16)
    if route != "grid_f32":
        assert not scratch
    if route == "simt":
        assert not laid
    else:
        sfx = "_grid_f32" if route == "grid_f32" else ""
        assert (fake.calls["lstm_scan_fwd" + sfx][1],
                fake.calls["lstm_scan_bwd" + sfx][0]) == tuple(
                    x.data_ptr() for x in laid)


def test_grid_wrappers_pass_the_plan_and_scratch(monkeypatch):
    d, t, b, h = 2, 3, 32, 768
    fake, laid, scratch = run_wrappers(monkeypatch, torch.bfloat16, h)
    assert "lstm_scan_fwd" not in fake.calls
    assert "lstm_scan_bwd" not in fake.calls
    for i, kernel in enumerate(("fwd", "bwd")):
        plan = K.cluster_plan(kernel, h, b, torch.bfloat16, d)
        args = fake.calls[f"lstm_scan_{kernel}_grid"]
        assert args[-7:-1] == (plan.units, plan.groups, plan.rows, plan.sub,
                               plan.chunk, plan.stages)
        assert args[-12:-7] == (d, t, b, h, 2)          # D, T, B, H, reverse
        # the laid-out weights, the exchange buffer by step parity and the
        # zeroed step counters
        xch, ctr = scratch[i]
        k = 4 * h if kernel == "bwd" else h
        assert xch.shape == (2, d, plan.groups * plan.rows, k)
        assert xch.dtype == torch.bfloat16 and ctr.dtype == torch.int32
        assert ctr.shape == (d * plan.groups,) and not ctr.any()
        # K2's carried state (h0, c0, h_fin, c_fin) sits between its
        # residuals and the scratch: NULL when the scan carries none
        at = 11 if kernel == "fwd" else 6
        if kernel == "fwd":
            assert args[7:11] == (None,) * 4
        assert args[at:at + 2] == (xch.data_ptr(), ctr.data_ptr())
        assert args[1 if kernel == "fwd" else 0] == laid[i].data_ptr()
        counted_once(kernel, "grid")


def test_grid_f32_wrappers_pass_the_plan_and_scratch(monkeypatch):
    d, t, b, h = 2, 3, 32, 384
    fake, laid, scratch = run_wrappers(monkeypatch, torch.float32, h)
    assert "lstm_scan_fwd" not in fake.calls
    assert "lstm_scan_bwd_grid" not in fake.calls
    for i, kernel in enumerate(("fwd", "bwd")):
        plan = K.cluster_plan(kernel, h, b, torch.float32, d)
        args = fake.calls[f"lstm_scan_{kernel}_grid_f32"]
        assert args[-12:-7] == (d, t, b, h, 2)          # D, T, B, H, reverse
        # the float32 weights, the k-major exchange of 64-row sub-tiles by
        # step parity and the zeroed step counters
        xch, ctr = scratch[i]
        k = 4 * h if kernel == "bwd" else h
        assert xch.shape == (2, d, plan.groups * plan.rows // plan.sub, k,
                             plan.sub)
        assert xch.dtype == torch.float32 and ctr.dtype == torch.int32
        assert ctr.shape == (d * plan.groups,) and not ctr.any()
        assert laid[i].dtype == torch.float32
        at = 11 if kernel == "fwd" else 6
        assert args[at:at + 2] == (xch.data_ptr(), ctr.data_ptr())
        assert args[1 if kernel == "fwd" else 0] == laid[i].data_ptr()
        counted_once(kernel, "grid_f32")
    # a carried state: buffer 0 holds h0 k-major, zeros past B
    g = torch.Generator().manual_seed(1)
    h0, c0 = torch.randn((2, d, b, h), generator=g)
    with torch.inference_mode():
        K.lstm_scan(torch.zeros((d, t, b, 4 * h)), torch.zeros((d, h, 4 * h)),
                    torch.ones((t, b)), torch.float32, (False, True), h0=h0,
                    c0=c0, return_state=True)
    xch = scratch[-1][0]
    rows = xch[0].transpose(2, 3).reshape(d, -1, h)
    assert torch.equal(rows[:, :b], h0) and not rows[:, b:].any()
