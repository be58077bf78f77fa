"""Masked LSTM scan: kernels K2 (``csrc/lstm_scan_fwd.cu``) and K3
(``csrc/lstm_scan_bwd.cu``).

Counterpart of ``semi_supervised_asr_tpu/ops/pallas_lstm.py``:
``lstm_scan`` takes input projections already computed for all steps (one
large product outside the kernel, as in JAX) and runs the serial
recurrence of D independent directions in one launch.  When its inputs
require grad it runs as an ``autograd.Function`` (the counterpart of
``lstm_scan_pallas``'s custom VJP): the forward keeps K2's residuals, the
backward runs K3 for the gate gradients and takes ``dW_hh = sum_t,b
hprev^T dgates`` as one float32 product outside the kernel.
``lstm_kernel`` / ``bilstm_kernel`` are the drop-ins for ``lstm_pallas`` /
``bilstm_pallas`` and for the reference's plain ``recurrent.lstm`` /
``bilstm`` (both directions of a BiLSTM share the launch here, which is
also what ``fuse_bilstm`` asks for).

Padded steps pass the (h, c) carry through and emit zeros, so the reverse
direction over a right-padded batch starts at each row's last valid frame.
Outside autograd a scan may start from given carries (``h0``, ``c0``) and
return its final ones (``return_state``): each row's (h, c) after its last
valid step, which a later scan resumes from (chunked streaming, the
reference's ``recurrent.lstm(..., h0=, c0=, return_state=True)``).

Three routes run the kernels, chosen by shape in :func:`cluster_plan`:
bfloat16 at H <= 512 runs as thread-block clusters (each block holds its
slice of ``w_hh`` in shared memory for the whole scan, the step's h or
dgates go between blocks through distributed shared memory, the step's
product runs on the tensor cores); bfloat16 above H = 512 runs as one grid
whose blocks are all resident at once (:func:`grid_plan`: each block holds
its slice of ``w_hh`` in shared memory, the step's h or dgates go between
blocks through a global buffer in L2 with a step barrier on a counter);
float32, and bfloat16 where neither fits, runs on the CUDA cores.
:func:`fragment_weights` lays ``w_hh`` out in the order the cluster and
grid kernels read it (a permutation, one gather a call) and
:func:`fragment_product_reference` computes one step's product from that
layout the way the kernels arrange it.

``lstm_scan_reference`` / ``lstm_scan_bwd_reference`` are the same math in
plain PyTorch.  The wrappers run them only for CPU tensors or when asked
with ``backend="reference"``; a CUDA tensor otherwise launches the kernel
or raises.  Residuals and gate gradients are indexed in real time order
for every direction (the JAX kernels index a reverse direction's in
flipped order).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from semi_supervised_asr_tpu_torch import _native
from semi_supervised_asr_tpu_torch.ops import recurrent as R


# ---- the cluster and grid routes: plans and weight layout ----

MAX_SMEM = 232_448          # shared memory one block can use on sm_90
CLUSTER_THREADS = 256       # the cluster kernels' launch bound
CLUSTER_PAD = 8             # bf16 pad of an exchanged row in shared memory
# Above this width w_hh fits no cluster's shared memory (4.7 MB a direction
# in bf16 at H=768), so bfloat16 there runs on the grid route.
CLUSTER_MAX_HIDDEN = 512
# cluster sizes in order of preference: 8 is the portable maximum; 16
# needs the non-portable attribute and may find room once per GPC
CLUSTER_SIZES = (8, 16, 4, 2, 1)
# The grid route: blocks of 8 warps, one an SM (their shared memory), all
# resident at once on the H100 SXM's 132 SMs; hidden units a block in
# order of preference (a multiple of 8 forward, 16 backward); the exchange
# streamed in chunks of at most GRID_MAX_CHUNK columns
GRID_SMS = 132
GRID_THREADS = 256
GRID_WARPS = GRID_THREADS // 32
GRID_UNITS = {"fwd": (16, 8, 32), "bwd": (16, 32)}
GRID_MAX_CHUNK = 768


class Plan(NamedTuple):
    """How a scan launches: ``route`` "cluster" (bf16, clusters of
    ``cluster`` blocks over ``rows`` batch rows, ``units`` hidden units a
    block, ``threads`` and ``smem`` bytes a block), "grid" (bf16, H/units
    blocks for each of ``groups`` groups of ``rows`` batch rows and each
    direction, the rows taken ``sub`` at a time, the exchange streamed in
    ``chunk`` columns through ``stages`` ring stages) or "simt" (the
    CUDA-core kernels; the integers 0)."""
    route: str
    cluster: int = 0
    rows: int = 0
    units: int = 0
    threads: int = 0
    smem: int = 0
    groups: int = 0
    sub: int = 0
    chunk: int = 0
    stages: int = 0


# batch rows a cluster: one mma n-tile.  Each step exchanges R x H (K2) or
# R x 4H (K3) bf16 values a block and runs an R-column product, so the
# smallest tile gives the shortest step and the most clusters
# (chip_smoke.py's phase 8 times 8 rows against 16)
CLUSTER_ROWS = 8


def cluster_smem(kernel: str, hidden: int, cluster: int, rows: int) -> int:
    """Shared memory of one block (bytes), as ``csrc/lstm_common.cuh``
    counts it: three mbarriers (32), the weight slice ([H, 4u] or [u, 4H]
    bf16), and by step parity the exchanged rows (C slabs of [R][W + pad]
    bf16, W = u for h, 4u for dgates) and the block's own slab."""
    u = hidden // cluster
    width = u if kernel == "fwd" else 4 * u
    slabs = 2 * (cluster + 1) * rows * (width + CLUSTER_PAD) * 2
    return 32 + hidden * 4 * u * 2 + slabs


def grid_smem(kernel: str, hidden: int, units: int, rows: int, sub: int,
              chunk: int, stages: int) -> int:
    """Shared memory of one grid block (bytes), as ``csrc/lstm_common.cuh``
    counts it: the weights' mbarrier (16), the weight slice (u x 4H bf16),
    the ring (min(stages, K/chunk) stages of [sub][chunk + pad] bf16, K = H
    forward, 4H backward), a sub-tile's streamed inputs (f32: 4u gates_x,
    or 4u acts + u cprev + u dh_out a row, and valid), the carries
    ([rows][u] x 2 f32) and the k-split partial sums."""
    bwd = kernel == "bwd"
    k = 4 * hidden if bwd else hidden
    work = units // (16 if bwd else 8) * (sub // 8)
    ring = min(stages, k // chunk) * sub * (chunk + CLUSTER_PAD) * 2
    inputs = -(-sub * ((6 if bwd else 4) * units + 1) * 4 // 16) * 16
    parts = (GRID_WARPS // work - 1) * work * 32 * (4 if bwd else 8) * 4
    return (16 + hidden * 4 * units * 2 + ring + inputs + rows * units * 8
            + parts)


def grid_plan(kernel: str, hidden: int, batch: int,
              directions: int) -> Plan | None:
    """The grid route's launch shape for bf16 K2 / K3 at this width, batch
    and number of directions, or None where none fits.  The first unit
    count of ``GRID_UNITS`` whose N = H/u blocks a direction fit the card
    (``GRID_SMS``, one block an SM) takes as many row groups as fit: each
    block then reads the fewest exchanged rows a step.  A sub-tile holds as
    many 8-row tiles as give the 8 warps a work unit each (fewer at a small
    batch: the warps then split the k-steps); the ring takes the widest
    chunk of at most ``GRID_MAX_CHUNK`` columns (and 3 stages where there
    are more than 2 chunks, else 2) that fits ``MAX_SMEM``."""
    bwd = kernel == "bwd"
    k = 4 * hidden if bwd else hidden
    if hidden % 16:
        return None
    for u in GRID_UNITS[kernel]:
        if hidden % u:
            continue
        fit = GRID_SMS // (hidden // u * directions)
        if fit < 1:
            continue
        groups = min(fit, -(-batch // 8))
        need = -(-batch // groups)                 # rows a group
        tiles = min(GRID_WARPS // (u // (16 if bwd else 8)),
                    1 << max(0, (-(-need // 8) - 1).bit_length()))
        sub = 8 * tiles
        rows = -(-need // sub) * sub
        for chunk in range(min(k, GRID_MAX_CHUNK) // 16 * 16, 0, -16):
            if k % chunk:
                continue
            for stages in ((3, 2) if k // chunk > 2 else (2,)):
                smem = grid_smem(kernel, hidden, u, rows, sub, chunk,
                                 stages)
                if smem <= MAX_SMEM:
                    return Plan("grid", 0, rows, u, GRID_THREADS, smem,
                                -(-batch // rows), sub, chunk, stages)
    return None


def cluster_plan(kernel: str, hidden: int, batch: int,
                 compute: torch.dtype, directions: int = 1) -> Plan:
    """The route and launch shape of K2 (``kernel="fwd"``) or K3
    (``"bwd"``) for this width, batch, compute dtype and number of
    directions.  float32, and bfloat16 where neither the cluster nor the
    grid route fits, go to the CUDA-core route; bfloat16 above
    ``CLUSTER_MAX_HIDDEN`` to :func:`grid_plan`'s.  Otherwise tiles of
    ``CLUSTER_ROWS`` rows and the first cluster size of ``CLUSTER_SIZES``
    whose blocks own a multiple of 16 units (whole k-steps of one block's
    slab; the backward's unit tiles) within ``MAX_SMEM``.  The batch and
    the directions only set the number of clusters there."""
    if kernel not in ("fwd", "bwd"):
        raise ValueError(f"kernel must be 'fwd' or 'bwd', got {kernel!r}")
    if compute != torch.bfloat16:
        return Plan("simt")
    if hidden > CLUSTER_MAX_HIDDEN:
        return grid_plan(kernel, hidden, batch, directions) or Plan("simt")
    r = CLUSTER_ROWS
    for c in CLUSTER_SIZES:
        u = hidden // c
        if hidden % c or u % 16:
            continue
        # a warp per (8 units, 8 rows) forward, (16 units, 8 rows) backward
        threads = 32 * (u // (8 if kernel == "fwd" else 16)) * (r // 8)
        smem = cluster_smem(kernel, hidden, c, r)
        if smem <= MAX_SMEM and threads <= CLUSTER_THREADS:
            return Plan("cluster", c, r, u, threads, smem)
    return Plan("simt")


def _fragment_position():
    """(m, k) inside a 16 x 16 A tile of each (lane, register, element) of
    an mma.sync m16n8k16 A fragment, as [32, 4, 2] tensors."""
    lane = torch.arange(32).view(32, 1, 1)
    reg = torch.arange(4).view(1, 4, 1)
    el = torch.arange(2).view(1, 1, 2)
    return lane // 4 + 8 * (reg % 2), 2 * (lane % 4) + 8 * (reg // 2) + el


@functools.lru_cache(maxsize=None)
def _fragment_index(kernel: str, hidden: int, u: int,
                    device: torch.device) -> torch.Tensor:
    """Flat indices into one direction's w_hh [H, 4H], in the order the
    cluster and grid kernels hold it: block by block (block j owns the
    units [j * u, (j + 1) * u)), then (forward) [8-unit group, k-step,
    m-tile (i|f, g|o), lane, register, element] with A[m, k] = w_hh[k,
    gate * H + unit], gate = 2 * m-tile + m // 8, unit = j * u + 8 * group
    + m % 8; or (backward) [16-unit tile, k-step, lane, register, element]
    with A[m, k] = w_hh[j * u + 16 * tile + m, _slab_column(k)]: the
    backward's k runs over the exchanged dgates slab by slab."""
    blocks = hidden // u
    m, kk = _fragment_position()
    h4 = 4 * hidden

    def axis(n, i, rank):        # arange(n) along axis i of ``rank`` axes
        shape = [1] * rank
        shape[i] = n
        return torch.arange(n).view(shape)

    if kernel == "fwd":          # [H/u, u/8, H/16, 2, 32, 4, 2]
        j, grp, ks, mt = (axis(n, i, 7) for i, n in
                          enumerate((blocks, u // 8, hidden // 16, 2)))
        gate = 2 * mt + m // 8
        unit = j * u + 8 * grp + m % 8
        idx = (16 * ks + kk) * h4 + gate * hidden + unit
    else:                        # [H/u, u/16, 4H/16, 32, 4, 2]
        j, tile, ks = (axis(n, i, 6) for i, n in
                       enumerate((blocks, u // 16, h4 // 16)))
        cols = _slab_column(16 * ks + kk, hidden, u)
        idx = (j * u + 16 * tile + m) * h4 + cols
    return idx.reshape(-1).to(device)


def _slab_column(k: torch.Tensor, hidden: int, u: int) -> torch.Tensor:
    """The gate column (gate * H + unit) of position k of the backward's
    exchanged dgates: block b's slab holds its u units' four gate groups,
    gate by gate."""
    block, rem = k // (4 * u), k % (4 * u)
    return (rem // u) * hidden + block * u + rem % u


def fragment_weights(w_hh: torch.Tensor, kernel: str,
                     plan: Plan) -> torch.Tensor:
    """w_hh [D, H, 4H] -> bf16 [D, H * 4H] in the fragment order of the
    cluster or grid kernels (block j's slice is the j-th of H / units
    equal pieces): a permutation of each direction's entries."""
    d, hidden, h4 = w_hh.shape
    idx = _fragment_index(kernel, hidden, plan.units, w_hh.device)
    return w_hh.to(torch.bfloat16).reshape(d, hidden * h4).index_select(1, idx)


def fragment_product_reference(w_frag: torch.Tensor, x: torch.Tensor,
                               kernel: str, plan: Plan) -> torch.Tensor:
    """One step's product from the fragment-ordered weights, arranged as
    the cluster and grid kernels arrange it (float32 sums): forward x = h
    [D, N, H] -> gates [D, N, 4H] = h . w_hh; backward x = dgates [D, N, 4H]
    -> dh [D, N, H] = dgates . w_hh^T."""
    d = w_frag.shape[0]
    u = plan.units
    hidden = x.shape[-1] if kernel == "fwd" else x.shape[-1] // 4
    c = hidden // u
    m, kk = _fragment_position()
    pos = (16 * m + kk).reshape(-1)            # (lane, reg, el) -> m, k
    lead = (d, c, u // 8, hidden // 16, 2) if kernel == "fwd" else (
        d, c, u // 16, hidden // 4)
    frags = w_frag.float().reshape(*lead, 256)
    tiles = torch.zeros_like(frags)
    tiles[..., pos] = frags                    # [..., 16 m x 16 k]
    tiles = tiles.view(*lead, 16, 16)
    xf = x.float()
    n = x.shape[1]
    if kernel == "fwd":
        # [D, C, grp, ks, mt, m, k] -> A [D, C, grp, mt, m, H]
        a = tiles.permute(0, 1, 2, 4, 5, 3, 6).reshape(d, c, u // 8, 2, 16,
                                                       hidden)
        out = torch.einsum("dcgtmk,dnk->dcgtmn", a, xf)
        # m = 8 * (gate % 2) + unit % 8, gate = 2 * mt + m // 8
        out = out.reshape(d, c, u // 8, 2, 2, 8, n)
        return out.permute(0, 6, 3, 4, 1, 2, 5).reshape(d, n, 4 * hidden)
    a = tiles.permute(0, 1, 2, 4, 3, 5).reshape(d, c, u // 16, 16,
                                                4 * hidden)
    cols = _slab_column(torch.arange(4 * hidden), hidden, u)
    out = torch.einsum("dctmk,dnk->dctmn", a, xf[..., cols])
    return out.permute(0, 4, 1, 2, 3).reshape(d, n, hidden)


def cluster_occupancy(kernel: str, plan: Plan) -> int:
    """How many clusters of ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    out = ctypes.c_int(0)
    code = getattr(_native.lib(), f"lstm_scan_{kernel}_occupancy")(
        plan.cluster * plan.units, plan.cluster, plan.rows,
        ctypes.byref(out))
    _native.check(f"lstm_scan_{kernel}_occupancy", code)
    return out.value


def grid_occupancy(kernel: str, hidden: int, plan: Plan) -> tuple[int, int]:
    """(blocks of the grid ``plan`` one SM holds, the card's SMs)
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``): a launch of N * G *
    D blocks runs only if it is at most their product."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    code = getattr(_native.lib(), f"lstm_scan_{kernel}_grid_occupancy")(
        hidden, plan.units, plan.rows, plan.sub, plan.chunk, plan.stages,
        ctypes.byref(per_sm), ctypes.byref(sms))
    _native.check(f"lstm_scan_{kernel}_grid_occupancy", code)
    return per_sm.value, sms.value


def _grid_ints(plan: Plan) -> tuple[int, ...]:
    """A grid plan's integers in the C entries' order."""
    return (plan.units, plan.groups, plan.rows, plan.sub, plan.chunk,
            plan.stages)


def _grid_scratch(kernel: str, plan: Plan, d: int, hidden: int,
                  device: torch.device, h0: torch.Tensor | None = None):
    """The grid route's exchange buffer ([2, D, G * R, K] bf16, by step
    parity) and its zeroed step counters ([D * G]).  With ``h0`` [D, B, H]
    (K2's initial carry) buffer 0 holds it rounded to bf16, zeros past B:
    the rows step 0 reads."""
    k = 4 * hidden if kernel == "bwd" else hidden
    shape = (2, d, plan.groups * plan.rows, k)
    if h0 is None:
        xch = torch.empty(shape, dtype=torch.bfloat16, device=device)
    else:
        xch = torch.zeros(shape, dtype=torch.bfloat16, device=device)
        xch[0, :, :h0.shape[1]] = h0
    ctr = torch.zeros((d * plan.groups,), dtype=torch.int32, device=device)
    return xch, ctr


def exchange_floor(kernel: str, plan: Plan, d: int, t: int, b: int,
                   device: torch.device, hidden: int = 0,
                   read: bool = True) -> None:
    """Launch the serial chain's floor of ``plan``: T steps of its
    exchange and the waits for it alone, no product and no gate math, on
    the grid the scan would have for D directions and B rows (a
    measurement of ``chip_smoke.py``, not a step of the scan).  A grid
    plan needs ``hidden``; ``read=False`` leaves out its read of the
    exchanged rows (the step barrier alone)."""
    if plan.route == "grid":
        xch, ctr = _grid_scratch(kernel, plan, d, hidden, device)
        code = _native.lib().lstm_grid_floor(
            int(kernel == "bwd"), int(read), d, t, b, hidden,
            *_grid_ints(plan), xch.data_ptr(), ctr.data_ptr(),
            _native.stream_ptr(device))
    else:
        code = _native.lib().lstm_exchange_floor(
            int(kernel == "bwd"), d, t, b, plan.cluster * plan.units,
            plan.cluster, plan.rows, _native.stream_ptr(device))
    _native.check("lstm_exchange_floor", code)
    _native.count("lstm_exchange_floor")


def lstm_scan_reference(
    gates_x: torch.Tensor,          # [D, T, B, 4H] float32
    w_hh: torch.Tensor,             # [D, H, 4H]
    valid: torch.Tensor,            # [T, B] float 0/1
    compute: torch.dtype,
    reverse: tuple[bool, ...],
    residuals: bool = False,
    h0: torch.Tensor | None = None,     # [D, B, H] float32
    c0: torch.Tensor | None = None,
    return_state: bool = False,
):
    """Plain version of the scan -> h_out [D, T, B, H] float32, plus
    (hprev, cprev, acts) when ``residuals``, all at the time index of the
    step that produced them (reverse directions included); the carries
    start at (h0, c0) (zeros when None), and ``return_state`` adds the
    final (h, c) [D, B, H]: ``(out, (h, c))``."""
    d, t, b, h4 = gates_x.shape
    hidden = h4 // 4

    def flip(x, i):          # reverse directions walk time backward
        return x.flip(0) if reverse[i] else x

    gx = torch.stack([flip(gates_x[i].float(), i) for i in range(d)], dim=1)
    v = torch.stack([flip(valid.float(), i) for i in range(d)], dim=1)
    v = v[..., None]                                     # [T, D, B, 1]
    w = w_hh.to(compute).float()                         # [D, H, 4H]
    if h0 is None:
        h = torch.zeros((d, b, hidden), dtype=torch.float32,
                        device=gates_x.device)
        c = torch.zeros_like(h)
    else:
        h, c = h0.float(), c0.float()
    outs, hps, cps, acts = [], [], [], []
    for s in range(t):
        gates = gx[s] + torch.bmm(h.to(compute).float(), w)
        i_, f_, g_, o_ = gates.chunk(4, dim=-1)
        i_, f_, o_ = torch.sigmoid(i_), torch.sigmoid(f_), torch.sigmoid(o_)
        g_ = torch.tanh(g_)
        c_new = f_ * c + i_ * g_
        h_new = o_ * torch.tanh(c_new)
        if residuals:
            hps.append(h)
            cps.append(c)
            acts.append(torch.cat([i_, f_, g_, o_], dim=-1))
        outs.append(v[s] * h_new)
        h = v[s] * h_new + (1.0 - v[s]) * h
        c = v[s] * c_new + (1.0 - v[s]) * c

    def unstack(xs):         # [T][D, B, X] -> [D, T, B, X] in real time
        y = torch.stack(xs, dim=1)
        return torch.stack([flip(y[i], i) for i in range(d)])

    out = unstack(outs)
    if residuals:
        out = out, unstack(hps), unstack(cps), unstack(acts)
    return (out, (h, c)) if return_state else out


def lstm_scan(
    gates_x: torch.Tensor,
    w_hh: torch.Tensor,
    valid: torch.Tensor,
    compute: torch.dtype,
    reverse: tuple[bool, ...],
    residuals: bool = False,
    backend: str | None = None,
    h0: torch.Tensor | None = None,
    c0: torch.Tensor | None = None,
    return_state: bool = False,
):
    """[D, T, B, 4H] projected gates + [D, H, 4H] w_hh + [T, B] valid ->
    masked hidden states [D, T, B, H] (float32), in real time order for
    every direction.  ``reverse[d]`` walks direction d from T-1 down to 0.
    ``residuals`` also returns (hprev, cprev, acts) for a backward pass.
    ``h0``, ``c0`` ([D, B, H] float32, both or neither) are the carries the
    scan starts from (zeros by default); ``return_state`` returns
    ``(out, (h, c))`` with the final carries [D, B, H].  Differentiable in
    ``gates_x`` and ``w_hh`` (through K3) when ``residuals`` is off and no
    state goes in or out.
    """
    stateful = h0 is not None or c0 is not None or return_state
    if torch.is_grad_enabled() and (gates_x.requires_grad
                                    or w_hh.requires_grad or (
                                        h0 is not None and h0.requires_grad)):
        if residuals:
            raise ValueError("lstm_scan: residuals are for a backward pass "
                             "of its own; ask for them without autograd")
        if stateful:
            raise ValueError("lstm_scan: a carried state (h0, c0, "
                             "return_state) is for calls without autograd")
        return _LSTMScan.apply(gates_x, w_hh, valid, compute, tuple(reverse),
                               backend)
    d, t, b, h4 = gates_x.shape
    if len(reverse) != d:
        raise ValueError(f"reverse has {len(reverse)} entries for D={d}")
    hidden = h4 // 4
    if (h0 is None) != (c0 is None):
        raise ValueError("lstm_scan: give both h0 and c0, or neither")
    for name, x in (("h0", h0), ("c0", c0)):
        if x is not None and (tuple(x.shape) != (d, b, hidden)
                              or x.device != gates_x.device):
            raise ValueError(f"{name}: expected {(d, b, hidden)} on "
                             f"{gates_x.device}, got {tuple(x.shape)} on "
                             f"{x.device}")
    if not _native.use_kernel(gates_x, backend):
        return lstm_scan_reference(gates_x, w_hh, valid, compute, reverse,
                                   residuals, h0, c0, return_state)
    dev = gates_x.device
    if compute not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lstm_scan kernel: compute dtype {compute} "
                         "unsupported (float32 or bfloat16)")
    if h4 % 4 or (compute == torch.bfloat16 and hidden % 2):
        raise ValueError(f"lstm_scan kernel: bad gate width {h4} (needs 4H, "
                         "with H even in bfloat16)")
    if gates_x.dtype != torch.float32:
        raise ValueError(f"gates_x must be float32, got {gates_x.dtype}")
    if tuple(w_hh.shape) != (d, hidden, h4) or w_hh.device != dev:
        raise ValueError(f"w_hh: expected {(d, hidden, h4)} on {dev}, got "
                         f"{tuple(w_hh.shape)} on {w_hh.device}")
    if tuple(valid.shape) != (t, b) or valid.device != dev:
        raise ValueError(f"valid: expected {(t, b)} on {dev}, got "
                         f"{tuple(valid.shape)} on {valid.device}")
    gx = gates_x.contiguous()
    plan = cluster_plan("fwd", hidden, b, compute, d)
    if plan.route == "simt":
        w = w_hh.to(compute).contiguous()
    else:
        w = fragment_weights(w_hh, "fwd", plan)
    v = valid.to(torch.float32).contiguous()
    h_out = torch.empty((d, t, b, hidden), dtype=torch.float32, device=dev)
    res = (None, None, None)
    if residuals:
        res = (torch.empty_like(h_out), torch.empty_like(h_out),
               torch.empty((d, t, b, h4), dtype=torch.float32, device=dev))
    init = (None, None)
    if h0 is not None:
        init = (h0.float().contiguous(), c0.float().contiguous())
    fin = (None, None)
    if return_state:
        fin = (torch.empty((d, b, hidden), dtype=torch.float32, device=dev),
               torch.empty((d, b, hidden), dtype=torch.float32, device=dev))
        if t == 0 or b == 0:         # no launch: the carries stay as given
            fin = tuple(x.clone() if x is not None else torch.zeros_like(f)
                        for x, f in zip(init, fin))
    mask = sum(1 << i for i, r in enumerate(reverse) if r)
    ptrs = (gx.data_ptr(), w.data_ptr(), v.data_ptr(), h_out.data_ptr(),
            *(_native.ptr(x) for x in res + init + fin))
    if plan.route == "grid":
        entry = "lstm_scan_fwd_grid"
        xch, ctr = _grid_scratch("fwd", plan, d, hidden, dev, init[0])
        code = _native.lib().lstm_scan_fwd_grid(
            *ptrs, xch.data_ptr(), ctr.data_ptr(), d, t, b, hidden, mask,
            *_grid_ints(plan), _native.stream_ptr(dev))
    else:
        entry = "lstm_scan_fwd"
        code = _native.lib().lstm_scan_fwd(
            *ptrs, d, t, b, hidden, mask, int(compute == torch.bfloat16),
            plan.cluster, plan.rows, _native.stream_ptr(dev))
    _native.check(entry, code)
    _native.count("lstm_scan_fwd")
    _native.count("lstm_scan_fwd_" + plan.route)
    out = (h_out, *res) if residuals else h_out
    return (out, fin) if return_state else out


def lstm_scan_bwd_reference(
    w_hh: torch.Tensor,             # [D, H, 4H]
    valid: torch.Tensor,            # [T, B] float 0/1
    acts: torch.Tensor,             # [D, T, B, 4H] float32
    cprev: torch.Tensor,            # [D, T, B, H] float32
    dh_out: torch.Tensor,           # [D, T, B, H] float32
    compute: torch.dtype,
    reverse: tuple[bool, ...],
) -> torch.Tensor:
    """Plain version of the backward scan -> dgates [D, T, B, 4H]
    float32: the gradient of the loss with respect to each step's gate
    pre-activations, given dh_out = dL/dh_out, in real time order."""
    d, t, b, h4 = acts.shape
    hidden = h4 // 4

    def walk(x, i):          # real time -> the forward's walk order
        return x.flip(0) if reverse[i] else x

    a = torch.stack([walk(acts[i].float(), i) for i in range(d)], dim=1)
    cp = torch.stack([walk(cprev[i].float(), i) for i in range(d)], dim=1)
    dho = torch.stack([walk(dh_out[i].float(), i) for i in range(d)], dim=1)
    v = torch.stack([walk(valid.float(), i) for i in range(d)], dim=1)
    v = v[..., None]                                     # [T, D, B, 1]
    wt = w_hh.to(compute).float().transpose(1, 2)        # [D, 4H, H]
    dh = torch.zeros((d, b, hidden), dtype=torch.float32, device=acts.device)
    dc = torch.zeros_like(dh)
    out = [None] * t
    for s in reversed(range(t)):
        i_, f_, g_, o_ = a[s].chunk(4, dim=-1)
        tanh_c = torch.tanh(f_ * cp[s] + i_ * g_)
        dh_new = v[s] * (dh + dho[s])
        dc_new = dh_new * o_ * (1.0 - tanh_c * tanh_c) + v[s] * dc
        dgates = torch.cat([dc_new * g_ * i_ * (1.0 - i_),
                            dc_new * cp[s] * f_ * (1.0 - f_),
                            dc_new * i_ * (1.0 - g_ * g_),
                            dh_new * tanh_c * o_ * (1.0 - o_)], dim=-1)
        out[s] = dgates
        dh = (1.0 - v[s]) * dh + torch.bmm(dgates.to(compute).float(), wt)
        dc = (1.0 - v[s]) * dc + dc_new * f_
    y = torch.stack(out, dim=1)                          # [D, T, B, 4H]
    return torch.stack([walk(y[i], i) for i in range(d)])


def lstm_scan_bwd(
    w_hh: torch.Tensor,
    valid: torch.Tensor,
    acts: torch.Tensor,
    cprev: torch.Tensor,
    dh_out: torch.Tensor,
    compute: torch.dtype,
    reverse: tuple[bool, ...],
    backend: str | None = None,
) -> torch.Tensor:
    """Backward scan on K3 -> dgates [D, T, B, 4H] float32 (see
    :func:`lstm_scan_bwd_reference` for the math).  Residuals as
    ``lstm_scan(..., residuals=True)`` returns them."""
    d, t, b, h4 = acts.shape
    if len(reverse) != d:
        raise ValueError(f"reverse has {len(reverse)} entries for D={d}")
    if not _native.use_kernel(acts, backend):
        return lstm_scan_bwd_reference(w_hh, valid, acts, cprev, dh_out,
                                       compute, reverse)
    hidden = h4 // 4
    dev = acts.device
    if compute not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lstm_scan_bwd kernel: compute dtype {compute} "
                         "unsupported (float32 or bfloat16)")
    vec = 8 if compute == torch.bfloat16 else 4
    if h4 % 4 or hidden % vec:
        raise ValueError(f"lstm_scan_bwd kernel: bad gate width {h4} (needs "
                         f"4H with H a multiple of {vec})")
    for name, x, shape in (("acts", acts, (d, t, b, h4)),
                           ("cprev", cprev, (d, t, b, hidden)),
                           ("dh_out", dh_out, (d, t, b, hidden))):
        if (x.dtype != torch.float32 or tuple(x.shape) != shape
                or x.device != dev):
            raise ValueError(f"{name}: expected float32 {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if tuple(w_hh.shape) != (d, hidden, h4) or w_hh.device != dev:
        raise ValueError(f"w_hh: expected {(d, hidden, h4)} on {dev}, got "
                         f"{tuple(w_hh.shape)} on {w_hh.device}")
    if tuple(valid.shape) != (t, b) or valid.device != dev:
        raise ValueError(f"valid: expected {(t, b)} on {dev}, got "
                         f"{tuple(valid.shape)} on {valid.device}")
    plan = cluster_plan("bwd", hidden, b, compute, d)
    if plan.route == "simt":
        # [D, 4H, H]: the product's reduction then runs over rows (see the
        # kernel's source note)
        w_t = w_hh.to(compute).transpose(1, 2).contiguous()
    else:
        w_t = fragment_weights(w_hh, "bwd", plan)
    v = valid.to(torch.float32).contiguous()
    a, cp, dho = acts.contiguous(), cprev.contiguous(), dh_out.contiguous()
    dgates = torch.empty((d, t, b, h4), dtype=torch.float32, device=dev)
    mask = sum(1 << i for i, r in enumerate(reverse) if r)
    ptrs = (w_t.data_ptr(), v.data_ptr(), a.data_ptr(), cp.data_ptr(),
            dho.data_ptr(), dgates.data_ptr())
    if plan.route == "grid":
        entry = "lstm_scan_bwd_grid"
        xch, ctr = _grid_scratch("bwd", plan, d, hidden, dev)
        code = _native.lib().lstm_scan_bwd_grid(
            *ptrs, xch.data_ptr(), ctr.data_ptr(), d, t, b, hidden, mask,
            *_grid_ints(plan), _native.stream_ptr(dev))
    else:
        entry = "lstm_scan_bwd"
        code = _native.lib().lstm_scan_bwd(
            *ptrs, d, t, b, hidden, mask, int(compute == torch.bfloat16),
            plan.cluster, plan.rows, _native.stream_ptr(dev))
    _native.check(entry, code)
    _native.count("lstm_scan_bwd")
    _native.count("lstm_scan_bwd_" + plan.route)
    return dgates


class _LSTMScan(torch.autograd.Function):
    """The scan with K2 forward (residuals kept) and K3 backward."""

    @staticmethod
    def forward(ctx, gates_x, w_hh, valid, compute, reverse, backend):
        h_out, hprev, cprev, acts = lstm_scan(
            gates_x, w_hh, valid, compute, reverse, residuals=True,
            backend=backend)
        ctx.save_for_backward(w_hh, valid, hprev, cprev, acts)
        ctx.args = (compute, reverse, backend)
        return h_out

    @staticmethod
    def backward(ctx, dh_out):
        w_hh, valid, hprev, cprev, acts = ctx.saved_tensors
        compute, reverse, backend = ctx.args
        dgates = lstm_scan_bwd(w_hh, valid, acts, cprev, dh_out.float(),
                               compute, reverse, backend)
        # weight gradient: one float32 product per direction outside the
        # kernel (pallas_lstm.py's einsum at preferred_element_type=f32)
        dw = torch.einsum("dtbh,dtbg->dhg", hprev, dgates)
        return dgates, dw.to(w_hh.dtype), None, None, None, None


def lstm_kernel(
    params: dict,
    x: torch.Tensor,
    lengths: torch.Tensor | None = None,
    reverse: bool = False,
    compute: torch.dtype = torch.float32,
    backend: str | None = None,
    h0: torch.Tensor | None = None,
    c0: torch.Tensor | None = None,
    return_state: bool = False,
):
    """Drop-in for ``recurrent.lstm`` on the scan kernel: [B, T, I] ->
    [B, T, H]; from the carries ``h0``, ``c0`` [B, H] when given, and with
    ``return_state`` -> (ys, (h, c)), the carries after each row's last
    valid step (no autograd)."""
    b, t, _ = x.shape
    gx = R.project(params, x, compute).transpose(0, 1)[None]
    valid = R.valid_mask(lengths, b, t, x.device)
    ys = lstm_scan(gx, params["w_hh"][None], valid, compute, (reverse,),
                   backend=backend,
                   h0=None if h0 is None else h0[None],
                   c0=None if c0 is None else c0[None],
                   return_state=return_state)
    if return_state:
        ys, (h, c) = ys
        return ys[0].transpose(0, 1), (h[0], c[0])
    return ys[0].transpose(0, 1)


def bilstm_kernel(
    params: dict,
    x: torch.Tensor,
    lengths: torch.Tensor | None = None,
    compute: torch.dtype = torch.float32,
    backend: str | None = None,
) -> torch.Tensor:
    """Drop-in for ``recurrent.bilstm``: both directions' input
    projections as one product, both recurrences in one launch ->
    [B, T, 2H] = concat(fwd, bwd)."""
    b, t, _ = x.shape
    fwd, bwd = params["fwd"], params["bwd"]
    hidden = fwd["w_hh"].shape[0]
    w_ih = torch.cat([fwd["w_ih"], bwd["w_ih"]], dim=1)          # [I, 8H]
    bias = torch.cat([fwd["b"], bwd["b"]])
    gx = R.mm(x, w_ih, compute) + bias.float()                   # [B, T, 8H]
    gx = gx.view(b, t, 2, 4 * hidden).permute(2, 1, 0, 3)        # [2, T, B, 4H]
    w_hh = torch.stack([fwd["w_hh"], bwd["w_hh"]])
    valid = R.valid_mask(lengths, b, t, x.device)
    ys = lstm_scan(gx, w_hh, valid, compute, (False, True), backend=backend)
    return ys.permute(2, 1, 0, 3).reshape(b, t, 2 * hidden)
