"""Data parallelism by explicit collectives.

Counterpart of ``semi_supervised_asr_tpu/parallel/dp.py``.  Each rank runs
the step on its rows of the global batch -- of each global microbatch
under ``train.grad_accum``, in ceil-sized blocks as GSPMD shards a batch
axis (:func:`ceil_block`: a rank's share may be short, or empty, when the
microbatch does not divide by the world size) -- with every loss term
normalized
by the global batch's count (``training/train_step.py`` sums those counts
first with :func:`all_reduce_counts`), so that the SUM of the ranks'
gradients is the gradient of the concatenated batch; :func:`all_reduce_grads`
takes that sum.  Every rank then clips and steps the same reduced
gradient, so the replicas stay bitwise equal.

The port's collectives are ``all_reduce`` here and ``barrier`` in
``parallel/mesh.py``: gloo on CUDA tensors offers little more, and the same
code runs on gloo on the CPU, gloo on the card and NCCL.  The model is not wrapped in
DistributedDataParallel: the step takes its gradients with
``torch.autograd.grad``, which never fires DDP's reducer hooks, and DDP
would rename every parameter ``module.*`` in the checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

# the largest flat buffer one all_reduce takes (float32 elements): bounds
# the copy a reduction holds beside the gradients
BUCKET_ELEMS = 1 << 25

# what the reductions of this process moved: calls and bytes of the flat
# buffers (the traffic between ranks is what the backend makes of them)
STATS = {"calls": 0, "bytes": 0}


@dataclass(frozen=True)
class DataParallel:
    """This rank's place in the data-parallel group."""

    rank: int
    world: int


def ceil_block(rank: int, world: int, m: int) -> tuple[int, int]:
    """Rank ``rank``'s rows [r0, r1) of an axis of ``m`` rows split over
    ``world`` ranks in blocks of ceil(m / world) (the last blocks short or
    empty)."""
    c = -(-m // world)
    return min(rank * c, m), min((rank + 1) * c, m)


def microbatch_blocks(dp: DataParallel, accum: int,
                      local: list[int | None], global_rows: list[int]
                      ) -> list[tuple[int, int, int] | None]:
    """Per stream of a step (``local``: this rank's rows of each batch,
    None where the step has no such stream; ``global_rows``: the global
    batches' sizes): (r0, r1, m), the rank's rows [r0, r1) of each of the
    batch's ``accum`` global microbatches of m rows."""
    out = []
    for n, g in zip(local, global_rows):
        if n is None:
            out.append(None)
            continue
        if g % accum:
            raise ValueError(f"global batch of {g} rows does not split into "
                             f"train.grad_accum={accum} microbatches")
        m = g // accum
        r0, r1 = ceil_block(dp.rank, dp.world, m)
        if (r1 - r0) * accum != n:
            raise ValueError(
                f"rank {dp.rank} holds {n} rows of a global batch of {g}; "
                f"its ceil-sized blocks of {accum} microbatches hold "
                f"{(r1 - r0) * accum} (data/pipeline.py::rank_rows)")
        out.append((r0, r1, m))
    return out


def current() -> DataParallel | None:
    """The group of this process, when one is initialized (a world of one
    included: its reductions still run, as a torchrun of one rank does)."""
    if not dist.is_initialized():
        return None
    return DataParallel(dist.get_rank(), dist.get_world_size())


def _buckets(tensors: list[torch.Tensor]) -> list[list[int]]:
    """Indices of ``tensors`` grouped into runs of at most BUCKET_ELEMS
    elements (a larger tensor gets a run of its own)."""
    out, cur, n = [], [], 0
    for i, t in enumerate(tensors):
        if cur and n + t.numel() > BUCKET_ELEMS:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += t.numel()
    if cur:
        out.append(cur)
    return out


def all_reduce_grads(grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """The SUM over the group of each float32 tensor of ``grads`` (any
    shapes, one device): the tensors are flattened into contiguous buffers
    of at most BUCKET_ELEMS elements, one ``all_reduce`` runs per buffer,
    and the result comes back in the input's shapes (new tensors)."""
    out: list[torch.Tensor] = [None] * len(grads)
    for idx in _buckets(grads):
        for i in idx:
            if grads[i].dtype != torch.float32:
                raise TypeError(f"all_reduce_grads takes float32 tensors, "
                                f"got {grads[i].dtype}")
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        STATS["calls"] += 1
        STATS["bytes"] += flat.numel() * flat.element_size()
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def all_reduce_counts(t: torch.Tensor) -> torch.Tensor:
    """The SUM over the group of a small tensor of counts (the step's
    normalizers, the evaluation's error counters) -> a new tensor."""
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    return t


def all_gather_rows(t: torch.Tensor, m: int) -> torch.Tensor:
    """The global (micro)batch of ``m`` rows of which ``t`` holds this
    rank's :func:`ceil_block` (every rank's block concatenated in rank
    order) -> a new tensor (babble noise mixes rows of other ranks).  Each
    rank sends its block cut or padded to ceil(m / world) rows, so a rank
    with an empty block sends whatever stand-in rows it holds, and they
    are dropped."""
    world = dist.get_world_size()
    c = -(-m // world)
    send = t[:c]
    if send.shape[0] < c:
        send = torch.cat([send, send.new_zeros((c - send.shape[0],
                                                *t.shape[1:]))])
    parts = [torch.empty_like(send) for _ in range(world)]
    dist.all_gather(parts, send.contiguous())
    STATS["calls"] += 1
    STATS["bytes"] += send.numel() * send.element_size()
    return torch.cat([p[:r1 - r0] for p, (r0, r1) in zip(
        parts, (ceil_block(q, world, m) for q in range(world)))])
