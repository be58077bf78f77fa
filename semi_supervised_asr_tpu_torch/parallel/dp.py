"""Data parallelism by explicit collectives.

Counterpart of ``semi_supervised_asr_tpu/parallel/dp.py``.  Each rank runs
the step on its rows of the global batch, with every loss term normalized
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

    def rows(self, local_batch: int) -> tuple[int, int, int]:
        """(first row, end row, global rows) of this rank's block of a
        global batch whose ranks each hold ``local_batch`` rows."""
        return (self.rank * local_batch, (self.rank + 1) * local_batch,
                self.world * local_batch)


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


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along axis
    0 in rank order -> a new tensor: the global batch of which ``t`` holds
    this rank's rows (babble noise mixes rows of other ranks)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    return torch.cat(parts)
