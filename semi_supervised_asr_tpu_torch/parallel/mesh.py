"""The process group of a data-parallel run, and each rank's rows.

Counterpart of ``semi_supervised_asr_tpu/parallel/mesh.py`` for data
parallelism only: one process per device, each holding a full replica of
the parameters.  ``maybe_initialize_distributed`` reads torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) and forms the default process group: NCCL for a CUDA
device, gloo for the CPU, or the backend the caller names (gloo on the
card lets several ranks share one device).  Without that environment the
run is one process, as before.  ``host_data_rows`` gives a rank's block of
every global batch, as the reference's does for a host's devices.  The
tensor-parallel ``model`` axis (``parallel.model_parallel > 1``) is not
ported and is refused by name.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from semi_supervised_asr_tpu_torch.config import ParallelConfig

# torchrun's variables; a run without RANK and WORLD_SIZE is one process
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def check_parallel_supported(pcfg: ParallelConfig) -> None:
    if max(int(pcfg.model_parallel), 1) != 1:
        raise NotImplementedError(
            f"parallel.model_parallel={pcfg.model_parallel!r} is not ported "
            "yet (the PyTorch port runs data parallelism only, with "
            "parallel.model_parallel=1)")


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """The rank that writes the checkpoints, metrics.jsonl and cmvn.npz."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def maybe_initialize_distributed(device: str | torch.device = "cuda",
                                 backend: str | None = None) -> torch.device:
    """Form the default process group from torchrun's environment, when it
    is set, and return this rank's device: ``cuda:LOCAL_RANK`` (modulo the
    visible cards, so that gloo ranks may share one), or the CPU.

    With ``WORLD_SIZE`` > 1 a group that cannot be formed raises: a rank
    never trains alone.  Without the environment nothing is initialized and
    ``device`` is returned as given."""
    device = torch.device(device)
    env = {k: os.environ.get(k) for k in _ENV}
    if env["RANK"] is None or env["WORLD_SIZE"] is None:
        return device
    n, r = int(env["WORLD_SIZE"]), int(env["RANK"])
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if not env[k]]
    if missing:
        raise RuntimeError(
            f"WORLD_SIZE={n} RANK={r} but {', '.join(missing)} unset: no "
            "process group can be formed (launch with torchrun)")
    local = int(env["LOCAL_RANK"] or r)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {r}: CUDA is not available")
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=r, world_size=n)
    if dist.get_world_size() != n or dist.get_rank() != r:
        raise RuntimeError(
            f"process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, the environment says {r} of {n}")
    return device


def require_group() -> None:
    """Raise when torchrun's environment says ``WORLD_SIZE`` > 1 but no
    process group was formed: a rank never trains alone."""
    n = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if n > 1 and world_size() != n:
        raise RuntimeError(
            f"WORLD_SIZE={n} but this process is in no process group of "
            f"that size: call maybe_initialize_distributed first (main.py "
            "does)")


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def host_data_rows(rank: int, world: int) -> tuple[int, int, int]:
    """(row_start, row_end, n_rows) of ``rank`` on the data axis: one row
    of ``world`` per rank.  The pipeline slices each global batch of B
    rows into this rank's ``B // world`` (``pipeline._slice_rows``)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    return rank, rank + 1, world
