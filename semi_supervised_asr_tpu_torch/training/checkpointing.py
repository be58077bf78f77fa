"""Checkpoint / resume on ``torch.save``, with the JAX package's contract.

Counterpart of ``semi_supervised_asr_tpu/training/checkpointing.py`` (orbax
there).  A checkpoint is a directory ``<dir>/<step>/`` holding ``state.pt``
(:meth:`TrainState.state_dict`: parameters, EMA buffer, Adam's moments and
count, step, generator state) and ``meta.json`` (the data-iterator position
and the metrics it was saved with).  Resume continues the exact stream: the
Solver fast-forwards the labeled epoch plan past the recorded batch and
each unlabeled stream by the restored step count, so a resumed run is
bitwise equal to an uninterrupted one.

The guarantees, as the reference gives them:

* a save writes ``<step>.ckpt-tmp.<pid>/``, fsyncs its files and the
  directory, renames it to ``<step>/`` with ``os.replace``, fsyncs the
  parent, then proves the step is the latest durable one
  (:meth:`Checkpointer.verify_durable`, :class:`CheckpointNotDurable`);
* retention keeps the newest two checkpoints and the best ``max_to_keep``
  by ``best_metric`` (checkpoints saved without metrics are kept), so a
  worsening metric never deletes the resume anchor;
* a tmp directory left by a save that died is quarantined under
  ``_quarantine/`` only by :meth:`Checkpointer.quarantine_stale_tmp`, which
  the Solver calls while it holds the workdir lock.

Saves are synchronous: the Solver refuses ``train.async_ckpt``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from semi_supervised_asr_tpu_torch.training.train_step import TrainState

_log = logging.getLogger("semi_supervised_asr_tpu_torch.ckpt")

TMP_MARK = ".ckpt-tmp"
STATE_FILE = "state.pt"
META_FILE = "meta.json"


class CheckpointNotDurable(RuntimeError):
    """A save that was requested never became the latest durable
    checkpoint.  Raised instead of continuing as if it had: a restart that
    trusts such a save re-runs the same steps forever."""


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_synced(path: Path, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _quarantine_stale_tmp(directory: Path) -> list[str]:
    """Move the tmp directories of saves that died mid-flight under
    ``_quarantine/`` (kept for post-mortem).  Only safe while the caller
    holds the workdir lock: then no other trainer's save is in flight, so
    every tmp entry is garbage."""
    moved = []
    if not directory.exists():
        return moved
    for entry in directory.iterdir():
        if TMP_MARK in entry.name:
            qdir = directory / "_quarantine"
            qdir.mkdir(exist_ok=True)
            dest = qdir / f"{entry.name}.{int(time.time() * 1e3)}"
            try:
                entry.rename(dest)
            except OSError:
                continue
            moved.append(entry.name)
            _log.error("quarantined stale checkpoint tmp dir %s -> %s "
                       "(a previous save died mid-flight)", entry.name, dest)
    return moved


class Checkpointer:
    def __init__(
        self,
        directory: str | Path,
        max_to_keep: int = 3,
        best_metric: str | None = None,
    ):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        # stale-tmp recovery is explicit (quarantine_stale_tmp): a read-only
        # Solver (--test, transcribe) against a live workdir must not rename
        # the live trainer's in-flight save
        self.quarantined: list[str] = []
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric     # lower is better

    def quarantine_stale_tmp(self) -> list[str]:
        """Quarantine dead-save debris.  Call only while holding the
        workdir lock.  Idempotent; accumulates into ``self.quarantined``."""
        moved = _quarantine_stale_tmp(self.dir)
        self.quarantined.extend(moved)
        return moved

    # ---------------------------------------------------------------- #
    # saving
    # ---------------------------------------------------------------- #

    def save(
        self,
        step: int,
        state: TrainState,
        data_pos: dict | None = None,
        metrics: dict | None = None,
    ) -> None:
        step = int(step)
        tmp = self.dir / f"{step}{TMP_MARK}.{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        sd = state.state_dict()
        meta = {"step": step,
                "data_pos": dict(data_pos or {"epoch": 0, "batch": 0}),
                "metrics": {k: float(v) for k, v in (metrics or {}).items()}}
        _write_synced(tmp / STATE_FILE, lambda f: torch.save(sd, f))
        _write_synced(tmp / META_FILE,
                      lambda f: f.write(json.dumps(meta).encode()))
        _fsync_dir(tmp)
        final = self.dir / str(step)
        old = None
        if final.exists():             # the same step saved again
            old = self.dir / f"{step}.ckpt-old.{os.getpid()}"
            os.replace(final, old)
        os.replace(tmp, final)
        _fsync_dir(self.dir)
        if old is not None:
            shutil.rmtree(old)
        self._apply_retention()
        self.verify_durable(step)

    def _apply_retention(self) -> None:
        """Keep the newest two ∪ the best ``max_to_keep`` by the metric
        (checkpoints without it are kept); delete the rest."""
        if not self.best_metric:
            keep = set(self.all_steps()[-max(self.max_to_keep, 1):])
        else:
            steps = self.all_steps()
            keep = set(steps[-2:])
            ranked = []
            for s in steps:
                m = self.metrics(s)
                if self.best_metric in m:
                    ranked.append(s)
                else:
                    keep.add(s)
            best = self._rank(ranked)
            keep.update(best[max(len(best) - self.max_to_keep, 0):])
        for s in self.all_steps():
            if s not in keep:
                shutil.rmtree(self.dir / str(s), ignore_errors=True)

    def _rank(self, steps: list[int]) -> list[int]:
        """``steps`` (ascending) from worst (highest) to best (lowest)
        metric; among equals the later step ranks better (the reference's
        stable sort)."""
        return sorted(steps, key=lambda s: self.metrics(s)[self.best_metric],
                      reverse=True)

    def verify_durable(self, step: int) -> None:
        """Prove ``step`` is the latest durable checkpoint -- raise
        :class:`CheckpointNotDurable` otherwise.  Called before anything
        that treats the save as done (an exec-restart, the end of
        training)."""
        latest = self.latest_step()
        if latest != step:
            stale = [e.name for e in self.dir.iterdir() if TMP_MARK in e.name]
            raise CheckpointNotDurable(
                f"checkpoint save of step {step} did not finalize: "
                f"latest durable step is {latest}, retained steps "
                f"{self.all_steps()}"
                + (f", stale tmp dirs {stale}" if stale else "")
                + " — refusing to continue as if the save succeeded "
                "(is another trainer racing on this workdir?)"
            )

    # ---------------------------------------------------------------- #
    # reading
    # ---------------------------------------------------------------- #

    def all_steps(self) -> list[int]:
        """Durable steps, ascending (a step directory with both files)."""
        if not self.dir.exists():
            return []
        return sorted(int(e.name) for e in self.dir.iterdir()
                      if e.name.isdigit() and (e / STATE_FILE).exists()
                      and (e / META_FILE).exists())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> dict:
        return self.meta(step)["metrics"]

    def meta(self, step: int) -> dict:
        return json.loads((self.dir / str(step) / META_FILE).read_text())

    def best_step(self) -> int | None:
        if not self.best_metric:
            return self.latest_step()
        ranked = self._rank([s for s in self.all_steps()
                             if self.best_metric in self.metrics(s)])
        return ranked[-1] if ranked else None

    def load(self, step: int | None = None) -> tuple[dict, dict, int]:
        """-> (state dict, meta, step) of ``step`` (default: the latest),
        on the CPU."""
        if step is None:
            step = self.latest_step()
        assert step is not None, f"no checkpoint found in {self.dir}"
        sd = torch.load(self.dir / str(step) / STATE_FILE,
                        map_location="cpu", weights_only=True)
        return sd, self.meta(step), int(step)

    def restore(
        self, state: TrainState, step: int | None = None
    ) -> tuple[TrainState, dict, int]:
        """Load ``step`` (default: the latest) into ``state``'s own tensors
        -> (state, data_pos, step)."""
        sd, meta, step = self.load(step)
        state.load_state_dict(sd)
        return state, dict(meta["data_pos"]), step

    def average_params(
        self, state_template: TrainState, last_k: int
    ) -> tuple[dict[str, np.ndarray], list[int]]:
        """Elementwise float64 mean of the parameters of the last
        ``last_k`` retained checkpoints, cast back to each parameter's
        dtype -> (flat name -> array, steps used)."""
        steps = self.all_steps()[-max(int(last_k), 1):]
        assert steps, f"no checkpoints found in {self.dir}"
        acc: dict[str, np.ndarray] = {}
        for s in steps:
            sd, _, _ = self.load(s)
            for n, t in sd["model"].items():
                x = t.double().numpy()
                acc[n] = x if n not in acc else acc[n] + x
        inv = 1.0 / len(steps)
        dtypes = {n: p.detach().cpu().numpy().dtype
                  for n, p in state_template.model.named_parameters()}
        return {n: np.asarray(a * inv, dtypes[n])
                for n, a in acc.items()}, steps
