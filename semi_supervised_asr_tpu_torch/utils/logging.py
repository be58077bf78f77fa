"""Metrics logging: machine-readable jsonl, optional tensorboard, stderr.

The PyTorch port's copy of ``semi_supervised_asr_tpu/utils/logging.py``.
Every record is one JSON line of ``<workdir>/metrics.jsonl`` with ``step``,
``time`` and ``prefix`` (``train``, ``dev``, ``wall``, ``data``) beside its
scalars.  Tensorboard is best-effort: ``tensorboardX`` when it imports, else
nothing (``_tb`` is None), which the logger says once.  A logger built with
``write=False`` (a data-parallel rank other than 0) writes no file and
still prints.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, workdir: str | Path, use_tensorboard: bool = True,
                 write: bool = True):
        self.dir = Path(workdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = (open(self.dir / "metrics.jsonl", "a", buffering=1)
                   if write else None)
        self._tb = None
        if use_tensorboard and write:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(str(self.dir / "tb"))
            except Exception as e:
                self.info(f"tensorboard off ({type(e).__name__}: {e}); "
                          "metrics.jsonl holds every record")

    def log(self, step: int, scalars: dict, prefix: str = "train") -> None:
        rec = {"step": int(step), "time": time.time(), "prefix": prefix}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                try:
                    self._tb.add_scalar(f"{prefix}/{k}", float(v), step)
                except (TypeError, ValueError):
                    pass

    def log_image(self, step: int, name: str, img) -> None:
        """[H, W] float array in [0,1] -> tensorboard heatmap image."""
        if self._tb is None:
            return
        import numpy as np

        arr = np.asarray(img, dtype=np.float32)[None, :, :]  # CHW, C=1
        self._tb.add_image(name, arr, step)

    def info(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def warning(self, msg: str) -> None:
        """Loud: stderr and the stdlib logger (so pytest caplog and any
        configured handlers see it)."""
        print(f"WARNING: {msg}", file=sys.stderr, flush=True)
        logging.getLogger("semi_supervised_asr_tpu_torch").warning(msg)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
