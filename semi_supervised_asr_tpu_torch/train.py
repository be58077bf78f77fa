"""Supervised training CLI of the PyTorch port.

    python -m semi_supervised_asr_tpu_torch.train --config configs/timit.yaml \\
        --workdir DIR --steps N [--device cpu] [--seed S] [section.key=value ...]

The per-step part of the JAX package's ``main.py --train`` (``Solver.train``)
for the LAS family: global CMVN over the training set (cached in
``DIR/cmvn.npz``, as the Solver does), seeded bucketed batches (int16 PCM
when ``data.audio_i16_transfer`` is set), and ``N`` supervised steps
(``training/train_step.py``), each logged as one JSON line of
``DIR/metrics.jsonl`` with the JAX metric keys.  At the end it writes
``DIR/params.npz``, so that ``semi_supervised_asr_tpu_torch.transcribe
--load-dir DIR`` decodes with what it trained.  Weights start from
``weights.init_numpy(seed)``.

``--device`` defaults to ``cuda`` and the CLI refuses to start without it;
``--device cpu`` runs every kernel's plain version.  ``data.dataset=synthetic``
trains on the seeded synthetic corpus, with nothing on disk.  Evaluation,
checkpoints and resume wait for the Solver slice.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from semi_supervised_asr_tpu_torch import strict_fp32, weights
from semi_supervised_asr_tpu_torch.config import Config, load_config
from semi_supervised_asr_tpu_torch.data import pipeline
from semi_supervised_asr_tpu_torch.data.bucketing import make_bucket_spec
from semi_supervised_asr_tpu_torch.data.registry import build_datasets
from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq
from semi_supervised_asr_tpu_torch.training import train_step as TS
from semi_supervised_asr_tpu_torch.transcribe import finalize_config

METRIC_KEYS = ("loss", "ce", "acc", "grad_norm", "tf_rate", "frames", "lr")


def load_cmvn(cfg: Config, dataset, workdir: Path):
    """(mean, inv_std) from ``workdir/cmvn.npz``, computed over the
    training set and written there when missing."""
    path = workdir / "cmvn.npz"
    if path.exists():
        with np.load(path) as z:
            return z["mean"], z["inv_std"]
    mean, inv_std = pipeline.compute_global_cmvn(dataset, cfg.frontend)
    np.savez(path, mean=mean, inv_std=inv_std)
    return mean, inv_std


def batch_tensors(batch: pipeline.Batch, device: torch.device):
    """A host batch -> (audio, audio_lens, tokens, real) on ``device``."""
    return (torch.as_tensor(batch.audio).to(device),
            torch.as_tensor(batch.audio_lens).to(device),
            torch.as_tensor(batch.tokens).to(device),
            torch.as_tensor(batch.real).to(device))


class Trainer:
    """A config, its data, a model and its train state on one device."""

    def __init__(self, cfg: Config, workdir: str | Path, device, seed: int):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.device = torch.device(device)
        bundle = build_datasets(cfg)
        self.cfg = cfg = finalize_config(cfg, bundle.vocab.size)
        model = Seq2Seq(cfg.model)
        weights.load_flat(model, weights.init_numpy(cfg.model, seed))
        self.state = TS.init_train_state(cfg, model.to(self.device), seed)
        mean, inv_std = load_cmvn(cfg, bundle.train, self.workdir)
        self.cmvn = (torch.as_tensor(mean, device=self.device),
                     torch.as_tensor(inv_std, device=self.device))
        self.spec = make_bucket_spec(cfg.data, cfg.frontend,
                                     cfg.model.time_reduction)
        self.batches = pipeline.batches(bundle.train, self.spec,
                                        cfg.train.batch_size, cfg.frontend,
                                        seed)

    def step(self, batch: pipeline.Batch) -> dict:
        """One supervised step -> metrics as Python numbers."""
        audio, lens, tokens, real = batch_tensors(batch, self.device)
        m = TS.supervised_step(self.cfg, self.state, audio, lens, tokens,
                               real, self.cmvn)
        return {k: float(m[k]) for k in METRIC_KEYS}

    def run(self, steps: int, log=print) -> list[dict]:
        out = []
        with open(self.workdir / "metrics.jsonl", "a") as f:
            for _ in range(steps):
                batch = next(self.batches)
                m = self.step(batch)
                rec = {"step": self.state.step, **m,
                       "bucket": list(batch.bucket)}
                f.write(json.dumps(rec) + "\n")
                f.flush()
                log(f"step {rec['step']} loss {m['loss']:.4f} ce "
                    f"{m['ce']:.4f} acc {m['acc']:.3f} grad_norm "
                    f"{m['grad_norm']:.3f} bucket {batch.bucket}")
                out.append(rec)
        weights.save_npz(self.state.model, self.workdir / "params.npz")
        return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="semi_supervised_asr_tpu_torch.train")
    p.add_argument("--config", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--seed", type=int, default=None,
                   help="weights, batch order and augmentation draws "
                        "(default train.seed)")
    p.add_argument("overrides", nargs="*", help="section.key=value")
    args = p.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu to run "
                             "the plain PyTorch versions")
        strict_fp32()
    seed = cfg.train.seed if args.seed is None else args.seed
    try:
        trainer = Trainer(cfg, args.workdir, device, seed)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    trainer.run(args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
