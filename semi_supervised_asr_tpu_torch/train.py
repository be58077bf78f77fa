"""Training CLI of the PyTorch port, supervised and semi-supervised.

    python -m semi_supervised_asr_tpu_torch.train --config configs/timit.yaml \\
        --workdir DIR --steps N [--device cpu] [--seed S] [section.key=value ...]

The per-step part of the JAX package's ``main.py --train`` (``Solver.train``)
for the LAS family: global CMVN over the training set (cached in
``DIR/cmvn.npz``, as the Solver does), seeded bucketed batches (int16 PCM
when ``data.audio_i16_transfer`` is set), and ``N`` steps
(``training/train_step.py``), each logged as one JSON line of
``DIR/metrics.jsonl`` with the JAX metric keys.  When
``objective.lambda_pseudo`` / ``lambda_text_ae`` > 0 (``configs/
ls100_semi.yaml``) each step also takes one batch of unlabeled audio,
padded to the largest frame and token buckets, and one of unlabeled text,
padded to the largest token bucket, both at ``train.batch_size`` (the
Solver's streams, seeded ``seed + 1`` and ``seed + 2``).  At the end it
writes ``DIR/params.npz``, so that ``semi_supervised_asr_tpu_torch.
transcribe --load-dir DIR`` decodes with what it trained.  Weights start from
``weights.init_numpy(seed)``.

``--device`` defaults to ``cuda`` and the CLI refuses to start without it;
``--device cpu`` runs every kernel's plain version.  ``data.dataset=synthetic``
trains on the seeded synthetic corpus, with nothing on disk.  Evaluation,
checkpoints, resume and decoding with the EMA weights (``decode.use_ema``;
the step updates the buffer, ``params.npz`` holds the live weights) wait
for the Solver slice.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# logged where the step runs the text autoencoder / the pseudo-label term
SEMI_KEYS = ("text_ae", "pseudo", "pseudo_gate")


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
        bs = cfg.train.batch_size
        self.batches = pipeline.repeating_batches(
            bundle.train, self.spec, cfg.frontend, bs, seed,
            drop_remainder=False)
        self.unlab_audio = self.unlab_text = None
        obj = cfg.objective
        if obj.lambda_pseudo > 0.0 and bundle.unlabeled_audio is not None:
            big = make_bucket_spec(dataclasses.replace(
                cfg.data, frame_buckets=(self.spec.frame_buckets[-1],),
                token_buckets=(self.spec.token_buckets[-1],)),
                cfg.frontend, cfg.model.time_reduction)
            self.unlab_audio = pipeline.repeating_batches(
                bundle.unlabeled_audio, big, cfg.frontend, bs, seed + 1,
                drop_remainder=False)
        if obj.lambda_text_ae > 0.0 and bundle.unlabeled_text is not None:
            self.unlab_text = pipeline.text_batches(
                bundle.unlabeled_text, self.spec.token_buckets[-1], bs,
                seed + 2)

    def unlabeled(self) -> dict:
        """The next batch of each unlabeled stream, as the step's keyword
        arguments on the device (empty for a supervised run)."""
        out = {}
        if self.unlab_audio is not None:
            audio, lens, _, real = batch_tensors(next(self.unlab_audio),
                                                 self.device)
            out.update(unlab_audio=audio, unlab_audio_lens=lens,
                       unlab_real=real)
        if self.unlab_text is not None:
            tokens, real = next(self.unlab_text)
            out.update(unlab_text=torch.as_tensor(tokens).to(self.device),
                       unlab_text_real=torch.as_tensor(real).to(self.device))
        return out

    def step(self, batch: pipeline.Batch) -> dict:
        """One step on ``batch`` and the next unlabeled batches -> metrics
        as Python numbers."""
        audio, lens, tokens, real = batch_tensors(batch, self.device)
        m = TS.supervised_step(self.cfg, self.state, audio, lens, tokens,
                               real, self.cmvn, **self.unlabeled())
        return {k: float(m[k]) for k in METRIC_KEYS + SEMI_KEYS if k in m}

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
                semi = "".join(f" {k} {m[k]:.4f}" for k in SEMI_KEYS
                               if k in m)
                log(f"step {rec['step']} loss {m['loss']:.4f} ce "
                    f"{m['ce']:.4f} acc {m['acc']:.3f}{semi} grad_norm "
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
