"""Training CLI of the PyTorch port: the short form of ``main --train``.

    python -m semi_supervised_asr_tpu_torch.train --config configs/timit.yaml \\
        --workdir DIR --steps N [--device cpu] [--seed S] [section.key=value ...]

``N`` steps of the Solver's training loop (``training/solver.py``) with
evaluation off: ``--steps N`` sets ``train.total_steps=N``,
``train.eval_every=0``, ``train.ckpt_every=N`` and ``train.log_every=1``,
so the run ends with one checkpoint of step ``N`` in ``DIR/checkpoints/``
and no decode of the dev set; ``--seed`` sets ``train.seed`` (weights,
batch order and augmentation draws).  ``DIR`` gets ``metrics.jsonl`` (a
``train`` record every step with the JAX metric keys, ``wall`` and
``data`` records), ``cmvn.npz``, the checkpoint and ``params.npz`` (the live
weights), so that ``semi_supervised_asr_tpu_torch.transcribe --load-dir
DIR`` decodes with what it trained.  When ``objective.lambda_pseudo`` /
``lambda_text_ae`` > 0 (``configs/ls100_semi.yaml``) each step also takes
one batch of each unlabeled stream.

``--device`` defaults to ``cuda`` and the CLI refuses to start without it;
``--device cpu`` runs every kernel's plain version.  ``data.dataset=
synthetic`` trains on the seeded synthetic corpus, with nothing on disk.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

from semi_supervised_asr_tpu_torch import strict_fp32, weights
from semi_supervised_asr_tpu_torch.config import Config, load_config
from semi_supervised_asr_tpu_torch.training.lm_trainer import LMNotFound
from semi_supervised_asr_tpu_torch.training.pretrain import EncoderNotFound
from semi_supervised_asr_tpu_torch.training.solver import Solver

METRIC_KEYS = ("loss", "ce", "acc", "grad_norm", "tf_rate", "frames", "lr")
# logged where the step runs the text autoencoder / the pseudo-label term
SEMI_KEYS = ("text_ae", "pseudo", "pseudo_gate")


def short_form(cfg: Config, steps: int, seed: int | None = None) -> Config:
    """``cfg`` for ``steps`` steps with evaluation off, a train record
    every step and one checkpoint at the end (and ``train.seed`` = ``seed``
    when given)."""
    return cfg.replace(train=dataclasses.replace(
        cfg.train, total_steps=steps, eval_every=0, ckpt_every=steps,
        log_every=1, seed=cfg.train.seed if seed is None else seed))


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

    cfg = short_form(load_config(args.config, args.overrides), args.steps,
                     args.seed)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu to run "
                             "the plain PyTorch versions")
        strict_fp32()
    try:
        solver = Solver(cfg, args.workdir, device)
    except (NotImplementedError, LMNotFound, EncoderNotFound) as e:
        raise SystemExit(str(e)) from None
    solver.train()
    weights.save_npz(solver.state.model, Path(args.workdir) / "params.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
