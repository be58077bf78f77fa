"""External LM training on unlabeled text, and the LM's weight file.

    python -m semi_supervised_asr_tpu_torch.training.lm_trainer \\
        --config configs/ls100_semi.yaml --workdir runs/lm \\
        [--device cpu] [section.key=value ...]

Counterpart of ``semi_supervised_asr_tpu/training/lm_trainer.py``: trains
the fusion LM of ``lm.arch`` (``models/lm.py``) on the config's
unlabeled-text stream (else the labeled transcripts) at the largest token
bucket, ``lm.batch_size`` rows a step (rows that are not real zeroed), with
Adam at a constant ``lm.learning_rate`` and no clipping, as ``optax.adam``
does; logs ``lm_loss`` / ``lm_ppl`` every ``lm.log_every`` steps to the
workdir's ``metrics.jsonl`` (prefix ``lm``); saves the weights; prints
``{"lm_loss", "lm_ppl"}``.  The LSTM LM's step runs its scan on K2 and K3
(float32 route) on the card.  ``--device`` defaults to ``cuda`` and the CLI
refuses to start without it; ``--device cpu`` runs the plain versions.

The weights go to ``<workdir>/lm_params/params.npz`` under the JAX tree's
path names (``weights.save_npz``).  ``decode.lm_ckpt=<workdir>`` with
``decode.lm_weight > 0`` fuses it shallowly at decode time
(:func:`decode_lm`); ``model.lm_fusion_ckpt=<workdir>`` grafts it into the
speller for deep or cold fusion (``load_lm`` with ``dims``).  An LM saved
by the JAX trainer (an orbax directory) is refused with an error that
names the converter it needs.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch
from torch import nn

from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.config import (
    Config, TrainConfig, load_config,
)
from semi_supervised_asr_tpu_torch.data import pipeline as pipe
from semi_supervised_asr_tpu_torch.data import registry
from semi_supervised_asr_tpu_torch.models import lm as LM
from semi_supervised_asr_tpu_torch.training import schedules
from semi_supervised_asr_tpu_torch.utils.logging import MetricsLogger

LM_FILE = "params.npz"


class LMNotFound(FileNotFoundError):
    """A workdir that holds no LM this package can read."""


def lm_ckpt_dir(workdir: str | Path) -> Path:
    return Path(workdir).absolute() / "lm_params"


def init_lm_params(cfg: Config, vocab_size: int, seed: int = 0,
                   device="cpu") -> nn.Module:
    """The LM of ``lm.arch`` with weights drawn from ``seed``
    (``weights.init_module``: the JAX init's distributions)."""
    lm = LM.build_lm(cfg.lm, vocab_size)
    weights.load_flat(lm, weights.init_module(lm, seed))
    return lm.to(device)


def save_lm(workdir: str | Path, lm: nn.Module) -> Path:
    """Write the LM's weights (written to a temporary name, then renamed)
    -> the file."""
    d = lm_ckpt_dir(workdir)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"params.{os.getpid()}.tmp.npz"
    weights.save_npz(lm, tmp)
    os.replace(tmp, d / LM_FILE)
    return d / LM_FILE


def load_lm(workdir: str | Path, cfg: Config, vocab_size: int,
            dims: tuple[int, int, int] | None = None,
            device="cpu") -> nn.Module:
    """Restore a trained LM.  ``dims`` = (embed, hidden, layers) reads it
    as an LSTM LM of those widths instead of ``cfg.lm``'s architecture
    (deep and cold fusion take ``model.lm_fusion_*``; the grafted LM is an
    LSTM, its state riding the speller's)."""
    d = lm_ckpt_dir(workdir)
    if not (d / LM_FILE).exists():
        if d.is_dir():
            raise LMNotFound(
                f"{d} holds no {LM_FILE}: an LM saved by the JAX trainer "
                "(orbax) needs the orbax -> params.npz converter, which is "
                "not written yet; train one with python -m "
                "semi_supervised_asr_tpu_torch.training.lm_trainer")
        raise LMNotFound(
            f"no trained LM at {d} (python -m semi_supervised_asr_tpu_torch"
            f".training.lm_trainer --workdir {workdir} writes one)")
    if dims is not None:
        lm = LM.LSTMLM(vocab_size, *dims)
    else:
        lm = LM.build_lm(cfg.lm, vocab_size)
    weights.load_npz(lm, d / LM_FILE)
    return lm.to(device)


def decode_lm(cfg: Config, vocab_size: int, device, log) -> nn.Module | None:
    """The LM that shallow fusion decodes with, or None: loaded from
    ``decode.lm_ckpt`` when ``decode.lm_weight`` > 0; with an empty
    ``lm_ckpt`` a warning and no fusion, as the reference's Solver does.
    ``log`` takes the warning and the line naming the LM."""
    dcfg = cfg.decode
    if dcfg.lm_weight <= 0.0:
        return None
    if not dcfg.lm_ckpt:
        log("WARNING: decode.lm_weight > 0 but decode.lm_ckpt is empty — "
            "shallow fusion DISABLED (train an LM with "
            "training/lm_trainer.py and set decode.lm_ckpt)")
        return None
    try:
        lm = load_lm(dcfg.lm_ckpt, cfg, vocab_size, device=device)
    except LMNotFound as e:
        raise LMNotFound(f"shallow LM fusion: decode.lm_ckpt="
                         f"{dcfg.lm_ckpt}: {e}") from None
    cache = LM.max_len(lm)
    if cache is not None and dcfg.max_decode_len > cache:
        raise ValueError(
            f"decode.max_decode_len {dcfg.max_decode_len} exceeds the "
            f"transformer LM's lm.max_len {cache}")
    log(f"shallow fusion: {cfg.lm.arch} LM from {dcfg.lm_ckpt} weight "
        f"{dcfg.lm_weight}")
    return lm


def adam(cfg: Config, lm: nn.Module) -> schedules.Adam:
    """``optax.adam(lm.learning_rate)`` over the LM's parameters."""
    return schedules.Adam(list(lm.parameters()), TrainConfig(
        optimizer="adam", learning_rate=cfg.lm.learning_rate,
        lr_schedule="constant", warmup_steps=0, beta1=0.9, beta2=0.999))


def train_step(lm: nn.Module, opt: schedules.Adam, tokens: torch.Tensor,
            backend: str | None = None) -> torch.Tensor:
    """One update on a text batch [B, U] -> the loss before it."""
    loss = LM.lm_loss(lm, tokens, backend)
    opt.step(list(torch.autograd.grad(loss, opt.params)))
    return loss.detach()


def train_lm(cfg: Config, workdir: str | Path, device="cuda",
             backend: str | None = None) -> dict:
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    device = torch.device(device)
    log = MetricsLogger(workdir)
    bundle = registry.build_datasets(cfg)
    text_ds = bundle.unlabeled_text or bundle.train

    lm = init_lm_params(cfg, bundle.vocab.size, cfg.train.seed, device)
    opt = adam(cfg, lm)
    token_bucket = max(cfg.data.token_buckets)
    if cfg.lm.arch == "transformer" and token_bucket > cfg.lm.max_len:
        raise ValueError(f"lm.max_len {cfg.lm.max_len} must cover the "
                         f"largest token bucket {token_bucket}")
    stream = pipe.text_batches(text_ds, token_bucket, cfg.lm.batch_size,
                               cfg.train.seed)
    loss = None
    try:
        for i in range(1, cfg.lm.total_steps + 1):
            tokens, real = next(stream)
            tokens = np.where(real[:, None], tokens, 0)
            loss = train_step(lm, opt,
                              torch.as_tensor(tokens, device=device),
                              backend)
            if i % cfg.lm.log_every == 0:
                val = float(loss)
                log.log(i, {"lm_loss": val, "lm_ppl": float(np.exp(val))},
                        "lm")
                log.info(f"lm step {i} loss {val:.4f} ppl "
                         f"{np.exp(val):.1f}")
        save_lm(workdir, lm)
    finally:
        log.close()
    final = float(loss) if loss is not None else float("nan")
    return {"lm_loss": final, "lm_ppl": float(np.exp(final))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="semi_supervised_asr_tpu_torch.training.lm_trainer")
    p.add_argument("--config", required=True)
    p.add_argument("--workdir", default="runs/lm")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("overrides", nargs="*", default=[])
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu to run "
                             "the plain PyTorch versions")
        from semi_supervised_asr_tpu_torch import strict_fp32

        strict_fp32()
    cfg = load_config(args.config, args.overrides)
    print(json.dumps(train_lm(cfg, args.workdir, device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
