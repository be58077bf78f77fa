"""BEST-RQ encoder pretraining (``objectives/best_rq.py``).

    python -m semi_supervised_asr_tpu_torch.training.pretrain \\
        --config configs/ls100_semi.yaml --workdir runs/bestrq \\
        [--device cpu] [section.key=value ...]

Counterpart of ``semi_supervised_asr_tpu/training/pretrain.py``: trains the
configured listener (any ``model.encoder_arch``) on the config's
unlabeled-audio stream (else the labeled audio; transcripts are never
read).  A step: ``train_step.featurize`` of the clean view (K1 on the
card), the frozen quantizer's targets, the span masking, the listener
(K2 / K3, or K5 for the attention listeners), the head, the masked CE and
its gradients, then the ``train.*`` optimizer chain
(``schedules.update``: ``train.freeze``, the clip, adam / adamw / sgd).
Metrics go to ``metrics.jsonl`` with the ``bestrq_`` prefix (prefix
``pretrain``) every ``pretrain.log_every`` steps and at step 1.  The global
CMVN of the pretraining corpus is cached as ``cmvn.npz``.

Exact resume: every ``pretrain.ckpt_every`` steps and at the end the
parameters, the optimizer state and the step go to
``train_ckpt/state.pt`` (written to a temporary name, then renamed); a
re-run of the same command resumes there, the stream fast-forwarded by
the steps taken, and each step's draws come from a generator seeded by
(``train.seed``, step) alone, so a resumed run is bitwise equal to a
straight one.

Artifacts in the workdir:
* ``encoder_params/params.npz``: the listener under the JAX tree's path
  names (``weights.save_npz``); ``train.init_encoder_from=<workdir>``
  starts any family's training from it (:func:`load_pretrained_encoder`);
* ``bestrq_params/params.npz``: the listener and the head;
* ``meta.json``: the reference's keys (dims, quantizer knobs, leaf count).

Under ``torchrun`` each rank takes its rows of every global batch
(``pipeline.rank_rows``), the draws are made at the global batch's shape,
the CE divides by the global count of masked positions, and the gradients
and metrics are summed by ``parallel/dp.py``'s flat all-reduce; rank 0
writes the workdir.  ``--device`` defaults to ``cuda`` and the CLI refuses
to start without it; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.config import Config, load_config
from semi_supervised_asr_tpu_torch.data import pipeline as pipe
from semi_supervised_asr_tpu_torch.data import registry
from semi_supervised_asr_tpu_torch.data.bucketing import make_bucket_spec
from semi_supervised_asr_tpu_torch.objectives import best_rq as BRQ
from semi_supervised_asr_tpu_torch.parallel import dp as DP
from semi_supervised_asr_tpu_torch.parallel import mesh as MESH
from semi_supervised_asr_tpu_torch.training import schedules
from semi_supervised_asr_tpu_torch.training import train_step as TS
from semi_supervised_asr_tpu_torch.training.solver import DeviceCopier
from semi_supervised_asr_tpu_torch.transcribe import finalize_config
from semi_supervised_asr_tpu_torch.utils.logging import MetricsLogger

PARAMS_FILE = "params.npz"
STATE_FILE = "state.pt"
# the metrics a step logs (as bestrq_<key>), the reference's
METRIC_KEYS = ("loss", "mask_acc", "codes_used", "masked_positions",
               "mask_frac")


class EncoderNotFound(FileNotFoundError):
    """A workdir that holds no pretrained encoder this package can read."""


def encoder_ckpt_dir(workdir: str | Path) -> Path:
    return Path(workdir).absolute() / "encoder_params"


def load_pretrained_encoder(workdir: str | Path, listener) -> None:
    """Copy the pretrained listener of ``workdir`` into ``listener`` (the
    fresh model's: its encoder dims and arch must be the pretraining
    config's).  A leaf count other than ``meta.json``'s, a missing or
    extra leaf, or a leaf of another shape raises naming it; so do a
    missing file and a JAX (orbax) ``encoder_params/`` directory."""
    d = encoder_ckpt_dir(workdir)
    if not (d / PARAMS_FILE).exists():
        if d.is_dir():
            raise EncoderNotFound(
                f"{d} holds no {PARAMS_FILE}: an encoder saved by the JAX "
                "pretrainer (orbax) needs the orbax -> params.npz converter, "
                "which is not written yet; pretrain one with python -m "
                "semi_supervised_asr_tpu_torch.training.pretrain")
        raise EncoderNotFound(
            f"train.init_encoder_from: no pretrained encoder at {d} (python "
            "-m semi_supervised_asr_tpu_torch.training.pretrain --workdir "
            f"{workdir} writes one)")
    meta_path = Path(workdir) / "meta.json"
    if meta_path.exists():
        got = json.loads(meta_path.read_text()).get("n_listener_leaves")
        n = len(list(listener.parameters()))
        if got not in (None, n):
            raise ValueError(
                f"pretrained encoder at {workdir} has n_listener_leaves="
                f"{got} param leaves, the model's listener has {n} — "
                "encoder dims/arch differ")
    weights.load_npz(listener, d / PARAMS_FILE)


def init_model(cfg: Config, seed: int, device="cpu") -> BRQ.BestRQModel:
    """The listener and head with weights drawn from ``seed``
    (``weights.init_module``: the JAX init's distributions)."""
    model = BRQ.BestRQModel(cfg.model, cfg.pretrain)
    weights.load_flat(model, weights.init_module(model, seed))
    return model.to(device)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s draws, a function of (seed, step)
    alone (the reference's ``fold_in(PRNGKey(seed + 99), step)``)."""
    return torch.Generator(device).manual_seed((seed + 99) * 2**32 + step)


def quantizer(cfg: Config, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The frozen (projection, codebook) on ``device``."""
    proj, cb = BRQ.make_quantizer(cfg.frontend.n_mels,
                                  cfg.model.time_reduction, cfg.pretrain)
    return (torch.as_tensor(proj, device=device),
            torch.as_tensor(cb, device=device))


def loss_and_grads(
    cfg: Config,
    model: BRQ.BestRQModel,
    audio: torch.Tensor,          # [B, S] float32 or int16
    audio_lens: torch.Tensor,     # [B] samples
    real: torch.Tensor,           # [B] bool
    cmvn: tuple[torch.Tensor, torch.Tensor],
    quant: tuple[torch.Tensor, torch.Tensor],
    gen: torch.Generator,
    backend: str | None = None,
    draws: BRQ.MaskDraws | None = None,
    dp: DP.DataParallel | None = None,
    global_rows: int | None = None,
    labels: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """One batch's BEST-RQ loss, metrics (the reference's keys but
    ``loss``) and the gradient of every parameter of ``model`` (in
    ``model.parameters()`` order).  ``draws`` fixes the masking and
    dropout draws, else they come from ``gen``; ``labels`` the targets
    (``bestrq_loss``'s).  Under ``dp`` the batch is
    this rank's ceil-sized block of a global batch of ``global_rows``, and
    the returned loss, metrics and gradients are the global batch's."""
    rows = None
    if dp is not None:
        rows, = DP.microbatch_blocks(dp, 1, [audio.shape[0]], [global_rows])
    with torch.no_grad():
        feats, flens = TS.featurize(cfg, audio, audio_lens, cmvn,
                                    augment=False, backend=backend)
    if draws is None:
        draws = BRQ.draw_masking(gen, model.listener, cfg.model,
                                 cfg.pretrain, tuple(feats.shape), flens,
                                 rows)
    loss, metrics = BRQ.bestrq_loss(
        model, cfg.pretrain, feats, flens, real, *quant, draws, backend,
        cfg.train.remat_encoder, dp, labels)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    loss = loss.detach()
    if dp is not None:
        # the rank's parts of the loss, the accuracy and the code hits
        # ride in the gradients' reduction
        hits = metrics["code_hits"]
        vec = torch.cat([torch.stack([loss, metrics["mask_acc"].float()]),
                         hits])
        *grads, vec = DP.all_reduce_grads([*grads, vec])
        loss, metrics["mask_acc"] = vec[0], vec[1]
        metrics["code_hits"] = vec[2:]
        metrics["codes_used"] = BRQ.codes_used(vec[2:])
    metrics.pop("code_hits")
    return loss, metrics, grads


def train_bestrq(cfg: Config, workdir: str | Path, device="cuda",
                 backend: str | None = None) -> dict:
    """Pretrain for ``pretrain.total_steps`` (resuming from the workdir's
    ``train_ckpt`` when it holds one) -> the last logged metrics, with
    ``first_loss`` and ``wall_s``."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    device = torch.device(device)
    TS.check_train_supported(cfg)
    MESH.require_group()
    dp = DP.current()
    rank, world = MESH.rank(), MESH.world_size()
    primary = rank == 0
    if cfg.train.batch_size % world:
        raise ValueError(
            f"global train.batch_size {cfg.train.batch_size} must divide by "
            f"the data-parallel world size {world}")
    log = MetricsLogger(workdir, write=primary)
    bundle = registry.build_datasets(cfg)
    audio_ds = bundle.unlabeled_audio or bundle.train
    cfg = finalize_config(cfg, bundle.vocab.size)
    pcfg = cfg.pretrain

    # the global CMVN of the pretraining corpus, cached (tmp + rename)
    stats_path = workdir / "cmvn.npz"
    if primary and not stats_path.exists():
        mean, inv_std = pipe.compute_global_cmvn(audio_ds, cfg.frontend)
        tmp = stats_path.with_suffix(f".{os.getpid()}.tmp.npz")
        np.savez(tmp, mean=mean, inv_std=inv_std)
        os.replace(tmp, stats_path)
    MESH.barrier()
    with np.load(stats_path) as z:
        cmvn = tuple(torch.as_tensor(z[k], device=device)
                     for k in ("mean", "inv_std"))

    model = init_model(cfg, cfg.train.seed, device)
    opt = schedules.make_optimizer(list(model.named_parameters()),
                                   cfg.train)
    quant = quantizer(cfg, device)

    ckpt_dir = workdir.absolute() / "train_ckpt"
    done = 0
    if (ckpt_dir / STATE_FILE).exists():
        sd = torch.load(ckpt_dir / STATE_FILE, weights_only=False)
        TS.load_module_state(model, sd["model"])
        opt.load_state_dict(sd["opt"])
        done = int(sd["step"])
        log.info(f"bestrq resumed from step {done}")

    def save_resume(step_done: int) -> None:
        if primary:
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            tmp = ckpt_dir / f"state.{os.getpid()}.tmp.pt"
            torch.save({"model": TS.module_state(model),
                        "opt": opt.state_dict(), "step": step_done}, tmp)
            os.replace(tmp, ckpt_dir / STATE_FILE)
        MESH.barrier()

    spec = make_bucket_spec(cfg.data, cfg.frontend, cfg.model.time_reduction)
    stream = pipe.repeating_batches(
        audio_ds, spec, cfg.frontend, cfg.train.batch_size, cfg.train.seed,
        drop_remainder=False, skip_batches=done,
        row_shard=MESH.host_data_rows(rank, world) if world > 1 else None)
    put = DeviceCopier(device)
    first_loss, metrics = None, {}
    t0 = time.perf_counter()
    try:
        for i in range(done + 1, pcfg.total_steps + 1):
            b = next(stream)
            audio, lens, real = put(b.audio, b.audio_lens, b.real)
            loss, metrics, grads = loss_and_grads(
                cfg, model, audio, lens, real, cmvn, quant,
                step_generator(cfg.train.seed, i, device), backend, dp=dp,
                global_rows=cfg.train.batch_size)
            schedules.update(opt, grads, cfg.train)
            metrics["loss"] = loss
            if i % pcfg.log_every == 0 or i == 1:
                m = {k: float(metrics[k]) for k in METRIC_KEYS}
                if first_loss is None:
                    first_loss = m["loss"]
                log.log(i, {f"bestrq_{k}": v for k, v in m.items()},
                        "pretrain")
                log.info(f"bestrq step {i} loss {m['loss']:.4f} mask_acc "
                         f"{m['mask_acc']:.3f} codes_used "
                         f"{m['codes_used']:.3f}")
            if pcfg.ckpt_every > 0 and i % pcfg.ckpt_every == 0:
                save_resume(i)
        save_resume(pcfg.total_steps)
        if primary:
            enc_dir = encoder_ckpt_dir(workdir)
            full_dir = workdir.absolute() / "bestrq_params"
            for d, module in ((enc_dir, model.listener), (full_dir, model)):
                d.mkdir(parents=True, exist_ok=True)
                tmp = d / f"params.{os.getpid()}.tmp.npz"
                weights.save_npz(module, tmp)
                os.replace(tmp, d / PARAMS_FILE)
            (workdir / "meta.json").write_text(json.dumps({
                "encoder_arch": cfg.model.encoder_arch,
                "enc_hidden": cfg.model.enc_hidden,
                "time_reduction": cfg.model.time_reduction,
                "n_listener_leaves": len(list(model.listener.parameters())),
                "codebook_size": pcfg.codebook_size,
                "codebook_dim": pcfg.codebook_dim,
                "quantizer_seed": pcfg.quantizer_seed,
                "steps": pcfg.total_steps,
            }))
    finally:
        log.close()
    out = {k: float(metrics[k]) for k in METRIC_KEYS if k in metrics}
    out["first_loss"] = first_loss if first_loss is not None else float("nan")
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="semi_supervised_asr_tpu_torch.training.pretrain")
    p.add_argument("--config", required=True)
    p.add_argument("--workdir", default="runs/bestrq")
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
    device = MESH.maybe_initialize_distributed(device)
    try:
        cfg = load_config(args.config, args.overrides)
        try:
            result = train_bestrq(cfg, args.workdir, device)
        except NotImplementedError as e:
            raise SystemExit(str(e)) from None
        if MESH.is_primary():
            print(json.dumps(result))
    finally:
        MESH.destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
