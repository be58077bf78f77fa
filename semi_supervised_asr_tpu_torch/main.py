"""CLI of the PyTorch port, with the JAX package's ``main.py`` surface:

    python -m semi_supervised_asr_tpu_torch.main --config configs/timit.yaml \\
        --train --workdir DIR [--resume] [section.key=value ...]
    python -m semi_supervised_asr_tpu_torch.main --config configs/timit.yaml \\
        --test --load-dir DIR [--beam 1|5] [--hyp-out F] [section.key=value]

``--train`` runs ``Solver.train`` (validation every ``train.eval_every``
steps, checkpoints, ``--resume`` from the latest one) and prints
``{"final_dev": ...}``; at a ``train.exec_restart_every`` boundary the
process replaces itself with a fresh one that resumes.  ``--test`` scores
the best (else latest) checkpoint of ``--load-dir`` and prints the error
rate, the decode mode and the length-cap hit rate; ``--beam 1`` decodes
greedy, any other beam size sets ``decode.beam_size``; ``--hyp-out``
writes the hypotheses and their error analysis.  ``--device`` defaults to
``cuda`` and the CLI refuses to start without it; ``--device cpu`` runs
every kernel's plain version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="semi_supervised_asr_tpu_torch.main")
    p.add_argument("--config", required=True, help="hyperparameter YAML")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--train", action="store_true")
    mode.add_argument("--test", action="store_true")
    p.add_argument("--workdir", default="runs/default",
                   help="checkpoints/logs directory")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in workdir")
    p.add_argument("--load-dir", default=None,
                   help="(test) workdir holding the checkpoint to score")
    p.add_argument("--beam", type=int, default=None,
                   help="(test) beam size override; 1 = greedy")
    p.add_argument("--hyp-out", default=None,
                   help="(test) write hypotheses jsonl here")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("overrides", nargs="*", default=[],
                   help="section.key=value config overrides")
    return p


def main(argv=None) -> int:
    # the effective argv: what an exec-restart rebuilds the command from
    eff_argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.beam == 0:
        raise SystemExit("--beam 0 (CTC greedy) is not ported yet")

    import torch

    from semi_supervised_asr_tpu_torch import strict_fp32
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu to run "
                             "the plain PyTorch versions")
        strict_fp32()
    cfg = load_config(args.config, args.overrides)
    if args.beam is not None and args.beam > 1:
        cfg = cfg.replace(decode=dataclasses.replace(cfg.decode,
                                                     beam_size=args.beam))
    workdir = args.workdir if args.train else (args.load_dir or args.workdir)
    try:
        solver = Solver(cfg, workdir, device)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None

    if args.train:
        result = solver.train(resume=args.resume)
        if getattr(solver, "restart_requested", False):
            # replace this process image with a fresh one that resumes
            # from the checkpoint just written
            sys.stdout.flush()
            sys.stderr.flush()
            cmd = [sys.executable, "-m", "semi_supervised_asr_tpu_torch.main",
                   *eff_argv]
            if "--resume" not in cmd:
                cmd.insert(cmd.index("--train") + 1 if "--train" in cmd
                           else len(cmd), "--resume")
            os.execv(sys.executable, cmd)
        print(json.dumps({"final_dev": result}))
        return 0

    mode = "greedy" if args.beam == 1 else "beam"
    print(json.dumps(solver.test(mode=mode, out_path=args.hyp_out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
