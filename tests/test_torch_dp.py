"""PyTorch port: data parallelism over two gloo ranks on the CPU.

Two ranks of this file run each case (``python tests/test_torch_dp.py CASE
OUT``, torchrun's environment set by hand, one torch thread each) at a few
layers and narrow widths: the step cases all on one pair of ranks, spawned
once for the module (their start-up paid once), the Solver run on its own.
Rank 0 also runs one process's step on the concatenated global batch, with
no process group in the way.

* The supervised step at global B=4 (rows of unequal token counts, the
  last a filler row; SpecAugment and scheduled sampling on, so the draws
  made at the global shape matter): the two ranks' summed loss within
  1e-6 relative of one process's, every all-reduced gradient leaf within
  the step test's tolerance (``tests/test_torch_train.py``, rtol 2e-4 /
  atol 2e-5), the two ranks' gradients bitwise equal, and each rank's
  generator left where one process's is.
* The same for the semi-supervised step (text autoencoder, the EMA
  teacher's pseudo-labels, gate open, a filler row in each unlabeled
  batch), and for the transducer's (``configs/ls100_transducer_semi.yaml``:
  the lattice NLL over the global real rows, the internal-LM term over the
  global text labels, the pseudo-label term over the global kept labels).
* The supervised step at global B=8 with encoder and decoder dropout,
  white and babble noise and ``train.grad_accum=2`` (each rank holding its
  rows of each microbatch; babble mixing rows of both ranks): as above,
  and both generators left where one process's are.
* The same at global B=6 and B=2 with ``train.grad_accum=2`` (the
  reference's lcm granule, not a multiple of world x accumulation): each
  rank holds a ceil-sized block of every microbatch, 2 rows and 1 of a
  microbatch of 3, or 1 and none of a microbatch of 1 (the empty rank runs
  an unreal stand-in row, makes the draws and joins the reductions);
  the Solver's granule is held against the reference's in
  tests/test_torch_solver.py.
* A 2-rank Solver run of 4 steps (``train.async_ckpt``, validation and a
  checkpoint every 2; constant-frames batches of 6 rows with
  ``train.grad_accum=2``, so each microbatch of 3 splits 2 + 1 and the
  step takes the global sizes the Solver passes, as training does):
  replicas bitwise equal, checkpoints written by rank
  0 alone, the sharded validation's records summing to the dev set, and a
  resume from step 2 in a fresh workdir bitwise equal to the straight run
  at step 4 (after tests/test_multihost.py).
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TOL_GRAD = dict(rtol=2e-4, atol=2e-5)
# configs/timit.yaml cut to a small width: SpecAugment on, teacher forcing
# 0.6 (scheduled sampling draws every step), float32
STEP = ["model.enc_hidden=16", "model.enc_layers=1", "model.dec_hidden=16",
        "model.attn_dim=8", "model.attn_conv_channels=2",
        "model.attn_conv_width=4", "model.embed_dim=8",
        "model.compute_dtype=float32", "train.batch_size=4",
        "objective.tf_rate_start=0.6", "objective.tf_rate_end=0.6",
        "data.dataset=synthetic", "data.num_synthetic_utts=8",
        "data.frame_buckets=[128]", "data.token_buckets=[12]",
        "decode.max_decode_len=8"]
SEMI = ["objective.pseudo_warmup_steps=0", "objective.pseudo_confidence=0"]
# configs/ls100_transducer_semi.yaml at the same small width
TRANSDUCER = ["model.pred_hidden=16", "model.joint_dim=16",
              "decode.max_symbols=2"]
# dropout in the listener and the speller, white and babble noise on every
# row, two microbatches: a global batch of 8, each rank holding 2 rows of
# each microbatch of 4
AUGMENT = ["model.enc_dropout=0.2", "model.dec_dropout=0.2",
           "frontend.noise_aug_prob=1.0",
           "frontend.noise_sources=[white,babble]", "train.grad_accum=2",
           "train.batch_size=8"]
# the global batches of the uneven cases (train.grad_accum=2, 2 ranks)
UNEVEN = {"uneven": 6, "empty": 2}
# the step cases, run in turn by one pair of ranks
STEP_CASES = ("supervised", "semi", "transducer_semi", "augment", *UNEVEN)
# configs/synthetic_smoke.yaml at a small width, 48 utterances in its
# 144-frame bucket, constant-frames batches of 900 // 144 = 6 rows (the
# lcm(2, 2) granule) in 2 microbatches of 3: rank 0 holds 2 rows of each,
# rank 1 one, the sizes the step takes from the Solver; a dev set of 12
# in 3 batches of train.batch_size: rank 0 decodes two of them, rank 1 one
SOLVER = ["data.num_synthetic_utts=48", "train.batch_size=4",
          "data.batch_frames=900", "train.grad_accum=2",
          "model.enc_hidden=8", "model.enc_layers=1",
          "model.enc_base_layers=1", "model.attn_dim=8",
          "model.dec_hidden=16", "model.embed_dim=8",
          "model.attn_conv_channels=2", "model.attn_conv_width=5",
          "decode.max_decode_len=6", "train.total_steps=4",
          "train.eval_every=2", "train.ckpt_every=2", "train.log_every=1",
          "train.async_ckpt=true", "frontend.spec_augment=true"]


# --------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------- #

def _step_case(case: str) -> dict:
    import torch

    from semi_supervised_asr_tpu_torch import weights
    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.data import pipeline
    from semi_supervised_asr_tpu_torch.data.bucketing import make_bucket_spec
    from semi_supervised_asr_tpu_torch.data.registry import build_datasets
    from semi_supervised_asr_tpu_torch.data.vocab import PAD
    from semi_supervised_asr_tpu_torch.models.seq2seq import build_model
    from semi_supervised_asr_tpu_torch.parallel import dp as DP
    from semi_supervised_asr_tpu_torch.training import train_step as TS
    from semi_supervised_asr_tpu_torch.transcribe import finalize_config

    semi = case in ("semi", "transducer_semi")
    config = {"semi": "configs/ls100_semi.yaml",
              "transducer_semi": "configs/ls100_transducer_semi.yaml"}.get(
        case, "configs/timit.yaml")
    extra = {"semi": SEMI, "augment": AUGMENT,
             "transducer_semi": SEMI + TRANSDUCER}.get(case, [])
    if case in UNEVEN:
        extra = AUGMENT + [f"train.batch_size={UNEVEN[case]}"]
    cfg = load_config(REPO / config, STEP + extra)
    bundle = build_datasets(cfg)
    cfg = finalize_config(cfg, bundle.vocab.size)
    spec = make_bucket_spec(cfg.data, cfg.frontend, cfg.model.time_reduction)
    # rows of unequal lengths, the last a filler row
    rows = {"augment": [0, 1, 2, 3, 4, 5, 6, 0], "uneven": [0, 1, 2, 3, 4, 0],
            "empty": [4, 0]}.get(case, [0, 1, 2, 0])
    lab = pipeline.assemble_batch(bundle.train, rows, len(rows) - 1,
                                  (128, 12), spec, cfg.frontend)
    n = len(rows)
    cmvn = tuple(torch.as_tensor(a) for a in
                 pipeline.compute_global_cmvn(bundle.train, cfg.frontend))
    unlab = {}
    if semi:
        ua = pipeline.assemble_batch(bundle.unlabeled_audio, [3, 1, 2, 3],
                                     3, (128, 12), spec, cfg.frontend)
        ut = next(pipeline.text_batches(bundle.unlabeled_text, 12, 4, 2))
        unlab = dict(unlab_audio=ua.audio, unlab_audio_lens=ua.audio_lens,
                     unlab_real=ua.real, unlab_text=ut[0],
                     unlab_text_real=ut[1])
    flat = weights.init_numpy(cfg.model, seed=0)

    def run(pos, dp):
        model = build_model(cfg.model)
        weights.load_flat(model, flat)
        state = TS.init_train_state(cfg, model, seed=3)
        if semi:    # a teacher that is not the student
            for e in state.ema.parameters():
                e.mul_(0.9)
        args = [torch.as_tensor(getattr(lab, f)[pos])
                for f in ("audio", "audio_lens", "tokens", "real")]
        kw = {k: torch.as_tensor(v[pos]) for k, v in unlab.items()}
        if dp is not None:     # the global batches' sizes, as the Solver
            kw["global_rows"] = (n, 4, 4)
        loss, aux, grads = TS.loss_and_grads(cfg, state, *args, cmvn,
                                             dp=dp, **kw)
        return {"loss": loss, "aux": {k: float(v) for k, v in aux.items()},
                "grads": grads, "gen": state.gen.get_state(),
                "dgen": state.dgen.get_state(),
                "tokens": int((TS.mask_unreal(args[2], args[3]) != PAD)
                              .sum())}

    dp = DP.current()
    # the rank's rows of each microbatch (the Solver's streams give these)
    mine = pipeline.rank_rows(n, (dp.rank, dp.rank + 1, dp.world),
                              max(cfg.train.grad_accum, 1))
    res = {"dp": run(mine, dp)}
    if dp.rank == 0:
        res["one"] = run(slice(0, n), None)
    return res


def _solver_case(out: Path) -> None:
    import torch

    from semi_supervised_asr_tpu_torch.config import load_config
    from semi_supervised_asr_tpu_torch.parallel import mesh as MESH
    from semi_supervised_asr_tpu_torch.training.solver import Solver

    cfg = load_config(REPO / "configs/synthetic_smoke.yaml", SOLVER)
    run, res = out / "run", out / "resumed"
    s = Solver(cfg, run, "cpu")
    rows = next(s._labeled_stream())[2].audio.shape[0]
    final = s.train()
    test = s.test(mode="greedy", out_path=out / "hyps.jsonl")
    _, records, _, _ = s._score_batches(s.bundle.dev, s.state.model,
                                        "greedy")
    sd = s.state.state_dict()
    if MESH.is_primary():
        (res / "checkpoints").mkdir(parents=True)
        shutil.copytree(run / "checkpoints" / "2", res / "checkpoints" / "2")
        shutil.copy(run / "cmvn.npz", res / "cmvn.npz")
    MESH.barrier()
    s2 = Solver(cfg, res, "cpu")
    s2.train(resume=True)
    torch.save({"state": sd, "resumed": s2.state.state_dict(),
                "final": final, "test": test, "n_records": len(records),
                "history": s.history, "dev_size": len(s.bundle.dev),
                "rows": rows},
               out / f"rank{MESH.rank()}.pt")


def _worker(case: str, out: str) -> None:
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from semi_supervised_asr_tpu_torch.parallel import mesh as MESH

    MESH.maybe_initialize_distributed("cpu")
    try:
        if case == "solver":
            _solver_case(Path(out))
        else:
            import torch

            # the step cases share one pair of ranks
            res = ({c: _step_case(c) for c in STEP_CASES}
                   if case == "steps" else _step_case(case))
            torch.save(res, Path(out) / f"rank{MESH.rank()}.pt")
    finally:
        MESH.destroy()


# --------------------------------------------------------------------- #
# the tests
# --------------------------------------------------------------------- #

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(case: str, out: Path, world: int = 2) -> list[dict]:
    """Run ``case`` on ``world`` gloo ranks -> each rank's saved results."""
    import torch

    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, case, str(out)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{case}: a rank hung")
        errs.append(err)
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Every step case on one pair of ranks -> {case: [rank 0's results,
    rank 1's]}."""
    r0, r1 = spawn("steps", tmp_path_factory.mktemp("steps"))
    return {c: [r0[c], r1[c]] for c in STEP_CASES}


def _check_step(results) -> None:
    import numpy as np
    import torch

    r0, r1 = results
    one, a, b = r0["one"], r0["dp"], r1["dp"]
    # the ranks hold unequal token counts, so a mean of per-rank means
    # would not be the global batch's mean
    assert a["tokens"] != b["tokens"]
    assert a["tokens"] + b["tokens"] == one["tokens"]
    np.testing.assert_allclose(a["loss"].item(), one["loss"].item(),
                               rtol=1e-6)
    for k in a["aux"]:
        np.testing.assert_allclose(a["aux"][k], one["aux"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for g, w in zip(a["grads"], one["grads"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL_GRAD)
    # every rank holds the same reduced gradient and metrics, bit for bit
    assert torch.equal(a["loss"], b["loss"]) and a["aux"] == b["aux"]
    assert all(torch.equal(x, y) for x, y in zip(a["grads"], b["grads"]))
    # the draws were made at the global shape on every rank
    for k in ("gen", "dgen"):
        assert torch.equal(a[k], one[k]) and torch.equal(b[k], one[k]), k


def test_two_ranks_supervised_step_match_one_process(steps):
    res = steps["supervised"]
    assert res[0]["dp"]["aux"]["tf_rate"] == 0.6
    _check_step(res)


def test_two_ranks_semi_step_match_one_process(steps):
    res = steps["semi"]
    aux = res[0]["dp"]["aux"]
    assert aux["pseudo_gate"] == 1.0 and aux["pseudo"] > 0
    assert aux["text_ae"] > 0
    _check_step(res)


def test_two_ranks_transducer_semi_step_match_one_process(steps):
    """The transducer's semi step: each term over its global count (real
    rows, text labels, kept pseudo labels + 1), summed before the
    forward."""
    res = steps["transducer_semi"]
    aux = res[0]["dp"]["aux"]
    assert aux["pseudo_gate"] == 1.0 and aux["pseudo"] > 0
    assert aux["text_ilm"] > 0 and aux["nll_per_label"] > 0
    _check_step(res)


def test_two_ranks_dropout_noise_accum_match_one_process(steps):
    """Encoder and decoder dropout, white and babble noise and
    ``train.grad_accum=2``: each rank draws the masks and the noise at the
    global microbatch's shape and keeps its rows, babble mixes rows
    gathered from both ranks, and each microbatch's counts are summed over
    the ranks."""
    res = steps["augment"]
    _check_step(res)


def test_two_ranks_uneven_microbatches_match_one_process(steps):
    """``train.grad_accum=2`` over 2 ranks at global batches the world does
    not divide per microbatch: ceil-sized blocks (2 + 1 rows of a
    microbatch of 3, or 1 + an empty block of a microbatch of 1), the
    draws made at the microbatch's shape."""
    from semi_supervised_asr_tpu_torch.data.pipeline import rank_rows

    assert [rank_rows(6, (r, r + 1, 2), 2).tolist() for r in (0, 1)] \
        == [[0, 1, 3, 4], [2, 5]]
    assert [rank_rows(2, (r, r + 1, 2), 2).tolist() for r in (0, 1)] \
        == [[0, 1], []]
    for case in UNEVEN:
        _check_step(steps[case])


def test_two_rank_solver_run_and_resume(tmp_path):
    import torch

    r0, r1 = spawn("solver", tmp_path)
    first = _first_difference(r0["state"], r1["state"])
    assert first is None, f"replicas differ at {first}"
    assert r0["state"]["step"] == 4
    # the ranks' shares of a batch of 6 in microbatches of 3: 2 + 2, 1 + 1
    assert [r0["rows"], r1["rows"]] == [4, 2]
    # rank 0 alone wrote the checkpoints and the metrics
    ckpts = sorted(p.name for p in (tmp_path / "run" / "checkpoints")
                   .iterdir())
    assert ckpts == ["2", "4"], ckpts
    assert (tmp_path / "run" / ".lock.p1").exists()
    recs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl")
            .read_text().splitlines()]
    assert [r["step"] for r in recs if r["prefix"] == "train"] == [1, 2, 3, 4]
    timing = ("frames_per_sec", "steps_per_sec")
    assert ([{k: v for k, v in h.items() if k not in timing}
             for h in r0["history"]]
            == [{k: v for k, v in h.items() if k not in timing}
                for h in r1["history"]])
    # the sharded evaluation: every rank has the global rates, each
    # decoded part of the dev set, nothing was lost
    assert r0["final"] == r1["final"] and r0["test"] == r1["test"]
    dev = r0["dev_size"]
    assert r0["n_records"] + r1["n_records"] == dev == r0["test"]["n_utts"]
    assert 0 < r0["n_records"] < dev
    parts = [tmp_path / f"hyps.jsonl.part{r}" for r in (0, 1)]
    assert sum(len(p.read_text().splitlines()) for p in parts) == dev
    # step 2's checkpoint resumed in a fresh workdir gives step 4 bitwise
    for r in (r0, r1):
        first = _first_difference(r["state"], r["resumed"])
        assert first is None, f"resume differs at {first}"
    assert isinstance(r0["state"]["gen"], torch.Tensor)


def _first_difference(a, b, path=""):
    import torch

    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            d = _first_difference(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            d = _first_difference(x, y, f"{path}.{i}")
            if d:
                return d
        return None
    if isinstance(a, torch.Tensor):
        same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
        return None if same else path
    return None if a == b else path


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
