"""PyTorch port: checkpoints, exact resume and the ``main`` CLI.

The port held against itself, as ``tests/test_exact_resume.py`` and
``tests/test_ckpt_durability.py`` hold the JAX package: a run stopped
mid-epoch and resumed is bitwise equal to the uninterrupted one
(supervised and semi-supervised: parameters, EMA buffer, Adam's moments,
the generator), a stale tmp directory is quarantined under the workdir
lock only, the resume anchor survives a worsening metric, retention stays
bounded, ``verify_durable`` raises on a step that is not the latest, a
second trainer on one workdir exits and the lock is released when
``train`` returns.  ``decode.use_ema`` decodes the EMA buffer,
``decode.average_ckpts`` the float64 mean of the last checkpoints, and
the ``main`` and ``transcribe`` CLIs round-trip a workdir.  Background
saves (``train.async_ckpt``) hold the state as it was when ``save``
returned, a failed one raises at the next save or wait, and a process
killed while one writes leaves a tmp directory that is quarantined.
"""

import json

import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu_torch import main as M
from semi_supervised_asr_tpu_torch import synthetic
from semi_supervised_asr_tpu_torch import transcribe as TR
from semi_supervised_asr_tpu_torch.config import load_config
from semi_supervised_asr_tpu_torch.training.checkpointing import (
    Checkpointer, CheckpointNotDurable,
)
from semi_supervised_asr_tpu_torch.training.solver import Solver

from test_torch_train import one_thread  # noqa: F401  (autouse fixture)

CONFIG = "configs/synthetic_smoke.yaml"
# 16 utterances at batch 4: 4 batches an epoch
SMALL = {"data.num_synthetic_utts": 16, "train.batch_size": 4,
         "train.eval_every": 0, "train.ckpt_every": 0, "train.log_every": 1,
         "model.enc_hidden": 8, "model.enc_layers": 1,
         "model.enc_base_layers": 1, "model.attn_dim": 8,
         "model.dec_hidden": 16, "model.embed_dim": 8,
         "model.attn_conv_channels": 2, "model.attn_conv_width": 5,
         "decode.max_decode_len": 6, "train.total_steps": 2}
SEMI = {"objective.lambda_text_ae": 0.3, "objective.lambda_pseudo": 0.3,
        "objective.use_ema_teacher": "true",
        "objective.pseudo_warmup_steps": 2}


def small_cfg(**extra):
    ov = {**SMALL, **extra}
    return load_config(CONFIG, [f"{k}={v}" for k, v in ov.items()])


def assert_state_bitwise_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    for part in ("model", "ema"):
        for n in sa[part]:
            assert torch.equal(sa[part][n].view(torch.uint8),
                               sb[part][n].view(torch.uint8)), (part, n)
    for x, y in zip(sa["opt"]["mu"] + sa["opt"]["nu"],
                    sb["opt"]["mu"] + sb["opt"]["nu"]):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    assert sa["opt"]["count"] == sb["opt"]["count"]
    assert sa["step"] == sb["step"]
    assert torch.equal(sa["gen"], sb["gen"])
    assert torch.equal(sa["dgen"], sb["dgen"])


# dropout in the listener and the speller, time warp and white noise: draws
# from the device generator too
AUGMENT = {"model.enc_dropout": 0.2, "model.dec_dropout": 0.2,
           "frontend.time_warp_param": 5, "frontend.noise_aug_prob": 0.5}


@pytest.mark.parametrize("semi, augment", [(False, False), (True, False),
                                           (False, True)],
                         ids=["supervised", "semi", "dropout"])
def test_exact_resume_is_bitwise(semi, augment, tmp_path):
    """4 batches an epoch; stop at step 5 (mid epoch 1), resume to 7: the
    state and the train records equal the uninterrupted run's bitwise,
    with SpecAugment and scheduled sampling drawing from the generator,
    and in the third case dropout, time warp and noise drawing from both
    generators."""
    extra = {"train.ckpt_every": 5, "frontend.spec_augment": "true",
             "objective.tf_rate_end": 0.5, "objective.tf_decay_steps": 4,
             **(SEMI if semi else {}), **(AUGMENT if augment else {})}
    full = Solver(small_cfg(**extra, **{"train.total_steps": 7}),
                  tmp_path / "full", "cpu")
    full.train()
    Solver(small_cfg(**extra, **{"train.total_steps": 5}),
           tmp_path / "split", "cpu").train()
    resumed = Solver(small_cfg(**extra, **{"train.total_steps": 7}),
                     tmp_path / "split", "cpu")
    resumed.train(resume=True)
    assert resumed.state.step == 7
    assert resumed.data_pos == full.data_pos == {"epoch": 1, "batch": 2}
    assert_state_bitwise_equal(full.state, resumed.state)
    if semi:
        assert not torch.equal(full.state.ema.speller.b_out,
                               full.state.model.speller.b_out)
    assert [h for h in full.history if h["step"] > 5] == [
        {**h, "frames_per_sec": f["frames_per_sec"],
         "steps_per_sec": f["steps_per_sec"]}
        for h, f in zip(resumed.history, full.history[5:])]


@pytest.fixture
def state(tmp_path):
    return Solver(small_cfg(), tmp_path / "s", "cpu").state


def test_stale_tmp_is_quarantined_and_step_recovers(state, tmp_path):
    d = tmp_path / "ckpts"
    d.mkdir()
    (d / "5.ckpt-tmp.999").mkdir()
    (d / "5.ckpt-tmp.999" / "partial").write_text("junk")
    ck = Checkpointer(d)
    assert ck.quarantined == [] and (d / "5.ckpt-tmp.999").exists()
    assert ck.quarantine_stale_tmp() == ["5.ckpt-tmp.999"]
    assert not (d / "5.ckpt-tmp.999").exists()
    assert [q.name.startswith("5.ckpt-tmp.999")
            for q in (d / "_quarantine").iterdir()] == [True]
    ck.save(5, state)
    ck.verify_durable(5)
    _, data_pos, step = ck.restore(state)
    assert (step, data_pos) == (5, {"epoch": 0, "batch": 0})
    assert Checkpointer(tmp_path / "c").quarantine_stale_tmp() == []


def test_worsening_metric_never_deletes_the_resume_anchor(state, tmp_path):
    ck = Checkpointer(tmp_path / "c", max_to_keep=3, best_metric="dev_error")
    for step, err in ((1, 0.10), (2, 0.09), (3, 0.08)):
        ck.save(step, state, metrics={"dev_error": err})
    for step in (4, 5):
        ck.save(step, state, metrics={"dev_error": 0.84})
        assert ck.latest_step() == step
    assert ck.all_steps() == [1, 2, 3, 4, 5]
    assert ck.best_step() == 3
    ck.save(6, state, metrics={"dev_error": 0.9})
    assert ck.all_steps() == [1, 2, 3, 5, 6]


def test_best_retention_still_bounds_the_set(state, tmp_path):
    ck = Checkpointer(tmp_path / "c", max_to_keep=2, best_metric="dev_error")
    for step in range(1, 9):
        ck.save(step, state, metrics={"dev_error": step / 10.0})
    assert ck.all_steps() == [1, 2, 7, 8]
    assert ck.latest_step() == 8 and ck.best_step() == 1
    # among equal metrics the later step ranks better, as in the reference
    ck = Checkpointer(tmp_path / "t", max_to_keep=1, best_metric="dev_error")
    for step in (1, 2, 3, 4):
        ck.save(step, state, metrics={"dev_error": 1e9})
    assert ck.best_step() == 4 and ck.all_steps() == [3, 4]


def test_verify_durable_raises_on_missing_step(state, tmp_path):
    ck = Checkpointer(tmp_path / "c")
    ck.save(3, state)
    ck.verify_durable(3)
    with pytest.raises(CheckpointNotDurable, match="did not finalize"):
        ck.verify_durable(4)
    (tmp_path / "c" / "4.ckpt-tmp.1").mkdir()
    with pytest.raises(CheckpointNotDurable, match="stale tmp dirs"):
        ck.verify_durable(4)
    for key, value in (("train.debug_nans", "true"),
                       ("parallel.model_parallel", 2)):
        with pytest.raises(NotImplementedError, match=key):
            Solver(small_cfg(**{key: value}), tmp_path / "a", "cpu")


def test_async_save_restores_the_snapshot(state, tmp_path):
    """A background save holds the state as it was when save() returned,
    though the state moves on at once, and restores as a synchronous save
    does; the next save waits for it."""
    import copy

    snap = copy.deepcopy(state.state_dict())
    ck = Checkpointer(tmp_path / "a", async_save=True)
    ck.save(1, state, {"epoch": 0, "batch": 3}, {"dev_error": 0.5})
    with torch.no_grad():                  # the next step moves the state
        for p in state.model.parameters():
            p.add_(1.0)
    state.step += 1
    ck.save(2, state)
    ck.wait()
    assert ck.all_steps() == [1, 2]
    sync = Checkpointer(tmp_path / "s")
    sd1, meta, _ = ck.load(1)
    assert meta["data_pos"] == {"epoch": 0, "batch": 3}
    for part in ("model", "ema"):
        for n, t in snap[part].items():
            assert torch.equal(sd1[part][n], t), (part, n)
    sync.save(2, state)
    sd2, _, _ = ck.load(2)
    sd2s, _, _ = sync.load(2)
    for n in sd2["model"]:
        assert torch.equal(sd2["model"][n], sd2s["model"][n])
    ck.verify_durable(2)


def test_failed_async_save_raises_at_the_next_save(state, tmp_path,
                                                   monkeypatch):
    from semi_supervised_asr_tpu_torch.training import checkpointing as CK

    ck = Checkpointer(tmp_path / "c", async_save=True)
    real = CK._write_synced

    def flaky(path, write):               # steps 1 and 5 hit a full disk
        if path.parent.name.split(".")[0] in ("1", "5"):
            raise OSError("disk full")
        real(path, write)

    monkeypatch.setattr(CK, "_write_synced", flaky)
    ck.save(1, state)                      # returns; the thread fails
    with pytest.raises(CK.CheckpointSaveFailed, match="disk full"):
        ck.save(2, state)
    ck.save(3, state)                      # the error was surfaced once
    ck.verify_durable(3)
    ck.save(5, state)
    with pytest.raises(CK.CheckpointSaveFailed, match="step 5"):
        ck.verify_durable(5)
    assert ck.all_steps() == [3]


def test_killed_async_save_leaves_tmp_that_is_quarantined(tmp_path):
    """A process killed while its background save writes leaves the tmp
    directory; the next trainer, under the workdir lock, quarantines it
    and the latest durable step is the one before."""
    import subprocess
    import sys

    d = tmp_path / "ck"
    overrides = [f"{k}={v}" for k, v in SMALL.items()]
    code = (
        "import os, torch\n"
        "from semi_supervised_asr_tpu_torch.config import load_config\n"
        "from semi_supervised_asr_tpu_torch.training import "
        "checkpointing as CK\n"
        "from semi_supervised_asr_tpu_torch.training.solver import Solver\n"
        f"cfg = load_config({CONFIG!r}, {overrides!r})\n"
        f"s = Solver(cfg, {str(tmp_path / 'w')!r}, 'cpu')\n"
        f"ck = CK.Checkpointer({str(d)!r}, async_save=True)\n"
        "ck.save(1, s.state)\n"
        "ck.wait()\n"
        "real = torch.save\n"
        "def dying(obj, f):\n"
        "    f.write(b'partial')\n"
        "    f.flush()\n"
        "    os._exit(9)\n"
        "CK.torch.save = dying\n"
        "ck.save(2, s.state)\n"
        "ck.wait()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 9, proc.stderr[-2000:]
    assert any(".ckpt-tmp" in e.name for e in d.iterdir())
    ck = Checkpointer(d)
    assert ck.latest_step() == 1
    moved = ck.quarantine_stale_tmp()
    assert len(moved) == 1 and moved[0].startswith("2.ckpt-tmp")
    assert not any(".ckpt-tmp" in e.name for e in d.iterdir())
    assert (d / "_quarantine").exists()


def test_workdir_lock(tmp_path):
    """A second trainer on a held workdir exits; the lock is released when
    train() returns, so a second Solver resumes in the same process; a
    read-only Solver leaves a live save's tmp directory alone."""
    wd = tmp_path / "wd"
    s1 = Solver(small_cfg(), wd, "cpu")
    s1._acquire_workdir_lock()
    s2 = Solver(small_cfg(), wd, "cpu")
    with pytest.raises(SystemExit, match="another trainer"):
        s2.train()
    s1.train()
    assert s1.state.step == 2 and s1._lock_fd is None
    s3 = Solver(small_cfg(**{"train.total_steps": 3}), wd, "cpu")
    s3.train(resume=True)
    assert s3.state.step == 3
    live = wd / "checkpoints" / "7.ckpt-tmp.1"
    live.mkdir()
    Solver(small_cfg(), wd, "cpu")
    assert live.exists() and not (wd / "checkpoints" / "_quarantine").exists()


def test_use_ema_decodes_the_ema_weights(tmp_path):
    cfg = small_cfg(**{"train.polyak_decay": 0.5, "decode.use_ema": "true"})
    s = Solver(cfg, tmp_path, "cpu")
    s.train()
    ema = dict(s.state.ema.named_parameters())
    assert any(not torch.equal(p, ema[n])
               for n, p in s.state.model.named_parameters())
    model = s.eval_params()
    sd, _, _ = s.ckpt.load(s.ckpt.best_step())
    for n, p in model.named_parameters():
        assert torch.equal(p, sd["ema"][n]) and torch.equal(p, ema[n])
    rate, _, _, _ = s._score_batches(s.bundle.dev, s.state.ema, "greedy")
    assert s.validate()["dev_error"] == rate
    with pytest.raises(ValueError, match="maintained EMA"):
        Solver(small_cfg(**{"decode.use_ema": "true"}), tmp_path / "x",
               "cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        Solver(small_cfg(**{"train.polyak_decay": 0.5,
                            "decode.use_ema": "true",
                            "decode.average_ckpts": 2}), tmp_path / "y",
               "cpu")


def test_average_ckpts_is_the_float64_mean(tmp_path):
    s = Solver(small_cfg(**{"train.total_steps": 3, "train.ckpt_every": 1}),
               tmp_path, "cpu")
    s.train()
    flat, steps = s.ckpt.average_params(s.state, 2)
    assert steps == [2, 3]
    a, b = s.ckpt.load(2)[0]["model"], s.ckpt.load(3)[0]["model"]
    for n, v in flat.items():
        want = ((a[n].double().numpy() + b[n].double().numpy()) * 0.5
                ).astype(np.float32)
        assert v.dtype == np.float32 and np.array_equal(v, want), n
    avg = Solver(small_cfg(**{"decode.average_ckpts": 2}), tmp_path, "cpu")
    for n, p in avg.eval_params().named_parameters():
        assert np.array_equal(p.detach().numpy(), flat[n]), n


def run_main(argv, capsys):
    assert M.main(["--device", "cpu", *argv, *[
        f"{k}={v}" for k, v in SMALL.items()]]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_cli_round_trip(tmp_path, capsys):
    """--train, --train --resume, --test --hyp-out, then transcribe from
    the workdir's checkpoint; the CLIs' refusals."""
    wd = str(tmp_path / "wd")
    out = run_main(["--config", CONFIG, "--train", "--workdir", wd,
                    "train.eval_every=1"], capsys)
    assert set(out["final_dev"]) == {"dev_error", "dev_cap_hit_rate"}
    assert M.main(["--device", "cpu", "--config", CONFIG, "--train",
                   "--resume", "--workdir", wd, *[
                       f"{k}={v}" for k, v in SMALL.items()],
                   "train.total_steps=3"]) == 0
    assert "resumed from step 2" in capsys.readouterr().err
    ck = Checkpointer(tmp_path / "wd" / "checkpoints")
    assert ck.latest_step() == 3
    hyp = tmp_path / "hyps.jsonl"
    res = run_main(["--config", CONFIG, "--test", "--load-dir", wd,
                    "--beam", "1", "--hyp-out", str(hyp)], capsys)
    assert res["mode"] == "greedy" and res["n_utts"] == 4
    assert 0 <= res["cap_hit_rate"] <= 1 and res["per"] >= 0
    recs = [json.loads(x) for x in hyp.read_text().splitlines()]
    assert len(recs) == 4 and {"uid", "ref", "hyp", "errors"} <= set(recs[0])
    analysis = json.loads((tmp_path / "hyps.jsonl.analysis.json")
                          .read_text())
    assert analysis["n_utts"] == 4 and analysis["unit"] == "phone39"
    beam = run_main(["--config", CONFIG, "--test", "--load-dir", wd],
                    capsys)
    assert beam["mode"] == "beam" and beam["n_utts"] == 4

    # transcribe decodes with the best checkpoint's weights
    cfg = load_config(CONFIG, [f"{k}={v}" for k, v in SMALL.items()])
    wav = synthetic.write_wavs(tmp_path, cfg, TR.build_vocab(cfg), 1)
    argv = ["--config", CONFIG, "--device", "cpu", "--beam", "1",
            str(wav[0]), *[f"{k}={v}" for k, v in SMALL.items()]]
    assert TR.main(["--load-dir", wd, *argv]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    solver = Solver(cfg, wd, "cpu")
    rec = TR.Recognizer(solver.cfg, solver.eval_params(), solver.cmvn,
                        solver.vocab, torch.device("cpu"))
    want = TR.transcribe(rec, wav, "greedy")[0]
    assert got == want
    with pytest.raises(SystemExit, match="params.npz"):
        TR.main(["--load-dir", str(tmp_path / "empty"), *argv])

    with pytest.raises(SystemExit, match="--beam 0"):
        M.main(["--config", CONFIG, "--test", "--beam", "0"])
    with pytest.raises(SystemExit, match="parallel.model_parallel"):
        M.main(["--config", CONFIG, "--train", "--workdir", wd, "--device",
                "cpu", "parallel.model_parallel=2"])
    with pytest.raises(SystemExit, match="train.debug_nans"):
        M.main(["--config", CONFIG, "--train", "--workdir", wd, "--device",
                "cpu", "train.debug_nans=true"])


def test_main_needs_cuda_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        M.main(["--config", CONFIG, "--train", "--workdir", str(tmp_path)])


def test_exec_restart_boundary_is_durable(tmp_path):
    s = Solver(small_cfg(**{"train.total_steps": 4,
                            "train.exec_restart_every": 3}), tmp_path, "cpu")
    s.train()
    assert s.restart_requested and s.state.step == 3
    assert s.ckpt.latest_step() == 3
    r = Solver(small_cfg(**{"train.total_steps": 4,
                            "train.exec_restart_every": 3}), tmp_path, "cpu")
    r.train(resume=True)
    assert not r.restart_requested and r.state.step == 4
