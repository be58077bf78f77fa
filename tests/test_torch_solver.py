"""PyTorch port: the Solver against the JAX package's Solver.

The resumable streams (``epoch_batches`` from ``start_batch``,
``repeating_batches`` and ``text_batches`` with ``skip_batches`` across
epoch boundaries, the synthetic dev split) and the Solver's labeled stream
at the default ``data.drop_remainder`` and under ``data.sortagrad_epochs``
are held byte for byte against JAX's.  Then a whole run: both Solvers start from the JAX Solver's initial
parameters on ``configs/synthetic_smoke.yaml`` at a small width
(SpecAugment off, teacher forcing 1), take 3 steps with validation every
2 and a train record every step: the losses agree to 1e-5 relative, the
dev error of each validation is equal, and so is ``test(mode="greedy")``'s
PER.  The JAX Solver is built and run once for the file.
"""

import dataclasses
import itertools
import json

import jax
import numpy as np
import pytest

from semi_supervised_asr_tpu.config import load_config as jax_load_config
from semi_supervised_asr_tpu.data import pipeline as JP
from semi_supervised_asr_tpu.data import registry as JR
from semi_supervised_asr_tpu.data.bucketing import (
    make_bucket_spec as jax_bucket_spec,
)
from semi_supervised_asr_tpu.training.solver import Solver as JaxSolver
from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.config import load_config
from semi_supervised_asr_tpu_torch.data import pipeline as PP
from semi_supervised_asr_tpu_torch.data import registry as PR
from semi_supervised_asr_tpu_torch.data.bucketing import make_bucket_spec
from semi_supervised_asr_tpu_torch.training.solver import Solver

from test_torch_train import one_thread  # noqa: F401  (autouse fixture)

CONFIG = "configs/synthetic_smoke.yaml"
# 18 utterances in one (144, 12) bucket at batch 4: 4 full batches and a
# partial one, which data.drop_remainder (default true) drops
SMALL = {"data.num_synthetic_utts": 18, "train.batch_size": 4,
         "model.enc_hidden": 8, "model.enc_layers": 1,
         "model.enc_base_layers": 1, "train.total_steps": 3,
         "train.eval_every": 2, "train.log_every": 1}
BATCH_FIELDS = ("audio", "audio_lens", "tokens", "token_lens", "real")
# constant-frames batching with two microbatches a step
FRAMES = {"data": {"batch_frames": 450}, "train": {"grad_accum": 2}}


def overrides(**extra):
    return [f"{k}={v}" for k, v in {**SMALL, **extra}.items()]


def assert_batches_equal(got, want):
    for f in BATCH_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f
    assert got.bucket == want.bucket and got.uids == want.uids


def records(workdir, prefix):
    return [r for r in map(json.loads,
                           (workdir / "metrics.jsonl").read_text()
                           .splitlines()) if r["prefix"] == prefix]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Solver's initial parameters, then its 3-step run and its
    greedy test."""
    workdir = tmp_path_factory.mktemp("jax_solver")
    solver = JaxSolver(jax_load_config(CONFIG, overrides()), workdir,
                       use_mesh=False)
    # no tensorboard: its attention plots (an eager teacher-forced pass at
    # each validation) are no part of what the tests compare
    if solver.log._tb is not None:
        solver.log._tb.close()
        solver.log._tb = None
    init = weights.flatten_tree(jax.tree.map(np.asarray, solver.state.params))
    labeled = list(itertools.takewhile(
        lambda ekb: ekb[0] == 0, solver._labeled_stream()))
    # the stream under constant-frames batching, from the same Solver
    cfg = solver.cfg
    solver.cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, **FRAMES["data"]),
        train=dataclasses.replace(cfg.train, **FRAMES["train"]))
    frames = list(itertools.takewhile(
        lambda ekb: ekb[0] == 0, solver._labeled_stream()))
    solver.cfg = cfg
    final = solver.train()
    test = solver.test(mode="greedy")
    return dict(init=init, labeled=[b for _, _, b in labeled],
                frames=[b for _, _, b in frames],
                train=records(workdir, "train"), dev=records(workdir, "dev"),
                final=final, test=test)


def test_labeled_stream_first_epoch_matches_jax(jax_run, tmp_path):
    """The Solver's labeled stream at the default data.drop_remainder
    (the port used to draw it without dropping the remainder)."""
    solver = Solver(load_config(CONFIG, overrides()), tmp_path, "cpu")
    assert solver.cfg.data.drop_remainder
    got = list(itertools.takewhile(lambda ekb: ekb[0] == 0,
                                   solver._labeled_stream()))
    assert [k for _, k, _ in got] == list(range(len(got)))
    assert len(got) == len(jax_run["labeled"]) == 4
    for (_, _, g), w in zip(got, jax_run["labeled"]):
        assert_batches_equal(g, w)
    # the setting matters here: without it the epoch holds a filler batch
    kept = list(PP.epoch_batches(solver.bundle.train, solver.spec,
                                 solver.cfg.frontend, 4, 0, 0,
                                 drop_remainder=False))
    assert len(kept) == 5 and any(not b.real.all() for b in kept)


def test_batch_frames_first_epoch_matches_jax(jax_run, tmp_path):
    """data.batch_frames=450 under train.grad_accum=2: each (144, 12)
    batch holds 450 // 144 = 3 rows, rounded down to the granule 2; the
    first epoch's batch sizes and rows are the JAX Solver's, byte for
    byte."""
    solver = Solver(load_config(CONFIG, overrides(**{
        f"{sec}.{k}": v for sec, kv in FRAMES.items()
        for k, v in kv.items()})), tmp_path, "cpu")
    got = [b for _, _, b in itertools.takewhile(
        lambda ekb: ekb[0] == 0, solver._labeled_stream())]
    assert [len(b.uids) for b in got] == [2] * 9
    assert len(got) == len(jax_run["frames"])
    for g, w in zip(got, jax_run["frames"]):
        assert_batches_equal(g, w)


def test_solver_run_matches_jax(jax_run, tmp_path):
    solver = Solver(load_config(CONFIG, overrides()), tmp_path, "cpu")
    solver.load_params(jax_run["init"])
    final = solver.train()
    got, want = records(tmp_path, "train"), jax_run["train"]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        for k in ("loss", "ce", "acc", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                       err_msg=f"step {g['step']} {k}")
        assert g["frames"] == w["frames"]
    got_dev, want_dev = records(tmp_path, "dev"), jax_run["dev"]
    assert [r["step"] for r in got_dev] == [r["step"] for r in want_dev] == [2]
    assert got_dev[0]["dev_error"] == want_dev[0]["dev_error"]
    assert final["dev_error"] == jax_run["final"]["dev_error"]
    assert (final["dev_cap_hit_rate"]
            == jax_run["final"]["dev_cap_hit_rate"])
    test = solver.test(mode="greedy")
    assert test == jax_run["test"]


def test_sortagrad_first_epoch_matches_jax(tmp_path):
    """data.sortagrad_epochs=1: the Solver's first epoch in ascending
    length, as JAX's Solver asks of its pipeline (sort_by_length while
    epoch < sortagrad_epochs), the second shuffled."""
    pc, jc = small_pair(**{"data.sortagrad_epochs": 1})
    solver = Solver(pc, tmp_path, "cpu")
    jb = JR.build_datasets(jc)
    jspec = jax_bucket_spec(jc.data, jc.frontend, 2)
    got = list(itertools.takewhile(lambda ekb: ekb[0] <= 1,
                                   solver._labeled_stream()))
    for epoch, sort in ((0, True), (1, False)):
        mine = [b for e, _, b in got if e == epoch]
        want = list(JP.epoch_batches(jb.train, jspec, jc.frontend, 4, 0,
                                     epoch, sort_by_length=sort))
        assert len(mine) == len(want) == 4
        for g, w in zip(mine, want):
            assert_batches_equal(g, w)
    # the setting matters: epoch 0 shuffled holds other batches
    shuffled = list(JP.epoch_batches(jb.train, jspec, jc.frontend, 4, 0, 0))
    assert ([b.uids for e, _, b in got if e == 0]
            != [b.uids for b in shuffled])


def small_pair(**extra):
    return (load_config(CONFIG, overrides(**extra)),
            jax_load_config(CONFIG, overrides(**extra)))


def test_resumable_streams_match_jax():
    """epoch_batches from start_batch, repeating_batches skipping across
    an epoch boundary (drop_remainder on and off), text_batches skipping
    across one, and the synthetic dev split."""
    pc, jc = small_pair()
    pb, jb = PR.build_datasets(pc), JR.build_datasets(jc)
    pspec = make_bucket_spec(pc.data, pc.frontend, 2)
    jspec = jax_bucket_spec(jc.data, jc.frontend, 2)
    for g, w in zip(
            PP.epoch_batches(pb.train, pspec, pc.frontend, 4, 0, 1,
                             start_batch=2),
            JP.epoch_batches(jb.train, jspec, jc.frontend, 4, 0, 1,
                             start_batch=2), strict=True):
        assert_batches_equal(g, w)
    for drop in (True, False):
        got = PP.repeating_batches(pb.train, pspec, pc.frontend, 4, 3,
                                   drop_remainder=drop, skip_batches=6)
        want = JP.repeating_batches(jb.train, jspec, jc.frontend, 4, 3,
                                    drop_remainder=drop, skip_batches=6)
        for g, w in zip(itertools.islice(got, 4), itertools.islice(want, 4)):
            assert_batches_equal(g, w)
    got = PP.text_batches(pb.unlabeled_text, 16, 4, 2, skip_batches=7)
    want = JP.text_batches(jb.unlabeled_text, 16, 4, 2, skip_batches=7)
    for (gt, gr), (wt, wr) in zip(itertools.islice(got, 4),
                                  itertools.islice(want, 4)):
        assert gt.tobytes() == wt.tobytes() and gr.tobytes() == wr.tobytes()
    assert len(pb.dev) == len(jb.dev) == 4
    assert pb.dev.cfg.synthetic_seed == jb.dev.cfg.synthetic_seed
    for i in range(len(pb.dev)):
        assert pb.dev[i].uid == jb.dev[i].uid
        assert pb.dev[i].audio.tobytes() == jb.dev[i].audio.tobytes()
        assert pb.dev[i].tokens.tobytes() == jb.dev[i].tokens.tobytes()
    for lens, drop in itertools.product(
            ([(3000, 5)] * 9, [(3000, 5)] * 9 + [(99999, 5)]), (True, False)):
        assert (PP.epoch_batch_count(lens, pspec, 4, 0, 0,
                                     drop_remainder=drop)
                == JP.epoch_batch_count(lens, jspec, 4, 0, 0,
                                        drop_remainder=drop))


@pytest.mark.parametrize("world, accum, frames", [(2, 2, 48), (2, 3, 40),
                                                  (4, 2, 16), (1, 2, 12)])
def test_batch_granule_is_the_reference_lcm(world, accum, frames):
    """The labeled stream's ``data.batch_frames`` batch sizes under data
    parallelism and accumulation: the reference's ``lcm(data-axis size,
    grad_accum)`` granule (``_train_batch_size`` of both Solvers)."""
    from types import SimpleNamespace

    over = ["train.batch_size=64", f"train.grad_accum={accum}",
            f"data.batch_frames={frames * 100}"]
    ref = JaxSolver._train_batch_size(SimpleNamespace(
        mesh=SimpleNamespace(devices=np.zeros((world, 1))),
        cfg=jax_load_config("configs/timit.yaml", over)))
    port = SimpleNamespace(cfg=load_config("configs/timit.yaml", over),
                           world=world, _accum=lambda: accum)
    got = Solver._train_batch_size(port)
    for key in [(f, u) for f in (100, 200, 400, 800) for u in (10, 50)]:
        assert got(key) == ref(key), key
