"""Solver: the train / eval loop of the PyTorch port.

Counterpart of ``semi_supervised_asr_tpu/training/solver.py`` for the LAS
family on one device: ``train()``, ``validate()``, ``test()`` around the
port's step (``training/train_step.py``) and decoders.

* The labeled stream draws ``data.drop_remainder`` batches of the seeded
  epoch plan; a semi-supervised run zips it with the unlabeled audio
  stream (the largest frame and token bucket, seed + 1) and the unlabeled
  text stream (the largest token bucket, seed + 2).
* The next steps' host-to-device copies are issued ``data.device_prefetch``
  deep (pinned memory, ``non_blocking``, on a side stream that the step
  waits for), so that they run beside the steps already queued.
* Every ``eval_every`` steps it greedy-decodes the dev set (through K1 and
  K2 on the card), scores PER (phones) or CER / WER (chars) with the
  native edit distance, and saves a checkpoint ranked by ``dev_error``;
  ``ckpt_every`` saves without evaluating.  Checkpoints keep the newest
  two and the best ``train.keep_ckpts`` (``training/checkpointing.py``).
* ``train(resume=True)`` restores the latest checkpoint and continues the
  exact streams: a resumed run is bitwise equal to an uninterrupted one.
* ``decode.use_ema`` validates and decodes with the EMA buffer,
  ``decode.average_ckpts`` with the mean of the last checkpoints.

Not ported (each refused with its key, here or where the step, the model
or the decoders are built): the feature store, grain threads, SortaGrad,
constant-frames batching, LM fusion, CTC and transducer decoding,
``train.async_ckpt`` and ``train.debug_nans``; data parallelism waits for
its own slice.
``train.compile_cache_dir`` has no meaning here (nothing is compiled per
shape) and has no effect.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.config import Config
from semi_supervised_asr_tpu_torch.data import pipeline as pipe
from semi_supervised_asr_tpu_torch.data import registry
from semi_supervised_asr_tpu_torch.data.bucketing import make_bucket_spec
from semi_supervised_asr_tpu_torch.data.vocab import EOS
from semi_supervised_asr_tpu_torch.decode.beam import check_supported
from semi_supervised_asr_tpu_torch.models.seq2seq import Seq2Seq
from semi_supervised_asr_tpu_torch.training import train_step as TS
from semi_supervised_asr_tpu_torch.training.checkpointing import Checkpointer
from semi_supervised_asr_tpu_torch.transcribe import (
    Recognizer, finalize_config,
)
from semi_supervised_asr_tpu_torch.utils import metrics as MET
from semi_supervised_asr_tpu_torch.utils.logging import MetricsLogger

# re-captured on every image replacement: os.execv keeps the PID, so the
# kernel's start time alone would charge an exec-restart generation with
# the whole previous generation's run time
_IMPORT_T0 = time.perf_counter()


def _proc_age_s() -> float:
    """Seconds since this process image started: the smaller of the
    kernel's start time (covers interpreter start, but not reset by execv)
    and this module's import time (reset by execv, misses what came
    before the import)."""
    import_age = time.perf_counter() - _IMPORT_T0
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(") ", 1)[1].split()
        start_ticks = float(fields[19])  # starttime is field 22 overall
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        proc_age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return min(proc_age, import_age)
    except Exception:
        return import_age


def check_solver_supported(cfg: Config) -> None:
    """Refuse the Solver options the port does not run, naming each key
    (the step's and the model's own options are checked where they are
    built)."""
    unsupported = {
        "train.async_ckpt": (cfg.train.async_ckpt, False),
        "train.debug_nans": (cfg.train.debug_nans, False),
        "data.grain_threads": (cfg.data.grain_threads, 0),
    }
    for key, (got, want) in unsupported.items():
        if got != want:
            raise NotImplementedError(
                f"{key}={got!r} is not ported yet (the PyTorch port's Solver "
                f"runs with {key}={want!r})")
    check_supported(cfg.decode)


class Solver:
    def __init__(self, cfg: Config, workdir: str | Path, device="cuda"):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.device = torch.device(device)
        check_solver_supported(cfg)
        self.bundle = registry.build_datasets(cfg)
        self.vocab = self.bundle.vocab
        self.cfg = cfg = finalize_config(cfg, self.vocab.size)
        if cfg.decode.use_ema:
            if TS.ema_decay(cfg) is None:
                raise ValueError(
                    "decode.use_ema needs a maintained EMA: set "
                    "train.polyak_decay > 0 (or train with the pseudo-label "
                    "EMA teacher) — otherwise the EMA buffer is a frozen "
                    "copy of the INITIAL weights")
            if cfg.decode.average_ckpts > 1:
                raise ValueError(
                    "decode.use_ema and decode.average_ckpts are mutually "
                    "exclusive — pick one weight-smoothing scheme")
        self.spec = make_bucket_spec(cfg.data, cfg.frontend,
                                     cfg.model.time_reduction)
        self.log = MetricsLogger(self.workdir)

        # global CMVN statistics, cached; written tmp + rename so that a
        # reader never sees a partial file
        stats_path = self.workdir / "cmvn.npz"
        if stats_path.exists():
            with np.load(stats_path) as z:
                self.cmvn = (z["mean"], z["inv_std"])
        else:
            mean, inv_std = pipe.compute_global_cmvn(self.bundle.train,
                                                     cfg.frontend)
            tmp = stats_path.with_suffix(f".{os.getpid()}.tmp.npz")
            np.savez(tmp, mean=mean, inv_std=inv_std)
            os.replace(tmp, stats_path)
            self.cmvn = (mean, inv_std)
        self.cmvn_dev = tuple(torch.as_tensor(a, device=self.device)
                              for a in self.cmvn)

        model = Seq2Seq(cfg.model)
        weights.load_flat(model, weights.init_numpy(cfg.model,
                                                    cfg.train.seed))
        self.state = TS.init_train_state(cfg, model.to(self.device),
                                         cfg.train.seed)
        self.ckpt = Checkpointer(self.workdir / cfg.train.ckpt_dir,
                                 max_to_keep=cfg.train.keep_ckpts,
                                 best_metric="dev_error")
        self.data_pos = {"epoch": 0, "batch": 0}
        self.history: list[dict] = []     # the "train" records logged
        self._copy_stream = None          # the card's input copies (_put)

    def load_params(self, flat: dict[str, np.ndarray]) -> None:
        """Start from given weights (flat JAX-layout names, e.g. a JAX
        Solver's initial parameters): into the model and the EMA buffer."""
        weights.load_flat(self.state.model, flat)
        weights.load_flat(self.state.ema, flat)

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #

    def _labeled_stream(self, start_epoch: int = 0, start_batch: int = 0):
        """Endless labeled stream of ``(epoch, batch_idx, batch)``; the
        train loop mirrors the position into ``self.data_pos`` when a step
        consumes the batch, so a resume continues the exact stream (the
        first epoch skips ``start_batch`` batches at plan cost)."""
        cfg = self.cfg

        def gen():
            epoch, skip = start_epoch, start_batch
            while True:
                it = pipe.epoch_batches(
                    self.bundle.train, self.spec, cfg.frontend,
                    cfg.train.batch_size, cfg.train.seed, epoch,
                    drop_remainder=cfg.data.drop_remainder,
                    start_batch=skip)
                n_yielded = 0
                for k, b in enumerate(it, start=skip):
                    yield epoch, k, b
                    n_yielded += 1
                if n_yielded == 0 and skip == 0:
                    # a full epoch with no batch would rebuild empty plans
                    # forever (a resume whose skip consumes the whole epoch
                    # rolls over legitimately, hence skip == 0)
                    raise RuntimeError(
                        f"training epoch {epoch} produced ZERO batches: "
                        "every utterance exceeds the bucket grid "
                        "(data.frame_buckets/token_buckets) and/or fewer "
                        "eligible rows than train.batch_size remain with "
                        "data.drop_remainder=true — fix the bucket/batch "
                        "config for this corpus")
                epoch += 1
                skip = 0

        return gen()

    def _unlabeled_streams(self, skip_batches: int = 0):
        """Unlabeled audio padded to the largest frame and token bucket,
        text to the largest token bucket.  Each semi step consumes one
        batch of each, so a resume skips ``skip_batches`` = the restored
        step count (plan cost only)."""
        cfg = self.cfg
        ua = ut = None
        if cfg.objective.lambda_pseudo > 0.0 and self.bundle.unlabeled_audio:
            big = make_bucket_spec(dataclasses.replace(
                cfg.data, frame_buckets=(self.spec.frame_buckets[-1],),
                token_buckets=(self.spec.token_buckets[-1],)),
                cfg.frontend, cfg.model.time_reduction)
            ua = pipe.repeating_batches(
                self.bundle.unlabeled_audio, big, cfg.frontend,
                cfg.train.batch_size, cfg.train.seed + 1,
                drop_remainder=False, skip_batches=skip_batches)
        if cfg.objective.lambda_text_ae > 0.0 and self.bundle.unlabeled_text:
            ut = pipe.text_batches(
                self.bundle.unlabeled_text, self.spec.token_buckets[-1],
                cfg.train.batch_size, cfg.train.seed + 2,
                skip_batches=skip_batches)
        return ua, ut

    def _put(self, *arrays) -> tuple[torch.Tensor, ...]:
        """Host arrays -> device tensors.  On the card each array is pinned
        and copied without blocking on a side stream, and the current
        stream waits for those copies before the work queued after this
        call: a prefetched step's copies run beside the steps queued
        before it."""
        if self.device.type != "cuda":
            return tuple(torch.as_tensor(a) for a in arrays)
        main = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = tuple(torch.from_numpy(np.ascontiguousarray(a))
                        .pin_memory().to(self.device, non_blocking=True)
                        for a in arrays)
        main.wait_stream(self._copy_stream)
        for t in out:
            # allocated on the side stream, used and freed on the main one
            t.record_stream(main)
        return out

    def step_inputs(self, batch, ua_stream=None, ut_stream=None):
        """One labeled batch and the next batch of each unlabeled stream
        -> (the step's positional device tensors, its unlabeled keyword
        tensors)."""
        args = self._put(batch.audio, batch.audio_lens, batch.tokens,
                         batch.real)
        unlab = {}
        if ua_stream is not None:
            ub = next(ua_stream)
            a, n, r = self._put(ub.audio, ub.audio_lens, ub.real)
            unlab.update(unlab_audio=a, unlab_audio_lens=n, unlab_real=r)
        if ut_stream is not None:
            toks, real = next(ut_stream)
            t, r = self._put(toks, real)
            unlab.update(unlab_text=t, unlab_text_real=r)
        return args, unlab

    def run_step(self, args, unlab) -> dict:
        """One update of ``self.state`` -> the step's metrics (0-dim
        tensors on the device and floats)."""
        return TS.supervised_step(self.cfg, self.state, *args, self.cmvn_dev,
                                  **unlab)

    def _acquire_workdir_lock(self) -> None:
        """Exclusive flock on ``<workdir>/.lock.p0``: a second trainer on
        one workdir would double-write metrics.jsonl and race checkpoint
        saves, so it fails loudly instead.  flock is released by the
        kernel when the process dies, so a killed trainer never wedges
        the workdir."""
        import fcntl

        if getattr(self, "_lock_fd", None) is not None:
            return
        path = self.workdir / ".lock.p0"
        fd = open(path, "w")
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            fd.close()
            raise SystemExit(
                f"{self.workdir}: another trainer already holds {path.name} "
                "— refusing to double-write metrics and race checkpoint "
                "saves on a shared workdir. Stop the other trainer or use a "
                "different --workdir.")
        fd.write(f"{os.getpid()}\n")
        fd.flush()
        self._lock_fd = fd

    def _release_workdir_lock(self) -> None:
        """Close (= release) the lock: it guards a live training loop
        only, so a second Solver in the same process can resume the
        workdir after train() returns."""
        fd, self._lock_fd = getattr(self, "_lock_fd", None), None
        if fd is not None:
            try:
                fd.close()
            except OSError:
                pass

    def train(self, resume: bool = False) -> dict:
        self._acquire_workdir_lock()
        try:
            # dead-save debris recovery belongs here, under the lock
            self.ckpt.quarantine_stale_tmp()
            return self._train_locked(resume)
        finally:
            self._release_workdir_lock()

    def _coverage(self) -> dict:
        """Utterances longer than the largest bucket are skipped every
        epoch: one "data" record says how many."""
        cov = {}
        for name, ds in (("train", self.bundle.train),
                         ("unlabeled", self.bundle.unlabeled_audio)):
            if ds is None or len(ds) == 0:
                continue
            n_skip = sum(1 for i in range(len(ds))
                         if self.spec.assign(ds.audio_len(i),
                                             ds.token_len(i)) is None)
            cov[f"{name}_utts"] = len(ds)
            cov[f"{name}_skipped"] = n_skip
            cov[f"{name}_skip_rate"] = n_skip / len(ds)
        return cov

    def _train_locked(self, resume: bool = False) -> dict:
        cfg = self.cfg
        # set at exec_restart_every boundaries; main.py re-executes a fresh
        # process with --resume when it sees this
        self.restart_requested = False
        start_batch = 0
        skip_unlab = 0
        if resume and self.ckpt.latest_step() is not None:
            self.state, self.data_pos, start = self.ckpt.restore(self.state)
            # data_pos["batch"] is the last batch consumed before the save;
            # each unlabeled stream advanced one batch a step
            start_batch = self.data_pos["batch"] + 1
            skip_unlab = self.state.step
            self.log.info(
                f"resumed from step {start} (epoch "
                f"{self.data_pos['epoch']}, next batch {start_batch})")

        labeled = self._labeled_stream(self.data_pos["epoch"], start_batch)
        ua_stream, ut_stream = self._unlabeled_streams(skip_unlab)
        cov = self._coverage()
        if cov:
            self.log.log(self.state.step, cov, "data")

        t_last = time.perf_counter()
        frames_acc = 0
        last_eval: dict = {}
        # startup wall = exec -> loop entry (datasets, CMVN, restore); the
        # first step's wall is logged with it once step 1 of this process
        # completes, under prefix "wall"
        startup_wall = _proc_age_s()
        first_step_t0: float | None = time.perf_counter()
        # early stopping remembers the best dev_error across a resume
        best_dev, evals_since_best = float("inf"), 0
        if resume and self.ckpt.best_step() is not None:
            m = self.ckpt.metrics(self.ckpt.best_step())
            if "dev_error" in m:
                best_dev = float(m["dev_error"])
        host_step = self.state.step

        def input_stream():
            for epoch, k, batch in labeled:
                args, unlab = self.step_inputs(batch, ua_stream, ut_stream)
                yield epoch, k, batch, args, unlab

        def _prefetch(it, depth=int(cfg.data.device_prefetch)):
            q = deque()
            for item in it:
                q.append(item)
                if len(q) >= max(depth, 1):
                    yield q.popleft()
            while q:
                yield q.popleft()

        inputs = _prefetch(input_stream())
        prof = None
        while host_step < cfg.train.total_steps:
            epoch, k, batch, args, unlab = next(inputs)
            # the position of the batch this step consumes (not of the
            # prefetched ones)
            self.data_pos["epoch"] = epoch
            self.data_pos["batch"] = k
            m = self.run_step(args, unlab)
            host_step += 1
            step = host_step
            if first_step_t0 is not None:
                self.log.log(step, {
                    "startup_wall_s": startup_wall,
                    "first_step_wall_s": time.perf_counter() - first_step_t0,
                    "resumed": float(bool(resume)),
                }, "wall")
                first_step_t0 = None

            # profiling window: profile_steps steps from profile_start
            if cfg.train.profile_steps > 0:
                if step == cfg.train.profile_start:
                    prof = _start_profiler(self.device)
                elif (prof is not None and step == cfg.train.profile_start
                      + cfg.train.profile_steps):
                    out = _stop_profiler(prof, self.workdir / "profile",
                                         self.device)
                    prof = None
                    self.log.info(f"profile trace written to {out}")
            frames_acc += (int(batch.audio_lens[batch.real].sum())
                           // cfg.frontend.hop_length)
            if step % cfg.train.log_every == 0:
                dt = time.perf_counter() - t_last
                scalars = {k: float(v) for k, v in m.items()}
                scalars["frames_per_sec"] = frames_acc / max(dt, 1e-9)
                scalars["steps_per_sec"] = cfg.train.log_every / max(dt, 1e-9)
                self.log.log(step, scalars, "train")
                self.history.append({"step": step, **scalars})
                self.log.info(
                    f"step {step} loss {scalars['loss']:.4f} "
                    f"acc {scalars['acc']:.3f} "
                    f"fps {scalars['frames_per_sec']:.0f}")
                t_last = time.perf_counter()
                frames_acc = 0

            if cfg.train.eval_every > 0 and step % cfg.train.eval_every == 0:
                t_ev = time.perf_counter()
                last_eval = self.validate()
                eval_wall = time.perf_counter() - t_ev
                t_ck = time.perf_counter()
                self.ckpt.save(step, self.state, self.data_pos,
                               {"dev_error": last_eval["dev_error"]})
                self.log.log(step, {
                    **last_eval,
                    "eval_wall_s": eval_wall,
                    "ckpt_wall_s": time.perf_counter() - t_ck,
                }, "dev")
                if last_eval["dev_error"] < best_dev - 1e-9:
                    best_dev, evals_since_best = last_eval["dev_error"], 0
                else:
                    evals_since_best += 1
                    patience = cfg.train.early_stop_patience
                    if patience > 0 and evals_since_best >= patience:
                        self.log.info(
                            f"early stop at step {step}: dev_error has not "
                            f"improved on {best_dev:.4f} for "
                            f"{evals_since_best} evals")
                        break
            elif cfg.train.ckpt_every > 0 and step % cfg.train.ckpt_every == 0:
                self.ckpt.save(step, self.state, self.data_pos,
                               {"dev_error": last_eval.get("dev_error", 1e9)})

            if (cfg.train.exec_restart_every > 0
                    and step % cfg.train.exec_restart_every == 0
                    and step < cfg.train.total_steps):
                saved_now = (
                    (cfg.train.eval_every > 0
                     and step % cfg.train.eval_every == 0)
                    or (cfg.train.ckpt_every > 0
                        and step % cfg.train.ckpt_every == 0))
                t_rs = time.perf_counter()
                if not saved_now:
                    self.ckpt.save(
                        step, self.state, self.data_pos,
                        {"dev_error": last_eval.get("dev_error", 1e9)})
                # the boundary save must be durable before main.py
                # re-executes into a resume from it
                self.ckpt.verify_durable(step)
                self.log.log(step, {
                    "restart_save_wall_s": time.perf_counter() - t_rs,
                }, "wall")
                self.restart_requested = True
                self.log.info(
                    f"exec-restart boundary at step {step} "
                    f"(train.exec_restart_every="
                    f"{cfg.train.exec_restart_every})")
                return last_eval

        if prof is not None:
            _stop_profiler(prof, self.workdir / "profile", self.device)
        # the final save, unless the loop just saved (ckpt_every <= 0
        # disables the periodic saves, not this one)
        if (cfg.train.ckpt_every <= 0
                or self.state.step % cfg.train.ckpt_every != 0):
            last_eval = self.validate()
            self.ckpt.save(self.state.step, self.state, self.data_pos,
                           {"dev_error": last_eval["dev_error"]})
        self.ckpt.verify_durable(self.state.step)
        return last_eval

    # ------------------------------------------------------------------ #
    # evaluation
    # ------------------------------------------------------------------ #

    def _score_batches(self, dataset, model: Seq2Seq, mode: str):
        """Decode a dataset -> (error rate, hypothesis records, WER or
        None, the share of hypotheses cut by the length cap).  WER (word
        level, from the decoded text) is reported for char units only."""
        if mode not in ("greedy", "beam"):
            raise NotImplementedError(
                f"decode mode {mode!r} is not ported yet (the PyTorch port "
                "decodes greedy and beam)")
        rec = Recognizer(self.cfg, model, self.cmvn, self.vocab, self.device)
        er, wer = MET.ErrorRate(), MET.ErrorRate()
        records = []
        # length-cap telemetry: a hypothesis that fills max_decode_len
        # without emitting EOS was cut by the cap
        cap_hits, n_scored = 0, 0
        char = self.cfg.data.unit in ("char", "bpe")
        batches = pipe.epoch_batches(dataset, self.spec, self.cfg.frontend,
                                     self.cfg.train.batch_size, seed=0,
                                     epoch=0, drop_remainder=False)
        for batch in batches:
            hyps, _ = rec.decode(batch.audio, batch.audio_lens, mode)
            refs = batch.tokens
            if self.cfg.data.unit == "phone":
                d, n = MET.per_batch(hyps, refs, self.vocab)
            else:
                d, n = MET.cer_batch(hyps, refs)
            er.update(d[batch.real], n[batch.real])
            for r in range(len(hyps)):
                if not batch.real[r]:
                    continue
                out = {"uid": batch.uids[r],
                       "ref": self.vocab.decode_text(refs[r]),
                       "hyp": self.vocab.decode_text(hyps[r]),
                       "errors": int(d[r]), "ref_len": int(n[r])}
                n_scored += 1
                if not bool((hyps[r] == EOS).any()):
                    cap_hits += 1
                    out["no_eos"] = True
                if char:
                    we, nw = MET.wer_strings(out["hyp"], out["ref"])
                    wer.update(we, nw)
                    out["word_errors"], out["ref_words"] = we, nw
                records.append(out)
        if n_scored and cap_hits / n_scored > 0.01:
            self.log.warning(
                f"LENGTH-CAP SATURATION: {cap_hits}/{n_scored} "
                f"hypotheses filled decode.max_decode_len="
                f"{self.cfg.decode.max_decode_len} without emitting EOS "
                "— the error metric is partly measuring TRUNCATION, not "
                "recognition. Raise max_decode_len (or check for a model "
                "that cannot terminate).")
        return (er.rate, records, (wer.rate if char else None),
                cap_hits / max(n_scored, 1))

    def _live_eval_model(self) -> Seq2Seq:
        """What validate() scores mid-training: the EMA buffer under
        decode.use_ema, else the live model."""
        return self.state.ema if self.cfg.decode.use_ema else self.state.model

    def validate(self) -> dict:
        rate, _, wrate, cap_rate = self._score_batches(
            self.bundle.dev, self._live_eval_model(), "greedy")
        self._log_alignment()
        out = {"dev_error": rate}
        if wrate is not None:
            out["dev_wer"] = wrate
        out["dev_cap_hit_rate"] = cap_rate
        return out

    @torch.inference_mode()
    def _log_alignment(self) -> None:
        """Teacher-forced attention of one dev utterance -> a tensorboard
        image.  Best-effort; skipped without tensorboard."""
        if self.log._tb is None:
            return
        try:
            from semi_supervised_asr_tpu_torch.objectives.losses import (
                shift_targets,
            )

            batch = next(iter(pipe.epoch_batches(
                self.bundle.dev, self.spec, self.cfg.frontend,
                self.cfg.train.batch_size, seed=0, epoch=0,
                drop_remainder=False)))
            audio, lens, tokens, _ = self._put(batch.audio, batch.audio_lens,
                                               batch.tokens, batch.real)
            feats, flens = TS.featurize(self.cfg, audio, lens, self.cmvn_dev)
            tokens_in, _ = shift_targets(tokens)
            _, alphas = self.state.model.forward_teacher(feats, flens,
                                                         tokens_in)
            a = alphas[0].float().cpu().numpy()          # [U, T']
            u = int(batch.token_lens[0])
            self.log.log_image(self.state.step, "attention/dev0",
                               a[:u] / max(a[:u].max(), 1e-6))
        except Exception as e:  # never fail training over a plot
            self.log.info(f"alignment plot skipped: {e}")

    def _model_from(self, flat: dict) -> Seq2Seq:
        model = Seq2Seq(self.cfg.model)
        weights.load_flat(model, {k: np.asarray(v) for k, v in flat.items()})
        return model.to(self.device)

    def eval_params(self, require_ckpt: bool = False) -> Seq2Seq:
        """The model decode-time consumers use: the average of the last
        checkpoints (decode.average_ckpts), else the best (then latest)
        checkpoint, its EMA buffer under decode.use_ema -- the same for
        --test and transcribe, so serving matches measured quality."""
        if self.ckpt.latest_step() is None:
            if require_ckpt:
                raise SystemExit(
                    f"{self.workdir}: no checkpoint found — decoding with "
                    "untrained params would produce garbage (check the "
                    "--load-dir path / train first)")
            return self._live_eval_model()
        if self.cfg.decode.average_ckpts > 1:
            flat, steps = self.ckpt.average_params(
                self.state, self.cfg.decode.average_ckpts)
            self.log.info(f"decoding with params averaged over steps {steps}")
            return self._model_from(flat)
        step = self.ckpt.best_step() or self.ckpt.latest_step()
        sd, _, _ = self.ckpt.load(step)
        if self.cfg.decode.use_ema:
            self.log.info("decoding with Polyak-EMA weights")
            return self._model_from(sd["ema"])
        return self._model_from(sd["model"])

    def test(self, mode: str = "beam",
             out_path: str | Path | None = None) -> dict:
        model = self.eval_params()
        eval_ds = (self.bundle.test if self.bundle.test is not None
                   else self.bundle.dev)
        rate, records, wrate, cap_rate = self._score_batches(eval_ds, model,
                                                             mode)
        if out_path is not None:
            with open(out_path, "w") as f:
                for r in records:
                    f.write(json.dumps(r) + "\n")
            if records:
                from semi_supervised_asr_tpu_torch.utils import (
                    error_analysis as EA,
                )

                analysis = EA.analyze_records(records, self.vocab,
                                              self.cfg.data.unit)
                Path(f"{out_path}.analysis.json").write_text(
                    json.dumps(analysis, indent=1))
                self.log.info(EA.summary_line(analysis))
        metric = {"phone": "per", "char": "cer"}.get(self.cfg.data.unit,
                                                     "ter")
        out = {metric: rate, "n_utts": len(records), "mode": mode}
        if wrate is not None:
            out["wer"] = wrate
        out["cap_hit_rate"] = cap_rate
        return out


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, out_dir: Path, device: torch.device) -> Path:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"trace.{os.getpid()}.{int(time.time())}.json"
    prof.export_chrome_trace(str(out))
    return out
