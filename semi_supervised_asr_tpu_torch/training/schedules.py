"""Learning-rate and teacher-forcing schedules, global-norm clipping, Adam.

Counterpart of ``semi_supervised_asr_tpu/training/schedules.py`` and of the
optax chain it builds (``clip_by_global_norm`` then ``adam``), written out
so that every number matches optax:

* the schedule is evaluated at the optimizer's count *before* the update,
  so with W warm-up steps the first update has learning rate 0;
* the clip scales by ``max_norm / norm`` only when ``norm > max_norm``
  (``torch.nn.utils.clip_grad_norm_`` would divide by ``norm + 1e-6``);
* Adam is optax's: ``m_hat / (sqrt(v_hat) + eps)`` with bias corrections
  at the new count and ``eps`` outside the square root, in float32.
  ``torch.optim.Adam`` with the rate set per step computes the same; the
  port keeps its own few lines so the order of operations is optax's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from semi_supervised_asr_tpu_torch.config import ObjectiveConfig, TrainConfig

f32 = np.float32


def learning_rate_schedule(cfg: TrainConfig):
    """-> step (int) -> learning rate (float): constant, cosine,
    exponential or noam, with optax's linear warm-up join.  The arithmetic
    is float32 in optax's order of operations, so the values are optax's
    to the last bits."""
    base = cfg.learning_rate
    floor = base * cfg.lr_min_ratio
    decay = max(cfg.decay_steps, 1)
    ratio = cfg.lr_min_ratio
    if cfg.lr_schedule == "constant":
        def main(step):
            return f32(base)
    elif cfg.lr_schedule == "cosine":
        def main(step):        # optax.cosine_decay_schedule(alpha=ratio)
            count = f32(min(step, decay))
            cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count
                                              / f32(decay)))
            return f32(base) * (f32(1 - ratio) * cos + f32(ratio))
    elif cfg.lr_schedule == "exponential":
        def main(step):        # optax.exponential_decay(end_value=floor)
            if step <= 0:
                value = f32(base)
            else:
                value = f32(base) * np.power(f32(ratio), f32(step / decay))
            clip = np.maximum if ratio < 1.0 else np.minimum
            return clip(value, f32(floor))
    elif cfg.lr_schedule == "noam":
        if cfg.warmup_steps <= 0:
            raise ValueError("lr_schedule=noam requires warmup_steps > 0")
        warm = f32(cfg.warmup_steps)

        def noam(step):
            s = np.maximum(f32(step), f32(1))
            return float(f32(base) * np.sqrt(warm) * np.minimum(
                s ** f32(-0.5), s * warm ** f32(-1.5)))

        return noam
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    w = cfg.warmup_steps
    if w > 0:
        def joined(step):      # optax.join_schedules([linear, main], [w])
            if step < w:       # optax.linear_schedule(0, base, w)
                frac = f32(1) - f32(max(step, 0)) / f32(w)
                return float(f32(-base) * frac + f32(base))
            return float(main(step - w))

        return joined
    return lambda step: float(main(step))


def tf_rate_at(step: int, obj: ObjectiveConfig) -> float:
    """Linear teacher-forcing decay from tf_rate_start to tf_rate_end."""
    frac = min(max(step / max(obj.tf_decay_steps, 1), 0.0), 1.0)
    return obj.tf_rate_start + (obj.tf_rate_end - obj.tf_rate_start) * frac


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (float32 scalar)."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm, in place: (g / norm) * max_norm when
    norm >= max_norm, else g unchanged (no host sync either way)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class Adam:
    """optax.adam over a list of float32 parameters (in-place updates)."""

    def __init__(self, params: list[torch.Tensor], cfg: TrainConfig):
        if cfg.optimizer != "adam":
            raise NotImplementedError(
                f"train.optimizer={cfg.optimizer!r} is not ported yet (the "
                "PyTorch port trains with adam)")
        self.params = params
        self.b1, self.b2, self.eps = cfg.beta1, cfg.beta2, 1e-8
        self.lr = learning_rate_schedule(cfg)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> float:
        """Apply one update; returns the learning rate it used."""
        lr = float(self.lr(self.count))
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            update = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.sub_(lr * update)
        return lr

    def state_dict(self) -> dict:
        """The moments (CPU copies) and the count; the parameters are the
        model's and are saved with it."""
        return {"count": self.count,
                "mu": [m.detach().cpu().clone() for m in self.mu],
                "nu": [v.detach().cpu().clone() for v in self.nu]}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy saved moments into this optimizer's own tensors (shapes
        must match; their device is kept)."""
        if len(sd["mu"]) != len(self.mu) or len(sd["nu"]) != len(self.nu):
            raise ValueError("optimizer state has "
                             f"{len(sd['mu'])} moments, this model "
                             f"{len(self.mu)}")
        for dst, src in zip(self.mu + self.nu, sd["mu"] + sd["nu"]):
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"optimizer moment shape {tuple(src.shape)}"
                                 f" does not match {tuple(dst.shape)}")
            dst.copy_(src)
        self.count = int(sd["count"])
