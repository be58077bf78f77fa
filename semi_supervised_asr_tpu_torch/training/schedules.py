"""Learning-rate and teacher-forcing schedules, and the optimizer chain.

Counterpart of ``semi_supervised_asr_tpu/training/schedules.py`` and of the
optax chain its ``make_optimizer`` builds (``train.freeze``'s set-to-zero,
``clip_by_global_norm``, then ``adam``, ``adamw`` or ``sgd``), written out
so that every number matches optax:

* the schedule is evaluated at the optimizer's count *before* the update,
  so with W warm-up steps the first update has learning rate 0;
* the clip scales by ``max_norm / norm`` only when ``norm > max_norm``
  (``torch.nn.utils.clip_grad_norm_`` would divide by ``norm + 1e-6``);
* Adam is optax's: ``m_hat / (sqrt(v_hat) + eps)`` with bias corrections
  at the new count and ``eps`` outside the square root, in float32;
  ``adamw`` adds ``weight_decay * p`` to that update (every leaf but the
  frozen fusion LM's) before the learning rate scales it; ``sgd`` is a
  momentum-0.9 trace ``m = g + 0.9 m``.  The port keeps its own few lines
  so the order of operations is optax's;
* ``train.freeze`` zeroes the gradient of every leaf whose reference path
  (``jax.tree_util.keystr``: ``['listener']['layers'][0]['w']``) holds one
  of its tokens, before the clip, so frozen leaves neither enter the clip's
  norm nor Adam's moments (adamw's decay still shrinks them, as optax's
  chain does).
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


def reference_path(name: str) -> str:
    """The reference's ``jax.tree_util.keystr`` of a parameter's path from
    the port's dotted name: ``listener.layers.0.w`` ->
    ``['listener']['layers'][0]['w']`` (list indices bare, dict keys
    quoted), the string ``train.freeze``'s tokens are matched against."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in name.split("."))


def frozen_mask(names: list[str], freeze) -> list[bool]:
    """Per parameter: whether a ``train.freeze`` token selects it."""
    tokens = tuple(freeze)
    return [any(t in reference_path(n) for t in tokens) for n in names]


class Adam:
    """optax.adam over a list of float32 parameters (in-place updates);
    with ``decay`` (one flag a parameter) optax.adamw, whose
    ``weight_decay * p`` joins the update of the flagged leaves."""

    frozen: list[bool] | None = None    # train.freeze (make_optimizer)

    def __init__(self, params: list[torch.Tensor], cfg: TrainConfig,
                 decay: list[bool] | None = None):
        self.params = params
        self.b1, self.b2, self.eps = cfg.beta1, cfg.beta2, 1e-8
        self.lr = learning_rate_schedule(cfg)
        self.wd = cfg.weight_decay if decay is not None else 0.0
        self.decay = decay if decay is not None else [False] * len(params)
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
        for p, g, m, v, decays in zip(self.params, grads, self.mu, self.nu,
                                      self.decay):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            update = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if decays:
                update = update + self.wd * p
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
        _load_moments(self, sd, ("mu", "nu"))


class SGD:
    """optax.sgd(lr, momentum=0.9): the trace ``m = g + 0.9 m``, then
    ``p -= lr * m``."""

    momentum = 0.9
    frozen: list[bool] | None = None

    def __init__(self, params: list[torch.Tensor], cfg: TrainConfig):
        self.params = params
        self.lr = learning_rate_schedule(cfg)
        self.count = 0
        self.trace = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> float:
        lr = float(self.lr(self.count))
        self.count += 1
        for p, g, m in zip(self.params, grads, self.trace):
            m.mul_(self.momentum).add_(g)
            p.sub_(lr * m)
        return lr

    def state_dict(self) -> dict:
        return {"count": self.count,
                "trace": [m.detach().cpu().clone() for m in self.trace]}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        _load_moments(self, sd, ("trace",))


def _load_moments(opt, sd: dict, keys: tuple[str, ...]) -> None:
    """Copy the saved lists ``keys`` of ``sd`` into ``opt``'s own tensors
    and restore its count (a list of another length or a tensor of another
    shape raises)."""
    for key in keys:
        if key not in sd:
            raise ValueError(f"optimizer state has no {key!r} (saved by "
                             "another train.optimizer?)")
        own = getattr(opt, key)
        if len(sd[key]) != len(own):
            raise ValueError(f"optimizer state has {len(sd[key])} {key} "
                             f"tensors, this model {len(own)}")
        for dst, src in zip(own, sd[key]):
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"optimizer {key} shape {tuple(src.shape)}"
                                 f" does not match {tuple(dst.shape)}")
            dst.copy_(src)
    opt.count = int(sd["count"])


OPTIMIZERS = ("adam", "adamw", "sgd")


def make_optimizer(named: list[tuple[str, torch.Tensor]], cfg: TrainConfig):
    """The ``train.optimizer`` over ``named`` parameters (name, tensor),
    with ``frozen`` set to :func:`frozen_mask` of ``train.freeze``; adamw
    decays every leaf but the frozen fusion LM's (``fusion_lm`` in its
    path)."""
    names = [n for n, _ in named]
    params = [p for _, p in named]
    if cfg.optimizer == "adam":
        opt = Adam(params, cfg)
    elif cfg.optimizer == "adamw":
        opt = Adam(params, cfg, decay=["fusion_lm" not in reference_path(n)
                                       for n in names])
    elif cfg.optimizer == "sgd":
        opt = SGD(params, cfg)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    opt.frozen = frozen_mask(names, cfg.freeze)
    return opt


@torch.no_grad()
def update(opt, grads: list[torch.Tensor],
           cfg: TrainConfig) -> tuple[torch.Tensor, float]:
    """The reference's chain on ``grads`` (changed in place): zero the
    frozen leaves' gradients, clip by the global norm of what is left, one
    step of ``opt`` -> (the global norm of the gradients as given, frozen
    leaves included, as the reference logs it; the learning rate used)."""
    gnorm = norm = global_norm(grads)
    if opt.frozen is not None and any(opt.frozen):
        for g, f in zip(grads, opt.frozen):
            if f:
                g.zero_()
        norm = global_norm(grads)
    if cfg.grad_clip_norm > 0:
        clip_by_global_norm(grads, cfg.grad_clip_norm, norm)
    return gnorm, opt.step(grads)
