"""Weight bridge between the JAX parameter tree and the port's modules.

The JAX model's parameters are a nested tree of dicts and lists
(``models/seq2seq.py::init_model``).  Flattened with "." between keys and
list indices, its paths are exactly the names of the port's parameters
(``listener.layers.0.fwd.w_ih``, ``speller.cells.0.b``,
``speller.attention.conv``, ...), and every array keeps the JAX layout.

* :func:`load_tree` copies a tree of numpy arrays (e.g.
  ``jax.tree.map(np.asarray, params)``) into a model, and
  :func:`unflatten_tree` turns flat names back into that tree;
* :func:`save_npz` / :func:`load_npz` store the same flat names in
  ``params.npz``, the port's weight file;
* :func:`init_numpy` draws a random tree with the model's shapes from a
  seed, with no JAX, for runs that have no checkpoint; :func:`init_module`
  does the same for any module of the package (an external LM:
  ``training/lm_trainer.py``).

A missing, extra or wrongly shaped leaf raises.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
from torch import nn

from semi_supervised_asr_tpu_torch.config import ModelConfig


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {"a.0.b": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten_tree(flat: dict[str, np.ndarray]):
    """{"a.0.b": array} -> nested dicts, with lists where every key of a
    level is an index (the inverse of :func:`flatten_tree`)."""
    root: dict = {}
    for name, value in flat.items():
        node, parts = root, name.split(".")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def load_flat(model: nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Copy flat-named arrays into ``model``'s parameters (exact names and
    shapes; dtypes are converted to each parameter's own)."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    for name, p in params.items():
        value = np.asarray(flat[name])
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} does not "
                             f"match the model's {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(value)))


def load_tree(model: nn.Module, tree) -> None:
    """Copy a JAX-layout parameter tree (numpy leaves) into ``model``."""
    load_flat(model, flatten_tree(tree))


def state_numpy(model: nn.Module) -> dict[str, np.ndarray]:
    return {n: p.detach().cpu().float().numpy()
            for n, p in model.named_parameters()}


def save_npz(model: nn.Module, path: str | Path) -> None:
    np.savez(path, **state_numpy(model))


def load_npz(model: nn.Module, path: str | Path) -> None:
    with np.load(path) as z:
        load_flat(model, {k: z[k] for k in z.files})


# listener biases (LayerNorm b, projections, attention, feed-forward, the
# conformer's conv module, the conv stem), the speller's own and its LM
# fusion's gate and DNN: zeros
ZERO_LEAVES = ("b", "bq", "bk", "bv", "bo", "b1", "b2", "b_pw1", "b_dw",
               "b_pw2", "bias", "b_out", "b_g", "b_l")


def _fan_init(rng: np.random.Generator, name: str, shape: tuple[int, ...],
              lstm: bool) -> np.ndarray:
    """Distribution per leaf, after the JAX initializers; ``lstm`` says
    that the leaf's group is an LSTM cell (it holds a ``w_hh``)."""
    leaf = name.rsplit(".", 1)[-1]
    if lstm:                                    # U(-1/sqrt(H), 1/sqrt(H))
        hidden = shape[-1] // 4
        bound = 1.0 / math.sqrt(hidden)
        return rng.uniform(-bound, bound, shape)
    if leaf == "g" or leaf.endswith("_g"):      # LayerNorm gain (ln1_g, ..)
        return np.ones(shape)
    if leaf in ZERO_LEAVES or leaf.endswith("_b"):
        return np.zeros(shape)
    if leaf == "embedding":                     # [V, width]
        return rng.standard_normal(shape) / math.sqrt(shape[-1])
    if leaf == "embed":                         # the transducer's predictor
        return rng.standard_normal(shape) * 0.02
    if leaf == "pos":               # transformer speller / LM [L, d]
        return rng.standard_normal(shape) * 0.02
    if leaf == "conv":                          # [W, 1, C]
        return rng.standard_normal(shape) / math.sqrt(shape[0])
    if leaf == "v":                             # glorot of an [A, 1] matrix
        fan_in, fan_out = shape[0], 1
    elif len(shape) == 4:                       # conv stem [3, 3, C_in, C]
        field = shape[0] * shape[1]
        fan_in, fan_out = field * shape[2], field * shape[3]
    else:   # glorot uniform matrices; [in, heads, d_head] as [in, d_model]
        fan_in, fan_out = shape[0], int(np.prod(shape[1:]))
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-bound, bound, shape)


def init_module(module: nn.Module, seed: int) -> dict[str, np.ndarray]:
    """Random float32 weights with the names and shapes of ``module``'s
    parameters, drawn from ``seed`` in their order, each leaf's
    distribution decided by its path (:func:`init_numpy`)."""
    rng = np.random.default_rng(seed)
    params = dict(module.named_parameters())
    out = {}
    for name, p in params.items():
        group = name.rsplit(".", 1)[0]
        out[name] = _fan_init(rng, name, tuple(p.shape),
                              lstm=f"{group}.w_hh" in params
                              ).astype(np.float32)
    return out


def init_numpy(cfg: ModelConfig, seed: int) -> dict[str, np.ndarray]:
    """Random float32 weights with the names and shapes of
    ``build_model(cfg)``, drawn from ``seed`` (the JAX init's shapes and
    distributions, not its values), decided by path: LayerNorm gains ones,
    biases zeros, LSTM cells uniform, embeddings normal / sqrt(width), the
    transformer speller's positions and the transducer's predictor
    embedding normal * 0.02, the rest glorot (the conv stem's with its
    receptive field; the CTC head's matrix and the transducer's joint
    too)."""
    from semi_supervised_asr_tpu_torch.models.seq2seq import build_model

    return init_module(build_model(cfg), seed)
