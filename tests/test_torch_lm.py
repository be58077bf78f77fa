"""PyTorch port parity: the external LMs (``models/lm.py``) and their
trainer (``training/lm_trainer.py``).

Seeded numpy weights (``weights.init_module``) cross into the JAX tree by
name; inputs are drawn with numpy.  At V 12, E 16, H 32, 2 layers, B 3,
U 7:

* the LSTM LM's ``lm_step``, ``lm_forward`` (each layer on the scan's
  plain twin), ``lm_loss`` and its gradient against JAX's, to 1e-5;
* the transformer LM's forward, its stepped logits with uneven per-row
  positions (rows advanced on a ragged schedule), and causality, to 2e-5
  (the reference's own, tests/test_transformer_lm.py);
* one ``train_lm`` step's parameters against ``optax.adam`` from the same
  init, to 1e-5;
* the weight file: save / load bitwise, ``dims`` reading an LM as the
  fusion LSTM, a missing LM and a JAX (orbax) one refused by name;
* the ``lm_trainer`` CLI on ``configs/synthetic_smoke.yaml`` (trains,
  logs, saves, prints ``lm_loss`` / ``lm_ppl``), and its CUDA refusal.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semi_supervised_asr_tpu.models import lm as JLM
from semi_supervised_asr_tpu_torch import weights
from semi_supervised_asr_tpu_torch.config import load_config
from semi_supervised_asr_tpu_torch.data.registry import build_vocab
from semi_supervised_asr_tpu_torch.models import lm as LM
from semi_supervised_asr_tpu_torch.training import lm_trainer as LT
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    FAST_XLA, one_thread, run_jax,
)

V, E, H, LAYERS, B, U = 12, 16, 32, 2, 3, 7
TOL = dict(rtol=1e-5, atol=1e-5)
TLM_TOL = dict(rtol=2e-5, atol=2e-5)


def lstm_lm(seed=0):
    lm = LM.LSTMLM(V, E, H, LAYERS)
    flat = weights.init_module(lm, seed)
    weights.load_flat(lm, flat)
    return lm, jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))


def transformer_lm(seed=1, max_len=10):
    lm = LM.TransformerLM(V, 16, 2, 4, 32, max_len)
    flat = weights.init_module(lm, seed)
    weights.load_flat(lm, flat)
    return lm, jax.tree.map(jnp.asarray, weights.unflatten_tree(flat))


def text(seed=2) -> np.ndarray:
    """[B, U] EOS-terminated, PAD-padded rows (one full, one short, one
    of a single EOS)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(3, V, (B, U)).astype(np.int32)
    tok[0, U - 1] = 2
    tok[1, 4], tok[1, 5:] = 2, 0
    tok[2, 0], tok[2, 1:] = 2, 0
    return tok


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_lm_trees_match_jax_init():
    """The port's names and shapes are the JAX initializers' trees."""
    for port, jinit in (
            (LM.LSTMLM(V, E, H, LAYERS),
             lambda k: JLM.init_lm(k, V, E, H, LAYERS)),
            (LM.TransformerLM(V, 16, 2, 4, 32, 10),
             lambda k: JLM.init_transformer_lm(k, V, 16, 2, 4, 32, 10))):
        want = weights.flatten_tree(jax.tree.map(
            lambda s: np.zeros(s.shape), jax.eval_shape(
                jinit, jax.random.PRNGKey(0))))
        got = {n: tuple(p.shape) for n, p in port.named_parameters()}
        assert got == {n: a.shape for n, a in want.items()}


@pytest.fixture(scope="module")
def lstm_ref():
    """(port LM, JAX tree, text, JAX's forward logits, loss, grads)."""
    lm, tree = lstm_lm()
    tok = text()
    tin = np.concatenate([np.ones((B, 1), np.int32), tok[:, :-1]], axis=1)
    logits, (loss, grads) = run_jax(
        lambda p, ti, tk: (JLM.lm_forward(p, ti),
                           jax.value_and_grad(JLM.lm_loss)(p, tk)),
        tree, jnp.asarray(tin), jnp.asarray(tok))
    return lm, tree, tok, tin, np.asarray(logits), float(loss), grads


def test_lstm_lm_step_matches_jax(lstm_ref):
    lm, tree, _, tin, logits_ref, _, _ = lstm_ref
    st, jst = LM.lm_step(lm, None, None, init_batch=B)[0], \
        JLM.lm_init_state(tree, B)
    jstep = jax.jit(JLM.lm_step, compiler_options=FAST_XLA)
    with torch.no_grad():
        for u in range(U):
            st, lg = LM.lm_step(lm, st, t(tin[:, u]))
            jst, jlg = jstep(tree, jst, jnp.asarray(tin[:, u]))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
            # the step's logits are the teacher-forced pass's
            np.testing.assert_allclose(lg.numpy(), logits_ref[:, u], **TOL)
    assert st["h"].shape == (LAYERS, B, H)
    for k in ("h", "c"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), **TOL)


def test_lstm_lm_forward_and_loss_match_jax(lstm_ref):
    lm, _, tok, tin, logits_ref, loss_ref, _ = lstm_ref
    with torch.no_grad():
        np.testing.assert_allclose(LM.lm_forward(lm, t(tin)).numpy(),
                                   logits_ref, **TOL)
        np.testing.assert_allclose(float(LM.lm_loss(lm, t(tok))), loss_ref,
                                   **TOL)


def test_lstm_lm_grads_match_jax(lstm_ref):
    lm, _, tok, _, _, _, grads = lstm_ref
    params = dict(lm.named_parameters())
    got = torch.autograd.grad(LM.lm_loss(lm, t(tok)), list(params.values()))
    want = weights.flatten_tree(jax.tree.map(np.asarray, grads))
    for (name, _), g in zip(params.items(), got):
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **TOL)


def test_transformer_lm_forward_matches_jax():
    lm, tree = transformer_lm()
    tin = np.concatenate([np.ones((B, 1), np.int32), text()[:, :-1]], 1)
    ref = run_jax(JLM.lm_forward, tree, jnp.asarray(tin))
    with torch.no_grad():
        np.testing.assert_allclose(LM.lm_forward(lm, t(tin)).numpy(),
                                   np.asarray(ref), **TLM_TOL)
        with pytest.raises(ValueError, match="max_len"):
            LM.lm_forward(lm, torch.ones((1, 11), dtype=torch.int32))


def test_transformer_lm_step_uneven_positions_and_causality():
    """Rows advanced on a ragged schedule (row r steps at the ticks where
    ``ADV[tick, r]``), the rest kept by a per-row select as the transducer
    beam keeps them: each row's stepped logits are its own teacher-forced
    prefix's, and JAX's per-row step gives the same; a later token never
    changes an earlier position's logits."""
    lm, tree = transformer_lm()
    tin = np.concatenate([np.ones((B, 1), np.int32), text()[:, :-1]], 1)
    with torch.no_grad():
        full = LM.lm_forward(lm, t(tin)).numpy()
        bumped = tin.copy()
        bumped[:, 4:] = (bumped[:, 4:] + 1) % V
        after = LM.lm_forward(lm, t(bumped)).numpy()
    np.testing.assert_array_equal(after[:, :4], full[:, :4])
    adv = np.array([[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 0, 0], [1, 1, 0],
                    [1, 1, 1], [0, 1, 1], [1, 0, 1]], bool)
    st = LM.lm_step(lm, None, None, init_batch=B)[0]
    jst = JLM.lm_step(tree, None, None, init_batch=B)[0]

    @jax.jit
    def jstep(p, state, tok, a):
        new, lg = JLM.lm_step(p, state, tok)
        return jax.tree.map(lambda n, o: jnp.where(a.reshape(
            (1, B) + (1,) * (n.ndim - 2)), n, o), new, state), lg

    pos = np.zeros(B, int)
    with torch.no_grad():
        for a in adv:
            cur = t(tin[np.arange(B), np.minimum(pos, U - 1)])
            new, lg = LM.lm_step(lm, st, cur)
            jst, jlg = jstep(tree, jst, jnp.asarray(cur.numpy()),
                             jnp.asarray(a))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                       **TLM_TOL)
            for r in np.flatnonzero(a):
                np.testing.assert_allclose(lg[r].numpy(), full[r, pos[r]],
                                           **TLM_TOL)
            st = LM.where_rows(t(a), new, st)
            pos += a
    np.testing.assert_array_equal(st["tpos"].numpy()[0], pos)


def test_train_lm_step_matches_optax(lstm_ref):
    """One ``lm_trainer.train_step`` (Adam at a constant rate, no clipping)
    against ``optax.adam`` on JAX's gradients from the same init.  Adam's
    first update is u(g) = g / (|g| + 1e-8): where |g| is within a few
    1e-8 of zero the two frameworks' float32 sums move u visibly, so the
    port's parameters are held to optax's moved by exactly that difference
    of the (already compared) gradients, as tests/test_torch_train.py
    holds the whole step."""
    lm0, tree, tok, _, _, _, grads = lstm_ref
    lm = copy.deepcopy(lm0)
    params = dict(lm.named_parameters())
    g_port = dict(zip(params, (g.numpy() for g in torch.autograd.grad(
        LM.lm_loss(lm, t(tok)), list(params.values())))))
    lr = 0.01
    cfg = load_config("configs/synthetic_smoke.yaml",
                      [f"lm.learning_rate={lr}"])
    loss = LT.train_step(lm, LT.adam(cfg, lm), t(tok))
    tx = optax.adam(lr)
    want = weights.flatten_tree(jax.tree.map(np.asarray, run_jax(
        lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p))[0]),
        grads, tree)))
    g_jax = weights.flatten_tree(jax.tree.map(np.asarray, grads))

    def u(g):
        return g.astype(np.float64) / (np.abs(g) + 1e-8)

    for name, p in lm.named_parameters():
        moved = want[name] - lr * (u(g_port[name]) - u(g_jax[name]))
        np.testing.assert_allclose(p.detach().numpy(), moved, err_msg=name,
                                   **TOL)
    assert loss.dim() == 0 and torch.isfinite(loss)


def test_lm_weight_file(tmp_path):
    """Save / load bitwise for both architectures; ``dims`` reads an LM as
    the fusion LSTM; a missing LM and a JAX (orbax) one are refused."""
    cfg = load_config("configs/synthetic_smoke.yaml", [
        f"lm.embed_dim={E}", f"lm.hidden={H}", f"lm.layers={LAYERS}"])
    lm, _ = lstm_lm()
    LT.save_lm(tmp_path / "lstm", lm)
    for got in (LT.load_lm(tmp_path / "lstm", cfg, V),
                LT.load_lm(tmp_path / "lstm", cfg, V, dims=(E, H, LAYERS))):
        assert isinstance(got, LM.LSTMLM)
        for (n, a), (_, b) in zip(lm.named_parameters(),
                                  got.named_parameters()):
            assert torch.equal(a, b), n
    tcfg = cfg.replace(lm=dataclasses.replace(
        cfg.lm, arch="transformer", embed_dim=16, layers=2, heads=4,
        ff_dim=32, max_len=10))
    tl, _ = transformer_lm()
    LT.save_lm(tmp_path / "tf", tl)
    got = LT.load_lm(tmp_path / "tf", tcfg, V)
    assert all(torch.equal(a, b) for a, b in zip(tl.parameters(),
                                                 got.parameters()))
    with pytest.raises(KeyError):         # the names say the architecture
        LT.load_lm(tmp_path / "tf", cfg, V)
    with pytest.raises(LT.LMNotFound, match="no trained LM"):
        LT.load_lm(tmp_path / "nothing", cfg, V)
    orbax = LT.lm_ckpt_dir(tmp_path / "jax")
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(LT.LMNotFound, match="converter"):
        LT.load_lm(tmp_path / "jax", cfg, V)


def test_lm_trainer_cli(tmp_path, capsys):
    over = ["lm.total_steps=6", "lm.log_every=3", "lm.hidden=16",
            "lm.embed_dim=8", "lm.batch_size=4", "data.num_synthetic_utts=8"]
    assert LT.main(["--config", "configs/synthetic_smoke.yaml",
                    "--workdir", str(tmp_path), "--device", "cpu",
                    *over]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"lm_loss", "lm_ppl"}
    assert np.isfinite(out["lm_loss"])
    np.testing.assert_allclose(out["lm_ppl"], np.exp(out["lm_loss"]),
                               rtol=1e-6)
    recs = [json.loads(x) for x in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if r["prefix"] == "lm"] == [3, 6]
    assert recs[-1]["lm_loss"] == out["lm_loss"]
    cfg = load_config("configs/synthetic_smoke.yaml", over)
    lm = LT.load_lm(tmp_path, cfg, build_vocab(cfg).size)
    assert lm.cells[0].w_hh.shape == (16, 64)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            LT.main(["--config", "configs/synthetic_smoke.yaml",
                     "--workdir", str(tmp_path / "gpu")])
