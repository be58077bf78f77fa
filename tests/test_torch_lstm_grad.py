"""PyTorch port parity: the LSTM backward scan (K3) and layer gradients.

The scan's autograd Function on CPU tensors (K2's plain forward with
residuals, then ``lstm_scan_bwd_reference``) is held against ``jax.vjp`` of
the Pallas ``lstm_scan_pallas`` / ``lstm_scan_pallas_bidir`` in interpret
mode, and the drop-ins ``lstm_kernel`` / ``bilstm_kernel`` against
``jax.grad`` of ``lstm_pallas`` / ``bilstm_pallas``, at the shapes and the
tolerance of tests/test_pallas_lstm.py (B=8, T=12, H=128, float32, rtol
2e-4, atol 2e-5).  The port keeps a reverse direction in real time order;
JAX's kernels run it on flipped inputs, so the JAX side is flipped back
before the comparison.  The CUDA kernel is compared with the plain version
on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.ops import pallas_lstm as PL
from semi_supervised_asr_tpu_torch.ops import lstm_scan as K

B, T, I, H = 8, 12, 16, 128
TOL = dict(rtol=2e-4, atol=2e-5)
# each JAX reference runs once, so its XLA compile dominates: the cheap
# backend settings cut it; the results stay inside the tolerances
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
LENS = np.asarray([T, T - 3, T - 5, 2, T, 0, 4, T], np.int32)
VALID = (np.arange(T)[:, None] < LENS[None, :]).astype(np.float32)


def draw(seed, d):
    """gates_x [D, T, B, 4H], w_hh [D, H, 4H], dh_out [D, T, B, H]."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    gx = rng.standard_normal((d, T, B, 4 * H)).astype(np.float32)
    w = rng.uniform(-bound, bound, (d, H, 4 * H)).astype(np.float32)
    dh = rng.standard_normal((d, T, B, H)).astype(np.float32)
    return gx, w, dh


def port_grads(gx, w, dh, reverse):
    g = torch.from_numpy(gx).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    h = K.lstm_scan(g, wt, torch.from_numpy(VALID), torch.float32, reverse)
    dg, dw = torch.autograd.grad(h, (g, wt), torch.from_numpy(dh))
    return h.detach().numpy(), dg.numpy(), dw.numpy()


def flip(x):
    return jnp.flip(x, axis=0)


def run_jax(fn, *args):
    """fn(*args) through jit, compiled with FAST_XLA."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(*args)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_grads_match_pallas_vjp(reverse):
    gx, w, dh = draw(int(reverse), 1)
    h, dg, dw = port_grads(gx, w, dh, (reverse,))
    # JAX walks a reverse direction over flipped inputs
    f = flip if reverse else (lambda x: x)
    valid = f(jnp.asarray(VALID))

    def ref(g, ww, d):
        h_, vjp = jax.vjp(
            lambda a, b: PL.lstm_scan_pallas(a, b, valid, jnp.float32, 1),
            g, ww)
        return (h_, *vjp(d))

    ref_h, ref_dg, ref_dw = run_jax(ref, f(jnp.asarray(gx[0])),
                                    jnp.asarray(w[0]),
                                    f(jnp.asarray(dh[0])))
    np.testing.assert_allclose(h[0], np.asarray(f(ref_h)), **TOL)
    np.testing.assert_allclose(dg[0], np.asarray(f(ref_dg)), **TOL)
    np.testing.assert_allclose(dw[0], np.asarray(ref_dw), **TOL)


def test_bidirectional_scan_grads_match_pallas_bidir_vjp():
    """D=2 (forward, reverse) in one launch against the stacked-rows
    kernel pair ``_fwd_kernel_bidir`` / ``_bwd_kernel_bidir``."""
    gx, w, dh = draw(2, 2)
    _, dg, dw = port_grads(gx, w, dh, (False, True))
    valid = jnp.asarray(VALID)
    gates = jnp.concatenate([gx[0], flip(gx[1])], axis=1)     # [T, 2B, 4H]
    valid2 = jnp.concatenate([valid, flip(valid)], axis=1)

    def ref(g, ww, d):
        _, vjp = jax.vjp(
            lambda a, b: PL.lstm_scan_pallas_bidir(a, b, valid2,
                                                   jnp.float32, 1),
            g, ww)
        return vjp(d)

    ref_dg, ref_dw = run_jax(ref, gates, jnp.asarray(w),
                             jnp.concatenate([dh[0], flip(dh[1])], axis=1))
    np.testing.assert_allclose(dg[0], np.asarray(ref_dg[:, :B]), **TOL)
    np.testing.assert_allclose(dg[1], np.asarray(flip(ref_dg[:, B:])), **TOL)
    np.testing.assert_allclose(dw, np.asarray(ref_dw), **TOL)


def lstm_params(rng):
    bound = 1.0 / np.sqrt(H)
    return {
        "w_ih": rng.uniform(-bound, bound, (I, 4 * H)).astype(np.float32),
        "w_hh": rng.uniform(-bound, bound, (H, 4 * H)).astype(np.float32),
        "b": rng.uniform(-bound, bound, (4 * H,)).astype(np.float32),
    }


@pytest.mark.parametrize("layer", ["lstm_reverse", "bilstm"])
def test_layer_grads_match_jax_grad(layer):
    """dx, dW_ih, dW_hh, db of a whole layer: the port's drop-in under
    autograd against jax.grad of the Pallas drop-in."""
    rng = np.random.default_rng(3)
    if layer == "bilstm":
        p = {"fwd": lstm_params(rng), "bwd": lstm_params(rng)}
        out_h = 2 * H
    else:
        p = lstm_params(rng)
        out_h = H
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    dy = rng.standard_normal((B, T, out_h)).astype(np.float32)
    lens = jnp.asarray(LENS)

    def jax_loss(params, xx):
        if layer == "bilstm":
            y = PL.bilstm_pallas(params, xx, lens, jnp.float32,
                                 allow_interpret=True)
        else:
            y = PL.lstm_pallas(params, xx, lens, True, jnp.float32,
                               allow_interpret=True)
        return jnp.sum(y * dy)

    ref_p, ref_x = run_jax(jax.grad(jax_loss, argnums=(0, 1)),
                           jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    tlens = torch.from_numpy(LENS)
    if layer == "bilstm":
        y = K.bilstm_kernel(tp, tx, tlens, torch.float32)
    else:
        y = K.lstm_kernel(tp, tx, tlens, True, torch.float32)
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                                [tx, *leaves])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ref_x), **TOL)
    for got, want in zip(grads[1:], jax.tree.leaves(ref_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_backward_wrapper_refusals():
    gx, w, dh = draw(4, 1)
    valid = torch.from_numpy(VALID)
    with torch.inference_mode():
        _, _, cprev, acts = K.lstm_scan(torch.from_numpy(gx),
                                        torch.from_numpy(w), valid,
                                        torch.float32, (False,),
                                        residuals=True)
    args = (torch.from_numpy(w), valid, acts, cprev, torch.from_numpy(dh),
            torch.float32)
    with pytest.raises(ValueError, match="reverse"):
        K.lstm_scan_bwd(*args, (False, True))
    with pytest.raises(ValueError, match="backend"):
        K.lstm_scan_bwd(*args, (False,), backend="cuda")
    # a CPU tensor runs the plain version
    got = K.lstm_scan_bwd(*args, (False,))
    want = K.lstm_scan_bwd_reference(*args, (False,))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
