"""PyTorch port parity: masked MHSA, the plain version of kernel K5.

On the CPU, JAX's ``flash_mhsa.mhsa`` is its ``mhsa_reference`` (the Pallas
kernel runs on a TPU only), and the port's ``mhsa`` on CPU tensors is its
``mhsa_reference``: the two are held together on the same numpy inputs,
forward and gradients (``jax.vjp``), with ragged lengths and a zero-length
row -- 1e-5 in float32; in bfloat16 to 1e-3 of the largest entry (both
round the scores, the weights and the outputs to bf16 at the same points;
on this CPU they agree bit for bit).  The kernels themselves
run on the card (``chip_smoke.py`` phase 9 holds them against this plain
version).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.ops import flash_mhsa as JFM
from semi_supervised_asr_tpu_torch.ops import flash_mhsa as FM

B, T, H, D = 3, 13, 2, 8
LENS = (13, 7, 0)
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-3)}


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                     for _ in range(4))
    mask = np.arange(T)[None, :] < np.asarray(LENS)[:, None]
    return q, k, v, mask, dout


def port(q, k, v, mask, dout, compute, backend=None):
    """(O, dq, dk, dv) of the port's mhsa as float32 numpy."""
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = FM.mhsa(*leaves, torch.from_numpy(mask), sm_scale=D ** -0.5,
                compute=compute, backend=backend)
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(dout).to(o.dtype))
    return [x.detach().float().numpy() for x in (o, *grads)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mhsa_matches_jax_forward_and_vjp(dtype):
    compute, jcompute, tol = DTYPES[dtype]
    q, k, v, mask, dout = inputs()
    got = port(q, k, v, mask, dout, compute)
    jmask = jnp.asarray(mask)

    def f(q_, k_, v_):
        return JFM.mhsa(q_, k_, v_, jmask, sm_scale=D ** -0.5,
                        compute=jcompute)

    @jax.jit
    def f_vjp(q_, k_, v_, dout_):
        o, vjp = jax.vjp(f, q_, k_, v_)
        return (o, *vjp(dout_.astype(o.dtype)))

    want = [np.asarray(x, np.float32)
            for x in f_vjp(*(jnp.asarray(x) for x in (q, k, v, dout)))]
    for name, a, w in zip(("O", "dq", "dk", "dv"), got, want):
        scale = 1.0 if dtype == "float32" else np.abs(w).max()
        np.testing.assert_allclose(a, w, rtol=tol, atol=tol * scale,
                                   err_msg=name)


def test_ragged_rows_and_the_empty_row():
    """Finite everywhere; the empty row averages v over all T keys and gets
    dq = 0; no gradient reaches k at a masked key (its score was replaced),
    and v at a masked key only through the empty row."""
    q, k, v, mask, dout = inputs(1)
    o, dq, dk, dv = port(q, k, v, mask, dout, torch.float32)
    assert all(np.isfinite(x).all() for x in (o, dq, dk, dv))
    np.testing.assert_allclose(o[2], np.broadcast_to(v[2].mean(0), o[2].shape),
                               rtol=1e-5, atol=1e-6)
    assert (dq[2] == 0).all()
    assert (dk[~mask] == 0).all()
    assert (dv[1][~mask[1]] == 0).all()
    np.testing.assert_allclose(dv[2], np.broadcast_to(dout[2].sum(0) / T,
                                                      dv[2].shape),
                               rtol=1e-5, atol=1e-6)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    q, k, v, mask, _ = (torch.from_numpy(x) for x in inputs(2))
    got = FM.mhsa(q, k, v, mask, sm_scale=0.3, compute=torch.float32)
    want = FM.mhsa_reference(q, k, v, mask, sm_scale=0.3,
                             compute=torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(FM.mhsa(q, k, v, mask, sm_scale=0.3,
                               compute=torch.float32, backend="reference"),
                       want)
    with pytest.raises(ValueError, match="backend"):
        FM.mhsa(q, k, v, mask, sm_scale=0.3, compute=torch.float32,
                backend="cuda")


@pytest.mark.parametrize("change, message", [
    (dict(d=12), "head dim 12"),
    (dict(d=136), "head dim 136"),
    (dict(k_len=12), "does not match q"),
    (dict(mask_dtype=torch.int32), "key_mask"),
    (dict(dtype=torch.float16), "compute dtype"),
])
def test_kernel_entry_refusals(change, message):
    """What the kernels do not take is refused before any launch."""
    d, t = change.get("d", 8), 5
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros((2, t, 2, d), dtype=dtype)
    k = torch.zeros((2, change.get("k_len", t), 2, d), dtype=dtype)
    mask = torch.ones((2, t), dtype=change.get("mask_dtype", torch.bool))
    with pytest.raises(ValueError, match=message):
        FM.mhsa_fwd(q, k, q, mask, 0.5)


def test_backward_entry_refuses_mismatched_statistics():
    q = torch.zeros((2, 5, 2, 8))
    mask = torch.ones((2, 5), dtype=torch.bool)
    m = torch.zeros((2, 2, 5))
    with pytest.raises(ValueError, match="mhsa_bwd: l"):
        FM.mhsa_bwd(q, q, q, mask, q, m, m[:, :, :4], q, 0.5)
    with pytest.raises(ValueError, match="mhsa_bwd: o"):
        FM.mhsa_bwd(q, q, q, mask, q.double(), m, m, q, 0.5)
