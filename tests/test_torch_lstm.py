"""PyTorch port parity: LSTM primitives and the forward scan kernel K2.

The scan's plain version (``lstm_scan_reference``, reached through the
drop-ins ``lstm_kernel`` / ``bilstm_kernel`` on CPU tensors) is held
against the Pallas kernel in interpret mode at the shapes and tolerance of
tests/test_pallas_lstm.py (B=8, T=12, I=16, H=128; 1e-5 in float32).  In
bfloat16 both sides round h and w_hh the same way but sum in different
orders; when that flips one bf16 rounding of h (an ulp of ~4e-3 at
|h| ~ 1), the gates move by about |w_hh| * ulp ~ 4e-4, so the bound there
is 1e-3.  The CUDA kernel is compared with the plain version on the card
by chip_smoke.py; the backward (K3) is tested in test_torch_lstm_grad.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_asr_tpu.ops import pallas_lstm as PL
from semi_supervised_asr_tpu.ops import recurrent as JR
from semi_supervised_asr_tpu_torch import _native
from semi_supervised_asr_tpu_torch.ops import lstm_scan as K
from semi_supervised_asr_tpu_torch.ops import recurrent as R
from tests.test_torch_train import (  # noqa: F401 -- one_thread: autouse
    one_thread, run_jax,
)

B, T, I, H = 8, 12, 16, 128
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = dict(rtol=1e-3, atol=1e-3)
LENS = np.asarray([T, T - 3, T - 5, 2, T, 0, 4, T], np.int32)


def lstm_params(rng, in_dim=I, hidden=H):
    bound = 1.0 / np.sqrt(hidden)
    return {
        "w_ih": rng.uniform(-bound, bound, (in_dim, 4 * hidden)),
        "w_hh": rng.uniform(-bound, bound, (hidden, 4 * hidden)),
        "b": rng.uniform(-bound, bound, (4 * hidden,)),
    }


def make(seed, bidir=False):
    rng = np.random.default_rng(seed)
    if bidir:
        p = {"fwd": lstm_params(rng), "bwd": lstm_params(rng)}
    else:
        p = lstm_params(rng)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    return p, x


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


CASES = {
    "full_length": dict(lens=False, reverse=False),
    "variable_length": dict(lens=True, reverse=False),
    "reverse": dict(lens=True, reverse=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lstm_kernel_plain_matches_pallas(case):
    c = CASES[case]
    p, x = make(sorted(CASES).index(case))
    lens = LENS if c["lens"] else None
    ref = PL.lstm_pallas(to_jax(p), jnp.asarray(x),
                         None if lens is None else jnp.asarray(lens),
                         c["reverse"], jnp.float32, allow_interpret=True)
    with torch.inference_mode():
        got = K.lstm_kernel(to_torch(p), torch.from_numpy(x),
                            None if lens is None else torch.from_numpy(lens),
                            c["reverse"], torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilstm_kernel_plain_matches_pallas(dtype):
    p, x = make(11, bidir=True)
    ref = PL.bilstm_pallas(to_jax(p), jnp.asarray(x), jnp.asarray(LENS),
                           jnp.dtype(dtype), allow_interpret=True)
    with torch.inference_mode():
        got = K.bilstm_kernel(to_torch(p), torch.from_numpy(x),
                              torch.from_numpy(LENS), R.dtype_of(dtype))
    tol = TOL if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    # the one plain recurrence also stands in for the reference's XLA scan
    ref_xla = JR.bilstm(to_jax(p), jnp.asarray(x), jnp.asarray(LENS),
                        jnp.dtype(dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_xla), **tol)


def test_scan_residuals_match_pallas():
    """hprev / cprev / acts, the inputs of the backward kernel K3."""
    rng = np.random.default_rng(12)
    p = lstm_params(rng)
    gx = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    valid = (np.arange(T)[:, None] < LENS[None, :]).astype(np.float32)
    ref = PL._fwd_call(jnp.asarray(gx), jnp.asarray(p["w_hh"], jnp.float32),
                       jnp.asarray(valid), jnp.float32, 1)
    with torch.inference_mode():
        got = K.lstm_scan(torch.from_numpy(gx)[None],
                          torch.from_numpy(p["w_hh"]).float()[None],
                          torch.from_numpy(valid), torch.float32, (False,),
                          residuals=True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), **TOL)


def test_reverse_direction_of_stacked_scan():
    """D=2 with the second direction reversed == two single scans."""
    rng = np.random.default_rng(13)
    gx = torch.from_numpy(rng.standard_normal((2, T, B, 4 * H)).astype(
        np.float32))
    w = torch.from_numpy(rng.uniform(-0.1, 0.1, (2, H, 4 * H)).astype(
        np.float32))
    valid = torch.from_numpy(
        (np.arange(T)[:, None] < LENS[None, :]).astype(np.float32))
    with torch.inference_mode():
        both = K.lstm_scan(gx, w, valid, torch.float32, (False, True),
                           residuals=True)
        for d, rev in enumerate((False, True)):
            one = K.lstm_scan(gx[d:d + 1], w[d:d + 1], valid, torch.float32,
                              (rev,), residuals=True)
            for a, b in zip(both, one):
                torch.testing.assert_close(a[d], b[0], rtol=0, atol=0)


def test_plain_primitives_match_jax():
    rng = np.random.default_rng(14)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     lstm_params(rng, in_dim=24, hidden=32))
    x = rng.standard_normal((B, 24)).astype(np.float32)
    h = rng.standard_normal((B, 32)).astype(np.float32)
    c = rng.standard_normal((B, 32)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        ref = run_jax(lambda *a: JR.lstm_single_step(*a, jnp.dtype(dtype)),
                      to_jax(p), jnp.asarray(x), jnp.asarray(h),
                      jnp.asarray(c))
        got = R.lstm_single_step(to_torch(p), torch.from_numpy(x),
                                 torch.from_numpy(h), torch.from_numpy(c),
                                 R.dtype_of(dtype))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    seq = rng.standard_normal((2, 6, 5)).astype(np.float32)
    lens = np.asarray([5, 2], np.int32)
    ref_f, ref_l = run_jax(JR.pyramid_fold, jnp.asarray(seq),
                           jnp.asarray(lens))
    got_f, got_l = R.pyramid_fold(torch.from_numpy(seq), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(ref_f))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))


def test_wrapper_refusals():
    p, x = make(15)
    tp = to_torch(p)
    before = dict(_native.LAUNCHES)
    with torch.inference_mode():
        K.lstm_kernel(tp, torch.from_numpy(x))
    assert _native.LAUNCHES == before          # CPU -> plain version
    # inputs that require grad run the autograd Function (K2 forward, K3
    # backward); residuals are refused there, being the Function's own
    w = tp["w_hh"].clone().requires_grad_(True)
    y = K.lstm_kernel(dict(tp, w_hh=w), torch.from_numpy(x))
    assert y.requires_grad and _native.LAUNCHES == before
    gx = torch.zeros((1, T, B, 4 * H), requires_grad=True)
    with pytest.raises(ValueError, match="residuals"):
        K.lstm_scan(gx, w[None], torch.ones((T, B)), torch.float32, (False,),
                    residuals=True)
    with torch.inference_mode(), pytest.raises(ValueError, match="backend"):
        K.lstm_kernel(tp, torch.from_numpy(x), backend="cuda")
