"""External language models for LM fusion: the LSTM LM and the causal
transformer LM.

Counterpart of ``semi_supervised_asr_tpu/models/lm.py``.  Two architectures
behind one interface (``lm.arch``): :class:`LSTMLM` and :class:`TransformerLM`
(pre-LN, with a per-step KV cache).  ``lm_step``, ``lm_forward`` and
``lm_loss`` dispatch on the model's class, so the trainer, the Solver and
the beams need no wiring of their own.  Parameter names are the JAX tree's
paths (``embedding``, ``cells.0.w_ih``, ``w_out``; ``blocks.0.wq`` [D, H,
Dh], ``pos``, ``lnf_g``, ...), so ``weights.load_tree`` carries a JAX LM
across.

The step follows the beams' contract::

    lm_step(lm, None,  None, init_batch=B) -> (state0, None)
    lm_step(lm, state, tokens)             -> (state', logits [B, V])

Every state leaf carries the lattice row on axis 1 behind a layer axis
(LSTM h / c [L, B, H]; the transformer's KV cache [L, B, T, D] and its
per-row positions ``tpos`` [1, B]), so a beam reorders them all alike.

The LSTM LM's teacher-forced pass runs each layer on the LSTM scan kernels
(``ops/lstm_scan.py::lstm_kernel``: K2 forward, K3 backward, one direction,
every step valid), as the transducer's predictor does; its step is the
plain cell (``recurrent.lstm_single_step``).  The LM is float32, as in the
reference: the scan takes the kernels' float32 route.  The transformer LM
is plain products and softmax, as the reference computes it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn
from torch import nn

from semi_supervised_asr_tpu_torch.models.listener import Leaves, LSTMWeights
from semi_supervised_asr_tpu_torch.ops import recurrent as R
from semi_supervised_asr_tpu_torch.ops.lstm_scan import lstm_kernel

NEG_INF = -1e30
F32 = torch.float32


class LSTMLM(nn.Module):
    """embedding [V, E], ``layers`` LSTM cells of ``hidden``, w_out [H, V],
    b_out [V]."""

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 hidden: int = 256, layers: int = 1):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(vocab_size, embed_dim))
        cells, in_dim = [], embed_dim
        for _ in range(layers):
            cells.append(LSTMWeights(in_dim, hidden))
            in_dim = hidden
        self.cells = nn.ModuleList(cells)
        self.w_out = nn.Parameter(torch.zeros(hidden, vocab_size))
        self.b_out = nn.Parameter(torch.zeros(vocab_size))


class TransformerLM(nn.Module):
    """Pre-LN causal transformer: embedding [V, D], pos [max_len, D] (it
    bounds the KV cache, hence the longest sequence it scores), ``layers``
    blocks (wq / wk / wv stored [D, heads, D / heads]), final LayerNorm,
    w_out [D, V], b_out [V]."""

    def __init__(self, vocab_size: int, d_model: int = 128, layers: int = 2,
                 heads: int = 4, d_ff: int = 512, max_len: int = 256):
        super().__init__()
        if d_model % heads:
            raise ValueError(f"lm d_model {d_model} must divide by heads "
                             f"{heads}")
        d, dh = d_model, d_model // heads
        self.embedding = nn.Parameter(torch.zeros(vocab_size, d))
        self.pos = nn.Parameter(torch.zeros(max_len, d))
        self.blocks = nn.ModuleList(
            Leaves(ln1_g=(d,), ln1_b=(d,), wq=(d, heads, dh),
                   wk=(d, heads, dh), wv=(d, heads, dh), wo=(d, d),
                   ln2_g=(d,), ln2_b=(d,), w1=(d, d_ff), b1=(d_ff,),
                   w2=(d_ff, d), b2=(d,))
            for _ in range(layers))
        self.lnf_g = nn.Parameter(torch.zeros(d))
        self.lnf_b = nn.Parameter(torch.zeros(d))
        self.w_out = nn.Parameter(torch.zeros(d, vocab_size))
        self.b_out = nn.Parameter(torch.zeros(vocab_size))


def build_lm(lcfg, vocab_size: int) -> nn.Module:
    """The LM of an ``lm`` config block (``lm.arch``: lstm | transformer),
    parameters zero (``weights.init_lm`` draws them)."""
    if lcfg.arch == "transformer":
        return TransformerLM(vocab_size, lcfg.embed_dim, lcfg.layers,
                             lcfg.heads, lcfg.ff_dim, lcfg.max_len)
    if lcfg.arch != "lstm":
        raise ValueError(f"unknown lm.arch {lcfg.arch!r}")
    return LSTMLM(vocab_size, lcfg.embed_dim, lcfg.hidden, lcfg.layers)


def max_len(lm: nn.Module) -> int | None:
    """The transformer LM's KV-cache depth; None for the LSTM LM."""
    return lm.pos.shape[0] if isinstance(lm, TransformerLM) else None


def _device(lm: nn.Module) -> torch.device:
    return lm.embedding.device


def reorder_rows(state: dict, rows: torch.Tensor) -> dict:
    """A state's leaves reordered by flat lattice rows (axis 1)."""
    return {n: x.index_select(1, rows) for n, x in state.items()}


def where_rows(cond: torch.Tensor, new: dict, old: dict) -> dict:
    """``new``'s lattice rows where ``cond`` (one entry a row, any shape
    that flattens to the rows) holds, else ``old``'s."""
    c = cond.reshape(-1)
    return {n: torch.where(c.reshape((1, -1) + (1,) * (x.dim() - 2)), x,
                           old[n]) for n, x in new.items()}


def check_depth(lm: nn.Module, max_u: int, what: str) -> None:
    """A transformer LM's KV cache must outlast ``max_u`` emissions."""
    cache = max_len(lm)
    if cache is not None and max_u >= cache:
        raise ValueError(
            f"{what} with a transformer LM: max_u {max_u} must stay below "
            f"lm.max_len {cache} (KV-cache depth; hypotheses advance the LM "
            "once per emitted label)")


# ---- the LSTM LM ----

def lm_init_state(lm: LSTMLM, batch: int) -> dict:
    hidden = lm.cells[0].w_hh.shape[0]
    z = torch.zeros((len(lm.cells), batch, hidden), dtype=F32,
                    device=_device(lm))
    return {"h": z, "c": z.clone()}


def _logits(lm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return R.mm(x, lm.w_out, F32) + lm.b_out.float()


def lm_step(lm: nn.Module, state: dict | None, tokens: torch.Tensor | None,
            init_batch: int | None = None):
    """The beams' step (module docstring): from ``state`` and the previous
    tokens [B] -> (the new state, logits [B, V] float32)."""
    if isinstance(lm, TransformerLM):
        return transformer_lm_step(lm, state, tokens, init_batch)
    if state is None:
        if init_batch is None:
            raise ValueError("lm_step: give init_batch for a fresh state")
        return lm_init_state(lm, init_batch), None
    x = lm.embedding[tokens.long()].float()
    hs, cs = [], []
    for i, cell in enumerate(lm.cells):
        h, c = R.lstm_single_step(cell.as_dict(), x, state["h"][i],
                                  state["c"][i], F32)
        hs.append(h)
        cs.append(c)
        x = h
    return {"h": torch.stack(hs), "c": torch.stack(cs)}, _logits(lm, x)


def lm_forward(lm: nn.Module, tokens_in: torch.Tensor,
               backend: str | None = None) -> torch.Tensor:
    """Teacher-forced pass over [B, U] -> logits [B, U, V] float32 (each
    LSTM layer one scan on K2 / K3)."""
    if isinstance(lm, TransformerLM):
        return transformer_lm_forward(lm, tokens_in)
    x = lm.embedding[tokens_in.long()].float()
    for cell in lm.cells:
        x = lstm_kernel(cell.as_dict(), x, None, False, F32, backend)
    return _logits(lm, x)


def lm_loss(lm: nn.Module, tokens: torch.Tensor,
            backend: str | None = None) -> torch.Tensor:
    """Next-token CE on EOS-terminated, PAD-padded text [B, U]."""
    # the speller imports this module, and the losses import the speller
    from semi_supervised_asr_tpu_torch.objectives.losses import (
        masked_ce, shift_targets,
    )

    tokens_in, targets = shift_targets(tokens)
    loss, _ = masked_ce(lm_forward(lm, tokens_in, backend), targets)
    return loss


# ---- the transformer LM ----

def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def _ffn(blk, x: torch.Tensor) -> torch.Tensor:
    h2 = _ln(x, blk.ln2_g, blk.ln2_b)
    return x + Fn.gelu(h2 @ blk.w1 + blk.b1, approximate="tanh") @ blk.w2 \
        + blk.b2


def transformer_lm_forward(lm: TransformerLM,
                           tokens_in: torch.Tensor) -> torch.Tensor:
    """Teacher-forced causal pass [B, U] -> [B, U, V] (U <= max_len)."""
    b, u = tokens_in.shape
    if u > lm.pos.shape[0]:
        raise ValueError(f"transformer LM: {u} tokens exceed lm.max_len "
                         f"{lm.pos.shape[0]}")
    x = lm.embedding[tokens_in.long()].float() + lm.pos[:u].float()[None]
    causal = torch.ones((u, u), dtype=torch.bool,
                        device=x.device).tril()
    for blk in lm.blocks:
        h = _ln(x, blk.ln1_g, blk.ln1_b)
        q = torch.einsum("bud,dhe->buhe", h, blk.wq)
        k = torch.einsum("bud,dhe->buhe", h, blk.wk)
        v = torch.einsum("bud,dhe->buhe", h, blk.wv)
        scale = 1.0 / math.sqrt(q.shape[-1])
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        scores = torch.where(causal, scores, NEG_INF)
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        x = _ffn(blk, x + out.reshape(b, u, -1) @ blk.wo)
    return _logits(lm, _ln(x, lm.lnf_g, lm.lnf_b))


def transformer_lm_step(lm: TransformerLM, state: dict | None,
                        tokens: torch.Tensor | None,
                        init_batch: int | None = None):
    """One step with the [L, B, T, D] KV cache.  Positions are per row
    (``tpos`` [1, B]): the LAS beam advances every row each step, the
    transducer and CTC beams only the rows that emit, so each row writes
    its cache at its own depth and attends to its own prefix.  A row past
    the cache's depth writes nothing (its step is one the beams discard)."""
    layers, d = len(lm.blocks), lm.blocks[0].wq.shape[0]
    t_max, dev = lm.pos.shape[0], _device(lm)
    if state is None:
        if init_batch is None:
            raise ValueError("lm_step: give init_batch for a fresh state")
        z = torch.zeros((layers, init_batch, t_max, d), dtype=F32,
                        device=dev)
        return {"kc": z, "vc": z.clone(),
                "tpos": torch.zeros((1, init_batch), dtype=torch.int32,
                                    device=dev)}, None
    b = tokens.shape[0]
    pos = state["tpos"][0].long()                              # [B]
    steps = torch.arange(t_max, device=dev)[None, :]
    write = (steps == pos[:, None])[..., None]                 # [B, T, 1]
    live = steps <= pos[:, None]                               # [B, T]
    x = (lm.embedding[tokens.long()].float()
         + lm.pos.float()[pos.clamp(max=t_max - 1)])           # [B, D]
    kcs, vcs = [], []
    for li, blk in enumerate(lm.blocks):
        n_heads = blk.wq.shape[1]
        h = _ln(x, blk.ln1_g, blk.ln1_b)
        q = torch.einsum("bd,dhe->bhe", h, blk.wq)
        k_new = torch.einsum("bd,dhe->bhe", h, blk.wk).reshape(b, 1, -1)
        v_new = torch.einsum("bd,dhe->bhe", h, blk.wv).reshape(b, 1, -1)
        kc = torch.where(write, k_new, state["kc"][li])
        vc = torch.where(write, v_new, state["vc"][li])
        kcs.append(kc)
        vcs.append(vc)
        kk = kc.reshape(b, t_max, n_heads, -1)
        vv = vc.reshape(b, t_max, n_heads, -1)
        scale = 1.0 / math.sqrt(q.shape[-1])
        scores = torch.einsum("bhd,bkhd->bhk", q, kk) * scale
        scores = torch.where(live[:, None, :], scores, NEG_INF)
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhk,bkhd->bhd", attn, vv)
        x = _ffn(blk, x + out.reshape(b, -1) @ blk.wo)
    logits = _logits(lm, _ln(x, lm.lnf_g, lm.lnf_b))
    return {"kc": torch.stack(kcs), "vc": torch.stack(vcs),
            "tpos": state["tpos"] + 1}, logits
