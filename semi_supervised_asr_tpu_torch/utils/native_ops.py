"""Batched edit distance through the native C++ kernel
(``native/edit_distance.cpp``).

The PyTorch port's copy of ``semi_supervised_asr_tpu/utils/native_ops.py``.
The shared library is compiled by ``g++`` at first use into the git-ignored
``_build/`` (as the FLAC reader is) and bound with ctypes (a C ABI over
int32 buffers).  A failed build raises: scoring never falls back silently.
:func:`batch_edit_distance_py` is the plain numpy version the tests hold
the kernel against.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "edit_distance.cpp"
_SO = _PKG / "_build" / "libedit_distance.so"

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _SO.parent.mkdir(parents=True, exist_ok=True)
            tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(str(_SO))
    except Exception as e:
        raise RuntimeError(f"native edit distance unavailable: {e}") from e
    lib.batch_edit_distance.restype = None
    lib.batch_edit_distance.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def _as_i32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x), dtype=np.int32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _edit_distance_py(a: np.ndarray, b: np.ndarray) -> int:
    """Rolling-row Levenshtein distance in numpy."""
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    row = np.arange(lb + 1, dtype=np.int32)
    for i in range(1, la + 1):
        prev_diag = row[0]
        row[0] = i
        for j in range(1, lb + 1):
            cur = row[j]
            row[j] = min(
                prev_diag + (a[i - 1] != b[j - 1]),
                cur + 1,
                row[j - 1] + 1,
            )
            prev_diag = cur
    return int(row[lb])


def _map_seq_py(seq: np.ndarray, table: np.ndarray | None) -> np.ndarray:
    if table is None:
        return seq
    valid = (seq >= 0) & (seq < len(table))
    mapped = table[np.clip(seq, 0, len(table) - 1)]
    return mapped[valid & (mapped >= 0)]


def batch_edit_distance(
    hyps: np.ndarray,        # [B, Uh] int padded
    hyp_lens: np.ndarray,    # [B]
    refs: np.ndarray,        # [B, Ur] int padded
    ref_lens: np.ndarray,    # [B]
    fold_table: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """-> (distances [B], folded ref lengths [B]).

    If ``fold_table`` is given (e.g. vocab.timit_39_id_map), both sides are
    mapped through it first; -1 entries delete the token (TIMIT 'q',
    specials).
    """
    hyps, refs = _as_i32(hyps), _as_i32(refs)
    hyp_lens, ref_lens = _as_i32(hyp_lens), _as_i32(ref_lens)
    b = hyps.shape[0]
    assert refs.shape[0] == b
    lib = _load()
    out = np.zeros(b, np.int32)
    reflen = np.zeros(b, np.int32)
    table = _as_i32(fold_table) if fold_table is not None else None
    lib.batch_edit_distance(
        _ptr(hyps), _ptr(hyp_lens), hyps.shape[1],
        _ptr(refs), _ptr(ref_lens), refs.shape[1], b,
        _ptr(table) if table is not None else None,
        len(table) if table is not None else 0,
        _ptr(out), _ptr(reflen),
    )
    return out, reflen


def batch_edit_distance_py(hyps, hyp_lens, refs, ref_lens,
                           fold_table=None) -> tuple[np.ndarray, np.ndarray]:
    """:func:`batch_edit_distance` in plain numpy (the tests' yardstick)."""
    hyps, refs = _as_i32(hyps), _as_i32(refs)
    hyp_lens, ref_lens = _as_i32(hyp_lens), _as_i32(ref_lens)
    table = _as_i32(fold_table) if fold_table is not None else None
    b = hyps.shape[0]
    out = np.zeros(b, np.int32)
    reflen = np.zeros(b, np.int32)
    for i in range(b):
        a = _map_seq_py(hyps[i, : hyp_lens[i]], table)
        r = _map_seq_py(refs[i, : ref_lens[i]], table)
        out[i] = _edit_distance_py(a, r)
        reflen[i] = len(r)
    return out, reflen
