"""Build and load the hand-written CUDA kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), placed in
``_build/`` under a name that hashes the sources, the shared headers
(``csrc/*.cuh``) and the flags: an edited source is rebuilt, an unchanged
one is reused.  The library is loaded with
``ctypes``; every pointer and the stream go through ``c_void_p``.

Nothing here runs at import time: the first kernel launch builds and loads.
Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code
into an exception.

``LAUNCHES`` counts kernel launches per kernel name.  Only the wrappers'
launch sites increment it, so a caller can reset it, drive the serving
or training path and see that each kernel actually ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: dict[str, int] = {"fused_post_fft": 0, "lstm_scan_fwd": 0,
                             "lstm_scan_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (argument order as in csrc/*.cu)
_SIGNATURES = {
    "fused_post_fft": [
        _P, _P, _P, _P, _I,          # pspec, band_w, band_lo, band_off, nnz
        _P, _P, _P,                  # mean, inv_std, lens
        _P, _P, _P, _P, _I, _I,      # fs, fw, ts, tw, n_freq, n_time
        _P,                          # out
        _I, _I, _I, _I, _F,          # B, T, F, M, log_floor
        _P,                          # stream
    ],
    "lstm_scan_fwd": [
        _P, _P, _P,                  # gates_x, w_hh, valid
        _P, _P, _P, _P,              # h_out, hprev, cprev, acts (or NULL)
        _I, _I, _I, _I,              # D, T, B, H
        _I, _I,                      # reverse_mask, w_is_bf16
        _P,                          # stream
    ],
    "lstm_scan_bwd": [
        _P, _P, _P, _P, _P,          # w_t, valid, acts, cprev, dh_out
        _P,                          # dgates
        _I, _I, _I, _I,              # D, T, B, H
        _I, _I,                      # reverse_mask, w_is_bf16
        _P,                          # stream
    ],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels in "
            f"{CSRC} are compiled at first use"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libssasr_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources())]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check(name: str, code: int) -> None:
    """Raise on a CUDA error code returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {code}")


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def use_kernel(t: torch.Tensor, backend: str | None) -> bool:
    """Kernel-or-plain decision shared by every wrapper.

    ``backend=None``: the kernel for a CUDA tensor, the plain version for a
    CPU tensor (the only way a plain version runs without being asked).
    ``backend="reference"``: the plain version, on any device.  Nothing on
    the serving path passes it; ``Recognizer`` threads it down so that a
    check can run the whole path on the plain versions on the card.
    """
    if backend == "reference":
        return False
    if backend is not None:
        raise ValueError(f"backend must be None or 'reference', "
                         f"got {backend!r}")
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False
