"""Build and load the hand-written CUDA kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` to an object, one process per source,
all started together, then links the objects into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), placed in
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
or training path and see that each kernel actually ran.  The LSTM scans
also count each launch under the route that ran it
(``lstm_scan_fwd_cluster`` / ``lstm_scan_fwd_grid`` /
``lstm_scan_fwd_simt``, and the same for ``lstm_scan_bwd``).
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

LAUNCHES: dict[str, int] = {
    "fused_post_fft": 0, "lstm_scan_fwd": 0, "lstm_scan_bwd": 0,
    "flash_mhsa_fwd": 0, "flash_mhsa_bwd": 0,
    "lstm_scan_fwd_cluster": 0, "lstm_scan_fwd_grid": 0,
    "lstm_scan_fwd_simt": 0, "lstm_scan_bwd_cluster": 0,
    "lstm_scan_bwd_grid": 0, "lstm_scan_bwd_simt": 0,
    "lstm_exchange_floor": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# a grid plan's integers: units, groups, rows, sub, chunk, stages
_GRID_PLAN = (_I, _I, _I, _I, _I, _I)
# C signatures of the entry points (argument order as in csrc/*.cu)
_SIGNATURES = {
    "fused_post_fft": [
        _P, _P, _P, _P, _I,          # pspec, band_w, band_lo, band_off, nnz
        _P, _P, _P,                  # mean, inv_std, lens
        _P, _P, _P, _P, _I, _I,      # fs, fw, ts, tw, n_freq, n_time
        _P,                          # out
        _I, _I, _I, _I, _F,          # B, T, F, M, log_floor
        _I, _I, _I, _I,              # rows, groups, stages, blocks_per_sm
        _P,                          # stream
    ],
    "lstm_scan_fwd": [
        _P, _P, _P,                  # gates_x, w_hh, valid
        _P, _P, _P, _P,              # h_out, hprev, cprev, acts (or NULL)
        _P, _P, _P, _P,              # h0, c0, h_fin, c_fin (or NULL)
        _I, _I, _I, _I,              # D, T, B, H
        _I, _I,                      # reverse_mask, w_is_bf16
        _I, _I,                      # cluster, rows (0: CUDA cores)
        _P,                          # stream
    ],
    "lstm_scan_bwd": [
        _P, _P, _P, _P, _P,          # w_t, valid, acts, cprev, dh_out
        _P,                          # dgates
        _I, _I, _I, _I,              # D, T, B, H
        _I, _I,                      # reverse_mask, w_is_bf16
        _I, _I,                      # cluster, rows (0: CUDA cores)
        _P,                          # stream
    ],
    "lstm_scan_fwd_grid": [
        _P, _P, _P,                  # gates_x, w_frag, valid
        _P, _P, _P, _P,              # h_out, hprev, cprev, acts (or NULL)
        _P, _P, _P, _P,              # h0, c0, h_fin, c_fin (or NULL)
        _P, _P,                      # exchange, counters
        _I, _I, _I, _I, _I,          # D, T, B, H, reverse_mask
        *_GRID_PLAN,
        _P,                          # stream
    ],
    "lstm_scan_bwd_grid": [
        _P, _P, _P, _P, _P,          # w_frag, valid, acts, cprev, dh_out
        _P,                          # dgates
        _P, _P,                      # exchange, counters
        _I, _I, _I, _I, _I,          # D, T, B, H, reverse_mask
        *_GRID_PLAN,
        _P,                          # stream
    ],
    "lstm_scan_fwd_occupancy": [_I, _I, _I, _IP],  # H, C, R, out
    "lstm_scan_bwd_occupancy": [_I, _I, _I, _IP],
    # H, units, rows, sub, chunk, stages, blocks an SM, SMs
    "lstm_scan_fwd_grid_occupancy": [_I, _I, _I, _I, _I, _I, _IP, _IP],
    "lstm_scan_bwd_grid_occupancy": [_I, _I, _I, _I, _I, _I, _IP, _IP],
    "lstm_grid_floor": [
        _I, _I, _I, _I, _I, _I,      # backward, read, D, T, B, H
        *_GRID_PLAN,
        _P, _P,                      # exchange, counters
        _P,                          # stream
    ],
    "lstm_exchange_floor": [
        _I, _I, _I, _I, _I,          # backward, D, T, B, H
        _I, _I,                      # cluster, rows
        _P,                          # stream
    ],
    "flash_mhsa_fwd": [
        _P, _P, _P, _P,              # q, k, v, key_mask
        _P, _P, _P,                  # o, m, l
        _I, _I, _I, _I, _F, _I,      # B, T, H, D, sm_scale, is_bf16
        _P,                          # stream
    ],
    "flash_mhsa_bwd": [
        _P, _P, _P, _P, _P, _P,      # q, k, v, key_mask, o, dout
        _P, _P, _P,                  # m, l, delta (scratch)
        _P, _P, _P,                  # dq, dk, dv
        _I, _I, _I, _I, _F, _I,      # B, T, H, D, sm_scale, is_bf16
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


def _run(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands in parallel; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    done = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        done.append(subprocess.CompletedProcess(cmd, proc.returncode, out,
                                                err))
    for res in done:
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(res.args)}\n"
                f"{res.stdout}\n{res.stderr}"
            )
    return done


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source, in parallel, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    extra = ["-Xptxas=-v"] if verbose else []
    compiled = _run([[nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o",
                      str(obj)] for src, obj in zip(_sources(), objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *(str(o) for o in objs)]])
    for obj in objs:
        obj.unlink()
    if verbose:
        print("".join(r.stdout + r.stderr for r in compiled))
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
