"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc into
`build/kernels/lib<name>.so` at the root of the checkout, then loaded with
ctypes.  Nothing is compiled or loaded at import: the first caller builds
(`load_library`), and `build_all` starts one nvcc per source at once.  A
library is rebuilt when the sha256 of its source and flags differs from
the stamp written beside it.  The check, the build and the stamp run
under an fcntl lock on a file beside the stamp, so processes that share the
build directory (the ranks of a mesh on one host) build each library once
and load it only when it is complete.  `check_tensor`, `check_aligned`,
`launch` and
`kernel_info` are the wrappers' shared input checks, launch call and
compiled-kernel report.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("chyp_rank", "chyp_train", "chyp_queries", "hyp_rank", "hyp_queries", "segsum",
           "gather", "relgrad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong
_IP = ctypes.POINTER(ctypes.c_int)


def _with_bf16(sigs: dict) -> dict:
    """The launchers and their bf16 instances (`<name>_bf16`, precision
    "default"), which take the same arguments."""
    return {**sigs, **{f"{k}_bf16": v for k, v in sigs.items()}}


# argtypes of every exported launcher; pointers and the stream are c_void_p
SIGNATURES = {
    "chyp_rank": {
        **_with_bf16({
            "chyp_rank_sweep_masked": [_P] * 8 + [_I] * 4 + [_F, _P],
            "chyp_rank_sweep_nomask": [_P] * 8 + [_I] * 4 + [_F, _P],
            "chyp_rank_filtered_sub": [_P] * 9 + [_I] * 5 + [_F, _P],
        }),
        "chyp_rank_sweep_info": [_I] * 2 + [_IP] * 4,
        "chyp_rank_sweep_bf16_info": [_I] * 2 + [_IP] * 4,
        # the proof of the bf16 sweep's epilogue
        "chyp_rank_scores_bf16": [_P] * 7 + [_I] * 4 + [_F, _I, _P],
    },
    "chyp_train": {
        "chyp_train_fwd": [_P] * 9 + [_I] * 4 + [_F, _F, _P],
        "chyp_train_bwd": [_P] * 13 + [_I] * 4 + [_F, _P],
        "chyp_train_lists": [_P] * 12 + [_I] * 4 + [_F, _P],
        "chyp_train_lists_blocks": [_IP],
    },
    "chyp_queries": {
        "fftroth_queries_fwd": [_P] * 6 + [_I] + [_P] * 3 + [_I] * 5 + [_P],
        "fftroth_queries_bwd": [_P] * 5 + [_I] + [_P] * 13 + [_I] * 5 + [_P],
    },
    "hyp_rank": {
        **_with_bf16({
            "hyp_rank_sweep_masked": [_P] * 11 + [_I] * 5 + [_P],
            "hyp_rank_sweep_nomask": [_P] * 11 + [_I] * 5 + [_P],
            "hyp_rank_filtered_sub": [_P] * 10 + [_I] * 5 + [_F, _P],
            "attrh_rank_sweep_masked": [_P] * 15 + [_I] * 4 + [_P],
            "attrh_rank_sweep_nomask": [_P] * 15 + [_I] * 4 + [_P],
            "attrh_rank_filtered_sub": [_P] * 14 + [_I] * 4 + [_P],
        }),
        "hyp_rank_radii": [_P] * 4 + [_I] * 3 + [_F, _P],
        "hyp_rank_sweep_info": [_I] * 3 + [_IP] * 4,
        "hyp_rank_sweep_bf16_info": [_I] * 3 + [_IP] * 4,
        # the proofs of the bf16 sweeps' epilogue and of its fast paths
        "hyp_rank_scores_bf16": [_P] * 9 + [_I] * 6 + [_P],
        "attrh_rank_scores_bf16": [_P] * 13 + [_I] * 5 + [_P],
        "hyp_rank_fast_arith_sweep": [_U64, _U64, _P, _P],
    },
    "hyp_queries": {
        "roth_rank_queries": [_P] * 6 + [_I] + [_P] * 5 + [_I] * 7 + [_F, _P],
    },
    "segsum": {f"segsum_{t}": [_P] * 3 + [_I, _I, _P] for t in ("f32", "f64", "bf16")},
    "gather": {f"row_gather_{t}": [_P] * 3 + [_I, _I, _P] for t in ("f32", "f64", "bf16")},
    "relgrad": {f"relgrad_{t}": [_P] * 6 + [_I] * 5 + [_P] for t in ("f32", "f64")},
}

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}  # name -> nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # CUDA_HOME, or nvcc's usual home

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return h.hexdigest()


def _paths(name: str):
    so = BUILD_DIR / f"lib{name}.so"
    return so, so.with_name(so.name + ".sha256")


def _is_current(name: str) -> bool:
    so, stamp = _paths(name)
    return so.exists() and stamp.exists() and stamp.read_text() == _digest(name)


def _start(name: str) -> subprocess.Popen:
    so, _ = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen):
    out, _ = proc.communicate()
    build_logs[name] = out
    so, stamp = _paths(name)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, so)
    stamp.write_text(_digest(name))


@contextlib.contextmanager
def _file_locks(names):
    """Exclusive fcntl locks on lib<name>.so.lock for each name, taken in
    sorted order (so two processes never wait on each other crosswise)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with contextlib.ExitStack() as stack:
        for n in sorted(set(names)):
            f = stack.enter_context(open(_paths(n)[0].with_suffix(".so.lock"), "a"))
            fcntl.flock(f, fcntl.LOCK_EX)  # released when the file closes
        yield


def build_all(names=SOURCES):
    """Compile every stale library, one nvcc per source, all in parallel."""
    with _lock, _file_locks(names):
        procs = {n: _start(n) for n in names if not _is_current(n)}
        errors = []
        for n, proc in procs.items():
            try:
                _finish(n, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if stale; argtypes set."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_paths(name)[0]))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


# ------------------------------ launch helpers --------------------------------


def check_tensor(name, t, dtype, shape, device):
    """Raise unless `t` is a contiguous tensor of `dtype` and `shape` on
    `device`: what a kernel takes, checked before a pointer is passed."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(**tensors):
    """Raise unless each tensor starts on a 16-byte boundary: the sweeps
    copy per-row vectors (and read tables) with 16-byte loads."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def kernel_info(lib_name: str, fn: str, device, *args, n: int = 4) -> list:
    """The n ints that info function `fn` of library `lib_name` writes
    through its trailing pointers for `args` on `device` (what the CUDA
    runtime reports of a compiled kernel); raise if it fails."""
    vals = [ctypes.c_int() for _ in range(n)]
    with torch.cuda.device(device):
        rc = getattr(load_library(lib_name), fn)(*args, *[ctypes.byref(v) for v in vals])
    if rc != 0:
        raise RuntimeError(f"{fn} failed: cudaError {rc}")
    return [v.value for v in vals]


def launch(lib_name: str, fn: str, device, *args):
    """Call launcher `fn` of library `lib_name` with `args` (tensors become
    their data pointers) and the stream current on `device` at call time,
    which on the autograd engine's thread is the backward's stream; raise
    if it did not launch."""
    lib = load_library(lib_name)
    cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor) else a
             for a in args]
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        rc = getattr(lib, fn)(*cargs, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: cudaError {rc}")
