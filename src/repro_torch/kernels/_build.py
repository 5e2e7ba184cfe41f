"""Build the CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file is a plain-C-interface shared library, compiled
with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``build/repro_torch/<name>-<hash>.so`` under the checkout root,
keyed by a hash of the source and the flags, at first use. Every source
builds in its own ``nvcc`` process, all started together. Never add
``--use_fast_math``: it turns ``x / sa`` and the rounding of the exact
kernels into approximations.

Nothing here runs at import time: the wrappers call :func:`library` the
first time they launch a kernel, so the CPU tests import every module
without a compiler. Where ``nvcc`` is missing, :func:`library` raises;
it never hands back a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("qmm", "fused_dequant", "mpmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every exported entry: (argtypes, restype)
SIGNATURES = {
    "qmm": {
        # a, b, out, M, N, K, mt, bn, splits, kc, a_vec, w_vec, stream
        "qmm_launch": [_P, _P, _P] + [_I] * 9 + [_P],
        # x, w, sw, sa, out, M, N, K, fused, packed, mt, splits, kc,
        # x_vec, w_vec, stream
        "int_tc_launch": [_P] * 5 + [_I] * 10 + [_P],
    },
    "fused_dequant": {
        # x, w, sw, sa, out, M, N, K, G, kind, act, rows, bn, splits,
        # kc, vec, stream
        "fused_dequant_launch": [_P] * 5 + [_I] * 11 + [_P],
    },
    "mpmm": {
        # a, b, out, M, N, K, g, w, thresh, fused, floor, exp_bits,
        # mant_bits, rows, bn, splits, vec, stream
        "mpmm_launch": [_P, _P, _P] + [_I] * 14 + [_P],
    },
}

# the CUDA toolkit's usual home, tried after $CUDA_HOME and PATH
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    """``build/repro_torch`` under the checkout root (the directory that
    holds ``src/``)."""
    return CSRC.parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    candidates: List[Optional[str]] = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of repro_torch cannot be "
        "built. CPU tensors take the plain PyTorch versions; CUDA tensors "
        "need the kernels.")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel (one ``nvcc`` per
    source). Returns {name: ptxas report} for the sources it built.
    Raises with the compiler's output when a build fails."""
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builds agree
        out.with_suffix(".log").write_text(log)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building every source
    first if this one is not built yet."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with "
                           f"cudaError_t {err}")
