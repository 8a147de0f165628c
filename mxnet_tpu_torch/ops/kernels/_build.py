"""Build the CUDA sources under ``mxnet_tpu_torch/csrc`` on first use.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

and is loaded through ``ctypes``.  The sources share ``csrc/dtypes.cuh``
(element types and their f32 conversions).  What ``ptxas -v`` reports
(registers, shared memory and spills of each kernel) is kept in
``BUILD_LOG[name]`` for the builds of this process.  Libraries land in
``build/`` at the repository root, named by a hash of the source, the
headers and the flags, so an edited source rebuilds and an unchanged one
loads at once.  A failed
build raises with nvcc's stderr; there is no fallback.

:func:`build_all` starts one nvcc per source at the same time and waits
for all of them (what ``chip_smoke.py`` calls before anything else);
:func:`load` builds a single source if it is not built yet.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

from ...base import MXNetError

__all__ = ["load", "build_all", "check", "dtype_code", "SOURCES", "CSRC",
           "BUILD_DIR", "BUILD_LOG", "DTYPE_CODES"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("layer_norm", "paged_attention", "flash_attention",
           "softmax_cross_entropy")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the element types the kernels take, by the code their C entry points
# read (csrc/dtypes.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise MXNetError(
            f"nvcc not found (looked in {home}/bin and PATH): the CUDA "
            "kernels are built from source on first use")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):  # every source may include one
        src += header.read_bytes()
    digest = hashlib.sha256(src + repr(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built.
    Returns (target, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, pending) -> None:
    if pending is None:
        return
    proc, tmp = pending
    _, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError(f"nvcc failed for csrc/{name}.cu "
                         f"(exit {proc.returncode}):\n{err}")
    BUILD_LOG[name] = err
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Build every source in parallel (one nvcc each) and load them."""
    names = [n for n in names if n not in _libs]
    with _lock:
        started = [(n, *_start(n)) for n in names]
        errors = []
        for n, out, pending in started:
            try:
                _finish(n, out, pending)
            except MXNetError as e:
                errors.append(str(e))
        if errors:
            raise MXNetError("\n".join(errors))
        for n, out, _ in started:
            _libs[n] = ctypes.CDLL(str(out))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def dtype_code(t, what: str, name: str) -> int:
    """The dtype code of tensor ``t`` for a C entry point, or raise."""
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise MXNetError(f"{what}: the kernel takes {name} as float32, "
                         f"bfloat16 or float16, got {t.dtype}")
    return code


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point of
    ``lib`` (every library exports ``mx_cuda_error_string``)."""
    if err != 0:
        fn = lib.mx_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise MXNetError(f"{what}: CUDA error {err} at launch "
                         f"({fn(err).decode()})")
