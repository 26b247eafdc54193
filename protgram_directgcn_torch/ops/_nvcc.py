"""Build a source of ``csrc/`` into a plain-C shared library, and the
checks every kernel wrapper shares.

``compile_source(name)`` runs ``nvcc`` for ``sm_90a`` on ``csrc/<name>.cu``,
and ``compile_host_source(name)`` runs ``g++`` on the host code
``csrc/<name>.cpp``, into ``_build/lib<name>_<hash>.so`` (gitignored), keyed
by the hash of the source and the flags, so a library is built once per
source version.  The modules load the result with ``ctypes`` and declare its
argument types themselves (``c_void_p`` for every pointer and the stream).
Sources include no PyTorch header, so a build takes seconds.  Builds of
different sources may run at the same time (``subprocess`` releases the GIL).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Host code: no FMA contraction and no fast-math, so that float64 sums and
# products round as numpy's do.
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (needed to build the csrc/ kernels for sm_90a)")


def compile_source(name: str) -> Dict[str, object]:
    """Compile ``csrc/<name>.cu`` with nvcc unless a library for its hash
    exists.

    Returns ``{"path", "seconds", "built", "log"}``: ``seconds`` is the nvcc
    wall time (0 when the library already existed) and ``log`` the
    compiler's output (ptxas register/shared-memory report).
    """
    return _compile(CSRC / f"{name}.cu", nvcc(), NVCC_FLAGS)


def compile_host_source(name: str) -> Dict[str, object]:
    """Compile ``csrc/<name>.cpp`` with g++ (``GXX_FLAGS``) unless a library
    for its hash exists; returns what :func:`compile_source` returns."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found (needed to build csrc/{name}.cpp)")
    return _compile(CSRC / f"{name}.cpp", gxx, GXX_FLAGS)


def _compile(source: Path, compiler: str, flags) -> Dict[str, object]:
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()
    path = BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"
    info: Dict[str, object] = {"path": str(path), "seconds": 0.0, "built": False, "log": ""}
    if path.exists():
        return info
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR))
    os.close(fd)
    t0 = time.monotonic()
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed ({proc.returncode}) on {source}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    info.update(seconds=time.monotonic() - t0, built=True, log=proc.stdout + proc.stderr)
    return info


def check_tensor(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``t`` has this shape, dtype and device and is contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} != expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(rc: int, what: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a C entry point returned."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
