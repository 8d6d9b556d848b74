"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

Each .cu file compiles on first use into a shared library with a plain C
interface under build/wavenet_tpu_torch/ at the repository root, for
sm_90a (Hopper).  The library's file name carries a hash of the sources and
flags, so an edited source (or header) builds a new library; a source newer
than its library also rebuilds it.  No torch headers are compiled in, which
keeps a build to seconds.  A build or load failure raises: there is no
fallback to the plain PyTorch path on a CUDA device.

Flags: no --use_fast_math (it would swap logf/expf/tanhf for approximations
and change the sampled tokens), and --fmad=false, so a * b + c is never
contracted into one fused multiply-add where the reference rounds the
product first (the sampler's logits * (1/T) + gumbel).  Explicit fmaf()
calls still compile to FMAs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]          # wavenet_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "wavenet_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Plain count of kernel launches, bumped by a wrapper right where it
    launches its kernel (thread-safe: the server decodes on two threads)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):          # .cu and .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a process-unique temp path and rename into place, so two
    # processes racing a first build never load a half-written library
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}.cu:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = _library_path(name)
        newest_src = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
        if not so.exists() or so.stat().st_mtime < newest_src:
            _build(name, so)
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib
