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

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def check_tensor(name: str, x, shape, dtype, device) -> None:
    """Refuse an operand a kernel does not take: wrong device, dtype or
    shape, or not contiguous (checked before any pointer is passed)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def _start_build(name: str, so: Path):
    """Start nvcc on csrc/<name>.cu; returns (process, temp output path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a process-unique temp path and rename into place, so two
    # processes racing a first build never load a half-written library
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp


def _finish_build(name: str, so: Path, proc, tmp: Path) -> None:
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc timed out building {name}.cu")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}.cu:\n{out}\n{err}")
    os.replace(tmp, so)


def _stale(so: Path) -> bool:
    newest_src = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return not so.exists() or so.stat().st_mtime < newest_src


def load_all(names) -> Dict[str, ctypes.CDLL]:
    """The ctypes handles of csrc/<name>.cu for every name; the libraries
    that need a build compile in parallel (one nvcc each, all started
    together), so a caller that needs several libraries at once, such as
    chip_smoke.py within its time limit, waits only for the slowest."""
    with _lock:
        pending, failure = [], None
        for name in names:
            if name in _libs:
                continue
            so = _library_path(name)
            if not _stale(so):
                _libs[name] = ctypes.CDLL(str(so))
                continue
            try:
                pending.append((name, so, *_start_build(name, so)))
            except RuntimeError as e:            # no nvcc
                failure = failure or e
        for name, so, proc, tmp in pending:      # wait for every nvcc
            try:
                _finish_build(name, so, proc, tmp)
                _libs[name] = ctypes.CDLL(str(so))
            except RuntimeError as e:
                failure = failure or e
        if failure is not None:
            raise failure
        return {name: _libs[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built first if needed."""
    return load_all([name])[name]
