"""ctypes bindings of the native data loader, cpp/fastloader.cpp at the
repository root (the source the JAX package's loader builds too).

The library compiles with g++ at first use into fastloader.so in the
kernel build cache (`library_path()`: utils/compcache.build_dir(), by
default build/wavenet_tpu_torch/, beside the port's CUDA libraries and
apart from the JAX package's build/fastloader.so, so the two packages never
race on one file), and again whenever the source is newer.  It builds into
a process-unique temporary name and is renamed into place, since several
processes (test workers, training ranks) may build it at once.  A failed
build raises with the compiler's message: there is no quiet fallback, and
the NumPy loop runs only where a caller asks for it
(AudioDataset(native=False)).  No -march=native, so a build directory
copied to another x86-64 host still works there; a library that does not
load (built for another platform) is rebuilt once.

Every function is bit-identical to its NumPy mirror (audio/mulaw.py,
AudioDataset's NumPy loop).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from wavenet_tpu_torch.utils import compcache

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "cpp" / "fastloader.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library is built and loaded from."""
    return compcache.build_dir() / "fastloader.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cannot build {SRC} with g++: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building {SRC}:\n{r.stdout}\n"
                           f"{r.stderr}")
    os.replace(tmp, so)


def library() -> ctypes.CDLL:
    """The loaded library, built first if it is missing or older than its
    source; raises RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists() or so.stat().st_mtime < SRC.stat().st_mtime:
            _build(so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            # a library built on another host (a copied build directory)
            _build(so)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise RuntimeError(f"cannot load {so}: {e}") from e
        compcache.mark_loaded(so.parent)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.mulaw_encode.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                     i32p]
        lib.mulaw_decode.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                     f32p]
        lib.gather_windows.argtypes = [i32p, i64p, i32p, i64p,
                                       ctypes.c_int64, ctypes.c_int64, i32p,
                                       ctypes.c_int32]
        for f in (lib.mulaw_encode, lib.mulaw_decode, lib.gather_windows):
            f.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads on this machine."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def mulaw_encode(x: np.ndarray, quantization_channels: int = 256
                 ) -> np.ndarray:
    """mulaw.encode_np, natively: float waveform -> int32 class ids."""
    lib = library()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.int32)
    lib.mulaw_encode(x.reshape(-1), x.size, quantization_channels,
                     out.reshape(-1))
    return out


def mulaw_decode(q: np.ndarray, quantization_channels: int = 256
                 ) -> np.ndarray:
    """mulaw.decode_np, natively: int32 class ids -> float32 waveform."""
    lib = library()
    q = np.ascontiguousarray(q, np.int32)
    out = np.empty(q.shape, np.float32)
    lib.mulaw_decode(q.reshape(-1), q.size, quantization_channels,
                     out.reshape(-1))
    return out


class WindowGatherer:
    """The clips concatenated once into one int32 buffer, and a batched
    window gather out of it.  The library is loaded (built if needed) at
    construction, so a missing toolchain fails there."""

    def __init__(self, clips: Sequence[np.ndarray]):
        self._lib = library()
        self.lengths = np.asarray([len(c) for c in clips], np.int64)
        self.offsets = np.zeros(len(clips), np.int64)
        np.cumsum(self.lengths[:-1], out=self.offsets[1:])
        self.flat = np.ascontiguousarray(
            np.concatenate([np.asarray(c, np.int32) for c in clips]))

    def gather(self, clip_idx: np.ndarray, starts: np.ndarray, window: int,
               num_threads: int = 4) -> np.ndarray:
        """out[b] = clips[clip_idx[b]][starts[b]:starts[b] + window]."""
        clip_idx = np.ascontiguousarray(clip_idx, np.int32)
        starts = np.ascontiguousarray(starts, np.int64)
        # the library checks no bounds: a bad draw would copy the next
        # clip's tokens (valid ids, wrong training data)
        if clip_idx.shape != starts.shape or clip_idx.ndim != 1:
            raise ValueError("clip_idx and starts must be 1-D of one length")
        if clip_idx.size:
            if clip_idx.min() < 0 or clip_idx.max() >= len(self.lengths):
                raise IndexError("clip_idx out of range")
            if (starts < 0).any() or (
                    starts + window > self.lengths[clip_idx]).any():
                raise IndexError("window overruns clip")
        out = np.empty((len(clip_idx), window), np.int32)
        # thread spawn and join cost more than the copy below ~1 MiB
        if out.nbytes < (1 << 20):
            num_threads = 1
        self._lib.gather_windows(self.flat, self.offsets, clip_idx, starts,
                                 len(clip_idx), window, out, num_threads)
        return out
