"""The kernel build cache: where the port's compiled libraries are built and
reused across processes.

Counterpart of wavenet_tpu/utils/compcache.py, which points JAX's
persistent compilation cache at a directory so that a restart does not
recompile its executables.  The port compiles too, at first use: nvcc
builds each CUDA source under csrc/ into a shared library
(ops/cuda/build.py) and g++ builds the native data loader
(cpp/loader.py).  Both read their directory from `build_dir()`, and a
library already there (same sources and flags) is loaded, not rebuilt, so
the cost of a build is paid once per directory, not once per process.

Usage: `compcache.enable(DIR)` before the first kernel launch, or
`--compile-cache [DIR]` on the generate, serve and train CLIs.  DIR
defaults to `default_dir()`: $WAVENET_TPU_COMPILE_CACHE, else
build/wavenet_tpu_torch/ under the repository root (listed in .gitignore),
which is also where everything builds when nothing is enabled.

Once a library has been loaded from a directory, that directory is fixed
for the process: enable() of another one raises, so a process never loads
some libraries from one directory and the rest from another.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Optional

_REPO = Path(__file__).resolve().parents[2]
_DEFAULT = _REPO / "build" / "wavenet_tpu_torch"

_lock = threading.Lock()
_enabled: Optional[Path] = None      # set by enable()
_loaded: Optional[Path] = None       # fixed by the first library loaded


def default_dir() -> str:
    """$WAVENET_TPU_COMPILE_CACHE, else build/wavenet_tpu_torch/ at the
    repository root."""
    return os.environ.get("WAVENET_TPU_COMPILE_CACHE") or str(_DEFAULT)


def build_dir() -> Path:
    """The directory libraries build into and load from: the one a load
    fixed, else the enabled one, else default_dir()."""
    with _lock:
        return Path(_loaded or _enabled or default_dir())


def enable(path: Optional[str] = None) -> str:
    """Build and load the port's libraries in `path` (default_dir() when
    None or empty) and return it as an absolute path.  Idempotent; raises
    RuntimeError once a library was loaded from another directory."""
    global _enabled
    d = Path(os.path.abspath(path or default_dir()))
    with _lock:
        if _loaded is not None and _loaded != d:
            raise RuntimeError(
                f"kernel build cache: libraries were already loaded from "
                f"{_loaded}; enable() must come before the first load")
        d.mkdir(parents=True, exist_ok=True)
        _enabled = d
    return str(d)


def enabled_dir() -> Optional[str]:
    """The directory enable() set, or None when it was not called."""
    with _lock:
        return None if _enabled is None else str(_enabled)


def mark_loaded(directory: Path) -> None:
    """Record that a library was loaded from `directory` (the loaders call
    this after each load); raises RuntimeError if an earlier one came from
    another directory."""
    global _loaded
    d = Path(os.path.abspath(directory))
    with _lock:
        if _loaded is not None and _loaded != d:
            raise RuntimeError(f"kernel build cache: a library was loaded "
                               f"from {d} after others from {_loaded}")
        _loaded = d


def add_cli_flag(parser) -> None:
    """Attach the shared --compile-cache flag to an argparse parser."""
    parser.add_argument(
        "--compile-cache", nargs="?", const="", default=None, metavar="DIR",
        help="build the CUDA kernels and the native loader in DIR and reuse "
             "them across processes; DIR defaults to "
             "$WAVENET_TPU_COMPILE_CACHE or build/wavenet_tpu_torch")


def enable_from_args(args) -> Optional[str]:
    """Honour the --compile-cache flag if it was given."""
    val = getattr(args, "compile_cache", None)
    if val is None:
        return None
    return enable(val or None)
