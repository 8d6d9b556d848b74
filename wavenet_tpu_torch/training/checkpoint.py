"""Checkpoint and exact resume: one torch.save file per step.

The port's own format (the GPU machine has no orbax): ckpt_<step>.pt holds
params, optimizer state and EMA (flat leaves under '/'-joined names, so a
mel model's upsampler is "upsampler/w0", ...), the step and the data
iterator's (seed, step), written to a temp file of its own and then
os.replace'd, so a reader sees either nothing or a whole checkpoint.
params.json (the config) sits beside the files, as in the reference, with
the same architecture guard and max_to_keep.

Saves are asynchronous by default, as the reference's are: save() copies
the state to the host on the calling thread (the next optimizer step may
replace or overwrite the device tensors) and hands the write to one
writer thread, which writes every save of the process first in, first
out, and prunes to max_to_keep only after a file has landed.  Reads
(latest_step, all_steps, restore) first wait out every pending save to
their directory made by this process, even one from a manager the caller
has dropped (the per-directory registry _PENDING, the reference's).  A
save that failed raises its error from its manager's next save() or
wait(), and from any read that waited for it.

Under data parallelism only rank 0's manager writes (writer=True, the
config and the checkpoints, as the reference's process 0 writes the
config); the other ranks' managers read the same directory and refuse to
save.

Counterpart of wavenet_tpu/training/checkpoint.py::CheckpointManager
(save, restore, latest_step, wait, load_config).
"""

from __future__ import annotations

import concurrent.futures
import itertools
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from wavenet_tpu_torch.audio.dataset import IteratorState
from wavenet_tpu_torch.config import WaveNetConfig

_FILE = re.compile(r"^ckpt_(\d+)\.pt$")

# pending saves per directory (strong references: a save stays visible to
# readers after its manager is dropped) and the one writer thread (started
# by the first save; the interpreter waits for it at exit)
_PENDING: Dict[str, List[concurrent.futures.Future]] = {}
_LOCK = threading.Lock()
_WRITER = concurrent.futures.ThreadPoolExecutor(
    1, thread_name_prefix="checkpoint-writer")
_TMP_IDS = itertools.count()


def _settle(futures, directory: str) -> None:
    """Wait for `futures`, drop them from the directory's registry, and
    raise the first one's error."""
    concurrent.futures.wait(futures)
    with _LOCK:
        left = [f for f in _PENDING.get(directory, ()) if f not in futures]
        if left:
            _PENDING[directory] = left
        else:
            _PENDING.pop(directory, None)
    for f in futures:
        if f.exception() is not None:
            raise RuntimeError(
                f"a checkpoint save to {directory} failed") from f.exception()


def _wait_directory(directory: str) -> None:
    """Block until every save to `directory` made by this process so far
    has landed (another process's saves are invisible here, but each lands
    by os.replace: a reader sees nothing or a whole file)."""
    with _LOCK:
        futures = list(_PENDING.get(directory, ()))
    _settle(futures, directory)


def _listed_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):        # a reader before rank 0 made it
        return []
    return sorted(int(m.group(1)) for m in map(_FILE.match,
                                               os.listdir(directory)) if m)


def _write(payload: dict, path: str, directory: str,
           max_to_keep: int) -> None:
    """The writer's job: the file, then the pruning of older ones."""
    tmp = f"{path}.{os.getpid()}.{next(_TMP_IDS)}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    for old in _listed_steps(directory)[:-max_to_keep]:
        os.remove(os.path.join(directory, f"ckpt_{old:08d}.pt"))


def _to_cpu(tree):
    """A host copy of every tensor of `tree` (a copy even of a host
    tensor, so later in-place updates cannot reach the saved one)."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class CheckpointManager:
    # every field that changes the parameter tree's shapes or the meaning
    # of the stored values (the reference's list)
    _ARCH_FIELDS = ("num_blocks", "max_dilation", "kernel_size",
                    "residual_channels", "skip_channels", "causal_channels",
                    "quantization_channels", "sample_rate", "param_dtype",
                    "mel", "global_classes", "global_channels")

    def __init__(self, directory: str, cfg: WaveNetConfig,
                 max_to_keep: int = 3, writer: bool = True):
        """writer=False: a reader of the directory (a data-parallel rank
        other than 0), which creates and writes nothing."""
        self.directory = os.path.abspath(directory)
        self.writer = writer
        if writer:
            os.makedirs(self.directory, exist_ok=True)
        self.cfg = cfg
        self.max_to_keep = max_to_keep
        self._pending: List[concurrent.futures.Future] = []
        cfg_path = os.path.join(self.directory, "params.json")
        if os.path.exists(cfg_path):
            # a stale architecture config would mis-restore: refuse to mix
            # model shapes in one directory (training-schedule fields may
            # differ across resumes)
            with open(cfg_path) as f:
                existing = WaveNetConfig.from_json(f.read())
            diff = [k for k in self._ARCH_FIELDS
                    if getattr(existing, k) != getattr(cfg, k)]
            if diff:
                raise ValueError(
                    f"{cfg_path} was written for a different model "
                    f"architecture (fields differ: {diff}); use a fresh "
                    f"checkpoint directory")
        elif writer:
            tmp = f"{cfg_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(cfg.to_json())
            os.replace(tmp, cfg_path)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        _wait_directory(self.directory)
        return _listed_steps(self.directory)

    def save(self, step: int, state: Dict[str, Any],
             iter_state: IteratorState, wait: bool = False) -> None:
        """Save `state` (params, opt_state, ema: dicts of tensors or None)
        for `step`.  Returns once the host copy is taken; the file lands in
        the background, or before returning with wait=True.  Raises the
        error of an earlier save of this manager that failed."""
        if not self.writer:
            raise RuntimeError(f"this manager only reads {self.directory} "
                               f"(rank 0 writes the checkpoints)")
        self._raise_failed()
        payload = {k: _to_cpu(v) for k, v in state.items()}
        payload["step"] = int(step)
        payload["iterator"] = {"seed": int(iter_state.seed),
                               "step": int(iter_state.step)}
        fut = _WRITER.submit(_write, payload, self._path(step),
                               self.directory, self.max_to_keep)
        with _LOCK:
            _PENDING.setdefault(self.directory, []).append(fut)
        self._pending.append(fut)
        if wait:
            self.wait()

    def _raise_failed(self) -> None:
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        _settle(done, self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        if steps:
            return steps[-1]
        self._refuse_orbax()
        return None

    def _refuse_orbax(self) -> None:
        """A directory of the JAX package's orbax checkpoints (numbered step
        directories) is not readable here: say how to carry it over."""
        if os.path.isdir(self.directory) and any(
                n.isdigit() and os.path.isdir(os.path.join(self.directory, n))
                for n in os.listdir(self.directory)):
            raise ValueError(
                f"{self.directory} holds JAX (orbax) checkpoints, which the "
                f"port cannot read; export the weights with the JAX "
                f"package's WaveNet.export_npz and load the .npz instead")

    def restore(self, step: Optional[int] = None, device="cuda"
                ) -> Tuple[Dict[str, Any], IteratorState]:
        """(state dict with params, opt_state, ema, step; IteratorState).
        Only this program's own files are read (weights_only loading)."""
        _wait_directory(self.directory)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self._path(step), map_location=device,
                             weights_only=True)
        it = payload.pop("iterator")
        return payload, IteratorState(seed=it["seed"], step=it["step"])

    def wait(self) -> None:
        """Block until every save of this manager has landed; raise the
        error of one that failed."""
        pending, self._pending = self._pending, []
        _settle(pending, self.directory)

    @staticmethod
    def load_config(directory: str) -> WaveNetConfig:
        with open(os.path.join(directory, "params.json")) as f:
            return WaveNetConfig.from_json(f.read())
