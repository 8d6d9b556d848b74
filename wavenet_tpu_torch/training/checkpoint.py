"""Checkpoint and exact resume: one torch.save file per step.

The port's own format (the GPU machine has no orbax): ckpt_<step>.pt holds
params, optimizer state and EMA (flat leaves under '/'-joined names, so a
mel model's upsampler is "upsampler/w0", ...), the step and the data
iterator's (seed, step), written to a temp file and then os.replace'd, so a reader sees
either nothing or a whole checkpoint.  params.json (the config) sits
beside the files, as in the reference, with the same architecture guard
and max_to_keep.  Saves are synchronous: save() returns once the file is
in place (the reference saves asynchronously; ROADMAP queue 1 item 5).

Counterpart of wavenet_tpu/training/checkpoint.py::CheckpointManager
(save, restore, latest_step, wait, load_config).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from wavenet_tpu_torch.audio.dataset import IteratorState
from wavenet_tpu_torch.config import WaveNetConfig

_FILE = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


class CheckpointManager:
    # every field that changes the parameter tree's shapes or the meaning
    # of the stored values (the reference's list)
    _ARCH_FIELDS = ("num_blocks", "max_dilation", "kernel_size",
                    "residual_channels", "skip_channels", "causal_channels",
                    "quantization_channels", "sample_rate", "param_dtype",
                    "mel", "global_classes", "global_channels")

    def __init__(self, directory: str, cfg: WaveNetConfig,
                 max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.cfg = cfg
        self.max_to_keep = max_to_keep
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
        else:
            tmp = f"{cfg_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(cfg.to_json())
            os.replace(tmp, cfg_path)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_FILE.match,
                                                   os.listdir(self.directory))
                      if m)

    def save(self, step: int, state: Dict[str, Any],
             iter_state: IteratorState) -> None:
        """Write `state` (params, opt_state, ema: dicts of tensors or None)
        for `step`; returns once the file is in place."""
        payload = {k: _to_cpu(v) for k, v in state.items()}
        payload["step"] = int(step)
        payload["iterator"] = {"seed": int(iter_state.seed),
                               "step": int(iter_state.step)}
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        if steps:
            return steps[-1]
        self._refuse_orbax()
        return None

    def _refuse_orbax(self) -> None:
        """A directory of the JAX package's orbax checkpoints (numbered step
        directories) is not readable here: say how to carry it over."""
        if any(n.isdigit() and os.path.isdir(os.path.join(self.directory, n))
               for n in os.listdir(self.directory)):
            raise ValueError(
                f"{self.directory} holds JAX (orbax) checkpoints, which the "
                f"port cannot read; export the weights with the JAX "
                f"package's WaveNet.export_npz and load the .npz instead")

    def restore(self, step: Optional[int] = None, device="cuda"
                ) -> Tuple[Dict[str, Any], IteratorState]:
        """(state dict with params, opt_state, ema, step; IteratorState).
        Only this program's own files are read (weights_only loading)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self._path(step), map_location=device,
                             weights_only=True)
        it = payload.pop("iterator")
        return payload, IteratorState(seed=it["seed"], step=it["step"])

    def wait(self) -> None:
        """Saves are synchronous; nothing is ever in flight."""

    @staticmethod
    def load_config(directory: str) -> WaveNetConfig:
        with open(os.path.join(directory, "params.json")) as f:
            return WaveNetConfig.from_json(f.read())
