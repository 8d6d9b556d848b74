"""Rank processes for the port's data-parallel tests (gloo on the CPU).

Imported by tests/test_torch_dataparallel.py and tests/test_torch_dp_train.py
and by the processes torch.multiprocessing spawns from them; imports torch
and the port only (no JAX), so a rank starts in about a second.

  run_ranks(fn, *args)   spawn two ranks of fn(rank, store, *args), each
                         bounded by a timeout, and raise if one fails;
                         store is a file:// rendezvous of their own (a
                         new file, so no two runs can meet on it, where a
                         free TCP port could be taken between its probe
                         and the ranks' bind);
  loss_ranks(...)        loss_fn_dp and the reduced gradients per case;
  train_ranks(...)       the train CLI's main() with every file the rank
                         writes under a directory recorded (an audit hook).
"""

from __future__ import annotations

import functools
import json
import os
import sys
import tempfile
import time
import uuid

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT_S = 60


def new_store(directory: str = None) -> str:
    """A file:// rendezvous URL on a file no other run uses (under
    `directory`, default a new temporary one)."""
    directory = directory or tempfile.mkdtemp(prefix="rdzv")
    return "file://" + os.path.join(os.path.abspath(directory),
                                    f"rdzv-{uuid.uuid4().hex}")


def _join(rank: int, store: str, world: int = 2) -> None:
    """Set this rank's environment (the launcher's variables) and make
    distributed.initialize rendezvous on `store`."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from wavenet_tpu_torch.parallel import distributed
    distributed.initialize = functools.partial(distributed.initialize,
                                               init_method=store)


def run_ranks(fn, *args, nprocs: int = 2, timeout: float = TIMEOUT_S,
              store_dir: str = None):
    """Run fn(rank, store, *args) in nprocs spawned processes (store: a
    new file:// rendezvous under store_dir); kill them and raise after
    `timeout` seconds, or when one fails."""
    ctx = mp.start_processes(fn, args=(new_store(store_dir), *args),
                             nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"the ranks of {fn.__name__} ran past "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


# ---------------------------------------------------------------------------
# loss_fn_dp and the reduced gradients
# ---------------------------------------------------------------------------

def _case_inputs(case: dict):
    """(config, tokens, mel, speaker) of a case written by the test."""
    from wavenet_tpu_torch.config import MelConfig, WaveNetConfig
    kw = dict(case["cfg"])
    if kw.get("mel"):
        kw["mel"] = MelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in kw["mel"].items()})
    cfg = WaveNetConfig(**kw)
    mel = None if case["mel"] is None else torch.tensor(case["mel"])
    spk = None if case["speaker"] is None else torch.tensor(case["speaker"])
    return cfg, torch.tensor(case["tokens"]), mel, spk


def loss_ranks(rank: int, store: str, workdir: str) -> None:
    """For every case in workdir/cases.json (params in <case>.npz): this
    rank's loss_fn_dp on its rows and the reduced gradients ("loss"), the
    grad_accum trainer steps ("accum"), or two trainer steps on the wavs
    under workdir/corpus, from an AudioDataset and from a
    StreamingAudioDataset ("stream"); writes workdir/<case>.rank<r>.npz."""
    _join(rank, store)
    import torch.distributed as dist
    from wavenet_tpu_torch.audio.dataset import AudioDataset
    from wavenet_tpu_torch.audio.streaming import StreamingAudioDataset
    from wavenet_tpu_torch.parallel import dataparallel, distributed
    from wavenet_tpu_torch.training.trainer import Trainer
    from wavenet_tpu_torch.utils.pytree_io import (flatten_tree,
                                                   params_from_numpy,
                                                   unflatten_tree)
    distributed.initialize(device="cpu")
    try:
        with open(os.path.join(workdir, "cases.json")) as f:
            cases = json.load(f)
        for name, case in cases.items():
            cfg, toks, mel, spk = _case_inputs(case)
            npz = np.load(os.path.join(workdir, f"{name}.npz"))
            params = params_from_numpy(unflatten_tree(dict(npz)), "cpu")
            out = {}
            if case["kind"] == "loss":
                sl = distributed.local_batch_slice(toks.shape[0])
                flat = {k: v.requires_grad_(True)
                        for k, v in flatten_tree(params).items()}
                loss, aux = dataparallel.loss_fn_dp(
                    unflatten_tree(flat), cfg, toks[sl],
                    use_fused=case["use_fused"],
                    mel=None if mel is None else mel[sl],
                    speaker=None if spk is None else spk[sl])
                keys = sorted(flat)
                grads = dict(zip(keys, torch.autograd.grad(
                    loss, [flat[k] for k in keys])))
                grads = dataparallel.reduce_gradients(grads)
                # bf16 leaves' gradients widened to f32 (np has no bf16)
                out = {f"grad/{k}": v.float().numpy()
                       for k, v in grads.items()}
                out.update({k: v.detach().numpy() for k, v in aux.items()})
            elif case["kind"] == "stream":
                root = os.path.join(workdir, "corpus")
                for name_, ds in (("mem", AudioDataset.from_dir(root, cfg)),
                                  ("stream", StreamingAudioDataset.from_dir(
                                      root, cfg))):
                    tr = Trainer(cfg, ds, device="cpu", params=params)
                    tr.run(case["steps"], log_every=0)
                    out.update({f"{name_}/{k}": v.detach().numpy()
                                for k, v in tr.state.params.items()})
                out["cached_clips"] = np.asarray(sorted(ds._cache))
            else:                       # grad_accum microsteps, trainer
                ds = AudioDataset.synthetic(cfg, num_clips=1,
                                            clip_seconds=0.05)
                tr = Trainer(cfg, ds, device="cpu", params=params)
                b = cfg.batch_size
                for m in range(cfg.grad_accum):
                    micro = toks[m * b:(m + 1) * b]
                    tr.step(micro[distributed.local_batch_slice(b)])
                out = {f"param/{k}": v.detach().numpy()
                       for k, v in tr.state.params.items()}
            np.savez(os.path.join(workdir, f"{name}.rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

_WRITE_FLAGS = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND


def _record_writes(root: str, log: list) -> None:
    """Append to `log` every file or directory this process creates,
    writes, renames or removes under `root` (a sys.audit hook)."""
    root = os.path.abspath(root)

    def under(p) -> bool:
        try:
            return os.path.abspath(os.fsdecode(p)).startswith(root)
        except TypeError:                # a file descriptor
            return False

    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            writes = (mode is not None and any(c in mode for c in "wax+")) \
                or (mode is None and flags & _WRITE_FLAGS)
            if writes and under(path):
                log.append(("open", os.fsdecode(path)))
        elif event in ("os.mkdir", "os.rename", "os.remove") and under(
                args[0]):
            log.append((event, os.fsdecode(args[0])))

    sys.addaudithook(hook)


def train_ranks(rank: int, store: str, argv: list, watch: str,
                outdir: str) -> None:
    """train.main(argv) as one rank; writes outdir/rank<r>.npz (the final
    params and EMA of this rank's trainer) and outdir/rank<r>.json (the
    files main() wrote under `watch`, and the metrics it returned)."""
    _join(rank, store)
    from wavenet_tpu_torch import train
    from wavenet_tpu_torch.training import trainer as ttrainer
    made = []
    init = ttrainer.Trainer.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    ttrainer.Trainer.__init__ = spy
    writes: list = []
    _record_writes(watch, writes)
    metrics = train.main(argv)
    writes = list(writes)
    st = made[0].state
    out = {f"param/{k}": v.detach().numpy() for k, v in st.params.items()}
    if st.ema is not None:
        out.update({f"ema/{k}": v.numpy() for k, v in st.ema.items()})
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"writes": writes, "metrics": metrics}, f)
