"""Rank processes for the port's training tests over the mesh's seq and
model axes (gloo on the CPU, up to four ranks).

Imported by tests/test_torch_seqpar.py and tests/test_torch_pipeline.py and
by the processes torch.multiprocessing spawns from them; imports torch and
the port only (no JAX).

  run_cases(rank, store, workdir)   every case of workdir/cases.json, in
      order: the ranks below the case's world size join a process group of
      their own for it (a file:// store per case), run it and write
      workdir/<case>.rank<r>.npz; the other ranks go on to the next case.
Case kinds:
  loss    the Trainer's route on this rank's part of the batch: the loss
          share and metrics, the reduced gradients of its slice ("local/")
          and the whole gradients gathered over `model` ("grad/");
  train   Trainer.run for `steps` steps with a checkpoint every
          `resume_at` steps, the whole params after it ("param/") and this
          rank's own leaves ("local/"), the losses; then a second trainer
          restores the checkpoint at `resume_at` and runs the rest
          ("resumed/");
  forward seqpar.forward_logits_sp on this rank's (data, seq) slice of
          `tokens` (its Megatron slices of the params under a model
          axis): its logits ("logits");
  decode  generate_distributed on the mesh ("tokens").
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _inputs(workdir: str, name: str, spec: dict):
    from wavenet_tpu_torch.config import WaveNetConfig
    from wavenet_tpu_torch.utils.pytree_io import (params_from_numpy,
                                                   unflatten_tree)
    cfg = WaveNetConfig.from_json(spec["cfg"])
    with np.load(os.path.join(workdir, f"{name}_params.npz")) as z:
        params = params_from_numpy(unflatten_tree(dict(z)), "cpu")
    with np.load(os.path.join(workdir, f"{name}_in.npz")) as z:
        inp = {k: torch.from_numpy(z[k]) for k in z.files}
    return cfg, params, inp


def _np(tree, prefix):
    # bf16 leaves widened to f32 (numpy has no bf16 of its own)
    return {f"{prefix}{k}": (v.detach().float() if v.dtype == torch.bfloat16
                             else v.detach()).numpy()
            for k, v in tree.items()}


def _loss(cfg, params, inp):
    from wavenet_tpu_torch.audio.dataset import AudioDataset
    from wavenet_tpu_torch.training.trainer import Trainer
    from wavenet_tpu_torch.utils.pytree_io import unflatten_tree
    ds = AudioDataset.synthetic(cfg, num_clips=1, clip_seconds=0.05)
    tr = Trainer(cfg, ds, device="cpu", params=params)
    rows = tr.rows
    get = lambda k: inp[k][rows] if k in inp else None
    loss, aux = tr._loss(unflatten_tree(tr.state.params), get("tokens"),
                         get("mel"), get("speaker"))
    keys = sorted(tr.state.params)
    grads = tr._reduce(dict(zip(keys, torch.autograd.grad(
        loss, [tr.state.params[k] for k in keys]))))
    out = _np(grads, "local/")
    out.update(_np(tr._gather(grads), "grad/"))
    out.update({k: v.detach().numpy() for k, v in aux.items()})
    out["share"] = loss.detach().numpy()
    out["route"] = np.asarray(tr.route)
    return out


def _train(cfg, params, spec, workdir, name):
    from wavenet_tpu_torch.audio.dataset import AudioDataset
    from wavenet_tpu_torch.training.trainer import Trainer
    ds = AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.1)
    ckpt = os.path.join(workdir, f"{name}_ckpt")
    tr = Trainer(cfg, ds, checkpoint_dir=ckpt, device="cpu", params=params)
    losses = []
    tr.run(spec["steps"], log_every=1, checkpoint_every=spec["resume_at"],
           log_fn=lambda m: None,
           metrics_fn=lambda step, m: losses.append(m["loss"]))
    out = _np(tr.full_params(), "param/")
    out.update(_np(tr.state.params, "local/"))
    if tr.state.ema is not None:
        out.update(_np(tr._gather(tr.state.ema), "ema/"))
    out["losses"] = np.asarray(losses)
    out["route"] = np.asarray(tr.route)
    tr.save()
    tr2 = Trainer(cfg, ds, checkpoint_dir=ckpt, device="cpu", params=params)
    tr2.restore(spec["resume_at"])
    tr2.run(spec["steps"] - spec["resume_at"], log_every=0)
    out.update(_np(tr2.full_params(), "resumed/"))
    if tr2.state.ema is not None:
        out.update(_np(tr2._gather(tr2.state.ema), "resumed_ema/"))
    return out


def _forward(cfg, params, inp):
    from wavenet_tpu_torch.parallel import seqpar, sharding
    from wavenet_tpu_torch.parallel.mesh import make_mesh, new_mesh_groups
    g = new_mesh_groups(make_mesh(cfg, "cpu"))
    if g.mp > 1:
        params = sharding.shard_params(params, cfg, g.mp, g.model_index)
    # batch_slice cuts windows of W + 1 tokens; a padded last column
    # makes its "inputs" these [B, T] tokens
    part = sharding.batch_slice(
        {"tokens": torch.nn.functional.pad(inp["tokens"], (0, 1)),
         "speaker": inp.get("speaker")}, g.dp, g.sp, g.data_index,
        g.seq_index, seq_sharded=True)
    with torch.no_grad():
        logits = seqpar.forward_logits_sp(params, cfg, g, part["inputs"],
                                          speaker=part.get("speaker"))
    return {"logits": logits.numpy()}


def _decode(cfg, params, inp):
    from wavenet_tpu_torch.generate import sampler
    from wavenet_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(cfg, "cpu")
    toks = sampler.generate_distributed(params, cfg, mesh, 3,
                                        int(inp["n"]), int(inp["batch"]),
                                        device="cpu")
    return {"tokens": toks.numpy()}


def run_cases(rank: int, store: str, workdir: str) -> None:
    import torch.distributed as dist
    from wavenet_tpu_torch.ops.cuda import train_stack
    torch.set_num_threads(1)
    budget = train_stack.VMEM_BUDGET
    with open(os.path.join(workdir, "cases.json")) as f:
        cases = json.load(f)
    for name, spec in cases.items():
        world = spec["world"]
        if rank >= world:
            continue
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        # the case's own rendezvous file beside the run's
        dist.init_process_group("gloo", init_method=f"{store}.{name}",
                                rank=rank, world_size=world)
        train_stack.VMEM_BUDGET = spec.get("vmem") or budget
        try:
            cfg, params, inp = _inputs(workdir, name, spec)
            if spec["kind"] == "loss":
                out = _loss(cfg, params, inp)
            elif spec["kind"] == "train":
                out = _train(cfg, params, spec, workdir, name)
            elif spec["kind"] == "forward":
                out = _forward(cfg, params, inp)
            else:
                out = _decode(cfg, params, inp)
            np.savez(os.path.join(workdir, f"{name}.rank{rank}.npz"), **out)
            dist.barrier()
        finally:
            train_stack.VMEM_BUDGET = budget
            dist.destroy_process_group()


def write_case(workdir: str, cases: dict, name: str, kind: str, world: int,
               cfg_json: str, params: dict, inputs: dict, **spec) -> None:
    """Add case `name` to `cases` and write its params (flat numpy leaves)
    and inputs (numpy arrays) for the ranks."""
    np.savez(os.path.join(workdir, f"{name}_params.npz"), **params)
    np.savez(os.path.join(workdir, f"{name}_in.npz"), **inputs)
    cases[name] = dict(spec, kind=kind, world=world, cfg=cfg_json)


def run(workdir: str, cases: dict, timeout: float = 240) -> dict:
    """Write cases.json, run the four ranks once over every case, and
    return {case: [each rank's results]}."""
    import _torch_dp_worker as dpw
    with open(os.path.join(workdir, "cases.json"), "w") as f:
        json.dump(cases, f)
    dpw.run_ranks(run_cases, workdir, nprocs=4, timeout=timeout,
                  store_dir=workdir)
    out = {}
    for name, spec in cases.items():
        out[name] = []
        for r in range(spec["world"]):
            with np.load(os.path.join(workdir, f"{name}.rank{r}.npz")) as z:
                out[name].append(dict(z))
    return out
