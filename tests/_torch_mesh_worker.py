"""Rank processes for the port's mesh decode and mesh serving tests (gloo
on the CPU, two ranks).

Imported by tests/test_torch_distdecode.py and tests/test_torch_mesh_serving.py
and by the processes torch.multiprocessing spawns from them; imports torch
and the port only (no JAX).

  decode_ranks(...)   every decode case on the (2, 1) and (1, 2) meshes:
                      tokens of each route, one-shot and streamed, rings
                      and carry, and the runs teacher-forced along JAX's
                      tokens; each rank writes what it got;
  serve_ranks(...)    WaveNetServer(mesh=) on rank 0, follow() on rank 1,
                      through the cases the test wrote; rank 0 writes the
                      responses and the engine's stats.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from _torch_dp_worker import _join

CHUNK = 10                       # streamed decodes' chunk, in samples
LAYOUTS = ((2, 1), (1, 2))       # (data, model)
WAIT_S = 60                      # every wait in the serving ranks


def load_case(workdir: str, name: str):
    """(config, params, inputs) of a case the test wrote."""
    from wavenet_tpu_torch.config import WaveNetConfig
    from wavenet_tpu_torch.utils.pytree_io import (params_from_numpy,
                                                   unflatten_tree)
    with open(os.path.join(workdir, f"{name}.json")) as f:
        spec = json.load(f)
    cfg = WaveNetConfig.from_json(spec["cfg"])
    with np.load(os.path.join(workdir, f"{name}_params.npz")) as z:
        params = params_from_numpy(unflatten_tree(dict(z)), "cpu")
    with np.load(os.path.join(workdir, f"{name}_in.npz")) as z:
        inputs = {k: torch.from_numpy(z[k]) for k in z.files}
    return cfg, params, spec, inputs


def _gather(t, group, size: int, dim: int):
    from wavenet_tpu_torch.parallel.distdecode import _all_gather
    return _all_gather(t, group, size, dim)


def _decode_case(cfg, params, spec, inp, dp: int, mp: int) -> dict:
    """Everything one case gives on one mesh layout (this rank's copy)."""
    from wavenet_tpu_torch.generate import sampler
    from wavenet_tpu_torch.ops.cuda import decode_common
    from wavenet_tpu_torch.parallel import distdecode as dd
    from wavenet_tpu_torch.parallel.mesh import make_mesh, mesh_groups
    mesh = make_mesh(cfg.replace(data_parallel=dp, model_parallel=mp), "cpu")
    groups = mesh_groups(mesh)
    w = decode_common.flatten_params(params, cfg)
    B, n, temp = spec["batch"], spec["n"], spec["temperature"]
    kw = dict(prime_tokens=inp.get("prime"), y=inp.get("y"),
              speaker=inp.get("speaker"), temperature=temp, device="cpu")
    seeds = spec["seed"]
    out = {"fan_out": np.asarray(
        sampler.kernel_fan_out(cfg, groups, B, temp, "cpu"))}
    out["auto"] = sampler.generate_distributed(w, cfg, mesh, seeds, n, B,
                                               **kw)
    out["stream"] = torch.cat(list(sampler.stream_distributed(
        w, cfg, mesh, seeds, n, B, chunk_samples=CHUNK, **kw)), dim=1)
    for srm in (False, True):
        tag = f"srm{int(srm)}"
        out[f"sharded_{tag}"] = dd.generate_sharded(
            w, cfg, mesh, seeds, n, B, shard_rings_model=srm, **kw)
        out[f"sharded_stream_{tag}"] = torch.cat(list(
            dd.generate_sharded_stream(w, cfg, mesh, seeds, n, B,
                                       chunk_samples=CHUNK,
                                       shard_rings_model=srm, **kw)), dim=1)
        # the state after the whole timeline, gathered from every rank
        lw = dd.local_weights(w, cfg, groups)
        rings, carry, s, g, prime, y, P, total = dd.setup_sharded(
            lw, cfg, groups, B, n, inp.get("prime"), seeds,
            inp.get("speaker"), inp.get("y"), None, "cpu", srm)
        toks, rings, carry = dd.decode_chunk_sharded(
            lw, cfg, groups, rings, carry, 0, s, total, temp, forced=prime,
            y=y, g=g, shard_rings_model=srm)
        if srm:
            rings = _gather(rings, groups.model, mp, 2)
        out[f"rings_{tag}"] = _gather(rings, groups.data, dp, 1).view(
            torch.int16)
        out[f"carry_{tag}"] = _gather(carry, groups.data, dp, 0)
        out[f"chunk_{tag}"] = _gather(toks, groups.data, dp, 0)
        if f"jax_forced_{dp}x{mp}" in inp and not srm:
            out["jax_tf"], out["jax_tf_rings"] = _teacher_forced(
                cfg, w, lw, groups, inp, spec, dp, mp)
    if dp > 1:
        # the fan-out's own state: the kernel module on this rank's rows
        mod = sampler.kernel_module(cfg, "cpu")
        rows = dd.local_rows(groups, B)
        rings, carry, s, g, P, total = decode_common.setup_decode(
            cfg, B, n, inp.get("prime"), seeds, "cpu", w, inp.get("speaker"))
        y = decode_common.cond_timeline(inp.get("y"), total)
        prime = inp.get("prime")
        toks, rings, carry = mod.decode_chunk(
            w, cfg, rings[:, rows].contiguous(), carry[rows], 0, s[rows],
            total, temp,
            forced=None if prime is None else prime[rows].contiguous(),
            y=None if y is None else y[rows],
            g=None if g is None else g[:, rows].contiguous())
        out["fan_rings"] = _gather(rings, groups.data, dp, 1).view(
            torch.int16)
        out["fan_carry"] = _gather(carry, groups.data, dp, 0)
        out["fan_chunk"] = _gather(toks, groups.data, dp, 0)
    return out


def _teacher_forced(cfg, w, lw, groups, inp, spec, dp, mp):
    """The mesh decode consuming JAX's tokens (forced[:, g] at step g):
    the fan-out's kernel module at (2, 1), the collective loop at (1, 2).
    Returns (tokens, rings as float32)."""
    from wavenet_tpu_torch.generate import sampler
    from wavenet_tpu_torch.parallel import distdecode as dd
    B, temp = spec["batch"], spec["temperature"]
    forced = inp[f"jax_forced_{dp}x{mp}"].to(torch.int32)
    steps = forced.shape[1] - 1
    rows = dd.local_rows(groups, B)
    rings, carry, s, g, _, _, _, _ = dd.setup_sharded(
        lw, cfg, groups, B, steps, None, spec["seed"], None, None, None,
        "cpu", False)
    f = forced[rows].contiguous()
    if mp == 1:
        toks, rings, _ = sampler.kernel_module(cfg, "cpu").decode_chunk(
            w, cfg, rings, carry, 0, s, steps, temp, forced=f)
    else:
        toks, rings, _ = dd.decode_chunk_sharded(
            lw, cfg, groups, rings, carry, 0, s, steps, temp, forced=f)
    return (_gather(toks, groups.data, dp, 0),
            _gather(rings.float(), groups.data, dp, 1))


def decode_ranks(rank: int, store: str, workdir: str) -> None:
    """Every case of workdir/cases.json on both layouts; this rank's
    results to workdir/rank<r>.npz."""
    import torch.distributed as dist
    _join(rank, store)
    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=2)
    try:
        with open(os.path.join(workdir, "cases.json")) as f:
            names = json.load(f)
        res = {}
        for name in names:
            cfg, params, spec, inp = load_case(workdir, name)
            for dp, mp in LAYOUTS:
                got = _decode_case(cfg, params, spec, inp, dp, mp)
                for k, v in got.items():
                    res[f"{name}/{dp}x{mp}/{k}"] = np.asarray(v)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve_case(name: str, spec: dict, model, mesh) -> dict:
    """One server case: rank 0 submits, the other rank follows."""
    from wavenet_tpu_torch.serving import WaveNetServer
    srv = WaveNetServer(model, mesh=mesh, **spec["server"])
    if srv.follower:
        srv.follow(timeout=WAIT_S)
        return {}
    out, done = {}, {}
    try:
        handles = []
        for i, r in enumerate(spec["requests"]):
            kw = dict(r)
            if "mel" in kw:
                kw["mel"] = np.asarray(kw["mel"], np.float32)
            if "prime" in kw:
                kw["prime"] = np.asarray(kw["prime"], np.float32)
            handles.append(srv.submit(**kw))
            if spec.get("stagger_s"):
                time.sleep(spec["stagger_s"])

        def consume(i, h):
            out[f"{name}/wave{i}"] = h.waveform()
            done[i] = time.monotonic()

        threads = [threading.Thread(target=consume, args=(i, h), daemon=True)
                   for i, h in enumerate(handles)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
            if t.is_alive():
                raise TimeoutError(f"{name}: a response ran past {WAIT_S} s")
    finally:
        srv.close()
    for k in ("batches", "padded_rows", "requests"):
        out[f"{name}/{k}"] = np.asarray(srv.stats[k])
    out[f"{name}/done"] = np.asarray([done[i] for i in sorted(done)])
    return out


def serve_ranks(rank: int, store: str, workdir: str) -> None:
    """Every serving case of workdir/serve.json; rank 0's responses,
    stats and finish times to workdir/serve_out.npz."""
    import torch.distributed as dist
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.parallel.mesh import make_mesh
    _join(rank, store)
    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=2)
    try:
        with open(os.path.join(workdir, "serve.json")) as f:
            cases = json.load(f)
        res = {}
        for name, spec in cases.items():
            cfg, params, _, _ = load_case(workdir, spec["model"])
            dp, mp = spec["layout"]
            mesh = make_mesh(cfg.replace(data_parallel=dp,
                                         model_parallel=mp), "cpu")
            res.update(_serve_case(name, spec, WaveNet(cfg, params), mesh))
        if rank == 0:
            np.savez(os.path.join(workdir, "serve_out.npz"), **res)
    finally:
        dist.destroy_process_group()
