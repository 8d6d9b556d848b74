"""The device mesh: axes (data, seq, model) over the process group.

Counterpart of wavenet_tpu/parallel/mesh.py, as a torch DeviceMesh with
one rank per device.  The axes keep the reference's order: data outermost
(one gradient reduction a step), model innermost (a reduction every
layer).  The data and model axes are ported; seq_parallel above 1 raises.
Training takes the data axis only (training/trainer.py refuses the model
axis); decode and serving take both (parallel/distdecode.py).

A decode over the mesh runs its collectives on a MeshGroups: this rank's
data and model sub-groups and its coordinates on those axes.  mesh_groups
gives the DeviceMesh's own sub-groups; new_mesh_groups makes a second,
independent set, so two threads of one process (the server's two decode
lanes) can each issue collectives without their order mixing on another
rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from wavenet_tpu_torch.config import WaveNetConfig

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


def mesh_shape(cfg: WaveNetConfig, world_size: int) -> Tuple[int, int, int]:
    """(data, seq, model) sizes of cfg over world_size ranks.
    data_parallel = 0 takes every rank the other axes leave; otherwise the
    product must equal world_size."""
    dp, sp, mp = cfg.data_parallel, cfg.seq_parallel, cfg.model_parallel
    if sp > 1:
        raise NotImplementedError(
            "seq_parallel > 1 (the seq axis of the mesh) is not ported yet "
            "(ROADMAP queue 1 item 11)")
    if dp < 0 or mp < 1:
        raise ValueError(f"data_parallel={dp} must be >= 0 and "
                         f"model_parallel={mp} >= 1")
    if dp == 0:
        dp = world_size // (sp * mp)
    if dp * sp * mp != world_size:
        raise ValueError(
            f"mesh data x seq x model = {dp} x {sp} x {mp} = {dp * sp * mp} "
            f"ranks, but the process group has {world_size} (launch one "
            f"process per rank, e.g. torchrun --nproc_per_node {dp * sp * mp}"
            f", with --override data_parallel=N equal to the world size)")
    return dp, sp, mp


def make_mesh(cfg: WaveNetConfig, device_type: str) -> DeviceMesh:
    """The (data, seq, model) mesh over the running process group (one
    rank per device of `device_type`, "cuda" or "cpu")."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a running process group "
                           "(distributed.initialize)")
    return init_device_mesh(device_type,
                            mesh_shape(cfg, dist.get_world_size()),
                            mesh_dim_names=AXES)


def single_device_mesh(device_type: str = "cpu") -> DeviceMesh:
    """The 1 x 1 x 1 mesh of a one-process run.  Without a running process
    group it starts a one-rank gloo group on an in-process store (a
    DeviceMesh always stands on a process group)."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(f"single_device_mesh in a group of "
                         f"{dist.get_world_size()} ranks; use make_mesh")
    return init_device_mesh(device_type, (1, 1, 1), mesh_dim_names=AXES)


@dataclass(frozen=True)
class MeshGroups:
    """This rank's place on the (data, model) axes of a mesh: the axis
    sizes, its coordinates, and the sub-groups it reduces over."""
    dp: int
    mp: int
    data_index: int
    model_index: int
    data: dist.ProcessGroup
    model: dist.ProcessGroup


def _check_decode_mesh(mesh: DeviceMesh) -> Tuple[int, int, int]:
    if tuple(mesh.mesh_dim_names or ()) != AXES:
        raise ValueError(f"a mesh with axes {AXES} (make_mesh), not "
                         f"{mesh.mesh_dim_names}")
    dp, sp, mp = mesh.shape
    if sp != 1:
        raise NotImplementedError(
            "the seq axis is not ported yet (ROADMAP queue 1 item 11)")
    return dp, sp, mp


def mesh_groups(mesh: DeviceMesh) -> MeshGroups:
    """The mesh's own data and model sub-groups of this rank."""
    dp, _, mp = _check_decode_mesh(mesh)
    return MeshGroups(dp, mp, mesh.get_local_rank(DATA_AXIS),
                      mesh.get_local_rank(MODEL_AXIS),
                      mesh.get_group(DATA_AXIS), mesh.get_group(MODEL_AXIS))


def new_mesh_groups(mesh: DeviceMesh) -> MeshGroups:
    """A fresh set of data and model sub-groups over the mesh's ranks
    (dist.new_group): every rank must call it, in the same order as every
    other call that makes groups.  Rank r of a (dp, 1, mp) mesh sits at
    data index r // mp and model index r % mp, the DeviceMesh's layout."""
    dp, _, mp = _check_decode_mesh(mesh)
    ranks = mesh.mesh.reshape(dp, mp).tolist()
    me = dist.get_rank()
    data = model = None
    for m in range(mp):                      # the data axis' groups ...
        g = dist.new_group([ranks[d][m] for d in range(dp)])
        if any(ranks[d][m] == me for d in range(dp)):
            data = g
    for d in range(dp):                      # ... then the model axis'
        g = dist.new_group(ranks[d])
        if me in ranks[d]:
            model = g
    return MeshGroups(dp, mp, mesh.get_local_rank(DATA_AXIS),
                      mesh.get_local_rank(MODEL_AXIS), data, model)
