"""The device mesh: axes (data, seq, model) over the process group.

Counterpart of wavenet_tpu/parallel/mesh.py, as a torch DeviceMesh with
one rank per device.  The axes keep the reference's order: data outermost
(one gradient reduction a step), then seq (a halo exchange a layer, or one
a step), model innermost (a reduction every layer).  Rank r of a
(dp, sp, mp) mesh sits at data index r // (sp mp), seq index (r // mp) % sp
and model index r % mp.  Training takes every axis (training/trainer.py
picks the route); decode and serving take the data and model axes and,
as the reference's decode does, count the seq axis as replicas: each seq
index runs the same (data, model) decode on its own sub-groups and gets
the same tokens.

Collectives run on a MeshGroups: this rank's sub-groups of each axis, the
(data, seq) group over which replicated gradients are summed, and its
coordinates.  mesh_groups gives the DeviceMesh's own sub-groups;
new_mesh_groups makes a second, independent set, so two threads of one
process (the server's two decode lanes) can each issue collectives
without their order mixing on another rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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
    if dp < 0 or mp < 1 or sp < 1:
        raise ValueError(f"data_parallel={dp} must be >= 0, "
                         f"seq_parallel={sp} and model_parallel={mp} >= 1")
    if dp == 0:
        dp = world_size // (sp * mp)
    if dp * sp * mp != world_size:
        raise ValueError(
            f"mesh data x seq x model = {dp} x {sp} x {mp} = {dp * sp * mp} "
            f"ranks, but the process group has {world_size} (launch one "
            f"process per rank, e.g. torchrun --nproc_per_node {dp * sp * mp}"
            f", with --override data_parallel=N times seq_parallel times "
            f"model_parallel equal to the world size)")
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
    """This rank's place on the mesh: the axis sizes, its coordinates, and
    the sub-groups it reduces over (None for an axis of one rank, or
    without a process group).  replica is the (data, seq) group: the
    ranks that hold the same model slice, over which gradients sum."""
    dp: int
    mp: int
    data_index: int
    model_index: int
    data: Optional[dist.ProcessGroup]
    model: Optional[dist.ProcessGroup]
    sp: int = 1
    seq_index: int = 0
    seq: Optional[dist.ProcessGroup] = None
    replica: Optional[dist.ProcessGroup] = None


def _check_mesh(mesh: DeviceMesh) -> Tuple[int, int, int]:
    if tuple(mesh.mesh_dim_names or ()) != AXES:
        raise ValueError(f"a mesh with axes {AXES} (make_mesh), not "
                         f"{mesh.mesh_dim_names}")
    return tuple(mesh.shape)


def _coords(mesh: DeviceMesh):
    """(the [dp, sp, mp] rank grid, this rank's (data, seq, model))."""
    dp, sp, mp = _check_mesh(mesh)
    ranks = mesh.mesh.reshape(dp, sp, mp)
    where = (ranks == dist.get_rank()).nonzero(as_tuple=True)
    return ranks, tuple(int(v[0]) for v in where)


def mesh_groups(mesh: DeviceMesh) -> MeshGroups:
    """The mesh's own data, model and seq sub-groups of this rank (no
    replica group: make one with new_mesh_groups)."""
    dp, sp, mp = _check_mesh(mesh)
    _, (d, s, m) = _coords(mesh)
    return MeshGroups(dp, mp, d, m, mesh.get_group(DATA_AXIS),
                      mesh.get_group(MODEL_AXIS), sp, s,
                      mesh.get_group(SEQ_AXIS))


def new_mesh_groups(mesh: DeviceMesh) -> MeshGroups:
    """A fresh set of data, model, seq and (data, seq) replica sub-groups
    over the mesh's ranks (dist.new_group): every rank must call it, in
    the same order as every other call that makes groups."""
    dp, sp, mp = _check_mesh(mesh)
    ranks, (d, s, m) = _coords(mesh)
    me = dist.get_rank()

    def axis(perm, size):
        # every group of the axis (the other coordinates fixed), made in
        # the same order on every rank; this rank's is kept
        mine = None
        for line in ranks.permute(*perm).reshape(-1, size).tolist():
            g = dist.new_group(line)
            if me in line:
                mine = g
        return mine
    data = axis((1, 2, 0), dp)
    model = axis((0, 1, 2), mp)
    seq = axis((0, 2, 1), sp)
    replica = axis((2, 0, 1), dp * sp)
    return MeshGroups(dp, mp, d, m, data, model, sp, s, seq, replica)
