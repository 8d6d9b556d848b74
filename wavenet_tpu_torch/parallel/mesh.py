"""The device mesh: axes (data, seq, model) over the process group.

Counterpart of wavenet_tpu/parallel/mesh.py, as a torch DeviceMesh with
one rank per device.  The axes keep the reference's order: data outermost
(one gradient reduction a step), model innermost (a reduction every
layer).  Only the data axis is ported: seq_parallel and model_parallel
above 1 raise.
"""

from __future__ import annotations

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
    if sp > 1 or mp > 1:
        raise NotImplementedError(
            "seq_parallel and model_parallel > 1 (the seq and model axes of "
            "the mesh) are not ported yet (ROADMAP queue 1 item 11)")
    if dp < 0:
        raise ValueError(f"data_parallel={dp} must be >= 0")
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
