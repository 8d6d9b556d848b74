"""The training mesh's exchanges, with their gradients.

The reference writes its exchanges as jax.lax.ppermute and psum inside
shard_map, and JAX transposes them for the backward.  torch.distributed's
calls carry no autograd, so every exchange on a differentiated path here
is a torch.autograd.Function that issues its conjugate in the backward:

  * ppermute(t, axis, step): t from the rank `step` places to the left on
    the axis (zeros where there is none), the cotangent sent back the
    other way (shard 0 of a halo receives zeros, as ppermute's unpaired
    targets do);
  * enter(t, axis): identity forward, the sum of the cotangents over the
    axis backward (a replicated tensor entering a column-split product:
    each rank's cotangent is a partial sum);
  * row_sum(partial, axis): the sum over the axis forward, identity
    backward (a row-split product's partial sums; the sum is replicated,
    so each rank's cotangent is already the whole one).

Point-to-point transfers of CUDA tensors over gloo are staged through host
memory (gloo's send and receive take host buffers); its collectives take
the CUDA tensors themselves.  Every call adds its wall time to `seconds`,
the device synchronised before and after it (chip_smoke.py reads it as the
collective time of a step).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

# wall seconds spent in this module's collectives (the process's total)
seconds = 0.0


class _Clock:
    """Adds the wall time of its block to `seconds`; for a CUDA tensor the
    device is synchronised first and last, so the time is the exchange's
    own and not the kernels' queued before it."""

    def __init__(self, t: torch.Tensor):
        self.dev = t.device if t.is_cuda else None

    def _sync(self):
        if self.dev is not None:
            torch.cuda.synchronize(self.dev)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        global seconds
        self._sync()
        seconds += time.perf_counter() - self.t0


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its group (None: one rank),
    its size and this rank's index on it."""
    group: Optional[dist.ProcessGroup]
    size: int
    index: int

    def rank(self, i: int) -> int:
        """The global rank of index i on this axis."""
        return dist.get_global_rank(self.group, i)


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """t as the buffer a point-to-point transfer on `group` takes: on the
    host for a CUDA tensor under gloo, contiguous."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.detach().to("cpu")
    return t.detach().contiguous()


def send(t: torch.Tensor, axis: Axis, i: int, tag: int = 0) -> None:
    """Send t to index i of the axis (blocking)."""
    with _Clock(t):
        dist.send(_staged(t, axis.group), axis.rank(i), group=axis.group,
                  tag=tag)


def recv(like: torch.Tensor, axis: Axis, i: int, tag: int = 0
         ) -> torch.Tensor:
    """Receive a tensor shaped and typed like `like` from index i of the
    axis (blocking), on like's device."""
    with _Clock(like):
        buf = _staged(torch.empty_like(like), axis.group)
        dist.recv(buf, axis.rank(i), group=axis.group, tag=tag)
        return buf.to(like.device)


def shift(t: torch.Tensor, axis: Axis, step: int = 1) -> torch.Tensor:
    """The t of index (this index - step) on the axis, zeros when that
    index is off the axis; every rank of the axis calls it (a ppermute
    of the pairs (i, i + step))."""
    if axis.size == 1:
        return torch.zeros_like(t)
    with _Clock(t):
        wire = _staged(t, axis.group)
        out = torch.zeros_like(wire)
        reqs = []
        dst, src = axis.index + step, axis.index - step
        if 0 <= dst < axis.size:
            reqs.append(dist.isend(wire, axis.rank(dst), group=axis.group))
        if 0 <= src < axis.size:
            reqs.append(dist.irecv(out, axis.rank(src), group=axis.group))
        for r in reqs:
            r.wait()
        return out.to(t.device)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """dist.all_reduce in place on t (a no-op without a group)."""
    if group is not None:
        with _Clock(t):
            dist.all_reduce(t, op=op, group=group)
    return t


def broadcast(t: torch.Tensor, axis: Axis, i: int) -> torch.Tensor:
    """Index i's t on every rank of the axis (in place)."""
    if axis.size > 1:
        with _Clock(t):
            dist.broadcast(t, axis.rank(i), group=axis.group)
    return t


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, step):
        ctx.axis, ctx.step = axis, step
        return shift(t, axis, step)

    @staticmethod
    def backward(ctx, g):
        return shift(g.contiguous(), ctx.axis, -ctx.step), None, None


def ppermute(t: torch.Tensor, axis: Axis, step: int = 1) -> torch.Tensor:
    """shift() with its transpose as the backward."""
    return _PPermute.apply(t, axis, step)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.axis.group), None


def enter(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Identity forward; the cotangents summed over the axis backward."""
    return t if axis.size == 1 else _Enter.apply(t, axis)


class _RowSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return all_reduce(t.clone(), axis.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def row_sum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over the axis forward; identity backward."""
    return t if axis.size == 1 else _RowSum.apply(t, axis)


def axis_of(groups, name: str) -> Axis:
    """The Axis `name` ("data", "seq" or "model") of a mesh.MeshGroups."""
    size, index, group = {
        "data": (groups.dp, groups.data_index, groups.data),
        "seq": (groups.sp, groups.seq_index, groups.seq),
        "model": (groups.mp, groups.model_index, groups.model)}[name]
    return Axis(group if size > 1 else None, size, index)
