"""The verify tool's probe kernels (csrc/probes.cu) and their wrappers.

Counterparts of the Mosaic probes in tools/ (each a `pl.pallas_call` the
reference ran on the TPU against interpret mode):

  probe_scratch       tools/tpu_scratch_test.py::kern, tools/tpu_scratch2d.py
                      ::kern, kern2, kern3 (P1)
  probe_gate          tools/tpu_tanh_probe.py::kern (P2)
  probe_lane_ops      tools/tpu_lane_ops_check.py::kernel_a, kernel_b,
                      kernel_c (P3)
  probe_shift_concat  tools/tpu_concat_probe.py::kA, kB, kC, kD (P4)

Each wrapper runs its plain PyTorch version (`*_reference`) for CPU
tensors and launches its kernel for CUDA tensors, bumping its launch count
where it launches; there is no fallback.  `probe_inputs` draws the probes'
operands from numpy seeds (the TPU probes drew theirs with jax.random), so
the card, the CPU tests and the golden files (tests/golden_torch/) see the
same values.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from wavenet_tpu_torch.ops.cuda import build
from wavenet_tpu_torch.ops.cuda.decode_common import ptr, raise_on

scratch_launches = build.LaunchCounter()
gate_launches = build.LaunchCounter()
lane_launches = build.LaunchCounter()
shift_launches = build.LaunchCounter()

# P1: mode -> (kernel mode, grid rows, tiles, the probe's printed
# expectation of out[:, :, 0, 0])
SCRATCH_MODES: Dict[str, Tuple[int, int, int, list]] = {
    "accumulate": (0, 1, 4, [[1, 2, 3, 4]]),
    "reset": (1, 2, 4, [[1, 2, 3, 4], [1, 2, 3, 4]]),
    "ring": (2, 1, 4, [[0, 1, 3, 6]]),
    "partial": (3, 1, 4, [[0, 1, 2, 3]]),
    "ring_launches": (4, 1, 4, [[0, 1, 3, 6]]),
}
LANE_CASES = ("a", "b", "c")
# P3: a case's operands, keys of probe_inputs / lane_inputs
LANE_OPS = {"a": ("a", "b", "w"), "b": ("h", "w_rs"),
            "c": ("xf", "yf", "wf")}
SHIFT_CASES = ("A", "B", "C", "D")
# tools/tpu_concat_probe.py: TT, R, d, off
TT, R, D, OFF = 512, 64, 32, 64


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wn_probe_scratch.argtypes = [p, p, i, i, i, i, p]
    lib.wn_probe_gate.argtypes = [p, p, p, p, i, p]
    lib.wn_probe_lane.argtypes = [i, p, p, p, p, p, i, p]
    lib.wn_probe_shift.argtypes = [i, p, p, p, i, i, i, i, p]
    for f in (lib.wn_probe_scratch, lib.wn_probe_gate, lib.wn_probe_lane,
              lib.wn_probe_shift):
        f.restype = i
    lib.wn_error_string.argtypes = [i]
    lib.wn_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The built and bound probe library (builds on first use)."""
    lib = build.load("probes")
    _bind(lib)
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _on(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _normal(rs: np.random.RandomState):
    def normal(*shape):
        return torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    return normal


def _lane_draws(normal, T: int) -> Dict[str, torch.Tensor]:
    """P3's operands at T rows, in the order they are drawn."""
    bf = torch.bfloat16
    return {"a": normal(T, 64).to(bf), "b": normal(T, 64).to(bf),
            "w": normal(128, 64).to(bf), "h": normal(T, 64).to(bf),
            "w_rs": normal(64, 128).to(bf), "xf": normal(T, 64),
            "yf": normal(T, 64), "wf": normal(64, 128)}


def probe_inputs(device="cuda") -> Dict[str, torch.Tensor]:
    """The probes' operands, drawn from numpy seeds: P2's 8,192-point
    linspace over [-30, 30] [64, 128]; P3's a, b, h [256, 64] bf16, w
    [128, 64] bf16, w_rs [64, 128] bf16, x, y [256, 64] f32, w_f [64, 128]
    f32 (standard normal); P4's ring [256, 64] f32, its 4-D snapshot
    [1, 1, 256, 64] and x [512, 64] f32."""
    normal = _normal(np.random.RandomState(0))
    out = {"gate_x": torch.from_numpy(np.linspace(
        -30.0, 30.0, 8 * 1024, dtype=np.float32).reshape(64, 128)),
        **_lane_draws(normal, 256)}
    out["ring"] = normal(256, R)
    out["shift_x"] = normal(TT, R)
    out["snaps"] = normal(1, 1, 256, R)
    return {k: v.to(device) for k, v in out.items()}


def lane_inputs(T: int, device="cuda",
                seed: int = 1) -> Dict[str, torch.Tensor]:
    """P3's operands (the keys of LANE_OPS) at T rows, drawn from a numpy
    seed as probe_inputs draws them: a T that is not a multiple of 16
    checks the kernel's ragged row tile."""
    out = _lane_draws(_normal(np.random.RandomState(seed)), T)
    return {k: v.to(device) for k, v in out.items()}


def shift_inputs(T: int, width: int, device="cuda", seed: int = 1,
                 offset: int = 0) -> Dict[str, torch.Tensor]:
    """P4's operands at T rows of `width` columns, drawn from a numpy seed:
    ring [256, width], its snapshot [1, 1, 256, width] and shift_x [T,
    width], x a view `offset` elements into its buffer on `device` (an
    offset of 1 puts it off 16-byte alignment)."""
    normal = _normal(np.random.RandomState(seed))
    ring, snaps, x = (normal(256, width), normal(1, 1, 256, width),
                      normal(T, width))
    buf = torch.zeros(offset + T * width)
    buf[offset:] = x.reshape(-1)
    return {"ring": ring.to(device), "snaps": snaps.to(device),
            "shift_x": buf.to(device)[offset:].view(T, width)}


# ---------------------------------------------------------------------------
# P1: scratch persistence
# ---------------------------------------------------------------------------

def probe_scratch_reference(mode: str, device="cpu") -> torch.Tensor:
    """out [rows, tiles, 8, 128] of the probe body `mode`, the grid walked
    in order."""
    kmode, rows, tiles, _ = SCRATCH_MODES[mode]
    out = torch.empty(rows, tiles, 8, 128, device=device)
    for r in range(rows):
        ring = torch.zeros(16, 128, device=device)
        for j in range(tiles):
            if kmode <= 1:
                ring[:8] += 1.0
                out[r, j] = ring[:8]
            elif kmode in (2, 4):
                out[r, j] = ring[:8]
                ring[:8] += float(j + 1)
            else:
                buf = torch.full((16, 128), float(j + 1), device=device)
                out[r, j] = ring[:8]
                ring[:8] = buf[8:16]
    return out


def probe_scratch(mode: str, device="cuda") -> torch.Tensor:
    """P1 on `device`: the kernel on the card (one launch, or one per tile
    for "ring_launches", the ring in device memory between them and each
    launch under programmatic dependent launch), the plain version on the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return probe_scratch_reference(mode)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    kmode, rows, tiles, _ = SCRATCH_MODES[mode]
    lib = library()
    out = torch.empty(rows, tiles, 8, 128, device=dev)
    with torch.cuda.device(dev):
        if kmode == 4:
            ring = torch.empty(rows, 8, 128, device=dev)
            for j in range(tiles):
                rc = lib.wn_probe_scratch(ptr(out), ptr(ring), kmode, rows,
                                          tiles, j, _stream(dev))
                scratch_launches.add()
                raise_on(lib, rc, "wn_probe_scratch")
        else:
            rc = lib.wn_probe_scratch(ptr(out), None, kmode, rows, tiles, 0,
                                      _stream(dev))
            scratch_launches.add()
            raise_on(lib, rc, "wn_probe_scratch")
    return out


# ---------------------------------------------------------------------------
# P2: the gate's transcendentals
# ---------------------------------------------------------------------------

# the card's tanhf and expf against torch's CPU tanh and sigmoid: the most
# ulps apart any of probe_gate's three outputs may be (measured: 4 on an
# H100); more is a wrong gate, not the math library
GATE_ULPS = 4


def ulps(a, b) -> int:
    """The largest distance in ulps between f32 arrays a and b (their
    bit patterns read as ints; a and b of one sign where they differ)."""
    a = torch.as_tensor(a).detach().cpu().float().reshape(-1)
    b = torch.as_tensor(b).detach().cpu().float().reshape(-1)
    d = a.view(torch.int32).long() - b.view(torch.int32).long()
    return int(d.abs().max()) if d.numel() else 0


def probe_gate_reference(x: torch.Tensor):
    return torch.tanh(x), torch.sigmoid(x), torch.tanh(x) * torch.sigmoid(x)


def probe_gate(x: torch.Tensor):
    """(tanh(x), sigmoid(x), tanh(x) * sigmoid(x)) f32, elementwise: on
    the card through gate.cuh's functions (the kernels' gate), on the CPU
    torch's.  Any contiguous x, at any offset."""
    if _on(x) == "cpu":
        return probe_gate_reference(x)
    build.check_tensor("x", x, x.shape, torch.float32, x.device)
    lib = library()
    outs = [torch.empty_like(x) for _ in range(3)]
    with torch.cuda.device(x.device):
        rc = lib.wn_probe_gate(ptr(x), *map(ptr, outs), x.numel(),
                               _stream(x.device))
        gate_launches.add()
    raise_on(lib, rc, "wn_probe_gate")
    return tuple(outs)


# ---------------------------------------------------------------------------
# P3: lane concat and lane slices around a product
# ---------------------------------------------------------------------------

def _exact_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, the products summed exactly in f64, rounded once."""
    return (a.double() @ w.double()).float()


def probe_lane_ops_reference(case: str, *ops):
    """case a: ([a | b] @ w,); case b: (o[:, :64] * 2 + 1, o[:, 64:] * 3 - 1)
    of o = h @ w_rs; case c: ([x | y] contracted on its lanes with w,)."""
    if case == "a":
        a, b, w = ops
        return (_exact_dot(torch.cat([a, b], dim=1), w),)
    if case == "b":
        h, w_rs = ops
        o = _exact_dot(h, w_rs)
        return o[:, :64] * 2.0 + 1.0, o[:, 64:] * 3.0 - 1.0
    if case == "c":
        x, y, w = ops
        return (torch.cat([x, y], dim=1) @ w.T,)
    raise ValueError(f"unknown lane case {case!r}")


def probe_lane_ops(case: str, *ops):
    """P3 case a, b or c (operands as probe_lane_ops_reference takes them):
    the kernel on the card, the plain version on the CPU.  On the card
    every operand must start 16-byte aligned (the kernel stages them by
    16-byte copies): a view at an offset raises ValueError."""
    if _on(ops[0]) == "cpu":
        return probe_lane_ops_reference(case, *ops)
    dev, T = ops[0].device, ops[0].shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    if case == "a":
        a, b, w = ops
        shapes = (("a", a, (T, 64), bf), ("b", b, (T, 64), bf),
                  ("w", w, (128, 64), bf))
        which, args = 0, (a, b, w)
    elif case == "b":
        h, w_rs = ops
        shapes = (("h", h, (T, 64), bf), ("w_rs", w_rs, (64, 128), bf))
        which, args = 1, (h, None, w_rs)
    elif case == "c":
        x, y, w = ops
        shapes = (("x", x, (T, 64), f32), ("y", y, (T, 64), f32),
                  ("w", w, (64, 128), f32))
        which, args = 2, (x, y, w)
    else:
        raise ValueError(f"unknown lane case {case!r}")
    for name, t, shape, dtype in shapes:
        build.check_tensor(name, t, shape, dtype, dev)
    lib = library()
    for name, t, _, _ in shapes:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the "
                             f"kernel stages it by 16-byte copies)")
    o1 = torch.empty(T, 64, device=dev)
    o2 = torch.empty(T, 64, device=dev) if case == "b" else None
    with torch.cuda.device(dev):
        rc = lib.wn_probe_lane(which, *map(ptr, args), ptr(o1), ptr(o2), T,
                               _stream(dev))
        lane_launches.add()
    raise_on(lib, rc, "wn_probe_lane")
    return (o1,) if o2 is None else (o1, o2)


# ---------------------------------------------------------------------------
# P4: time-axis concatenations of the causal shift
# ---------------------------------------------------------------------------

def probe_shift_concat_reference(case: str, ring: torch.Tensor,
                                 x: torch.Tensor) -> torch.Tensor:
    """kA: concat(ring[off:off+d], x[:TT-d]) * 2; kB: the same with ring the
    4-D snapshot [1, 1, rows, R]; kC: concat(x[d:], ring[off:off+d]) * 2;
    kD: kC on v = x * 1.5."""
    rr = ring.reshape(-1, ring.shape[-1])[OFF:OFF + D]
    if case in ("A", "B"):
        v = torch.cat([rr, x[:x.shape[0] - D]], dim=0)
    elif case in ("C", "D"):
        xs = x * 1.5 if case == "D" else x
        v = torch.cat([xs[D:], rr], dim=0)
    else:
        raise ValueError(f"unknown shift case {case!r}")
    return v * 2.0


def probe_shift_concat(case: str, ring: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """P4 case A-D on ring ([rows, R], or [1, 1, rows, R] for B) and x
    [TT, R] f32: the kernel on the card, the plain version on the CPU.
    Any R and any contiguous ring and x, at any offset (the kernel takes
    16-byte units where R % 4 == 0 and every pointer is 16-byte aligned,
    else single elements)."""
    if _on(x) == "cpu":
        return probe_shift_concat_reference(case, ring, x)
    if case not in SHIFT_CASES:
        raise ValueError(f"unknown shift case {case!r}")
    dev = x.device
    T_, R_ = x.shape
    rows = ring.shape[-2]
    build.check_tensor("ring", ring, (1, 1, rows, R_) if case == "B"
                       else (rows, R_), torch.float32, dev)
    build.check_tensor("x", x, (T_, R_), torch.float32, dev)
    if rows < OFF + D or T_ < D:
        raise ValueError("ring or x too short for the probe's slices")
    lib = library()
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = lib.wn_probe_shift(SHIFT_CASES.index(case), ptr(ring), ptr(x),
                                ptr(out), T_, R_, D, OFF, _stream(dev))
        shift_launches.add()
    raise_on(lib, rc, "wn_probe_shift")
    return out
