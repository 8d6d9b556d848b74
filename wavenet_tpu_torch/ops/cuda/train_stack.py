"""Fused training stack: the layer-group forward and backward CUDA kernels
(csrc/train_stack.cu), their plain PyTorch versions, and the autograd op.

Counterpart of wavenet_tpu/ops/pallas/train_stack.py for width-2 models,
unconditional or mel-conditioned (y; speaker conditioning is not ported
yet, ROADMAP queue 2): the planner (`pick_tile`, `plan_dils`, `group_plan`,
`supported`), `_slice_group`/`_prep_weights` (here `prep_weights`),
`group_apply` (here the autograd.Function `_GroupApply`) with its forward
and backward, and `forward_skip_fused`.  Not ported: the multi-row `nb`
layouts, the roll-based causal shift, the interpret-mode rounding branch
and the Mosaic fences, all of which exist for the TPU's compiler.

Numerics (the reference's fused recipe, train_stack.py:352-419, 512-514):
the residual stream is carried in f32 through a layer group and rounded to
bf16 once, at the group's output; matrix operands are bf16 values summed
in f32; every cotangent inside the stack stays f32.  So the group
boundaries are part of the numerics, and the port plans its groups with
the reference's own arithmetic.

Routing is by the tensors' device: the plain versions run only for CPU
tensors; for CUDA tensors the wrappers launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.ops.cuda import build
from wavenet_tpu_torch.ops.shift import shift_right

# device kernels launched by each wrapper, as the library reports them, one
# count per variant: a forward group call launches Lg + 1, a backward one
# 10 per layer plus 2 (unconditional) or 12 per layer plus 2 (mel)
fwd_launches = build.LaunchCounter()
bwd_launches = build.LaunchCounter()
fwd_mel_launches = build.LaunchCounter()
bwd_mel_launches = build.LaunchCounter()

VMEM_BUDGET = 13 * 1024 * 1024
ROWS_PER_SPLIT = 1024        # rows per partial sum of a weight gradient
_MAX_SMEM = 227 * 1024

GROUP_KEYS = ("w_cur", "w_prev", "b", "w_res", "b_res", "w_skip", "b_skip")


# ---------------------------------------------------------------------------
# planner (the reference's arithmetic, single-row layout, no speaker)
# ---------------------------------------------------------------------------

def _pad8(d: int) -> int:
    return (d + 7) // 8 * 8


def _winpad(cfg: WaveNetConfig) -> int:
    return max(8, cfg.max_dilation)


def pick_tile(cfg: WaveNetConfig, T: int) -> int:
    """Largest power-of-two tile >= max(max_dilation, 8) that divides T,
    capped at 512; 0 when there is none."""
    lo = max(cfg.max_dilation, 8)
    tt = max(lo, 512)
    while tt > lo and T % tt:
        tt //= 2
    if T % tt or tt < lo:
        return 0
    return tt


def _group_sizes(cfg: WaveNetConfig, TT: int, dils) -> Tuple[int, int]:
    """The reference's on-chip bytes (fwd, bwd) of one layer group at one
    batch row per grid step (train_stack.py::_group_sizes, nb = (1, 1),
    mel terms included, no speaker terms).  The mel terms move the group
    boundaries: at `full_vocoder`, T = 8192 the plan has six groups where
    `full` has five."""
    R, S = cfg.residual_channels, cfg.skip_channels
    Lg = len(dils)
    sum_dg = sum(_pad8(d) for d in dils)
    maxd = _winpad(cfg)
    M = cfg.mel.num_mels if cfg.mel is not None else 0
    w = 2 * Lg * (4 * R * R + R * R + R * S) + 2 * Lg * M * 2 * R
    dw = (4 * Lg * (4 * R * R + R * R + R * S + 3 * R)
          + 4 * Lg * M * 2 * R)
    fwd = (w + 2 * sum_dg * R + 4 * (maxd + TT) * R + 4 * TT * M
           + 2 * (2 * TT * R * 2 + 4 * TT * S * 2 + 2 * sum_dg * R
                  + 2 * TT * R))
    bwd = (w + dw + 8 * TT * M + 2 * (Lg + 1) * TT * R
           + 4 * sum_dg * R + 4 * (maxd + TT) * R + 4 * (TT + maxd) * R
           + 2 * (2 * TT * R * 2 + 4 * TT * R * 4 + 4 * TT * S
                  + 2 * sum_dg * R))
    return fwd, bwd


def plan_dils(cfg: WaveNetConfig, dils, TT: int) -> List[Tuple[int, int]]:
    """Fewest contiguous layer groups whose reference kernels fit the
    reference's on-chip budget; [] when one layer alone does not fit.

    On the card the budget bounds nothing (each layer is its own launch);
    the plan only fixes where the residual stream is rounded to bf16, so
    the port's groups equal the reference's for the same (cfg, T) and the
    two give the same numerics."""
    L = len(dils)
    groups, lo = [], 0
    while lo < L:
        hi = lo + 1
        if max(_group_sizes(cfg, TT, dils[lo:hi])) > VMEM_BUDGET:
            return []
        while hi < L and max(_group_sizes(cfg, TT,
                                          dils[lo:hi + 1])) <= VMEM_BUDGET:
            hi += 1
        groups.append((lo, hi))
        lo = hi
    return groups


def group_plan(cfg: WaveNetConfig, TT: int) -> List[Tuple[int, int]]:
    return plan_dils(cfg, cfg.dilations, TT)


def supported(cfg: WaveNetConfig, T: int) -> bool:
    """Whether the fused stack takes (cfg, T): width-2, no speaker
    conditioning, a tileable T and a feasible group plan (the reference's
    `supported`)."""
    if cfg.kernel_size != 2 or cfg.global_classes is not None:
        return False
    TT = pick_tile(cfg, T)
    return bool(TT) and bool(group_plan(cfg, TT))


def _fwd_smem(R: int) -> int:
    """Shared memory of a forward block (train_stack.cu: fwd_smem)."""
    return (2 * 64 * 2 * R + 32 * 128) * 4


def _bwd_smem(R: int, S: int) -> int:
    """Shared memory of a backward block (train_stack.cu: bwd_smem)."""
    return (64 * max(2 * R, R + S) + 64 * 2 * R + 32 * 128) * 4


def _widths_taken(R: int, S: int, nm: int = 0) -> bool:
    """R, S and the mel count nm multiples of 4 (the kernels read rows of
    shared memory as float4), nm at most 2R (y rows are staged where xcat
    was), and a backward tile that fits one block's shared memory
    (R = 128, S = 256 needs 176 KiB)."""
    return (R % 4 == 0 and S % 4 == 0 and nm % 4 == 0 and nm <= 2 * R
            and max(_fwd_smem(R), _bwd_smem(R, S)) <= _MAX_SMEM)


def _num_mels(cfg: WaveNetConfig) -> int:
    return 0 if cfg.mel is None else cfg.mel.num_mels


def kernel_supported(cfg: WaveNetConfig) -> bool:
    """Whether the CUDA kernels take cfg's widths (every preset's do)."""
    return _widths_taken(cfg.residual_channels, cfg.skip_channels,
                         _num_mels(cfg))


def check_kernel_supported(cfg: WaveNetConfig) -> None:
    """Raise NotImplementedError when a fused-eligible cfg has widths the
    CUDA kernels do not take: on the card the fused stack runs only
    through the kernels, never through another path."""
    if not kernel_supported(cfg):
        raise NotImplementedError(
            f"the train_stack CUDA kernels do not take residual_channels="
            f"{cfg.residual_channels}, skip_channels={cfg.skip_channels}, "
            f"num_mels={_num_mels(cfg)} (multiples of 4 within one block's "
            f"shared memory, num_mels <= 2 R); other "
            f"widths wait for ROADMAP queue 2 item 4")


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def prep_weights(w_cur, w_prev, b, w_res, b_res, w_skip, b_skip,
                 v_cond=None):
    """One group's raw params -> kernel operands:
      wz  [Lg, 2R, 2R] bf16 = [w_cur ; w_prev] on the contraction axis
      b   [Lg, 2R] f32;  wrs [Lg, R, R+S] bf16 = [w_res | w_skip]
      b_res [Lg, R] f32;  b_skip [Lg, S] f32;
      with mel, v_cond [Lg, M, 2R] bf16 last."""
    Lg, R = w_cur.shape[0], w_cur.shape[1]
    bf, f32 = torch.bfloat16, torch.float32
    vc = () if v_cond is None else (
        v_cond.reshape(Lg, v_cond.shape[1], 2 * R).to(bf).contiguous(),)
    return (
        torch.cat([w_cur.reshape(Lg, R, 2 * R), w_prev.reshape(Lg, R, 2 * R)],
                  dim=1).to(bf).contiguous(),
        b.reshape(Lg, 2 * R).to(f32).contiguous(),
        torch.cat([w_res, w_skip], dim=2).to(bf).contiguous(),
        b_res.to(f32).contiguous(),
        b_skip.to(f32).contiguous(),
    ) + vc


def _causal(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[:, t - d], zero for t < d."""
    B, _, C = x.shape
    return shift_right(x, d, x.new_zeros(B, d, C))


def _anticausal(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[:, t + d], zero for t + d >= T (the transpose of _causal)."""
    out = torch.zeros_like(x)
    out[:, :x.shape[1] - d] = x[:, d:]
    return out


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def group_fwd_reference(x, skip, ops, dils: Sequence[int], y=None):
    """Plain PyTorch group forward: (x [B,T,R] f32 with bf16 values,
    skip [B,T,S] f32, with mel y [B,T,M] bf16 and ops ending in v_cond)
    -> (skip_out, x_out, xs [Lg+1,B,T,R] bf16 holding every layer's input
    and, last, the group output)."""
    wz, b, wrs, bres, bskip = ops[:5]
    R = x.shape[-1]
    carry = x.float()
    xs = [carry.to(torch.bfloat16)]
    for l, d in enumerate(dils):
        xb = xs[-1].float()
        xcat = torch.cat([xb, _causal(xb, d)], dim=-1)
        z = xcat @ wz[l].float() + b[l]
        if y is not None:
            z = z + y.float() @ ops[5][l].float()
        h = _bf(torch.tanh(z[..., :R]) * torch.sigmoid(z[..., R:]))
        o = h @ wrs[l].float()
        carry = (carry + o[..., :R]) + bres[l]
        skip = (skip + o[..., R:]) + bskip[l]
        xs.append(carry.to(torch.bfloat16))
    return skip, xs[-1].float(), torch.stack(xs)


def group_bwd_reference(xs, dskip, dx_out, ops, dils: Sequence[int],
                        y=None):
    """Plain PyTorch group backward, written out (not autograd) so every
    cotangent stays f32.  Returns (dx_in, dwz, db, dwrs, dbres, dbskip)
    with dbskip = the [S] sum of dskip (each layer's skip-bias gradient),
    and with mel (y [B,T,M] bf16) also dv_cond [Lg, M, 2R] and dy [B,T,M],
    dy summed over the layers in reverse order."""
    wz, b, wrs = ops[:3]
    Lg = len(dils)
    R = xs.shape[-1]
    S = dskip.shape[-1]
    dx = dx_out.float()
    dwz = torch.empty(Lg, 2 * R, 2 * R, device=dx.device)
    db = torch.empty(Lg, 2 * R, device=dx.device)
    dwrs = torch.empty(Lg, R, R + S, device=dx.device)
    dbres = torch.empty(Lg, R, device=dx.device)
    if y is not None:
        vc, yf = ops[5], y.float()
        M = y.shape[-1]
        dvc = torch.empty(Lg, M, 2 * R, device=dx.device)
        dy = None
    for l in reversed(range(Lg)):
        d = dils[l]
        xb = xs[l].float()
        xcat = torch.cat([xb, _causal(xb, d)], dim=-1)
        z = xcat @ wz[l].float() + b[l]
        if y is not None:
            z = z + yf @ vc[l].float()
        tf, sg = torch.tanh(z[..., :R]), torch.sigmoid(z[..., R:])
        h = _bf(tf * sg)
        dbres[l] = dx.sum(dim=(0, 1))
        dcat = torch.cat([dx, dskip], dim=-1)
        dh = dcat @ wrs[l].float().T
        dwrs[l] = h.reshape(-1, R).T @ dcat.reshape(-1, R + S)
        dz = torch.cat([dh * sg * (1.0 - tf * tf),
                        dh * tf * sg * (1.0 - sg)], dim=-1)
        dwz[l] = xcat.reshape(-1, 2 * R).T @ dz.reshape(-1, 2 * R)
        db[l] = dz.sum(dim=(0, 1))
        if y is not None:
            dvc[l] = yf.reshape(-1, M).T @ dz.reshape(-1, 2 * R)
            part = dz @ vc[l].float().T
            dy = part if dy is None else dy + part
        dboth = dz @ wz[l].float().T
        dx = (dx + dboth[..., :R]) + _anticausal(dboth[..., R:], d)
    out = (dx, dwz, db, dwrs, dbres, dskip.sum(dim=(0, 1)))
    return out if y is None else out + (dvc, dy)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wn_ts_group_fwd.argtypes = [p] * 14 + [i] * 6 + [p, p]
    lib.wn_ts_group_fwd.restype = i
    lib.wn_ts_group_bwd.argtypes = [p] * 9 + [i] * 6 + [p] * 14 + [i, p, p]
    lib.wn_ts_group_bwd.restype = i
    lib.wn_ts_colsum.argtypes = [p, i, i, p, p, i, p, p]
    lib.wn_ts_colsum.restype = i
    lib.wn_ts_error_string.argtypes = [i]
    lib.wn_ts_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The built and bound kernel library (builds on first use)."""
    lib = build.load("train_stack")
    _bind(lib)
    return lib


def _check_ops(ops, Lg, R, S, dev, y, B, T) -> int:
    """Check the operands (and y [B, T, M] bf16 with v_cond last in ops, or
    neither); returns M (0 without mel)."""
    bf, f32 = torch.bfloat16, torch.float32
    M = 0 if y is None else y.shape[-1]
    if len(ops) != (5 if y is None else 6):
        raise ValueError("ops end in v_cond exactly when y is given")
    for name, x, shape, dtype in zip(
            ("wz", "b", "wrs", "b_res", "b_skip", "v_cond"), ops,
            ((Lg, 2 * R, 2 * R), (Lg, 2 * R), (Lg, R, R + S), (Lg, R),
             (Lg, S), (Lg, M, 2 * R)), (bf, f32, bf, f32, f32, bf)):
        build.check_tensor(name, x, shape, dtype, dev)
    if y is not None:
        build.check_tensor("y", y, (B, T, M), bf, dev)
    return M


def _prepare(x: torch.Tensor, S: int, dils, what: str, y=None):
    """Shared checks of both wrappers; returns (lib, dims, dils array)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    B, T, R = x.shape
    nm = 0 if y is None else y.shape[-1]
    if not _widths_taken(R, S, nm):
        raise ValueError(f"{what}: widths R={R}, S={S}, M={nm} are not "
                         f"taken by the kernels (see kernel_supported)")
    if not dils or min(dils) < 1 or max(dils) > T:
        raise ValueError(f"{what}: dilations {tuple(dils)} must lie in "
                         f"[1, T={T}]")
    lib = library()
    return lib, (B, T, R), (ctypes.c_int * len(dils))(*dils)


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.wn_ts_error_string(rc).decode()})")


def _ptr(x) -> Optional[int]:
    return None if x is None else x.data_ptr()


def group_fwd(x: torch.Tensor, skip: torch.Tensor, ops, dils, y=None):
    """One layer group's forward (plain version for CPU tensors, the
    kernel for CUDA tensors): returns (skip_out, x_out, xs).  With mel,
    y [B, T, M] bf16 and ops ending in v_cond.  skip_out is a new tensor;
    the kernel could write it in place (it reads each skip element once
    before writing it), but a new buffer keeps autograd's view of the
    inputs unchanged at the cost of one [B, T, S] f32 buffer per live
    group."""
    if x.device.type == "cpu":
        return group_fwd_reference(x, skip, ops, dils, y)
    S = skip.shape[-1]
    lib, (B, T, R), dils_c = _prepare(x, S, dils, "group_fwd", y)
    dev, f32 = x.device, torch.float32
    Lg = len(dils)
    build.check_tensor("x", x, (B, T, R), f32, dev)
    build.check_tensor("skip", skip, (B, T, S), f32, dev)
    nm = _check_ops(ops, Lg, R, S, dev, y, B, T)
    skip_out = torch.empty_like(skip)
    x_out = torch.empty_like(x)
    xs = torch.empty(Lg + 1, B, T, R, dtype=torch.bfloat16, device=dev)
    carry = torch.empty_like(x)
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wn_ts_group_fwd(
            x.data_ptr(), skip.data_ptr(), skip_out.data_ptr(),
            x_out.data_ptr(), xs.data_ptr(), carry.data_ptr(),
            *(o.data_ptr() for o in ops[:5]), _ptr(y),
            _ptr(ops[5] if nm else None), ctypes.addressof(dils_c),
            Lg, B * T, T, R, S, nm, ctypes.byref(n), stream)
    (fwd_mel_launches if nm else fwd_launches).add(n.value)
    _raise_on(lib, rc, "wn_ts_group_fwd")
    return skip_out, x_out, xs


def group_bwd(xs: torch.Tensor, dskip: torch.Tensor, dx_out: torch.Tensor,
              ops, dils, y=None):
    """One layer group's backward (plain version for CPU tensors, the
    kernel for CUDA tensors): returns (dx_in, dwz, db, dwrs, dbres,
    dbskip), all f32, and with mel (y, ops ending in v_cond) also
    (dv_cond, dy); the weight gradients are fixed-order sums and dy a
    fixed-order sum over the layers, so two runs on the same inputs give
    the same bits."""
    if xs.device.type == "cpu":
        return group_bwd_reference(xs, dskip, dx_out, ops, dils, y)
    S = dskip.shape[-1]
    lib, (B, T, R), dils_c = _prepare(dx_out, S, dils, "group_bwd", y)
    dev, f32 = xs.device, torch.float32
    Lg = len(dils)
    M = B * T
    build.check_tensor("xs", xs, (Lg + 1, B, T, R), torch.bfloat16, dev)
    build.check_tensor("dskip", dskip, (B, T, S), f32, dev)
    build.check_tensor("dx_out", dx_out, (B, T, R), f32, dev)
    nm = _check_ops(ops, Lg, R, S, dev, y, B, T)
    nsplit = -(-M // ROWS_PER_SPLIT)
    e = lambda *shape, dtype=f32: torch.empty(*shape, dtype=dtype, device=dev)
    dx_in, dwz, db = e(B, T, R), e(Lg, 2 * R, 2 * R), e(Lg, 2 * R)
    dwrs, dbres, dbskip = e(Lg, R, R + S), e(Lg, R), e(S)
    dvc = dy = None
    if nm:
        dvc, dy = e(Lg, nm, 2 * R), e(B, T, nm)
    dxa, dxb, dprev, dz = e(M, R), e(M, R), e(M, R), e(M, 2 * R)
    h = e(M, R, dtype=torch.bfloat16)
    part = e(nsplit * max(4 * R * R, R * (R + S), 2 * R * nm))
    bpart = e(nsplit * max(2 * R, S))
    wz, b, wrs = ops[:3]
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wn_ts_group_bwd(
            xs.data_ptr(), dskip.data_ptr(), dx_out.data_ptr(),
            wz.data_ptr(), b.data_ptr(), wrs.data_ptr(), _ptr(y),
            _ptr(ops[5] if nm else None), ctypes.addressof(dils_c), Lg, M,
            T, R, S, nm, dx_in.data_ptr(), dwz.data_ptr(), db.data_ptr(),
            dwrs.data_ptr(), dbres.data_ptr(), _ptr(dvc), _ptr(dy),
            dxa.data_ptr(),
            dxb.data_ptr(), dprev.data_ptr(), dz.data_ptr(), h.data_ptr(),
            part.data_ptr(), bpart.data_ptr(), ROWS_PER_SPLIT,
            ctypes.byref(n), stream)
        if rc == 0:
            rc = lib.wn_ts_colsum(dskip.data_ptr(), M, S, dbskip.data_ptr(),
                                  bpart.data_ptr(), ROWS_PER_SPLIT,
                                  ctypes.byref(n), stream)
    (bwd_mel_launches if nm else bwd_launches).add(n.value)
    _raise_on(lib, rc, "wn_ts_group_bwd")
    out = (dx_in, dwz, db, dwrs, dbres, dbskip)
    return out if not nm else out + (dvc, dy)


# ---------------------------------------------------------------------------
# the differentiable group and the stack
# ---------------------------------------------------------------------------

class _GroupApply(torch.autograd.Function):
    """One layer group: (x, skip_in, y, raw group params) -> (skip_out,
    x_out), with group_bwd as its backward (the reference's custom VJP).
    y is the f32 upsampled mel features [B, T, M] (None without mel): it
    is rounded to bf16 here, inside the op, so its cotangent dy comes back
    f32, as the reference's VJP hands it to the upsampler."""

    @staticmethod
    def forward(ctx, dils, x, skip, y, w_cur, w_prev, b, w_res, b_res,
                w_skip, b_skip, v_cond):
        ops = prep_weights(w_cur, w_prev, b, w_res, b_res, w_skip, b_skip,
                           v_cond)
        yb = None if y is None else y.to(torch.bfloat16).contiguous()
        skip_out, x_out, xs = group_fwd(x, skip, ops, dils, yb)
        ctx.save_for_backward(xs, yb, *ops)
        ctx.dils = dils
        return skip_out, x_out

    @staticmethod
    def backward(ctx, dskip, dx_out):
        xs, yb, *ops = ctx.saved_tensors
        dils = ctx.dils
        dx, dwz, db, dwrs, dbres, dbskip, *cond = group_bwd(
            xs, dskip.float().contiguous(), dx_out.float().contiguous(),
            ops, dils, yb)
        Lg, R = len(dils), xs.shape[-1]
        S = dskip.shape[-1]
        dvc = dy = None
        if cond:
            dvc, dy = cond
            dvc = dvc.reshape(Lg, dvc.shape[1], 2, R)
        return (None, dx, dskip, dy,
                dwz[:, :R].reshape(Lg, R, 2, R),
                dwz[:, R:].reshape(Lg, R, 2, R),
                db.reshape(Lg, 2, R),
                dwrs[..., :R], dbres, dwrs[..., R:],
                dbskip.expand(Lg, S), dvc)


def forward_skip_fused(params, cfg: WaveNetConfig, x: torch.Tensor,
                       tile=None, y=None) -> torch.Tensor:
    """Embedded input [B, T, R] (f32 holding bf16 values) -> skip sum
    [B, T, S] f32 through the layer groups of group_plan(cfg, tile).
    y: the upsampled mel features [B, T, M] f32 of a mel model (None
    otherwise).  Callers check supported(cfg, T) first; on a CUDA device
    widths the kernels do not take raise NotImplementedError."""
    B, T, R = x.shape
    TT = tile or pick_tile(cfg, T)
    if not TT:
        raise ValueError(f"T={T} is not tileable for this config; gate "
                         f"fused paths on train_stack.supported(cfg, T)")
    if T % TT:
        raise ValueError(f"tile={TT} does not divide T={T}")
    if cfg.global_classes is not None:
        raise NotImplementedError(
            "speaker-conditioned fused stacks are not ported yet (ROADMAP "
            "queue 2)")
    if (y is None) != (cfg.mel is None):
        raise ValueError("y is required with cfg.mel, and only then")
    groups = group_plan(cfg, TT)
    if not groups:
        raise ValueError("no feasible group plan; gate on supported()")
    if x.device.type == "cuda":
        check_kernel_supported(cfg)
    skip = torch.zeros(B, T, cfg.skip_channels, device=x.device)
    x_g = x.float().contiguous()
    y = None if y is None else y.float()
    for lo, hi in groups:
        skip, x_g = _GroupApply.apply(
            tuple(cfg.dilations[lo:hi]), x_g, skip, y,
            *(params[k][lo:hi] for k in GROUP_KEYS),
            None if y is None else params["v_cond"][lo:hi])
    return skip
