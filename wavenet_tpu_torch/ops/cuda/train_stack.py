"""Fused training stack: the layer-group forward and backward CUDA kernels
(csrc/train_stack.cu), their plain PyTorch versions, and the autograd op.

Counterpart of wavenet_tpu/ops/pallas/train_stack.py for width-2 models,
unconditional, mel-conditioned (y) or speaker-conditioned (g, the
per-row gate offsets), alone or together: the planner (`pick_tile`,
`plan_dils`, `group_plan`, `supported`), `_slice_group`/`_prep_weights`
(here `prep_weights`),
`group_apply` (here the autograd.Function `_GroupApply`) with its forward
and backward, and `forward_skip_fused`.  Not ported: the multi-row `nb`
layouts, the roll-based causal shift, the interpret-mode rounding branch
and the Mosaic fences, all of which exist for the TPU's compiler.

Numerics (the reference's fused recipe, train_stack.py:352-419, 512-514):
the residual stream is carried in f32 through a layer group and rounded to
bf16 once, at the group's output; matrix operands are bf16 values summed
in f32 (the forward's products, and the backward's recompute of them,
summed exactly and rounded to f32 once: `_mm`); every cotangent inside the
stack stays f32.  So the group boundaries are part of the numerics, and
the port plans its groups with the reference's own arithmetic.

Routing is by the tensors' device: the plain versions run only for CPU
tensors; for CUDA tensors the wrappers launch the kernels or raise.  The
kernels take every width `supported` takes: a layer block of 64, 32 or 16
rows, the largest that fits an SM's shared memory (`fwd_rows`,
`bwd_rows`), and widths that are not multiples of 4 zero-padded to them
(`pad_ops`, `fwd_padded`, `bwd_padded`).
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.ops.cuda import build
from wavenet_tpu_torch.ops.shift import shift_right

# device kernels launched by each wrapper, as the library reports them, one
# count per variant (unconditional, mel, and speaker with or without mel):
# a forward group call launches Lg + 1; a backward one
# (7 + 2 mel + speaker) Lg + 1, mel and speaker each 1 or 0
fwd_launches = build.LaunchCounter()
bwd_launches = build.LaunchCounter()
fwd_mel_launches = build.LaunchCounter()
bwd_mel_launches = build.LaunchCounter()
fwd_gc_launches = build.LaunchCounter()
bwd_gc_launches = build.LaunchCounter()
# the backward's column sums called alone (column_sums), one a call
colsum_launches = build.LaunchCounter()

# group calls of the kernels by direction and row tile ("fwd64", "bwd32",
# ...): which layer block each width launched
tile_calls = collections.Counter()

VMEM_BUDGET = 13 * 1024 * 1024
ROWS_PER_SPLIT = 1024        # rows per partial sum of a weight gradient
COLSUM_STRIP = 32            # columns a block of the column sums owns
ROW_TILES = (64, 32, 16)     # rows of a layer block, the largest first
_MAX_SMEM = 227 * 1024

GROUP_KEYS = ("w_cur", "w_prev", "b", "w_res", "b_res", "w_skip", "b_skip")


# ---------------------------------------------------------------------------
# planner (the reference's arithmetic, single-row layout)
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
    mel and speaker terms included).  The mel terms move the group
    boundaries: at `full_vocoder`, T = 8192 the plan has six groups where
    `full` has five; the speaker's g block (gc = 8 Lg R bytes) moves them
    at some widths (`full` with S = 512 and 109 speakers)."""
    R, S = cfg.residual_channels, cfg.skip_channels
    Lg = len(dils)
    sum_dg = sum(_pad8(d) for d in dils)
    maxd = _winpad(cfg)
    M = cfg.mel.num_mels if cfg.mel is not None else 0
    gc = 8 * Lg * R if cfg.global_classes is not None else 0
    w = 2 * Lg * (4 * R * R + R * R + R * S) + 2 * Lg * M * 2 * R
    dw = (4 * Lg * (4 * R * R + R * R + R * S + 3 * R)
          + 4 * Lg * M * 2 * R)
    fwd = (w + gc + 2 * sum_dg * R + 4 * (maxd + TT) * R + 4 * TT * M
           + 2 * (2 * TT * R * 2 + 4 * TT * S * 2 + 2 * sum_dg * R
                  + 2 * TT * R))
    bwd = (w + dw + 8 * TT * M + 2 * gc + 2 * (Lg + 1) * TT * R
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


def config_taken(cfg: WaveNetConfig) -> bool:
    """Whether the stack computes cfg's model at all: kernel_size 2,
    causal_channels == residual_channels and compute_dtype bfloat16 (the
    kernels compute in bf16, as the reference's Pallas kernels do), at any
    param_dtype.  Every other model, float16 and float32 compute among
    them, trains on the scan (models/wavenet.forward_logits)."""
    return (cfg.kernel_size == 2 and cfg.compute_dtype == "bfloat16"
            and cfg.embed_channels == cfg.residual_channels)


def supported(cfg: WaveNetConfig, T: int) -> bool:
    """Whether the fused stack takes (cfg, T): config_taken, a tileable T
    and a feasible group plan (the reference's `supported`)."""
    if not config_taken(cfg):
        return False
    TT = pick_tile(cfg, T)
    return bool(TT) and bool(group_plan(cfg, TT))


# two stages of a weight's rows: f64 [16][128] in the forward, bf16
# [32][128] in the backward
_W_FWD, _W_BWD = 2 * 16 * 128 * 8, 2 * 32 * 128 * 2


def _tile(K: int, rows: int = 64) -> int:
    """Bytes of a layer block's bf16 operand tile with K columns: `rows`
    rows of K + 8 elements (train_stack.cu: tile_ld); none for K = 0."""
    return rows * (K + 8) * 2 if K else 0


def _fwd_smem(R: int, nm: int = 0, rows: int = 64) -> int:
    """Shared memory of a forward layer block of `rows` rows, the one plan
    of it: bf16 tiles of xcat (2R columns), h (R) and, with mel, y (nm),
    and the staged weights; group_fwd passes it to the library, which
    refuses a size smaller than its layout needs (82 KiB at `full`, 93 KiB
    with mel: two blocks per SM)."""
    return _tile(2 * R, rows) + _tile(R, rows) + _tile(nm, rows) + _W_FWD


def _bwd_smem(R: int, S: int, nm: int = 0, rows: int = 64) -> int:
    """Shared memory of a backward layer block of `rows` rows, the one
    plan of it: the larger of f32 [rows][max(2R, R + S)] (dcat, then dz)
    and the bf16 tiles of xcat and y (the recompute of z), + f32
    [rows][2R] (tanh and sigmoid, then dz) + the staged weights; group_bwd
    passes it to the library, which refuses a size smaller than its layout
    needs."""
    return (max(rows * max(2 * R, R + S) * 4,
                _tile(2 * R, rows) + _tile(nm, rows))
            + rows * 2 * R * 4 + _W_BWD)


def fwd_rows(R: int, nm: int = 0) -> int:
    """The row tile of a forward layer block at the kernels' widths (R, nm
    multiples of 4): the largest of ROW_TILES whose block fits an SM's
    227 KiB (64 at every preset); 0 when none does."""
    return next((r for r in ROW_TILES if _fwd_smem(R, nm, r) <= _MAX_SMEM),
                0)


def bwd_rows(R: int, S: int, nm: int = 0) -> int:
    """The row tile of a backward layer block, as fwd_rows (64 at every
    preset, 32 at R = S = 256 and at `full` with S = 512 or 1,024)."""
    return next((r for r in ROW_TILES if _bwd_smem(R, S, nm, r) <= _MAX_SMEM),
                0)


def _num_mels(cfg: WaveNetConfig) -> int:
    return 0 if cfg.mel is None else cfg.mel.num_mels


def kernel_supported(cfg: WaveNetConfig) -> bool:
    """Whether the CUDA kernels plan a layer block for cfg's widths, each
    padded to a multiple of 4 (pad_ops): true for every width the
    reference's `supported` fuses (tests/test_torch_train_stack_plan.py
    sweeps them)."""
    R, S, nm = padded_widths(cfg.residual_channels, cfg.skip_channels,
                             _num_mels(cfg))
    return bool(fwd_rows(R, nm) and bwd_rows(R, S, nm))


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


def _pad_parts(t: torch.Tensor, dim: int, sizes, padded) -> torch.Tensor:
    """t's axis `dim` cut into parts of `sizes`, each zero-padded at its
    end to its size in `padded`, joined again (t itself when nothing
    grows)."""
    if tuple(sizes) == tuple(padded):
        return t
    out = []
    for part, n in zip(torch.split(t, list(sizes), dim=dim), padded):
        shape = list(part.shape)
        shape[dim] = n - shape[dim]
        out += [part, part.new_zeros(shape)]
    return torch.cat(out, dim=dim)


def _unpad_parts(t: torch.Tensor, dim: int, sizes, padded) -> torch.Tensor:
    """The inverse of _pad_parts: the first sizes[i] of each padded part."""
    if tuple(sizes) == tuple(padded):
        return t
    return torch.cat([part.narrow(dim, 0, n) for part, n in zip(
        torch.split(t, list(padded), dim=dim), sizes)], dim=dim).contiguous()


def padded_widths(R: int, S: int, nm: int = 0) -> Tuple[int, int, int]:
    """The widths the kernels compute at: R, S and nm rounded up to
    multiples of 4 (their copies move 4 elements, and shared memory is read
    as float4)."""
    return tuple(-(-n // 4) * 4 for n in (R, S, nm))


def pad_ops(ops, R: int, S: int, Rp: int, Sp: int, nm: int = 0,
            nmp: int = 0):
    """prep_weights' operands at widths (R, S, nm) -> the same at (Rp, Sp,
    nmp), every added row and column zero: each half of wz's and b's 2R
    (filter, gate; current, previous), W_res and W_skip's columns apart,
    v_cond's rows.  A padded channel's z is 0, so its gate tanh(0) *
    sigmoid(0) = 0, and every added product is an exact zero: the real
    channels' forward is unchanged bit for bit."""
    wz, b, wrs, bres, bskip = ops[:5]
    r2, r2p = (R, R), (Rp, Rp)
    out = (_pad_parts(_pad_parts(wz, 1, r2, r2p), 2, r2, r2p),
           _pad_parts(b, 1, r2, r2p),
           _pad_parts(_pad_parts(wrs, 1, (R,), (Rp,)), 2, (R, S), (Rp, Sp)),
           _pad_parts(bres, 1, (R,), (Rp,)),
           _pad_parts(bskip, 1, (S,), (Sp,)))
    if len(ops) > 5:
        out += (_pad_parts(_pad_parts(ops[5], 1, (nm,), (nmp,)), 2, r2,
                           r2p),)
    return out


def fwd_padded(fwd, x, skip, ops, dils, y=None, g=None, **kw):
    """fwd (group_fwd or group_fwd_reference) at the padded widths
    (padded_widths), its results cut back to (R, S): (skip_out, x_out,
    xs)."""
    R, S = x.shape[-1], skip.shape[-1]
    nm = 0 if y is None else y.shape[-1]
    Rp, Sp, nmp = padded_widths(R, S, nm)
    r, s, h = ((R,), (Rp,)), ((S,), (Sp,)), ((R, R), (Rp, Rp))
    skip_o, x_o, xs = fwd(
        _pad_parts(x, -1, *r), _pad_parts(skip, -1, *s),
        pad_ops(ops, R, S, Rp, Sp, nm, nmp), dils,
        None if y is None else _pad_parts(y, -1, (nm,), (nmp,)),
        None if g is None else _pad_parts(g, -1, *h), **kw)
    return (_unpad_parts(skip_o, -1, *s), _unpad_parts(x_o, -1, *r),
            _unpad_parts(xs, -1, *r))


def bwd_padded(bwd, xs, dskip, dx_out, ops, dils, y=None, g=None, **kw):
    """bwd (group_bwd or group_bwd_reference) at the padded widths, every
    gradient cut back to the real channels (the padded ones' are
    dropped)."""
    R, S = xs.shape[-1], dskip.shape[-1]
    nm = 0 if y is None else y.shape[-1]
    Rp, Sp, nmp = padded_widths(R, S, nm)
    r, s, h = ((R,), (Rp,)), ((S,), (Sp,)), ((R, R), (Rp, Rp))
    dx, dwz, db, dwrs, dbres, dbskip, *cond = bwd(
        _pad_parts(xs, -1, *r), _pad_parts(dskip, -1, *s),
        _pad_parts(dx_out, -1, *r), pad_ops(ops, R, S, Rp, Sp, nm, nmp),
        dils, None if y is None else _pad_parts(y, -1, (nm,), (nmp,)),
        None if g is None else _pad_parts(g, -1, *h), **kw)
    out = (_unpad_parts(dx, -1, *r),
           _unpad_parts(_unpad_parts(dwz, 1, *h), 2, *h),
           _unpad_parts(db, 1, *h),
           _unpad_parts(_unpad_parts(dwrs, 1, *r), 2, (R, S), (Rp, Sp)),
           _unpad_parts(dbres, 1, *r), _unpad_parts(dbskip, 0, *s))
    if y is not None:
        dvc, dy = cond[:2]
        out += (_unpad_parts(_unpad_parts(dvc, 1, (nm,), (nmp,)), 2, *h),
                _unpad_parts(dy, -1, (nm,), (nmp,)))
    if g is not None:
        out += (_unpad_parts(cond[-1], -1, *h),)
    return out


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


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w of bf16-valued operands, summed exactly and rounded to f32
    once, as the kernels sum them: every product of two bf16 values is
    exact in float64, and so is their sum while the terms lie within
    ~2^37 of each other.  Any such summation rounds to the same f32, so
    the kernel forward equals this one bit for bit; two f32 sums in
    different orders would drift ~2% apart over 40 layers (the bf16
    roundings of h and of each layer's input carry their last-bit
    differences), outside the reference suite's bands."""
    return (a.double() @ w.double()).float()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def group_fwd_reference(x, skip, ops, dils: Sequence[int], y=None, g=None):
    """Plain PyTorch group forward: (x [B,T,R] f32 with bf16 values,
    skip [B,T,S] f32, with mel y [B,T,M] bf16 and ops ending in v_cond,
    with a speaker g [B,Lg,2R] f32) -> (skip_out, x_out, xs [Lg+1,B,T,R]
    bf16 holding every layer's input and, last, the group output)."""
    wz, b, wrs, bres, bskip = ops[:5]
    R = x.shape[-1]
    carry = x.float()
    xs = [carry.to(torch.bfloat16)]
    for l, d in enumerate(dils):
        xb = xs[-1].float()
        xcat = torch.cat([xb, _causal(xb, d)], dim=-1)
        z = _mm(xcat, wz[l]) + b[l]
        if y is not None:
            z = z + _mm(y, ops[5][l])
        if g is not None:
            z = z + g[:, l, None]
        h = _bf(torch.tanh(z[..., :R]) * torch.sigmoid(z[..., R:]))
        o = _mm(h, wrs[l])
        carry = (carry + o[..., :R]) + bres[l]
        skip = (skip + o[..., R:]) + bskip[l]
        xs.append(carry.to(torch.bfloat16))
    return skip, xs[-1].float(), torch.stack(xs)


def group_bwd_reference(xs, dskip, dx_out, ops, dils: Sequence[int],
                        y=None, g=None):
    """Plain PyTorch group backward, written out (not autograd) so every
    cotangent stays f32.  Returns (dx_in, dwz, db, dwrs, dbres, dbskip)
    with dbskip = the [S] sum of dskip (each layer's skip-bias gradient),
    with mel (y [B,T,M] bf16) also dv_cond [Lg, M, 2R] and dy [B,T,M],
    dy summed over the layers in reverse order, and with a speaker (g
    [B,Lg,2R] f32) last dg [B, Lg, 2R], each row's sum of dz over time."""
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
    if g is not None:
        dg = torch.empty_like(g)
    for l in reversed(range(Lg)):
        d = dils[l]
        xb = xs[l].float()
        xcat = torch.cat([xb, _causal(xb, d)], dim=-1)
        z = _mm(xcat, wz[l]) + b[l]
        if y is not None:
            z = z + _mm(yf, vc[l])
        if g is not None:
            z = z + g[:, l, None]
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
        if g is not None:
            dg[:, l] = dz.sum(dim=1)
        if y is not None:
            dvc[l] = yf.reshape(-1, M).T @ dz.reshape(-1, 2 * R)
            part = dz @ vc[l].float().T
            dy = part if dy is None else dy + part
        dboth = dz @ wz[l].float().T
        dx = (dx + dboth[..., :R]) + _anticausal(dboth[..., R:], d)
    out = (dx, dwz, db, dwrs, dbres, dskip.sum(dim=(0, 1)))
    if y is not None:
        out += (dvc, dy)
    return out if g is None else out + (dg,)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wn_ts_group_fwd.argtypes = [p] * 15 + [i] * 8 + [p, p]
    lib.wn_ts_group_fwd.restype = i
    lib.wn_ts_group_bwd.argtypes = ([p] * 10 + [i] * 6 + [p] * 16
                                    + [i, i, i, p, p])
    lib.wn_ts_group_bwd.restype = i
    lib.wn_ts_colsum.argtypes = [p, i, p, p, i, p, i, i, p, p, i, p, p]
    lib.wn_ts_colsum.restype = i
    lib.wn_ts_error_string.argtypes = [i]
    lib.wn_ts_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The built and bound kernel library (builds on first use)."""
    lib = build.load("train_stack")
    _bind(lib)
    return lib


def _check_ops(ops, Lg, R, S, dev, y, B, T, g=None) -> int:
    """Check the operands (and y [B, T, M] bf16 with v_cond last in ops, or
    neither; and g [B, Lg, 2R] f32 when given); returns M (0 without
    mel)."""
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
    if g is not None:
        build.check_tensor("g", g, (B, Lg, 2 * R), f32, dev)
    return M


def _prepare(x: torch.Tensor, dils, what: str):
    """Shared checks of both wrappers; returns (lib, dims, dils array)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    B, T, R = x.shape
    if not dils or min(dils) < 1 or max(dils) > T:
        raise ValueError(f"{what}: dilations {tuple(dils)} must lie in "
                         f"[1, T={T}]")
    lib = library()
    return lib, (B, T, R), (ctypes.c_int * len(dils))(*dils)


def _check_aligned(what: str, named) -> None:
    """The kernels' cp.async copies read 8 or 16 bytes at a time; fresh
    allocations start on such a boundary, a view into one may not."""
    for name, t in named:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte "
                             f"boundary")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.wn_ts_error_string(rc).decode()})")


def _ptr(x) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _counters(nm: int, g, fwd: bool) -> build.LaunchCounter:
    """The count a launch of this variant bumps: speaker (with or without
    mel), mel, or unconditional."""
    if g is not None:
        return fwd_gc_launches if fwd else bwd_gc_launches
    if nm:
        return fwd_mel_launches if fwd else bwd_mel_launches
    return fwd_launches if fwd else bwd_launches


def _plan_rows(what: str, rows: Optional[int], planned: int, widths) -> int:
    """The row tile to launch: `rows` when the caller forces one (the
    library refuses a block that does not fit), else the planned one."""
    rows = planned if rows is None else rows
    if rows not in ROW_TILES:
        raise ValueError(f"{what}: row tile {rows} at widths {widths}; the "
                         f"kernels take {ROW_TILES} rows (planned: "
                         f"{planned}, 0 when no block fits)")
    return rows


def group_fwd(x: torch.Tensor, skip: torch.Tensor, ops, dils, y=None,
              g=None, rows: Optional[int] = None):
    """One layer group's forward (plain version for CPU tensors, the
    kernel for CUDA tensors): returns (skip_out, x_out, xs).  With mel,
    y [B, T, M] bf16 and ops ending in v_cond; with a speaker, g [B, Lg, 2R]
    f32 (each row's gate offsets).  skip_out is a new tensor;
    the kernel could write it in place (it reads each skip element once
    before writing it), but a new buffer keeps autograd's view of the
    inputs unchanged at the cost of one [B, T, S] f32 buffer per live
    group.  Widths that are not multiples of 4 run padded (fwd_padded);
    rows forces the layer block's row tile (fwd_rows plans it; every tile
    gives the same bits)."""
    if x.device.type == "cpu":
        return group_fwd_reference(x, skip, ops, dils, y, g)
    S = skip.shape[-1]
    nm = 0 if y is None else y.shape[-1]
    if padded_widths(x.shape[-1], S, nm) != (x.shape[-1], S, nm):
        return fwd_padded(group_fwd, x, skip, ops, dils, y, g, rows=rows)
    lib, (B, T, R), dils_c = _prepare(x, dils, "group_fwd")
    rows = _plan_rows("group_fwd", rows, fwd_rows(R, nm), (R, nm))
    dev, f32 = x.device, torch.float32
    Lg = len(dils)
    build.check_tensor("x", x, (B, T, R), f32, dev)
    build.check_tensor("skip", skip, (B, T, S), f32, dev)
    nm = _check_ops(ops, Lg, R, S, dev, y, B, T, g)
    _check_aligned("group_fwd", (("y", y), ("wz", ops[0]), ("wrs", ops[2]),
                                 ("v_cond", ops[5] if nm else None)))
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
            _ptr(ops[5] if nm else None), _ptr(g), ctypes.addressof(dils_c),
            Lg, B * T, T, R, S, nm, rows, _fwd_smem(R, nm, rows),
            ctypes.byref(n), stream)
    _counters(nm, g, fwd=True).add(n.value)
    _raise_on(lib, rc, "wn_ts_group_fwd")
    tile_calls[f"fwd{rows}"] += 1
    return skip_out, x_out, xs


def _colsum_scratch(plans, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column sums' partials (f32) and arrival counts (zeros), enough
    for each (B, T, widths) of `plans`: one launch summing tensors of those
    widths per batch row of T rows (csrc/train_stack.cu: colsum)."""
    plans = [(B, T, sum(-(-N // COLSUM_STRIP) for N in widths))
             for B, T, widths in plans]
    nparts = max(strips * COLSUM_STRIP * B * -(-T // ROWS_PER_SPLIT)
                 for B, T, strips in plans)
    ncount = max(B * strips for B, _, strips in plans)
    return (torch.empty(nparts, dtype=torch.float32, device=dev),
            torch.zeros(ncount, dtype=torch.int32, device=dev))


def column_sums(*xs: torch.Tensor, T: Optional[int] = None):
    """Column sums of one or two f32 tensors [M, N] of the same rows, per
    batch row of T rows (T = M, the default: over all rows): a tuple of
    [M // T, N], one a tensor, through the kernel that sums the backward's
    bias gradients, called alone (two tensors in one launch, as group_bwd
    sums db and db_res): each split of ROWS_PER_SPLIT rows (never two batch
    rows) summed row by row in f32, then a batch row's splits in order, so
    group_bwd's bits.  Each N a multiple of 4.  The plain version (CPU
    tensors) is torch's sum, in another order."""
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"column_sums: one or two tensors, got {len(xs)}")
    M, dev = xs[0].shape[0], xs[0].device
    T = M if T is None else T
    if T <= 0 or M % T:
        raise ValueError(f"column_sums: T={T} must divide M={M}")
    if dev.type == "cpu":
        return tuple(x.reshape(M // T, T, -1).sum(dim=1) for x in xs)
    for x in xs:
        build.check_tensor("x", x, (M, x.shape[-1]), torch.float32, dev)
        if x.shape[-1] % 4:
            raise ValueError(f"column_sums: N={x.shape[-1]} must be a "
                             f"multiple of 4")
    _check_aligned("column_sums", [("x", x) for x in xs])
    lib = library()
    widths = tuple(x.shape[-1] for x in xs)
    part, count = _colsum_scratch(((M // T, T, widths),), dev)
    outs = tuple(torch.empty(M // T, N, dtype=torch.float32, device=dev)
                 for N in widths)
    b, nb, ob = ((xs[1].data_ptr(), widths[1], outs[1].data_ptr())
                 if len(xs) == 2 else (None, 0, None))
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.wn_ts_colsum(
            xs[0].data_ptr(), widths[0], outs[0].data_ptr(), b, nb, ob, M, T,
            part.data_ptr(), count.data_ptr(), ROWS_PER_SPLIT,
            ctypes.byref(n), torch.cuda.current_stream(dev).cuda_stream)
    colsum_launches.add(n.value)
    _raise_on(lib, rc, "wn_ts_colsum")
    return outs


def group_bwd(xs: torch.Tensor, dskip: torch.Tensor, dx_out: torch.Tensor,
              ops, dils, y=None, g=None, rows: Optional[int] = None):
    """One layer group's backward (plain version for CPU tensors, the
    kernel for CUDA tensors): returns (dx_in, dwz, db, dwrs, dbres,
    dbskip), all f32, with mel (y, ops ending in v_cond) also (dv_cond,
    dy), and with a speaker (g [B, Lg, 2R]) last dg [B, Lg, 2R]; the weight
    gradients and dg are fixed-order sums and dy a fixed-order sum over
    the layers, so two runs on the same inputs give the same bits.
    Widths that are not multiples of 4 run padded (bwd_padded); rows
    forces the layer block's row tile (bwd_rows plans it; every tile gives
    the same bits)."""
    if xs.device.type == "cpu":
        return group_bwd_reference(xs, dskip, dx_out, ops, dils, y, g)
    S = dskip.shape[-1]
    nm = 0 if y is None else y.shape[-1]
    if padded_widths(xs.shape[-1], S, nm) != (xs.shape[-1], S, nm):
        return bwd_padded(group_bwd, xs, dskip, dx_out, ops, dils, y, g,
                          rows=rows)
    lib, (B, T, R), dils_c = _prepare(dx_out, dils, "group_bwd")
    rows = _plan_rows("group_bwd", rows, bwd_rows(R, S, nm), (R, S, nm))
    dev, f32 = xs.device, torch.float32
    Lg = len(dils)
    M = B * T
    build.check_tensor("xs", xs, (Lg + 1, B, T, R), torch.bfloat16, dev)
    build.check_tensor("dskip", dskip, (B, T, S), f32, dev)
    build.check_tensor("dx_out", dx_out, (B, T, R), f32, dev)
    nm = _check_ops(ops, Lg, R, S, dev, y, B, T, g)
    _check_aligned("group_bwd", (("xs", xs), ("dskip", dskip),
                                 ("dx_out", dx_out), ("y", y),
                                 ("wz", ops[0]), ("wrs", ops[2]),
                                 ("v_cond", ops[5] if nm else None)))
    nsplit = -(-M // ROWS_PER_SPLIT)
    e = lambda *shape, dtype=f32: torch.empty(*shape, dtype=dtype, device=dev)
    dx_in, dwz, db = e(B, T, R), e(Lg, 2 * R, 2 * R), e(Lg, 2 * R)
    dwrs, dbres, dbskip = e(Lg, R, R + S), e(Lg, R), e(S)
    dvc = dy = dg = None
    if nm:
        dvc, dy = e(Lg, nm, 2 * R), e(B, T, nm)
    if g is not None:
        dg = e(B, Lg, 2 * R)
    dxa, dxb, dprev, dz = e(M, R), e(M, R), e(M, R), e(M, 2 * R)
    h = e(M, R, dtype=torch.bfloat16)
    part = e(nsplit * max(4 * R * R, R * (R + S), 2 * R * nm))
    # the column sums' partials and arrival counts: db and db_res in one
    # launch, db_skip, and dg per batch row
    bpart, count = _colsum_scratch(
        ((1, M, (2 * R, R)), (1, M, (S,)))
        + (() if g is None else ((B, T, (2 * R,)),)), dev)
    wz, b, wrs = ops[:3]
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wn_ts_group_bwd(
            xs.data_ptr(), dskip.data_ptr(), dx_out.data_ptr(),
            wz.data_ptr(), b.data_ptr(), wrs.data_ptr(), _ptr(y),
            _ptr(ops[5] if nm else None), _ptr(g), ctypes.addressof(dils_c),
            Lg, M, T, R, S, nm, dx_in.data_ptr(), dwz.data_ptr(),
            db.data_ptr(), dwrs.data_ptr(), dbres.data_ptr(), _ptr(dvc),
            _ptr(dy), _ptr(dg), dxa.data_ptr(),
            dxb.data_ptr(), dprev.data_ptr(), dz.data_ptr(), h.data_ptr(),
            part.data_ptr(), bpart.data_ptr(), count.data_ptr(),
            ROWS_PER_SPLIT, rows, _bwd_smem(R, S, nm, rows), ctypes.byref(n),
            stream)
        if rc == 0:
            rc = lib.wn_ts_colsum(dskip.data_ptr(), S, dbskip.data_ptr(),
                                  None, 0, None, M, M, bpart.data_ptr(),
                                  count.data_ptr(), ROWS_PER_SPLIT,
                                  ctypes.byref(n), stream)
    _counters(nm, g, fwd=False).add(n.value)
    _raise_on(lib, rc, "wn_ts_group_bwd")
    tile_calls[f"bwd{rows}"] += 1
    out = (dx_in, dwz, db, dwrs, dbres, dbskip)
    if nm:
        out += (dvc, dy)
    return out if g is None else out + (dg,)


# ---------------------------------------------------------------------------
# the differentiable group and the stack
# ---------------------------------------------------------------------------

class _GroupApply(torch.autograd.Function):
    """One layer group: (x, skip_in, y, g, raw group params) -> (skip_out,
    x_out), with group_bwd as its backward (the reference's custom VJP).
    y is the f32 upsampled mel features [B, T, M] (None without mel): it
    is rounded to bf16 here, inside the op, so its cotangent dy comes back
    f32, as the reference's VJP hands it to the upsampler.  g is the
    group's speaker offsets [B, Lg, 2R] f32 (None without a speaker); its
    cotangent dg is f32.  The weights may be f32, bf16 or f16 leaves
    (cfg.param_dtype; prep_weights casts them to the kernels' operands):
    their cotangents are summed over every row and tile in f32 and rounded
    once to each leaf's dtype here, at the group's end, where the
    reference's VJP casts them (ops/pallas/train_stack.py's
    _group_vjp_bwd)."""

    @staticmethod
    def forward(ctx, dils, x, skip, y, g, w_cur, w_prev, b, w_res, b_res,
                w_skip, b_skip, v_cond):
        ops = prep_weights(w_cur, w_prev, b, w_res, b_res, w_skip, b_skip,
                           v_cond)
        yb = None if y is None else y.to(torch.bfloat16).contiguous()
        skip_out, x_out, xs = group_fwd(x, skip, ops, dils, yb, g)
        ctx.save_for_backward(xs, yb, g, *ops)
        ctx.dils = dils
        ctx.dtypes = [None if w is None else w.dtype
                      for w in (w_cur, w_prev, b, w_res, b_res, w_skip,
                                b_skip, v_cond)]
        return skip_out, x_out

    @staticmethod
    def backward(ctx, dskip, dx_out):
        xs, yb, g, *ops = ctx.saved_tensors
        dils = ctx.dils
        dx, dwz, db, dwrs, dbres, dbskip, *cond = group_bwd(
            xs, dskip.float().contiguous(), dx_out.float().contiguous(),
            ops, dils, yb, g)
        Lg, R = len(dils), xs.shape[-1]
        S = dskip.shape[-1]
        dvc = dy = dg = None
        if g is not None:
            dg = cond.pop()
        if cond:
            dvc, dy = cond
            dvc = dvc.reshape(Lg, dvc.shape[1], 2, R)
        dw = (dwz[:, :R].reshape(Lg, R, 2, R), dwz[:, R:].reshape(Lg, R, 2, R),
              db.reshape(Lg, 2, R), dwrs[..., :R], dbres, dwrs[..., R:],
              dbskip.expand(Lg, S), dvc)
        return (None, dx, dskip, dy, dg) + tuple(
            None if d is None else d.to(t) for d, t in zip(dw, ctx.dtypes))


def stack_forward(params, cfg: WaveNetConfig, groups, x: torch.Tensor, fwd,
                  y=None, g=None):
    """The whole stack's forward outside autograd, group by group, through
    `fwd` (group_fwd, the kernel, or group_fwd_reference, the plain
    version), with the bf16 mel features y of a mel model and the speaker
    offsets g [L, B, 2, R] of a speaker model: (skip, [(dils, ops, xs, the
    group's g)]).  The verify tool and chip_smoke.py hold the kernels
    against the plain versions with it."""
    B = x.shape[0]
    skip = torch.zeros(*x.shape[:2], cfg.skip_channels, device=x.device)
    saved = []
    for lo, hi in groups:
        dils = tuple(cfg.dilations[lo:hi])
        ops = prep_weights(*(params[k][lo:hi] for k in GROUP_KEYS),
                           None if y is None else params["v_cond"][lo:hi])
        gg = None if g is None else g[lo:hi].transpose(0, 1).reshape(
            B, hi - lo, -1).contiguous()
        skip, x, xs = fwd(x, skip, ops, dils, y, gg)
        saved.append((dils, ops, xs, gg))
    return skip, saved


def stack_backward(saved, dskip: torch.Tensor, bwd, y=None):
    """The backward of stack_forward's `saved` through `bwd` (group_bwd or
    group_bwd_reference): [(name, gradient)] (each group's dg with speaker
    offsets), dx last, after it the mel features' dy summed over the
    groups (a mel model)."""
    dx = torch.zeros(*dskip.shape[:2], saved[0][2].shape[-1],
                     device=dskip.device)
    grads, dy = [], None
    names = ("dwz", "db", "dwrs", "dbres", "dbskip", "dv_cond")
    for gi, (dils, ops, xs, gg) in reversed(list(enumerate(saved))):
        dx, *gw = bwd(xs, dskip, dx, ops, dils, y, gg)
        if gg is not None:
            grads.append((f"g{gi}.dg", gw.pop()))
        if y is not None:
            dy = gw[-1] if dy is None else dy + gw[-1]
            gw = gw[:-1]
        grads += [(f"g{gi}.{n}", g) for n, g in zip(names, gw)]
    return grads + [("dx", dx)] + ([] if y is None else [("dy", dy)])


def forward_skip_fused(params, cfg: WaveNetConfig, x: torch.Tensor,
                       tile=None, y=None, g=None) -> torch.Tensor:
    """Embedded input [B, T, R] (f32 holding bf16 values) -> skip sum
    [B, T, S] f32 through the layer groups of group_plan(cfg, tile).
    y: the upsampled mel features [B, T, M] f32 of a mel model (None
    otherwise); g: the speaker offsets [L, B, 2, R] f32 of a speaker model
    (models/wavenet.global_cond_offsets), sliced per group as the
    reference slices them, so autograd carries dg back to g_embed and
    v_global.  Callers check supported(cfg, T) first; on a CUDA device
    every width it accepts runs on the kernels (kernel_supported)."""
    B, T, R = x.shape
    TT = tile or pick_tile(cfg, T)
    if not TT:
        raise ValueError(f"T={T} is not tileable for this config; gate "
                         f"fused paths on train_stack.supported(cfg, T)")
    if T % TT:
        raise ValueError(f"tile={TT} does not divide T={T}")
    if (y is None) != (cfg.mel is None):
        raise ValueError("y is required with cfg.mel, and only then")
    if (g is None) != (cfg.global_classes is None):
        raise ValueError("g is required with cfg.global_classes, and only "
                         "then")
    groups = group_plan(cfg, TT)
    if not groups:
        raise ValueError("no feasible group plan; gate on supported()")
    skip = torch.zeros(B, T, cfg.skip_channels, device=x.device)
    x_g = x.float().contiguous()
    y = None if y is None else y.float()
    for lo, hi in groups:
        g_g = None if g is None else g[lo:hi].float().transpose(0, 1).reshape(
            B, hi - lo, 2 * R).contiguous()
        skip, x_g = _GroupApply.apply(
            tuple(cfg.dilations[lo:hi]), x_g, skip, y, g_g,
            *(params[k][lo:hi] for k in GROUP_KEYS),
            None if y is None else params["v_cond"][lo:hi])
    return skip
