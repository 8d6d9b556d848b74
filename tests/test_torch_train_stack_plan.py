"""The stack kernels' plans that live in Python, on the CPU.

* Shared memory: `_fwd_smem` and `_bwd_smem` are the one plans of a
  forward and a backward layer block's shared memory at each row tile
  (the library takes the tile and the size as arguments and refuses less
  than its layout needs), the wrappers pass them, every width the kernels
  took before keeps its 64-row blocks and bytes, and every width the
  reference fuses gets a row tile whose blocks fit.
* The bound `chip_smoke.py` prints beside the kernels' times, as the
  kernels compute the products (three bf16 passes per product with an f32
  cotangent, at the bf16 peak).
* The profiler's kernel names, as `chip_smoke.py` prints the forward's
  and the backward's split by kernel.
"""

import contextlib
import ctypes
import os
import sys
import types

import pytest
import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.ops.cuda import train_stack as ts
from wavenet_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _taken_before(R, S, nm):
    """The widths the kernels took with the backward's plan written in
    both csrc/train_stack.cu (bwd_smem) and Python."""
    fwd = (2 * 64 * 2 * R + 32 * 128) * 4
    bwd = (64 * max(2 * R, R + S) + 64 * 2 * R + 32 * 128) * 4
    return (R % 4 == 0 and S % 4 == 0 and nm % 4 == 0 and nm <= 2 * R
            and max(fwd, bwd) <= 227 * 1024)


def _fused_s_max(cfg, T):
    """The largest S <= 4096 at which the stack takes cfg at T (0 if
    none): supported() is monotone in S (every term of the reference's
    on-chip sizes grows with it), so a bisection finds it."""
    lo, hi = 0, 4096
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ts.supported(cfg.replace(skip_channels=mid), T):
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("r_lo", range(4, 513, 64))
def test_widths_taken_are_the_parents(r_lo):
    """(1) Taken before => the same plan: for every R in [r_lo, r_lo + 64),
    S in {4, 8, ..., 512} and nm in {0, 4, ..., 2R} (R a multiple of 4)
    that the kernels took before, both layer blocks keep 64 rows and their
    bytes.  (2) Fused by the reference => taken: for every R in
    [r_lo - 3, r_lo + 61) (1 to 512 over the cases) and nm in {0, 6, 8,
    24, 80, 128, 256}, at `full`'s depth and T = 8192, the largest S the
    port's `supported` takes (the reference's planner; 0 to 4096) has a
    row tile whose forward and backward blocks fit 227 KiB at the padded
    widths, and so has every smaller S (each block's bytes grow with S).
    R = 256, S = 512, which ROADMAP once gave as a refused example, is
    fused by neither package."""
    for R in range(r_lo, r_lo + 64, 4):
        for S in range(4, 513, 4):
            for nm in range(0, 2 * R + 1, 4):
                if _taken_before(R, S, nm):
                    assert (ts.fwd_rows(R, nm), ts.bwd_rows(R, S, nm)) == (
                        64, 64), (R, S, nm)
    base = tconfig.full()
    for nm in (0, 6, 8, 24, 80, 128, 256):
        mel = None if not nm else tconfig.MelConfig(num_mels=nm)
        for R in range(r_lo - 3, r_lo + 61):
            cfg = base.replace(residual_channels=R, mel=mel)
            S = _fused_s_max(cfg, 8192)
            if not S:
                continue
            for s in sorted({1, (S + 1) // 2, S}):
                Rp, Sp, nmp = ts.padded_widths(R, s, nm)
                rf, rb = ts.fwd_rows(Rp, nmp), ts.bwd_rows(Rp, Sp, nmp)
                assert rf and rb, (R, s, nm)
                assert ts._fwd_smem(Rp, nmp, rf) <= 227 * 1024
                assert ts._bwd_smem(Rp, Sp, nmp, rb) <= 227 * 1024
            assert ts.kernel_supported(cfg.replace(skip_channels=S))
    if r_lo <= 128 < r_lo + 64:
        assert ts._bwd_smem(128, 256) == 176 * 1024
        assert ts.bwd_rows(128, 256, 80) == 64
    if r_lo <= 256 < r_lo + 64:
        assert not ts.supported(base.replace(residual_channels=256,
                                             skip_channels=512), 8192)
        assert ts.bwd_rows(256, 256) == 32


@pytest.mark.parametrize("preset,fwd,bwd", [
    ("full", 83968, 176 * 1024), ("full_vocoder", 95232, 176 * 1024),
    ("tiny", 47104, 49152)])
def test_layer_block_plans_per_preset(preset, fwd, bwd):
    """The forward block: bf16 tiles [64][K + 8] of xcat (2R), h (R) and,
    with mel, y (M), and two f64 [16][128] weight stages (32 KiB): 82 KiB
    at `full`, 93 KiB with mel, so two blocks fit an SM's 227 KiB.  The
    backward block keeps its parent's size at these widths."""
    cfg = getattr(tconfig, preset)()
    R, S = cfg.residual_channels, cfg.skip_channels
    nm = 0 if cfg.mel is None else cfg.mel.num_mels
    assert ts._fwd_smem(R, nm) == fwd
    assert ts._bwd_smem(R, S, nm) == bwd
    assert ts._bwd_smem(R, S, nm) == (64 * max(2 * R, R + S) + 64 * 2 * R
                                      + 32 * 128) * 4
    if preset != "tiny":
        assert 2 * ts._fwd_smem(R, nm) <= 232448


class _Lib:
    """Records the arguments of the library's entry points."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.mark.parametrize("nm", [0, 24])
def test_wrappers_pass_the_plans(monkeypatch, nm):
    """group_fwd and group_bwd hand the library their 64-row tile and
    `_fwd_smem(R, nm)` and `_bwd_smem(R, S, nm)`, the two arguments before
    the launch count (traced with the library and the stream stubbed, on
    meta tensors)."""
    R, S, B, T, dils = 20, 12, 2, 16, (1, 2)
    lib = _Lib()
    monkeypatch.setattr(ts, "_prepare", lambda x, dils, what: (
        lib, tuple(x.shape), (ctypes.c_int * len(dils))(*dils)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    e = lambda *shape, dtype=torch.float32: torch.empty(
        *shape, dtype=dtype, device="meta")
    bf = torch.bfloat16
    ops = (e(2, 2 * R, 2 * R, dtype=bf), e(2, 2 * R), e(2, R, R + S, dtype=bf),
           e(2, R), e(2, S)) + ((e(2, nm, 2 * R, dtype=bf),) if nm else ())
    y = e(B, T, nm, dtype=bf) if nm else None
    _, _, xs = ts.group_fwd(e(B, T, R), e(B, T, S), ops, dils, y)
    assert lib.calls["wn_ts_group_fwd"][-4:-2] == (64, ts._fwd_smem(R, nm))
    ts.group_bwd(xs, e(B, T, S), e(B, T, R), ops, dils, y)
    assert lib.calls["wn_ts_group_bwd"][-4:-2] == (64,
                                                   ts._bwd_smem(R, S, nm))


def _stack_bound(preset, num_groups):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    cfg = getattr(tconfig, preset)()
    groups = ts.group_plan(cfg, ts.pick_tile(cfg, 8192))
    assert len(groups) == num_groups
    return chip_smoke.stack_bound(cfg, groups, 8, 8192)


@pytest.mark.parametrize("preset,groups,fwd_ms,bwd_ms", [
    ("full", 5, 0.608, 3.996), ("full_vocoder", 6, 0.717, 4.755)])
def test_stack_bound_prices_the_products_on_tensor_cores(preset, groups,
                                                         fwd_ms, bwd_ms):
    """B = 8, T = 8192: the backward's bound counts each f32-cotangent
    product as three bf16 passes at the bf16 peak (it was 18.30 ms at
    `full` with them at the f32 CUDA-core peak); both bounded by
    operations."""
    b = _stack_bound(preset, groups)
    assert b["fwd"]["bound_ms"] == pytest.approx(fwd_ms, rel=5e-3)
    assert b["bwd"]["bound_ms"] == pytest.approx(bwd_ms, rel=5e-3)
    assert b["fwd"]["bound_by"] == b["bwd"]["bound_by"] == "operations"
    assert b["fwd"]["library_ms"] is None and b["bwd"]["library_ms"] is None


def test_kernel_names():
    assert [profiling.kernel_name(n) for n in (
        "void (anonymous namespace)::wgrad_kernel<1>(__nv_bfloat16 const*, "
        "float const*, int, float*)",
        "void (anonymous namespace)::bwd_layer_kernel(float const*)",
        "void (anonymous namespace)::fwd_layer_kernel(__nv_bfloat16 const*, "
        "float*, __nv_bfloat16*, float*, float const*, float*, int)",
        "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n")] == [
        "wgrad_kernel<1>", "bwd_layer_kernel", "fwd_layer_kernel",
        "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n"]


def test_sass_compare_drops_addresses_encodings_and_labels():
    """utils/sass_compare reads cuobjdump's listing per function and
    compares instructions without their addresses, encodings and label
    numbers (how the 64-row layer kernels were held to the parent's
    code)."""
    from wavenet_tpu_torch.utils import sass_compare
    listing = """
        Function : _Z3fooILi64EEvv
        /*0000*/  MOV R1, c[0x0][0x28] ;   /* 0x00000a0000017a02 */
        /*0010*/  BRA `(.L_x_12) ;          /* 0x0000000000047947 */
        Function : _Z3foov
        /*0000*/  MOV R1, c[0x0][0x28] ;   /* 0x00000a0000017a02 */
        /*0020*/  BRA `(.L_x_3) ;           /* 0x0000000000057947 */
        Function : _Z3barv
        /*0000*/  MOV R2, c[0x0][0x28] ;   /* 0x00000a0000027a02 */
    """
    f = sass_compare.functions(listing)
    assert sorted(f) == ["_Z3barv", "_Z3fooILi64EEvv", "_Z3foov"]
    assert f["_Z3foov"] == ["MOV R1, c[0x0][0x28] ;", "BRA `(.L) ;"]
    assert sass_compare.compare(f["_Z3foov"], f["_Z3fooILi64EEvv"]) == {
        "instructions": [2, 2], "differing": 0}
    assert sass_compare.compare(f["_Z3foov"], f["_Z3barv"]) == {
        "instructions": [2, 1], "differing": 2}
    assert sass_compare.main(["a.cu"]) == 2
