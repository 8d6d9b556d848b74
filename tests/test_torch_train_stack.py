"""The port's training forward against the JAX package on the same inputs.

Inputs are made from a seed with numpy; JAX's params carry over with
params_from_numpy.  The reference's fused stack runs in Pallas interpret
mode, as tests/test_pallas_train.py runs it; the port's runs its plain
PyTorch versions (these are CPU tensors).  Tolerances are the reference
suite's own bands (test_pallas_train.py:96-103, 149-150): forward
atol 5e-3 / rtol 1e-3, loss rtol 2e-3, each gradient within 2e-2 of its
largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.ops import shift as jshift
from wavenet_tpu.ops.pallas import train_stack as jts
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.ops import shift as tshift
from wavenet_tpu_torch.ops.cuda import train_stack as tts
from wavenet_tpu_torch.utils.pytree_io import flatten_tree, params_from_numpy

torch.set_num_threads(1)

BASE = dict(num_blocks=2, max_dilation=8, residual_channels=16,
            skip_channels=16)
T = 64


def _cfgs(**kw):
    kw = dict(BASE, **kw)
    return jconfig.WaveNetConfig(**kw), tconfig.WaveNetConfig(**kw)


def _params(jc):
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _trainable(npp):
    return {k: v.requires_grad_(True)
            for k, v in params_from_numpy(npp, "cpu").items()}


def _assert_grads(jg, tp, tg, band=2e-2):
    for k, g in zip(tp, tg):
        a = np.asarray(jg[k], np.float32)
        g = np.zeros_like(a) if g is None else g.detach().numpy()
        scale = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(g / scale, a / scale, atol=band,
                                   err_msg=k)


def _tokens(B, n, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (B, n)).astype(
        np.int32)


@pytest.mark.parametrize("d", [1, 3, 8])
def test_shift_right_equal(d):
    rs = np.random.RandomState(d)
    x = rs.randn(2, 16, 5).astype(np.float32)
    ctx = rs.randn(2, 8, 5).astype(np.float32)
    want = np.asarray(jshift.shift_right(jnp.asarray(x), d, jnp.asarray(ctx)))
    got = tshift.shift_right(torch.from_numpy(x), d, torch.from_numpy(ctx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("preset,T_", [("tiny", 2048), ("small", 8192),
                                      ("full", 8192), ("fastgen_bench", 8192),
                                      ("tiny", 100), ("full", 4096)])
def test_planner_matches_reference(preset, T_):
    jc, tc = jconfig.get_config(preset), tconfig.get_config(preset)
    TT = tts.pick_tile(tc, T_)
    assert TT == jts.pick_tile(jc, T_)
    assert tts.supported(tc, T_) == jts.supported(jc, T_)
    if TT:
        assert tts.group_plan(tc, TT) == jts.group_plan(jc, TT)
    if (preset, T_) == ("full", 8192):
        # five groups that do not line up with the four dilation blocks
        assert tts.group_plan(tc, TT) == [(0, 9), (9, 18), (18, 27),
                                          (27, 36), (36, 40)]


def test_scan_loss_matches_jax():
    jc, tc = _cfgs()
    jp, npp = _params(jc)
    toks = _tokens(2, T + 1)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jwn.loss_fn(p, jc, jnp.asarray(toks)), has_aux=True)(jp)
    tp = _trainable(npp)
    tl, taux = twn.loss_fn(tp, tc, torch.from_numpy(toks))
    tg = torch.autograd.grad(tl, list(tp.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    np.testing.assert_allclose(float(taux["accuracy"]),
                               float(jaux["accuracy"]), atol=1 / 128)
    _assert_grads(jg, tp, tg)


def _fused_case(jc, tc, tile, budget=None, monkeypatch=None):
    """skip, loss and grads of mean((skip - tgt)^2) through both fused
    stacks, from the same embedded input."""
    if budget is not None:
        monkeypatch.setattr(jts, "VMEM_BUDGET", budget)
        monkeypatch.setattr(tts, "VMEM_BUDGET", budget)
    jp, npp = _params(jc)
    toks = _tokens(2, T)
    tgt = np.random.RandomState(2).randn(2, T, jc.skip_channels).astype(
        np.float32)

    def jloss(p):
        x = jwn.embed_tokens(p, jc, jnp.asarray(toks),
                             jwn._shifted_tokens(jnp.asarray(toks)))
        skip = jts.forward_skip_fused(p, jc, x, interpret=True, tile=tile)
        return jnp.mean((skip - tgt) ** 2), skip

    (jl, jskip), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = _trainable(npp)
    t = torch.from_numpy(toks)
    x = twn.embed_tokens(tp, tc, t, twn._shifted_tokens(t))
    tskip = tts.forward_skip_fused(tp, tc, x, tile=tile)
    tl = torch.mean((tskip - torch.from_numpy(tgt)) ** 2)
    tg = torch.autograd.grad(tl, list(tp.values()), allow_unused=True)
    np.testing.assert_allclose(tskip.detach().numpy(), np.asarray(jskip),
                               atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    _assert_grads(jg, tp, tg)


@pytest.mark.parametrize("case", ["default_tile", "tile8", "max_dilation4"])
def test_fused_stack_matches_jax(case):
    kw = dict(max_dilation=4, num_blocks=1) if case == "max_dilation4" \
        else {}
    jc, tc = _cfgs(**kw)
    _fused_case(jc, tc, tile=8 if case in ("tile8", "max_dilation4")
                else None)


def test_fused_stack_multi_group_matches_jax(monkeypatch):
    """A shrunken budget splits the stack into several groups (the
    residual is then rounded at every group boundary) on both sides."""
    jc, tc = _cfgs()
    TT = 16
    budget = max(max(tts._group_sizes(tc, TT, tc.dilations[l:l + 3]))
                 for l in range(0, 6))
    monkeypatch.setattr(tts, "VMEM_BUDGET", budget)
    plan = tts.group_plan(tc, TT)
    assert len(plan) >= 3, plan
    _fused_case(jc, tc, tile=TT, budget=budget, monkeypatch=monkeypatch)
    assert jts.group_plan(jc, TT) == plan


def test_fused_loss_matches_jax():
    """The whole slice's loss: embed -> fused stack -> head -> softmax
    cross-entropy, and every parameter's gradient."""
    jc, tc = _cfgs()
    jp, npp = _params(jc)
    toks = _tokens(2, T + 1)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jwn.loss_fn(p, jc, jnp.asarray(toks), use_fused=True,
                              interpret=True), has_aux=True)(jp)
    tp = _trainable(npp)
    tl, _ = twn.loss_fn(tp, tc, torch.from_numpy(toks), use_fused=True)
    tg = torch.autograd.grad(tl, list(tp.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    _assert_grads(jg, tp, tg)


def _bf_st(x):
    """bf16 rounding with a straight-through (identity) gradient."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def test_group_bwd_reference_matches_autograd():
    """The written-out backward equals autograd of a straight-through copy
    of the plain forward (f32 cotangents through every rounding)."""
    _, tc = _cfgs()
    R, S = tc.residual_channels, tc.skip_channels
    dils = tc.dilations[2:7]
    Lg = len(dils)
    rs = np.random.RandomState(3)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (rs.randn(*s) * sc).astype(np.float32))
    x = t(2, T, R).to(torch.bfloat16).float()
    skip = t(2, T, S, sc=0.1)
    raw = [t(Lg, R, 2, R, sc=0.3), t(Lg, R, 2, R, sc=0.3), t(Lg, 2, R, sc=0.1),
           t(Lg, R, R, sc=0.3), t(Lg, R, sc=0.1), t(Lg, R, S, sc=0.3),
           t(Lg, S, sc=0.1)]
    ops = tts.prep_weights(*raw)
    dskip, dxout = t(2, T, S), t(2, T, R)
    wz = ops[0].float().requires_grad_(True)
    b = ops[1].clone().requires_grad_(True)
    wrs = ops[2].float().requires_grad_(True)
    bres = ops[3].clone().requires_grad_(True)
    xin = x.clone().requires_grad_(True)
    carry, sk = xin, skip
    for l, d in enumerate(dils):
        xb = _bf_st(carry)
        xcat = torch.cat([xb, tts._causal(xb, d)], -1)
        z = xcat @ wz[l] + b[l]
        h = _bf_st(torch.tanh(z[..., :R]) * torch.sigmoid(z[..., R:]))
        o = h @ wrs[l]
        carry = (carry + o[..., :R]) + bres[l]
        sk = (sk + o[..., R:]) + ops[4][l]
    out = _bf_st(carry)
    loss = (sk * dskip).sum() + (out * dxout).sum()
    want = torch.autograd.grad(loss, [xin, wz, b, wrs, bres])
    _, _, xs = tts.group_fwd_reference(x, skip, ops, dils)
    got = tts.group_bwd_reference(xs, dskip, dxout, ops, dils)
    for name, g, w in zip(("dx", "dwz", "db", "dwrs", "dbres"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()),
                                   err_msg=name)
    np.testing.assert_allclose(got[5].numpy(), dskip.sum((0, 1)).numpy(),
                               rtol=1e-6)


class _OnCuda:
    """Stands in for a CUDA tensor on a machine without CUDA."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return True

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("which", ["fwd", "bwd", "fwd_gc", "bwd_gc"])
def test_cuda_tensor_never_takes_the_plain_path(monkeypatch, which):
    """A CUDA tensor goes to the kernel (which cannot build without nvcc)
    and never to the plain version, with speaker offsets g too."""
    from wavenet_tpu_torch.ops.cuda import build
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the kernel path really runs")
    calls = []
    monkeypatch.setattr(tts, "group_fwd_reference",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(tts, "group_bwd_reference",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(build, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    build._libs.pop("train_stack", None)
    R, S, Lg = 32, 32, 2
    ops = tts.prep_weights(torch.zeros(Lg, R, 2, R), torch.zeros(Lg, R, 2, R),
                           torch.zeros(Lg, 2, R), torch.zeros(Lg, R, R),
                           torch.zeros(Lg, R), torch.zeros(Lg, R, S),
                           torch.zeros(Lg, S))
    g = _OnCuda(torch.zeros(2, Lg, 2 * R)) if which.endswith("gc") else None
    with pytest.raises(RuntimeError, match="nvcc"):
        if which.startswith("fwd"):
            tts.group_fwd(_OnCuda(torch.zeros(2, 16, R)),
                          _OnCuda(torch.zeros(2, 16, S)), ops, (1, 2), g=g)
        else:
            tts.group_bwd(_OnCuda(torch.zeros(Lg + 1, 2, 16, R)),
                          _OnCuda(torch.zeros(2, 16, S)),
                          _OnCuda(torch.zeros(2, 16, R)), ops, (1, 2), g=g)
    assert not calls


class _Lib:
    """Records every call of the library's entry points."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _meta_params(tc):
    """The stack's params of tc as meta tensors that need grads."""
    L, R, S = tc.num_layers, tc.residual_channels, tc.skip_channels
    shapes = {"w_cur": (L, R, 2, R), "w_prev": (L, R, 2, R), "b": (L, 2, R),
              "w_res": (L, R, R), "b_res": (L, R), "w_skip": (L, R, S),
              "b_skip": (L, S)}
    if tc.mel is not None:
        shapes["v_cond"] = (L, tc.mel.num_mels, 2, R)
    return {k: torch.empty(*v, device="meta", requires_grad=True)
            for k, v in shapes.items()}


def test_kernel_refuses_widths_it_does_not_take(monkeypatch):
    """No width that supported() takes is refused any more: `full` at
    R = 256 (a backward block of 32 rows), R = 18 (padded to 20) and
    `tiny` with 80 mels (nm > 2R) reach the library, forward and
    backward, with the planned row tile and the padded widths, and nothing
    raises.  Traced on meta tensors that the wrappers take for CUDA ones,
    with the library, the device and the stream stubbed."""
    import contextlib
    import ctypes
    import types
    lib = _Lib()
    monkeypatch.setattr(tts, "_prepare", lambda x, dils, what: (
        lib, tuple(x.shape), (ctypes.c_int * len(dils))(*dils)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    cases = [(tconfig.full().replace(residual_channels=256), 8192,
              (256, 256, 0), (64, 32), 40),
             (_cfgs(residual_channels=18)[1], T, (20, 16, 0), (64, 64), 1),
             (tconfig.tiny().replace(mel=tconfig.MelConfig()), 2048,
              (32, 16, 80), (64, 64), 1)]
    for tc, T_, widths, rows, groups in cases:
        assert tts.supported(tc, T_) and tts.kernel_supported(tc)
        assert len(tts.group_plan(tc, tts.pick_tile(tc, T_))) == groups
        lib.calls.clear()
        params = _meta_params(tc)
        x = torch.empty(2, T_, tc.residual_channels, device="meta",
                        requires_grad=True)
        y = None if tc.mel is None else torch.empty(
            2, T_, tc.mel.num_mels, device="meta")
        skip = tts.forward_skip_fused(params, tc, x, y=y)
        assert skip.shape == (2, T_, tc.skip_channels)
        skip.sum().backward()
        assert x.grad.shape == x.shape
        assert all(p.grad.shape == p.shape for p in params.values())
        R, S, nm = widths
        fwd = [a for n, a in lib.calls if n == "wn_ts_group_fwd"]
        bwd = [a for n, a in lib.calls if n == "wn_ts_group_bwd"]
        assert len(fwd) == len(bwd) == groups
        for a in fwd:
            assert a[18:23] == (R, S, nm, rows[0],
                                tts._fwd_smem(R, nm, rows[0]))
            assert a[22] <= 227 * 1024
        for a in bwd:
            assert a[13:16] == (R, S, nm)
            assert a[-4:-2] == (rows[1], tts._bwd_smem(R, S, nm, rows[1]))
            assert a[-3] <= 227 * 1024


PADDED = {"r18_s10": dict(residual_channels=18, skip_channels=10),
          "r18_s10_speaker": dict(residual_channels=18, skip_channels=10,
                                  global_classes=5, global_channels=8),
          "r8_mel24": dict(residual_channels=8, skip_channels=16, mel=24)}


@pytest.mark.parametrize("case", list(PADDED))
def test_padded_widths_match_plain_and_jax(case, monkeypatch):
    """The route the kernels take at these widths, through the plain
    versions: pad_ops and the padded inputs (R, S to multiples of 4) ->
    plain group forward and backward -> cut back.  (1) Over the whole
    stack against the unpadded plain version: the skip sum and every
    layer input bit for bit (a padded channel adds exact zeros), each
    gradient within 1e-5 of its largest element (f32 sums over more,
    zero, terms).  (2) The loss and every gradient through the fused
    stack against the JAX package's fused stack in Pallas interpret mode,
    within the reference suite's bands; nm = 24 > 2R at R = 8 too."""
    from functools import partial
    kw = dict(PADDED[case], num_blocks=1)
    nm = kw.pop("mel", 0)
    if nm:
        mel = dict(num_mels=nm, hop_length=16, win_length=64, fmax=4000.0,
                   upsample_factors=(4, 4))
        jc, tc = _cfgs(mel=jconfig.MelConfig(**mel), **kw)
        tc = tc.replace(mel=tconfig.MelConfig(**mel))
    else:
        jc, tc = _cfgs(**kw)
    jp, npp = _params(jc)
    B = 3
    toks = _tokens(B, T + 1)
    ids = np.array([3, 1, 3], np.int32)
    frames = np.random.RandomState(3).randn(B, T // 16, nm).astype(
        np.float32)
    jkw, tkw = {}, {}
    if nm:
        jkw["mel"], tkw["mel"] = jnp.asarray(frames), torch.from_numpy(frames)
    if tc.global_classes is not None:
        jkw["speaker"], tkw["speaker"] = jnp.asarray(ids), torch.from_numpy(
            ids)
    fwd = partial(tts.fwd_padded, tts.group_fwd_reference)
    bwd = partial(tts.bwd_padded, tts.group_bwd_reference)

    # (1) the stack, padded against unpadded
    tp = params_from_numpy(npp, "cpu")
    t = torch.from_numpy(toks[:, :-1])
    with torch.no_grad():
        x = twn.embed_tokens(tp, tc, t, twn._shifted_tokens(t))
        y = g = None
        if nm:
            y = torch.from_numpy(np.random.RandomState(4).randn(
                B, T, nm).astype(np.float32)).to(torch.bfloat16)
        if tc.global_classes is not None:
            g = twn.global_cond_offsets(tp, tc, torch.from_numpy(ids))
        groups = tts.group_plan(tc, tts.pick_tile(tc, T))
        ct = torch.from_numpy(np.random.RandomState(5).randn(
            B, T, tc.skip_channels).astype(np.float32))
        want = tts.stack_forward(tp, tc, groups, x,
                                 tts.group_fwd_reference, y, g)
        got = tts.stack_forward(tp, tc, groups, x, fwd, y, g)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a[2], b[2])
        gw = tts.stack_backward(want[1], ct, tts.group_bwd_reference, y)
        gg = tts.stack_backward(got[1], ct, bwd, y)
    assert [n for n, _ in gg] == [n for n, _ in gw]
    for (n, a), (_, b) in zip(gg, gw):
        assert a.shape == b.shape, n
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), n

    # (2) the loss and its gradients against JAX's fused stack
    monkeypatch.setattr(tts, "group_fwd", fwd)
    monkeypatch.setattr(tts, "group_bwd", bwd)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jwn.loss_fn(p, jc, jnp.asarray(toks), use_fused=True,
                              interpret=True, **jkw), has_aux=True)(jp)
    tpl = params_from_numpy(npp, "cpu")
    flat = flatten_tree(tpl)
    for v in flat.values():
        v.requires_grad_(True)
    tl, _ = twn.loss_fn(tpl, tc, torch.from_numpy(toks), use_fused=True,
                        **tkw)
    tg = torch.autograd.grad(tl, list(flat.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    jflat = flatten_tree(jax.tree.map(np.asarray, jg))
    assert sorted(jflat) == sorted(flat)
    for k, gr in zip(flat, tg):
        a = np.asarray(jflat[k], np.float32)
        scale = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(gr.numpy() / scale, a / scale, atol=2e-2,
                                   err_msg=k)
