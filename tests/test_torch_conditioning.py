"""The port's mel conditioning, module by module, against the JAX package on
the CPU: features, upsampler, params, the scan and fused training forwards
with mel, the group plan, and the written-out mel backward.

Inputs come from numpy seeds; JAX's params carry over with
params_from_numpy.  The config is the JAX tests' mel config (num_mels 8,
hop 16, win 64, factors (4, 4)) on small stacks.  Tolerances:
  * log-mel features: bit for bit (the same numpy code);
  * the upsampler: 1e-5 relative to the largest feature (f32 sums of k
    shifted products here, XLA's convolution order there);
  * training losses rtol 2e-3, each gradient within 2e-2 of its largest
    element, the fused forward atol 5e-3 / rtol 1e-3 (the reference suite's
    bands, tests/test_pallas_train.py:96-103, 377-416).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.audio import mel as jmel
from wavenet_tpu.models import conditioning as jcond
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.ops.pallas import train_stack as jts
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import mel as tmel
from wavenet_tpu_torch.models import conditioning as tcond
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.ops.cuda import train_stack as tts
from wavenet_tpu_torch.utils.pytree_io import flatten_tree, params_from_numpy

torch.set_num_threads(1)

MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))
BASE = dict(num_blocks=2, max_dilation=8, residual_channels=16,
            skip_channels=16)
T = 64


def _cfgs(mel=MEL, **kw):
    kw = dict(BASE, **kw)
    return (jconfig.WaveNetConfig(mel=jconfig.MelConfig(**mel), **kw),
            tconfig.WaveNetConfig(mel=tconfig.MelConfig(**mel), **kw))


def _params(jc):
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _trainable(npp):
    """Port params whose leaves (nested upsampler included) need grads;
    returns (nested params, flat '/'-joined leaves)."""
    tp = params_from_numpy(npp, "cpu")
    flat = flatten_tree(tp)
    for v in flat.values():
        v.requires_grad_(True)
    return tp, flat


def _assert_grads(jg, flat, grads, band=2e-2):
    jflat = flatten_tree(jax.tree.map(np.asarray, jg))
    assert sorted(jflat) == sorted(flat)
    for k, g in zip(flat, grads):
        a = np.asarray(jflat[k], np.float32)
        g = np.zeros_like(a) if g is None else g.detach().numpy()
        scale = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(g / scale, a / scale, atol=band,
                                   err_msg=k)


def _mel_frames(B, F, M, seed=2):
    return np.random.RandomState(seed).randn(B, F, M).astype(np.float32)


def _tokens(B, n, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (B, n)).astype(
        np.int32)


@pytest.mark.parametrize("mel", ["test", "preset"])
def test_log_mel_bit_identical(mel):
    kw = MEL if mel == "test" else {}
    jm, tm = jconfig.MelConfig(**kw), tconfig.MelConfig(**kw)
    x = np.random.RandomState(0).uniform(-1, 1, 3001).astype(np.float32)
    np.testing.assert_array_equal(
        tmel.mel_filterbank(16000, tm.win_length, tm.num_mels, tm.fmin,
                            tm.fmax),
        jmel.mel_filterbank(16000, jm.win_length, jm.num_mels, jm.fmin,
                            jm.fmax))
    got, want = tmel.log_mel(x, 16000, tm), jmel.log_mel(x, 16000, jm)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == tmel.frames_for_samples(3001, tm.hop_length) \
        == jmel.frames_for_samples(3001, jm.hop_length)


@pytest.mark.parametrize("mel", ["test", "preset"])
def test_upsample_mel_matches_jax(mel):
    kw = MEL if mel == "test" else {}
    jm, tm = jconfig.MelConfig(**kw), tconfig.MelConfig(**kw)
    jp = jax.tree.map(np.asarray, jcond.init_upsampler_params(
        jm, jax.random.PRNGKey(3), jnp.float32))
    frames = _mel_frames(2, 5, jm.num_mels) * 3.0
    n = 5 * jm.hop_length - 7
    want = np.asarray(jcond.upsample_mel(jp, jm, jnp.asarray(frames), n))
    got = tcond.upsample_mel(params_from_numpy(jp, "cpu"), tm,
                             torch.from_numpy(frames), n).numpy()
    assert got.shape == want.shape == (2, n, jm.num_mels)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="target"):
        tcond.upsample_mel(params_from_numpy(jp, "cpu"), tm,
                           torch.from_numpy(frames), 5 * jm.hop_length + 1)


def test_init_params_mel_shapes_match_jax():
    jc, tc = _cfgs()
    got = twn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    _, want = _params(jc)
    shapes = lambda p: {k: tuple(v.shape) for k, v in flatten_tree(p).items()}
    assert shapes(got) == shapes(want)
    assert set(got["upsampler"]) == {"w0", "b0", "w1", "b1"}
    w0 = got["upsampler"]["w0"]                  # near-identity taps
    eye = torch.eye(8)[None] / 9
    assert float((w0 - eye).abs().max()) < 0.01 and w0.dtype == torch.float32
    limit = (6.0 / (8 + 16)) ** 0.5              # glorot, fan-in M
    assert float(got["v_cond"].abs().max()) <= limit


def test_project_cond_is_the_exact_bf16_product():
    """The decode recipe: bf16 operands, the exact sum rounded once to f32;
    JAX's bf16 einsum with f32 accumulation agrees to f32 rounding."""
    jc, tc = _cfgs(residual_channels=32, skip_channels=32)
    jp, npp = _params(jc)
    y = _mel_frames(3, 7, 8, seed=4) * 4.0
    got = tcond.project_cond(params_from_numpy(npp, "cpu"),
                             torch.from_numpy(y))
    assert got.shape == (3, 7, tc.num_layers, 64)
    assert got.dtype == torch.float32
    bf64 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                                .astype(jnp.float32), np.float64)
    f64 = np.einsum("btm,lmn->btln", bf64(y),
                    bf64(npp["v_cond"]).reshape(tc.num_layers, 8, 64))
    np.testing.assert_array_equal(got.numpy(), f64.astype(np.float32))
    want = np.asarray(jcond.project_cond(
        {"v_cond": jnp.asarray(npp["v_cond"]).astype(jnp.bfloat16)},
        jnp.asarray(y).astype(jnp.bfloat16))).reshape(3, 7, -1, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_scan_loss_with_mel_matches_jax(remat):
    """loss_fn(mel=) on the scan path (each layer recomputed in the
    backward with remat), and every gradient, v_cond and the upsampler's
    included."""
    jc, tc = _cfgs(remat=remat)
    jp, npp = _params(jc)
    toks = _tokens(2, T + 1)
    mel = _mel_frames(2, T // 16, 8)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jwn.loss_fn(p, jc, jnp.asarray(toks), mel=jnp.asarray(mel)),
        has_aux=True)(jp)
    tp, flat = _trainable(npp)
    tl, _ = twn.loss_fn(tp, tc, torch.from_numpy(toks),
                        mel=torch.from_numpy(mel))
    tg = torch.autograd.grad(tl, list(flat.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    _assert_grads(jg, flat, tg)


def _fused_mel_case(jc, tc, tile, monkeypatch=None, budget=None):
    """skip, loss and grads of mean((skip - tgt)^2) through both fused
    stacks with mel (the upsampler in front), from the same inputs."""
    if budget is not None:
        monkeypatch.setattr(jts, "VMEM_BUDGET", budget)
        monkeypatch.setattr(tts, "VMEM_BUDGET", budget)
    jp, npp = _params(jc)
    toks = _tokens(2, T)
    mel = _mel_frames(2, 5, 8)
    tgt = np.random.RandomState(3).randn(2, T, jc.skip_channels).astype(
        np.float32)

    def jloss(p):
        x = jwn.embed_tokens(p, jc, jnp.asarray(toks),
                             jwn._shifted_tokens(jnp.asarray(toks)))
        y = jcond.upsample_mel(p["upsampler"], jc.mel, jnp.asarray(mel), T)
        skip = jts.forward_skip_fused(p, jc, x, interpret=True, tile=tile,
                                      y=y)
        return jnp.mean((skip - tgt) ** 2), skip

    (jl, jskip), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp, flat = _trainable(npp)
    t = torch.from_numpy(toks)
    x = twn.embed_tokens(tp, tc, t, twn._shifted_tokens(t))
    y = tcond.upsample_mel(tp["upsampler"], tc.mel, torch.from_numpy(mel), T)
    tskip = tts.forward_skip_fused(tp, tc, x, tile=tile, y=y)
    tl = torch.mean((tskip - torch.from_numpy(tgt)) ** 2)
    tg = torch.autograd.grad(tl, list(flat.values()), allow_unused=True)
    np.testing.assert_allclose(tskip.detach().numpy(), np.asarray(jskip),
                               atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    _assert_grads(jg, flat, tg)


@pytest.mark.parametrize("tile", [None, 8])
def test_fused_stack_with_mel_matches_jax(tile):
    """The fused plain versions with y against the Pallas kernels with y
    in interpret mode: skip, loss, and every gradient (dv_cond, and dy
    through the upsampler)."""
    jc, tc = _cfgs()
    _fused_mel_case(jc, tc, tile)


def test_fused_stack_with_mel_multi_group_matches_jax(monkeypatch):
    """A shrunken budget splits the stack into several groups on both
    sides; y feeds every group, so dy is summed over the groups."""
    jc, tc = _cfgs()
    TT = 16
    budget = max(max(tts._group_sizes(tc, TT, tc.dilations[l:l + 3]))
                 for l in range(0, 6))
    monkeypatch.setattr(tts, "VMEM_BUDGET", budget)
    assert len(tts.group_plan(tc, TT)) >= 3
    _fused_mel_case(jc, tc, TT, monkeypatch, budget)
    assert jts.group_plan(jc, TT) == tts.group_plan(tc, TT)


def test_fused_loss_with_mel_matches_jax():
    """The whole training loss with mel on the fused path."""
    jc, tc = _cfgs()
    jp, npp = _params(jc)
    toks = _tokens(2, T + 1)
    mel = _mel_frames(2, T // 16, 8)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jwn.loss_fn(p, jc, jnp.asarray(toks), mel=jnp.asarray(mel),
                              use_fused=True, interpret=True),
        has_aux=True)(jp)
    tp, flat = _trainable(npp)
    tl, _ = twn.loss_fn(tp, tc, torch.from_numpy(toks),
                        mel=torch.from_numpy(mel), use_fused=True)
    tg = torch.autograd.grad(tl, list(flat.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    _assert_grads(jg, flat, tg)


@pytest.mark.parametrize("preset,T_", [("full_vocoder", 8192),
                                      ("conditional", 8192),
                                      ("full_vocoder", 4096)])
def test_group_plan_with_mel_matches_reference(preset, T_):
    """The mel terms of the planner move the group boundaries: at
    full_vocoder, T = 8192, six groups where `full` has five."""
    jc, tc = jconfig.get_config(preset), tconfig.get_config(preset)
    TT = tts.pick_tile(tc, T_)
    assert TT == jts.pick_tile(jc, T_)
    assert tts.supported(tc, T_) == jts.supported(jc, T_) is True
    assert tts.group_plan(tc, TT) == jts.group_plan(jc, TT)
    if (preset, T_) == ("full_vocoder", 8192):
        assert tts.group_plan(tc, TT) == [(0, 8), (8, 16), (16, 23),
                                          (23, 30), (30, 38), (38, 40)]


def _bf_st(x):
    """bf16 rounding with a straight-through (identity) gradient."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def test_group_bwd_reference_with_mel_matches_autograd():
    """The written-out backward with mel (dv_cond, and dy summed over the
    layers) equals autograd of a straight-through copy of the forward."""
    R, S, M = 16, 16, 8
    dils = (1, 2, 4, 8, 1)
    Lg = len(dils)
    rs = np.random.RandomState(5)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (rs.randn(*s) * sc).astype(np.float32))
    x = t(2, T, R).to(torch.bfloat16).float()
    skip = t(2, T, S, sc=0.1)
    raw = [t(Lg, R, 2, R, sc=0.3), t(Lg, R, 2, R, sc=0.3), t(Lg, 2, R, sc=0.1),
           t(Lg, R, R, sc=0.3), t(Lg, R, sc=0.1), t(Lg, R, S, sc=0.3),
           t(Lg, S, sc=0.1), t(Lg, M, 2, R, sc=0.3)]
    ops = tts.prep_weights(*raw)
    assert len(ops) == 6 and ops[5].shape == (Lg, M, 2 * R)
    y = t(2, T, M).to(torch.bfloat16)
    dskip, dxout = t(2, T, S), t(2, T, R)
    wz = ops[0].float().requires_grad_(True)
    wrs = ops[2].float().requires_grad_(True)
    vc = ops[5].float().requires_grad_(True)
    yf = y.float().requires_grad_(True)
    xin = x.clone().requires_grad_(True)
    carry, sk = xin, skip
    for l, d in enumerate(dils):
        xb = _bf_st(carry)
        xcat = torch.cat([xb, tts._causal(xb, d)], -1)
        z = (xcat @ wz[l] + ops[1][l]) + yf @ vc[l]
        h = _bf_st(torch.tanh(z[..., :R]) * torch.sigmoid(z[..., R:]))
        o = h @ wrs[l]
        carry = (carry + o[..., :R]) + ops[3][l]
        sk = (sk + o[..., R:]) + ops[4][l]
    loss = (sk * dskip).sum() + (_bf_st(carry) * dxout).sum()
    want = torch.autograd.grad(loss, [xin, wz, wrs, vc, yf])
    skip_out, _, xs = tts.group_fwd_reference(x, skip, ops, dils, y)
    np.testing.assert_allclose(skip_out.numpy(), sk.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    got = tts.group_bwd_reference(xs, dskip, dxout, ops, dils, y)
    assert len(got) == 8
    for name, g, w in zip(("dx", "dwz", "dwrs", "dv_cond", "dy"),
                          (got[0], got[1], got[3], got[6], got[7]), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()),
                                   err_msg=name)


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


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_cuda_tensor_with_mel_never_takes_the_plain_path(monkeypatch, which):
    """With y, a CUDA tensor goes to the kernel (which cannot build
    without nvcc) and never to the plain version."""
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
    R, S, M, Lg = 32, 32, 8, 2
    z = torch.zeros
    ops = tts.prep_weights(z(Lg, R, 2, R), z(Lg, R, 2, R), z(Lg, 2, R),
                           z(Lg, R, R), z(Lg, R), z(Lg, R, S), z(Lg, S),
                           z(Lg, M, 2, R))
    y = _OnCuda(z(2, 16, M, dtype=torch.bfloat16))
    with pytest.raises(RuntimeError, match="nvcc"):
        if which == "fwd":
            tts.group_fwd(_OnCuda(z(2, 16, R)), _OnCuda(z(2, 16, S)), ops,
                          (1, 2), y)
        else:
            tts.group_bwd(_OnCuda(z(Lg + 1, 2, 16, R)), _OnCuda(z(2, 16, S)),
                          _OnCuda(z(2, 16, R)), ops, (1, 2), y)
    assert not calls


def test_kernel_widths_with_mel():
    """The kernels take num_mels multiples of 4 up to 2R (every mel preset);
    other counts raise on the card instead of taking another path."""
    for preset in ("conditional", "full_vocoder"):
        assert tts.kernel_supported(tconfig.get_config(preset)), preset
    assert tts.kernel_supported(_cfgs()[1])                 # M = 8, R = 16
    _, tc = _cfgs(mel=dict(MEL, num_mels=6))
    assert not tts.kernel_supported(tc) and tts.supported(tc, T)
    _, tc = _cfgs(mel=dict(MEL, num_mels=40))               # M > 2R
    assert not tts.kernel_supported(tc)
