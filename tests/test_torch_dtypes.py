"""The config's two dtype fields in the port, against the JAX package on the
CPU: compute_dtype="float16" and param_dtype in {bfloat16, float16}.

Inputs come from numpy seeds; JAX's params (bf16 leaves included) carry
over with params_from_numpy.  The reference's fused stack runs in Pallas
interpret mode; the port's runs its plain versions (CPU tensors).
Tolerances, each stated where it is used:
  * float16 compute: logits within 2e-3 of the largest, the loss at rtol
    1e-4, every gradient within 2e-3 of its largest element (f16 keeps
    3 more mantissa bits than bf16, whose bands are 2e-2);
  * bf16 leaves: the fused loss at rtol 2e-3 and each gradient within 2e-2
    of its largest element (the reference suite's bands,
    tests/test_torch_train_stack.py);
  * the optimizer on bf16 leaves: params and EMA within one bf16 ulp of
    optax's run op by op (pow and sqrt are other libraries'), the moments
    bit for bit;
  * trainers: losses at rtol 1e-3 over 5 steps (the scan band of
    tests/test_torch_train.py); at param_dtype float16 both go NaN from
    step 2;
  * carries, checkpoints, decode and artifacts: bit for bit.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.audio import dataset as jds
from wavenet_tpu.models import api as japi
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.training import trainer as jtrainer
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import dataset as tds
from wavenet_tpu_torch.generate import sampler
from wavenet_tpu_torch.models import api as tapi
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.serving import export_decoder, load_decoder
from wavenet_tpu_torch.training import trainer as ttrainer
from wavenet_tpu_torch.utils.pytree_io import (flatten_tree, load_npz,
                                               params_from_numpy,
                                               params_to_numpy, save_npz)

torch.set_num_threads(1)

MICRO = dict(num_blocks=2, max_dilation=8, residual_channels=16,
             skip_channels=16, batch_size=2, train_window=64,
             learning_rate=3e-3)
MEL = dict(num_mels=8, hop_length=16, win_length=64, upsample_factors=(4, 4))
BF16 = dict(param_dtype="bfloat16")
F16 = dict(compute_dtype="float16")


def _cfgs(mel=False, **kw):
    kw = dict(MICRO, **kw)
    return (jconfig.WaveNetConfig(
                mel=jconfig.MelConfig(**MEL) if mel else None, **kw),
            tconfig.WaveNetConfig(
                mel=tconfig.MelConfig(**MEL) if mel else None, **kw))


def _init(jc):
    """The reference's init_params(jc, PRNGKey(0)), compiled as one
    program."""
    return jax.jit(lambda k: jwn.init_params(jc, k))(jax.random.PRNGKey(0))


def _params(jc):
    jp = _init(jc)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _tokens(B, n, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (B, n)).astype(
        np.int32)


def _assert_grads(jg, tg, band):
    jg, tg = flatten_tree(jg), flatten_tree(tg)
    assert sorted(jg) == sorted(tg)
    for k, a in jg.items():
        a = np.asarray(a, np.float32)
        g = tg[k].detach().float().numpy()
        scale = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(g / scale, a / scale, atol=band,
                                   err_msg=k)


def _grad_tree(tp, loss):
    flat = flatten_tree(tp)
    keys = sorted(flat)
    return dict(zip(keys, torch.autograd.grad(loss, [flat[k] for k in keys])))


def _trainable(tp):
    return {k: (_trainable(v) if isinstance(v, dict)
                else v.detach().clone().requires_grad_(True))
            for k, v in tp.items()}


@pytest.mark.parametrize("pdt", ["float32", "bfloat16", "float16"])
def test_init_leaf_dtypes_match_jax(pdt):
    """Every leaf (mel upsampler, speaker tables, K = 3 taps and the
    embedding projection included) in the reference's dtype and shape; a
    float32 model draws what it drew before, and the other dtypes draw the
    same values rounded."""
    kw = dict(param_dtype=pdt, global_classes=3, global_channels=8,
              kernel_size=3, causal_channels=8)
    jc, tc = _cfgs(mel=True, **kw)
    want = flatten_tree(jax.eval_shape(
        lambda k: jwn.init_params(jc, k), jax.random.PRNGKey(0)))
    got = flatten_tree(twn.init_params(tc, torch.Generator().manual_seed(0),
                                       "cpu"))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in got.items()}
    f32 = flatten_tree(twn.init_params(
        tc.replace(param_dtype="float32"),
        torch.Generator().manual_seed(0), "cpu"))
    for k, v in got.items():
        assert torch.equal(v, f32[k].to(v.dtype)), k


def test_dtype_fields_outside_the_reference_are_refused():
    for kw in ({"param_dtype": "float64"}, {"compute_dtype": "int8"}):
        with pytest.raises(NotImplementedError, match=list(kw)[0]):
            twn.check_supported(tconfig.WaveNetConfig(**kw))


def test_numpy_carry_of_bf16_leaves_bit_for_bit(tmp_path):
    """JAX's bf16 leaves (ml_dtypes arrays, and the '<V2' form np.load
    gives for the reference's own export) become torch.bfloat16 bit for
    bit, and come back as arrays jnp.asarray reads as bf16."""
    jc, tc = _cfgs(mel=True, **BF16)
    jp = jax.tree.map(np.asarray, _init(jc))
    tp = params_from_numpy(jp, "cpu")
    for k, v in flatten_tree(jp).items():
        t = flatten_tree(tp)[k]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16), _bits(v))
    back = flatten_tree(params_to_numpy(tp))
    for k, v in flatten_tree(jp).items():
        assert jnp.asarray(back[k]).dtype == jnp.bfloat16
        np.testing.assert_array_equal(_bits(back[k]), _bits(v))
    np.savez(tmp_path / "ref.npz", **flatten_tree(jp))
    with np.load(tmp_path / "ref.npz") as z:
        void = {k: z[k] for k in z.files}
    assert {v.dtype.str for v in void.values()} == {"|V2"}
    again = flatten_tree(params_from_numpy(void, "cpu"))
    for k, v in flatten_tree(tp).items():
        assert torch.equal(again[k].view(torch.int16), v.view(torch.int16))
    # save_npz / load_npz: the 'bfloat16' header, read by np.load where
    # ml_dtypes is loaded and by load_npz without it
    buf = io.BytesIO()
    save_npz(buf, {"w": back["w_cur"], "v": void["w_cur"],
                   "f": np.arange(3, dtype=np.float16)})
    with np.load(io.BytesIO(buf.getvalue())) as z:
        assert z["w"].dtype == jnp.bfloat16 == z["v"].dtype
        np.testing.assert_array_equal(_bits(z["w"]), _bits(jp["w_cur"]))
    z = load_npz(io.BytesIO(buf.getvalue()))
    assert z["w"].dtype.str == "|V2" and z["f"].dtype == np.float16
    np.testing.assert_array_equal(_bits(z["v"]), _bits(jp["w_cur"]))


@pytest.mark.parametrize("variant", ["plain", "mel", "speaker"])
def test_float16_forward_loss_and_grads_match_jax(variant):
    """compute_dtype float16, B = 2, T = 64: logits within 2e-3 of the
    largest, loss at rtol 1e-4, every gradient within 2e-3 of its
    largest element, against JAX's scan."""
    kw = dict(F16)
    if variant == "speaker":
        kw.update(global_classes=3, global_channels=8)
    jc, tc = _cfgs(mel=variant == "mel", **kw)
    jp, tp = _params(jc)
    toks = _tokens(2, 65)
    jkw, tkw = {}, {}
    if variant == "mel":
        frames = np.random.RandomState(2).randn(2, 5, 8).astype(np.float32)
        jkw["mel"], tkw["mel"] = jnp.asarray(frames), torch.from_numpy(frames)
    if variant == "speaker":
        sp = np.array([2, 0], np.int32)
        jkw["speaker"], tkw["speaker"] = jnp.asarray(sp), torch.from_numpy(sp)
    want = np.asarray(jwn.forward_logits(jp, jc, toks[:, :-1], **jkw))
    got = twn.forward_logits(tp, tc, torch.from_numpy(toks[:, :-1]),
                             **tkw).numpy()
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jwn.loss_fn(p, jc, jnp.asarray(toks), **jkw),
        has_aux=True))(jp)
    tp = _trainable(tp)
    tl, _ = twn.loss_fn(tp, tc, torch.from_numpy(toks), **tkw)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    _assert_grads(jg, _grad_tree(tp, tl), band=2e-3)


@pytest.mark.parametrize("variant", ["plain", "mel", "speaker"])
def test_bf16_leaves_fused_loss_and_grads_match_jax(variant):
    """param_dtype bfloat16 through the fused stack (plain versions) at
    T = 129 against loss_fn(use_fused=True, interpret=True): the loss at
    rtol 2e-3, every gradient bf16 (as the reference's VJP hands them)
    and within 2e-2 of its largest element.  T = 129 tokens: 128 inputs,
    two tiles of the stack."""
    kw = dict(BF16, train_window=128)
    if variant == "speaker":
        kw.update(global_classes=3, global_channels=8)
    jc, tc = _cfgs(mel=variant == "mel", **kw)
    jp, tp = _params(jc)
    toks = _tokens(2, 129)
    jkw, tkw = {}, {}
    if variant == "mel":
        frames = np.random.RandomState(2).randn(2, 8, 8).astype(np.float32)
        jkw["mel"], tkw["mel"] = jnp.asarray(frames), torch.from_numpy(frames)
    if variant == "speaker":
        sp = np.array([2, 0], np.int32)
        jkw["speaker"], tkw["speaker"] = jnp.asarray(sp), torch.from_numpy(sp)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jwn.loss_fn(p, jc, jnp.asarray(toks), use_fused=True,
                              interpret=True, **jkw), has_aux=True))(jp)
    tp = _trainable(tp)
    tl, _ = twn.loss_fn(tp, tc, torch.from_numpy(toks), use_fused=True,
                        **tkw)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    tg = _grad_tree(tp, tl)
    assert {g.dtype for g in tg.values()} == {torch.bfloat16}
    # the reference's VJP hands back the stack input's cotangent in f32,
    # so its embedding tables' gradients alone are f32; torch gives every
    # leaf its own dtype
    assert {k for k, g in flatten_tree(jg).items()
            if g.dtype != jnp.bfloat16} == {"embed_cur", "embed_prev"}
    _assert_grads(jg, tg, band=2e-2)


@pytest.mark.parametrize("pdt", ["bfloat16", "float16"])
def test_optimizer_matches_optax_on_low_precision_leaves(pdt):
    """Adam + warmup + clip + MultiSteps(2) + EMA over 12 gradients on
    bf16 (f16) leaves, step by step, against optax run op by op
    (jax.disable_jit: compiled, XLA keeps f32 inside the clip's fusion):
    params and EMA within one ulp of the leaf dtype of optax's (pow and
    sqrt are other libraries'), mu and nu in the leaves' dtype and equal
    to optax's bit for bit, so that nu's missing decay in bf16 (b2 = 0.999
    rounds to 1.0) shows."""
    kw = dict(warmup_steps=2, grad_clip_norm=3.0, grad_accum=2,
              ema_decay=0.9, learning_rate=0.05, param_dtype=pdt)
    jc, tc = _cfgs(**kw)
    dt = jnp.dtype(pdt)
    rs = np.random.RandomState(0)
    p0 = {"a": rs.randn(3, 4), "b": rs.randn(5)}
    grads = [{k: rs.randn(*v.shape) * (0.5 + 1.5 * (i % 3))
              for k, v in p0.items()} for i in range(12)]
    cast = lambda t: jax.tree.map(lambda v: jnp.asarray(v, dt), t)
    tx = jtrainer.make_optimizer(jc)
    jp = cast(p0)
    jst, jema = tx.init(jp), jp
    opt = ttrainer.make_optimizer(tc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tst, tema = opt.init(tp), dict(tp)
    ulp = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}[pdt]
    for g in grads:
        jg = cast(g)
        with jax.disable_jit():        # MultiSteps' lax.cond compiles else
            updates, jst = tx.update(jg, jst, jp)
            jp = optax.apply_updates(jp, updates)
        d = jnp.where(jst.mini_step == 0, 0.9, 1.0)
        jema = jax.tree.map(lambda e, p: d * e + (1.0 - d) * p, jema, jp)
        tp, tst, applied, _ = opt.update(
            params_from_numpy(jax.tree.map(np.asarray, jg), "cpu"), tst, tp)
        if applied:
            tema = ttrainer.ema_update(tema, tp, 0.9)
        for k in p0:
            for got, want in ((tp[k], jp[k]), (tema[k], jema[k])):
                assert got.dtype == getattr(torch, pdt)
                want = np.asarray(want, np.float32)
                np.testing.assert_allclose(
                    got.float().numpy(), want, rtol=ulp,
                    atol=ulp * np.abs(want).max(), err_msg=k)
            # the moments bit for bit: a nu that decayed by 0.999 a step
            # would stay inside the one-ulp band above over 6 steps
            adam = jst.inner_opt_state[1][0]
            for m, want in (("mu", adam.mu[k]), ("nu", adam.nu[k])):
                assert tst[m][k].dtype == getattr(torch, pdt)
                np.testing.assert_array_equal(
                    tst[m][k].float().numpy(), np.asarray(want, np.float32),
                    err_msg=f"{m} {k}")
    assert tst["count"] == 6


def test_adam_second_moment_does_not_decay_in_bf16():
    """optax on a bf16 leaf meets b2 = 0.999 as bf16, which is 1.0: with
    g = 0.5 every step, nu adds bf16(0.001) g^2 and never decays (0.000250,
    0.000500, 0.000748).  The port's nu, mu and params equal optax's bit
    for bit (lr 0.05)."""
    jc, tc = _cfgs(learning_rate=0.05, **BF16)
    jp = {"a": jnp.ones((1,), jnp.bfloat16)}
    tx = jtrainer.make_optimizer(jc)
    jst = tx.init(jp)
    opt = ttrainer.make_optimizer(tc)
    tp = {"a": torch.ones(1, dtype=torch.bfloat16)}
    tst = opt.init(tp)
    nus = []
    for _ in range(3):
        updates, jst = tx.update({"a": jnp.full((1,), 0.5, jnp.bfloat16)},
                                 jst, jp)
        jp = optax.apply_updates(jp, updates)
        tp, tst, _, _ = opt.update(
            {"a": torch.full((1,), 0.5, dtype=torch.bfloat16)}, tst, tp)
        nus.append(tst["nu"]["a"])
        assert tst["nu"]["a"].dtype == torch.bfloat16
        for got, want in ((tst["nu"]["a"], jst[0].nu["a"]),
                          (tst["mu"]["a"], jst[0].mu["a"]),
                          (tp["a"], jp["a"])):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
    step = nus[0]
    assert torch.equal(nus[1], nus[0] + step)
    assert torch.equal(nus[2], nus[1] + step)


def _jax_losses(jtr, n):
    seen = []
    last = jtr.run(n, log_every=1, log_fn=lambda _: None,
                   metrics_fn=lambda s, m: seen.append(m["loss"]))
    return seen + [last["loss"]]


def _port_losses(ttr, n):
    seen = []
    last = ttr.run(n, log_every=1, log_fn=lambda _: None,
                   metrics_fn=lambda s, m: seen.append(m["loss"]))
    return seen + [last["loss"]]


@pytest.mark.parametrize("kw", [BF16, F16, {"param_dtype": "float16"}],
                         ids=["param_bf16", "compute_f16", "param_f16"])
def test_trainer_matches_jax_trainer(kw):
    """5 steps of the scan route (fused_stack=False, grad_clip_norm 1.0)
    from the same weights: losses at rtol 1e-3; leaves and Adam's moments
    in the reference's dtypes.  At param_dtype float16 both trainers go
    NaN from step 2 (Adam's eps = 1e-8 is 0 in f16): the port follows
    the dtype and adds no guard."""
    jc, tc = _cfgs(fused_stack=False, grad_clip_norm=1.0, **kw)
    jd = jds.AudioDataset.synthetic(jc, num_clips=2, clip_seconds=0.05)
    td = tds.AudioDataset.synthetic(tc, num_clips=2, clip_seconds=0.05)
    jtr = jtrainer.Trainer(jc, jd)
    p0 = params_from_numpy(jax.tree.map(np.asarray, jtr.state.params), "cpu")
    ttr = ttrainer.Trainer(tc, td, device="cpu", params=p0)
    assert not ttr.use_fused
    want = _jax_losses(jtr, 5)
    got = _port_losses(ttr, 5)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    pdt = getattr(torch, tc.param_dtype)
    assert {v.dtype for v in ttr.state.params.values()} == {pdt}
    assert {v.dtype for v in ttr.state.opt_state["nu"].values()} == {pdt}
    assert {str(v.dtype) for v in jax.tree.leaves(jtr.state.params)} == \
        {tc.param_dtype}
    if tc.param_dtype == "float16":
        assert np.isfinite(got[0]) and np.isnan(got[1:]).all()


def test_trainer_bf16_fused_resume_bit_exact_and_guard(tmp_path):
    """bf16 leaves on the fused route: 4 straight steps == 2 + save +
    restore + 2, bit for bit (params, moments, EMA); every saved leaf is
    bf16; a config of another param_dtype is refused."""
    _, tc = _cfgs(ema_decay=0.99, **BF16)
    td = tds.AudioDataset.synthetic(tc, num_clips=2, clip_seconds=0.05)
    a = ttrainer.Trainer(tc, td, device="cpu")
    assert a.use_fused
    a.run(4, log_every=0)
    b = ttrainer.Trainer(tc, td, checkpoint_dir=str(tmp_path), device="cpu")
    b.run(2, log_every=0)
    b.save()
    raw = torch.load(os.path.join(tmp_path, "ckpt_00000002.pt"),
                     weights_only=False)
    for tree in (raw["params"], raw["ema"], raw["opt_state"]["mu"],
                 raw["opt_state"]["nu"]):
        assert {v.dtype for v in tree.values()} == {torch.bfloat16}
    c = ttrainer.Trainer(tc, td, checkpoint_dir=str(tmp_path), device="cpu")
    c.restore()
    c.run(2, log_every=0)
    for tree in ("params", "ema"):
        for k, v in getattr(a.state, tree).items():
            assert torch.equal(getattr(c.state, tree)[k].view(torch.int16),
                               v.view(torch.int16)), (tree, k)
    for k, v in a.state.opt_state["nu"].items():
        assert torch.equal(c.state.opt_state["nu"][k], v)
    with pytest.raises(ValueError, match="param_dtype"):
        ttrainer.Trainer(tc.replace(param_dtype="float32"), td,
                         checkpoint_dir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("variant", ["plain", "mel", "speaker"])
def test_float16_decode_matches_jax(variant):
    """compute_dtype float16 (f32 leaves): the plain route on every device;
    48 greedy steps equal JAX's scan decoder token for token; the teacher-
    forced decode logits of JAX's tokens within 2e-3 of the largest of
    JAX's; and sampled fast == naive token for token."""
    kw = dict(F16)
    if variant == "speaker":
        kw.update(global_classes=3, global_channels=8)
    mel = variant == "mel"
    jc, tc = _cfgs(mel=mel, **kw)
    assert sampler.kernel_module(tc, "cuda") is sampler.PLAIN
    jp, tp = _params(jc)
    N = 48
    jgen, tgen, tnaive = {}, {}, {}
    if mel:
        from wavenet_tpu.models import conditioning as jcond
        from wavenet_tpu_torch.models import conditioning as tcond
        frames = np.random.RandomState(2).randn(2, 5, 8).astype(np.float32)
        jy = jcond.upsample_mel(jp["upsampler"], jc.mel, jnp.asarray(frames),
                                N)
        jgen["cond"] = jcond.project_cond(jp, jy)
        tgen["y"] = tcond.upsample_mel(tp["upsampler"], tc.mel,
                                       torch.from_numpy(frames), N)
        tnaive["y"] = tgen["y"]
    if variant == "speaker":
        sp = np.array([2, 0], np.int32)
        jgen["speaker"] = jnp.asarray(sp)
        tgen["speaker"] = tnaive["speaker"] = torch.from_numpy(sp)
    jt = np.asarray(jwn.generate(jp, jc, jax.random.PRNGKey(1), N, batch=2,
                                 temperature=0.0, **jgen))
    tt = sampler.generate_auto(tp, tc, N, batch=2, temperature=0.0,
                               device="cpu", **tgen)
    if not mel:                          # JAX's decode cond is f32 there
        np.testing.assert_array_equal(tt.numpy(), jt)
    # teacher-forced: the port's ring decoder over JAX's greedy tokens
    jstate = jwn.decode_init(jc, 2)
    tstate = twn.decode_init(tc, 2, "cpu")
    jg = tg = None
    if variant == "speaker":
        jg = jwn.global_cond_offsets(jp, jc, jgen["speaker"])
        tg = twn.global_cond_offsets(tp, tc, tgen["speaker"])
    jstep = jax.jit(lambda s, tok: jwn.decode_step(jp, jc, s, tok, gcond=jg))
    for t in range(N):
        tok = np.ascontiguousarray(jt[:, t])
        jstate, jl = jstep(jstate, jnp.asarray(tok))
        tstate, tl = twn.decode_step(tp, tc, tstate, torch.from_numpy(tok),
                                     gcond=tg)
        jl = np.asarray(jl)
        assert np.abs(tl.numpy() - jl).max() <= 2e-3 * np.abs(jl).max()
    fast = sampler.generate_auto(tp, tc, 24, batch=2, seeds=5,
                                 device="cpu", **tgen)
    naive = sampler.generate_naive(tp, tc, 24, batch=2, seeds=5,
                                   device="cpu", **tnaive)
    np.testing.assert_array_equal(fast.numpy(), naive.numpy())


def test_export_npz_appends_the_suffix_as_the_reference(tmp_path):
    """export_npz('model') writes 'model.npz', as np.savez (and so the
    reference's export_npz) does; a path with the suffix is kept as given;
    the file loads back bit for bit."""
    _, tc = _cfgs(**BF16)
    tm = tapi.WaveNet(tc, twn.init_params(
        tc, torch.Generator().manual_seed(0), "cpu"))
    np.savez(tmp_path / "numpy", x=np.zeros(1))
    tm.export_npz(str(tmp_path / "port"))
    tm.export_npz(tmp_path / "path.npz")
    assert sorted(os.listdir(tmp_path)) == ["numpy.npz", "path.npz",
                                            "port.npz"]
    for name in ("port.npz", "path.npz"):
        back = tapi.WaveNet.from_npz(str(tmp_path / name), device="cpu")
        for k, v in flatten_tree(back.params).items():
            assert torch.equal(v.view(torch.int16),
                               flatten_tree(tm.params)[k].view(torch.int16))


def test_npz_both_ways_and_artifact_with_bf16_leaves(tmp_path):
    """A bf16-leaf model: the reference's export_npz ('<V2' members) loads
    into the port bit for bit; the port's export_npz loads into the
    reference as bf16 bit for bit; both generate the same greedy tokens;
    a bf16-leaf AOT artifact gives the facade's tokens bit for bit."""
    jc, tc = _cfgs(**BF16)
    jm = japi.WaveNet(jc).init(jax.random.PRNGKey(0))
    jm.export_npz(str(tmp_path / "ref.npz"))
    tm = tapi.WaveNet.from_npz(str(tmp_path / "ref.npz"), device="cpu")
    want = flatten_tree(jax.tree.map(np.asarray, jm.params))
    got = flatten_tree(tm.params)
    for k, v in want.items():
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[k].view(torch.int16).numpy().view(np.uint16), _bits(v))
    tm.export_npz(str(tmp_path / "port.npz"))
    back = japi.WaveNet.from_npz(str(tmp_path / "port.npz"))
    for k, v in flatten_tree(back.params).items():
        assert v.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_bits(v), _bits(want[k]))
    again = tapi.WaveNet.from_npz(str(tmp_path / "port.npz"), device="cpu")
    for k, v in flatten_tree(again.params).items():
        assert torch.equal(v.view(torch.int16), got[k].view(torch.int16))
    assert tm.cfg == tc
    toks = tm.generate(num_samples=16, batch=2, seed=7)
    path = str(tmp_path / "a.wnx")
    export_decoder(tm.params, tc, path, num_samples=16, batch=2,
                   platforms=("cpu",))
    dec = load_decoder(path, device="cpu")
    assert {v.dtype for v in flatten_tree(dec.params).values()} == \
        {torch.bfloat16}
    np.testing.assert_array_equal(dec.generate(seed=7).numpy(),
                                  np.asarray(toks))
