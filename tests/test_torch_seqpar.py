"""Training over the mesh's seq axis (parallel/seqpar.py) on the CPU,
against the JAX package's wavenet_tpu/parallel/seqpar.py on the
conftest's virtual CPU devices and against the port in one process.

One spawn of four gloo ranks (tests/_torch_meshtrain_worker.py) runs every
case; a case of two ranks runs on ranks 0-1.  Cases: forward_logits_sp at
(data, seq, model) = (1, 4, 1), (2, 2, 1), (1, 4, 1) with speakers and
(1, 2, 2) (the Megatron split under the seq axis), whose assembled
logits equal the unsharded forward's and JAX's forward_logits_sp to
1e-5 (the reference's tests/test_seqpar.py:23-72); both seq routes (the
scan with one halo exchange a layer, f32 as the reference's tests; and
overlap-discard through the fused stack's plain versions, bf16 with
nonzero biases, which the shard-0 phantom rows would otherwise hide) at
(data, seq) = (1, 2), (2, 2) and (1, 4), a mel case and a speaker case
of each; the trainer over (1, 2, 1) for 3 steps; and a decode over a mesh
with a seq axis (its seq ranks are replicas, as the reference's decode
counts them).  Tolerances, the reference's (tests/test_seqpar.py:128-134):
loss rtol 2e-6, every gradient leaf atol 5e-5 / rtol 1e-4, for the
sharded port against the port in one process and for the f32 scan against
JAX.  The bf16 fused route against JAX's interpret-mode kernels takes the
reference suite's stack band (loss rtol 2e-3, each leaf within 2e-2 of
its largest element; tests/test_pallas_train.py:96-103): the port sums
bf16 products exactly, JAX in f32, and a last-bit difference moves a bf16
rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.parallel import seqpar as jseqpar
from wavenet_tpu.parallel.mesh import make_mesh as jmake_mesh
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio.dataset import AudioDataset
from wavenet_tpu_torch.generate.sampler import generate_auto
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.parallel import seqpar
from wavenet_tpu_torch.training.trainer import Trainer
from wavenet_tpu_torch.utils.pytree_io import (flatten_tree,
                                               params_from_numpy,
                                               unflatten_tree)

import _torch_meshtrain_worker as worker

torch.set_num_threads(1)

MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))
BASE = dict(num_blocks=1, max_dilation=8, residual_channels=16,
            skip_channels=16, compute_dtype="float32", batch_size=2,
            train_window=128)
# name: (sp, dp, fused, extra config)
LOSS = {
    "scan_sp2": (2, 1, False, {}),
    "scan_sp2_dp2": (2, 2, False, {}),
    "scan_sp4": (4, 1, False, {}),
    "scan_mel": (2, 1, False, {"mel": MEL}),
    "scan_speaker": (2, 2, False, {"global_classes": 3,
                                   "global_channels": 8}),
    "fused_sp2": (2, 1, True, {}),
    "fused_sp2_dp2": (2, 2, True, {}),
    "fused_sp4": (4, 1, True, {}),
    "fused_mel": (2, 2, True, {"mel": MEL}),
    "fused_speaker": (2, 1, True, {"global_classes": 3,
                                   "global_channels": 8}),
}
# forward_logits_sp: name -> (data, seq, model, extra config)
FWD = {
    "fwd_sp4": (1, 4, 1, {}),
    "fwd_sp2_dp2": (2, 2, 1, {}),
    "fwd_speaker": (1, 4, 1, {"global_classes": 3, "global_channels": 8}),
    "fwd_sp2_mp2": (1, 2, 2, {}),
}
STEPS, RESUME_AT, LR = 3, 2, 1e-3


def _cfgs(**kw):
    kw = dict(BASE, **kw)
    mel = kw.pop("mel", None)
    return (jconfig.WaveNetConfig(
                mel=None if mel is None else jconfig.MelConfig(**mel), **kw),
            tconfig.WaveNetConfig(
                mel=None if mel is None else tconfig.MelConfig(**mel), **kw))


def _params(jc, nonzero_bias: bool):
    jp = jax.tree.map(np.asarray, jwn.init_params(jc, jax.random.PRNGKey(0)))
    if nonzero_bias:
        rs = np.random.RandomState(7)
        for k in ("b", "b_res", "b_skip"):
            jp[k] = (jp[k] + 0.1 * rs.randn(*jp[k].shape)).astype(np.float32)
    return jp


def _inputs(name, jc):
    rs = np.random.RandomState(sum(map(ord, name)))
    B, W = jc.batch_size, jc.train_window
    inp = {"tokens": rs.randint(0, 256, (B, W + 1)).astype(np.int32)}
    if jc.mel is not None:
        inp["mel"] = rs.randn(B, W // jc.mel.hop_length,
                              jc.mel.num_mels).astype(np.float32)
    if jc.global_classes is not None:
        inp["speaker"] = np.array([0, 2], np.int32)[:B]
    return inp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("seqpar"))
    cases, info = {}, {}
    for name, (sp, dp, fused, extra) in LOSS.items():
        jc, tc = _cfgs(seq_parallel=sp, data_parallel=dp,
                       fused_stack=fused,
                       **dict(extra, compute_dtype="bfloat16") if fused
                       else extra)
        jp = _params(jc, fused)
        inp = _inputs(name, jc)
        worker.write_case(d, cases, name, "loss", sp * dp, tc.to_json(),
                          flatten_tree(jp), inp)
        info[name] = (jc, tc, jp, inp, fused)
    for name, (dp, sp, mp, extra) in FWD.items():
        jc, tc = _cfgs(data_parallel=dp, seq_parallel=sp, model_parallel=mp,
                       **extra)
        jp = _params(jc, False)
        inp = _inputs(name, jc)
        inp["tokens"] = inp["tokens"][:, :-1]              # [B, T]
        worker.write_case(d, cases, name, "forward", dp * sp * mp,
                          tc.to_json(), flatten_tree(jp), inp)
        info[name] = (jc, tc, jp, inp, False)
    jc, tc = _cfgs(seq_parallel=2, compute_dtype="bfloat16",
                   learning_rate=LR, ema_decay=0.99)
    jp = _params(jc, True)
    worker.write_case(d, cases, "train", "train", 2, tc.to_json(),
                      flatten_tree(jp), {}, steps=STEPS, resume_at=RESUME_AT)
    info["train"] = (jc, tc, jp, {}, True)
    _, tc = _cfgs(seq_parallel=2, compute_dtype="bfloat16")
    tp = twn.init_params(tc, torch.Generator().manual_seed(4), "cpu")
    worker.write_case(d, cases, "decode", "decode", 2, tc.to_json(),
                      flatten_tree({k: v.numpy() for k, v in tp.items()}),
                      {"n": np.asarray(24), "batch": np.asarray(2)})
    info["decode"] = (None, tc, tp, {}, False)
    return d, info, worker.run(d, cases)


def _single(tc, jp, inp, fused):
    """The port's one-process loss and gradients on the whole batch."""
    cfg = tc.replace(seq_parallel=1, data_parallel=1)
    flat = {k: v.requires_grad_(True) for k, v in
            flatten_tree(params_from_numpy(jp, "cpu")).items()}
    t = lambda k: None if k not in inp else torch.from_numpy(inp[k])
    loss, _ = twn.loss_fn(unflatten_tree(flat), cfg, t("tokens"),
                          mel=t("mel"), speaker=t("speaker"),
                          use_fused=fused)
    keys = sorted(flat)
    g = torch.autograd.grad(loss, [flat[k] for k in keys])
    return float(loss.detach()), {k: v.numpy() for k, v in zip(keys, g)}


def _grads(res, prefix="grad/"):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name", list(LOSS))
def test_seq_loss_and_grads_match_single_process(run, name):
    _, info, out = run
    jc, tc, jp, inp, fused = info[name]
    ranks = out[name]
    assert str(ranks[0]["route"]) == ("sp_fused" if fused else "sp")
    for r in ranks[1:]:                     # every replica: the same bits
        for k, v in _grads(ranks[0]).items():
            np.testing.assert_array_equal(_grads(r)[k], v, err_msg=k)
    loss, grads = _single(tc, jp, inp, fused)
    np.testing.assert_allclose(float(ranks[0]["loss"]), loss, rtol=2e-6)
    shares = sum(float(r["share"]) for r in ranks)
    np.testing.assert_allclose(shares, loss, rtol=2e-6)
    got = _grads(ranks[0])
    assert sorted(got) == sorted(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(got[k], g, atol=5e-5, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(LOSS))
def test_seq_loss_and_grads_match_jax(run, name):
    _, info, out = run
    jc, tc, jp, inp, fused = info[name]
    mesh = jmake_mesh(jc)
    toks = jnp.asarray(inp["tokens"])
    kw = {k: jnp.asarray(inp[k]) for k in ("mel", "speaker") if k in inp}
    if fused:
        fn = lambda p: jseqpar.loss_fn_sp_fused(
            p, jc, mesh, toks[:, :-1], toks[:, 1:], interpret=True, **kw)
    else:
        fn = lambda p: jseqpar.loss_fn_sp(p, jc, mesh, toks[:, :-1],
                                          toks[:, 1:], **kw)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(fn, has_aux=True))(jp)
    r0 = out[name][0]
    got = _grads(r0)
    jflat = flatten_tree(jax.tree.map(np.asarray, jg))
    assert sorted(got) == sorted(jflat)
    if not fused:
        np.testing.assert_allclose(float(r0["loss"]), float(jl), rtol=2e-6)
        for k, g in jflat.items():
            np.testing.assert_allclose(got[k], g, atol=5e-5, rtol=1e-4,
                                       err_msg=k)
        return
    np.testing.assert_allclose(float(r0["loss"]), float(jl), rtol=2e-3)
    for k, g in jflat.items():
        scale = max(float(np.abs(g).max()), 1e-12)
        assert float(np.abs(got[k] - g).max()) <= 2e-2 * scale, k


def _assembled(ranks, dp, sp, mp):
    """The global [B, T, Q] logits from every rank's (data, seq, model)
    block (rank r at r // (sp mp), (r // mp) % sp, r % mp)."""
    rows = []
    for d in range(dp):
        cols = []
        for s in range(sp):
            cols.append(np.concatenate(
                [ranks[(d * sp + s) * mp + m]["logits"] for m in range(mp)],
                axis=-1))
        rows.append(np.concatenate(cols, axis=1))
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("name", list(FWD))
def test_seq_forward_matches_single_process(run, name):
    """The reference's test_sp_forward_exact and its speaker and model
    variants (tests/test_seqpar.py:23-72, 186-201): the sharded logits
    equal the unsharded forward's to 1e-5."""
    _, info, out = run
    jc, tc, jp, inp, _ = info[name]
    dp, sp, mp, _ = FWD[name]
    got = _assembled(out[name], dp, sp, mp)
    spk = inp.get("speaker")
    with torch.no_grad():
        want = twn.forward_logits(
            params_from_numpy(jp, "cpu"), tc, torch.from_numpy(inp["tokens"]),
            speaker=None if spk is None else torch.from_numpy(spk))
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(FWD))
def test_seq_forward_matches_jax(run, name):
    _, info, out = run
    jc, tc, jp, inp, _ = info[name]
    dp, sp, mp, _ = FWD[name]
    mesh = jmake_mesh(jc)
    p = jp
    if mp > 1:
        from wavenet_tpu.parallel import sharding as jshd
        p = jax.device_put(jp, jshd.param_shardings(jc, mesh))
    kw = {} if "speaker" not in inp else {"speaker": jnp.asarray(
        inp["speaker"])}
    want = jax.jit(lambda p, t: jseqpar.forward_logits_sp(
        p, jc, mesh, t, **kw))(p, jnp.asarray(inp["tokens"]))
    np.testing.assert_allclose(_assembled(out[name], dp, sp, mp),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


def _one_process_trainer(tc, jp):
    cfg = tc.replace(seq_parallel=1, data_parallel=1, model_parallel=1)
    ds = AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.1)
    tr = Trainer(cfg, ds, device="cpu",
                 params=params_from_numpy(jp, "cpu"))
    losses = []
    tr.run(STEPS, log_every=1, log_fn=lambda m: None,
           metrics_fn=lambda step, m: losses.append(m["loss"]))
    return tr, losses


def test_trainer_over_the_seq_axis_matches_one_process(run):
    """Three steps through overlap-discard on (1, 2, 1) against one
    process: each step's loss within rtol 1e-5 and each param within
    2 * steps * lr (Adam moves a weight by about lr whatever its
    gradient's size, so an element whose near-zero gradient another
    summation order flips moves the other way; tests/test_torch_dp_train.py),
    the median element within the reference trainer test's atol 1e-5
    (tests/test_seqpar.py:183)."""
    _, info, out = run
    jc, tc, jp, _, _ = info["train"]
    r0, r1 = out["train"]
    assert str(r0["route"]) == "sp_fused"
    tr, losses = _one_process_trainer(tc, jp)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    for k, v in tr.state.params.items():
        d = np.abs(r0[f"param/{k}"] - v.detach().numpy())
        assert d.max() <= 2 * STEPS * LR, (k, d.max())
        assert np.median(d) <= 1e-5, (k, np.median(d))


def test_seq_checkpoint_resumes_exactly_and_decodes_in_one_process(run):
    """The seq ranks hold whole, equal params; the resumed run repeats the
    uninterrupted one bit for bit; the checkpoint loads in one process
    and decodes there."""
    d, info, out = run
    _, tc, _, _, _ = info["train"]
    r0, r1 = out["train"]
    for k in r0:
        if k.startswith(("param/", "local/", "ema/")):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    for k, v in _grads(r0, "param/").items():
        np.testing.assert_array_equal(r0[f"resumed/{k}"], v, err_msg=k)
        np.testing.assert_array_equal(r0[f"resumed_ema/{k}"], r0[f"ema/{k}"],
                                      err_msg=k)
    model = WaveNet.from_checkpoint(f"{d}/train_ckpt", step=STEPS,
                                    use_ema=False, device="cpu")
    for k, v in flatten_tree(model.params).items():
        np.testing.assert_array_equal(v.numpy(), r0[f"param/{k}"], err_msg=k)
    toks = model.generate(num_samples=16, batch=2, seed=1)
    want = generate_auto({k: torch.from_numpy(v) for k, v in
                          _grads(r0, "param/").items()},
                         tc, 16, batch=2, seeds=1, device="cpu")
    assert toks.shape == (2, 16) and torch.equal(toks, want)


def test_decode_over_a_seq_axis_counts_replicas(run):
    """A (1, 2, 1) mesh decodes as the reference's does: each seq rank
    runs the whole decode, and both get one device's tokens."""
    _, info, out = run
    _, tc, tp, _, _ = info["decode"]
    want = generate_auto(tp, tc, 24, batch=2, seeds=3, device="cpu")
    for r in out["decode"]:
        np.testing.assert_array_equal(r["tokens"], want.numpy())


def test_seq_refusals_stay():
    """K > 2 at any seq size, and a shard shorter than max_dilation; the
    fused gate refuses a shard shorter than the warmup."""
    _, tc = _cfgs(kernel_size=3)
    with pytest.raises(ValueError, match="width-2 only"):
        seqpar.check_seq_shardable(tc, 1, 128)
    _, tc = _cfgs(max_dilation=32)
    with pytest.raises(ValueError, match="halo"):
        seqpar.check_seq_shardable(tc, 8, 64)          # 64/8 = 8 < 32
    assert seqpar.check_seq_shardable(tc, 2, 64) == 32
    _, tc = _cfgs(compute_dtype="bfloat16")
    assert seqpar.sp_fused_supported(tc, 128, 2)
    assert not seqpar.sp_fused_supported(tc, 128, 1)
    assert not seqpar.sp_fused_supported(tc, 100, 2)
    _, big = _cfgs(num_blocks=2, max_dilation=64, compute_dtype="bfloat16")
    assert not seqpar.sp_fused_supported(big, 128, 2)  # rf 254 > 64
