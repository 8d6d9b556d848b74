"""Training over the mesh's model axis on the CPU: the layer pipeline on
the fused stack (parallel/pipeline.py) and the Megatron-split scan
(parallel/megatron.py), against the JAX package on the conftest's virtual
CPU devices (wavenet_tpu/parallel/pipeline.loss_fn_pp with its kernels in
interpret mode; the GSPMD scan under sharding.param_pspecs) and against
the port in one process.

One spawn of four gloo ranks (tests/_torch_meshtrain_worker.py) runs every
case; a case of two ranks runs on ranks 0-1.  Cases: the pipeline at
model = 2 with data in {1, 2} and microbatch in {1, 2}, and with mel; the
Megatron scan at model = 2 (with mel and speakers), at (data, model) =
(2, 2), and under a seq axis at (1, 2, 2); the trainer over (1, 1, 2) on
each route for 3 steps, with a checkpoint that resumes bit for bit and
loads and decodes in one process.
Tolerances, the reference's: the pipeline's loss 2e-4 and each gradient
leaf within 0.02 of its largest element (tests/test_pipeline.py:68-76),
with the stack's group plan pinned to the stage boundaries on both sides
(the residual is rounded to bf16 at group edges; align_group_budget
there); the Megatron scan's loss rtol 2e-6 and gradients atol 5e-5 /
rtol 1e-4 (tests/test_sharding.py:54-61).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.ops.pallas import train_stack as jts
from wavenet_tpu.parallel import pipeline as jpp
from wavenet_tpu.parallel import seqpar as jseqpar
from wavenet_tpu.parallel import sharding as jshd
from wavenet_tpu.parallel.mesh import make_mesh as jmake_mesh
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio.dataset import AudioDataset
from wavenet_tpu_torch.generate.sampler import generate_auto
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.ops.cuda import train_stack as tts
from wavenet_tpu_torch.parallel import pipeline, sharding
from wavenet_tpu_torch.training.trainer import Trainer
from wavenet_tpu_torch.utils.pytree_io import (flatten_tree,
                                               params_from_numpy,
                                               unflatten_tree)

import _torch_meshtrain_worker as worker

torch.set_num_threads(1)

MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))
PIPE = dict(num_blocks=4, max_dilation=8, residual_channels=16,
            skip_channels=16, compute_dtype="bfloat16", batch_size=4,
            train_window=64)
SCAN = dict(num_blocks=1, max_dilation=8, residual_channels=16,
            skip_channels=16, compute_dtype="float32", batch_size=8,
            train_window=128)
SPK = dict(global_classes=3, global_channels=8)
# name: (base, dp, sp, mp, extra config)
LOSS = {
    "pp": (PIPE, 1, 1, 2, {}),
    "pp_mb2": (PIPE, 1, 1, 2, {"pipeline_microbatch": 2}),
    "pp_dp2": (PIPE, 2, 1, 2, {}),
    "pp_mel": (PIPE, 2, 1, 2, {"mel": MEL}),
    "tp": (SCAN, 1, 1, 2, dict(SPK, mel=MEL)),
    "tp_dp2": (SCAN, 2, 1, 2, {}),
    "tp_sp2": (SCAN, 1, 2, 2, {"batch_size": 2}),
    "tp_bf16_leaves": (SCAN, 1, 1, 2, {"compute_dtype": "bfloat16",
                                       "param_dtype": "bfloat16"}),
}
TRAIN = {
    "train_pp": (PIPE, dict(ema_decay=0.99)),
    "train_tp": (SCAN, dict(grad_accum=2, grad_clip_norm=0.05,
                            ema_decay=0.99)),
}
STEPS, RESUME_AT, LR = 3, 2, 1e-3


def _cfgs(base, **kw):
    kw = dict(base, **kw)
    mel = kw.pop("mel", None)
    return (jconfig.WaveNetConfig(
                mel=None if mel is None else jconfig.MelConfig(**mel), **kw),
            tconfig.WaveNetConfig(
                mel=None if mel is None else tconfig.MelConfig(**mel), **kw))


def _budget(ts, cfg):
    """The reference test's align_group_budget: the on-chip budget at which
    the one-device group plan splits exactly at the stage boundaries."""
    mp = cfg.model_parallel
    TT = ts.pick_tile(cfg, cfg.train_window)
    Lst = cfg.num_layers // mp
    return max(max(ts._group_sizes(cfg, TT, cfg.dilations[i:i + Lst]))
               for i in range(0, cfg.num_layers - Lst + 1))


def _inputs(name, jc):
    rs = np.random.RandomState(sum(map(ord, name)))
    B, W = jc.batch_size, jc.train_window
    inp = {"tokens": rs.randint(0, 256, (B, W + 1)).astype(np.int32)}
    if jc.mel is not None:
        inp["mel"] = rs.randn(B, W // jc.mel.hop_length,
                              jc.mel.num_mels).astype(np.float32)
    if jc.global_classes is not None:
        inp["speaker"] = (np.arange(B) % jc.global_classes).astype(np.int32)
    return inp


def _params(jc):
    """The reference's init, as its pipeline and sharding tests use it."""
    return jax.tree.map(np.asarray, jwn.init_params(jc,
                                                    jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pipeline"))
    cases, info = {}, {}
    for name, (base, dp, sp, mp, extra) in LOSS.items():
        jc, tc = _cfgs(base, data_parallel=dp, seq_parallel=sp,
                       model_parallel=mp, **extra)
        jp, inp = _params(jc), _inputs(name, jc)
        vmem = _budget(tts, tc) if base is PIPE else None
        worker.write_case(d, cases, name, "loss", dp * sp * mp, tc.to_json(),
                          flatten_tree(jp), inp, vmem=vmem)
        info[name] = (jc, tc, jp, inp, vmem)
    for name, (base, extra) in TRAIN.items():
        jc, tc = _cfgs(base, model_parallel=2, learning_rate=LR,
                       **dict(extra, batch_size=4))
        jp = _params(jc)
        vmem = _budget(tts, tc) if base is PIPE else None
        worker.write_case(d, cases, name, "train", 2, tc.to_json(),
                          flatten_tree(jp), {}, vmem=vmem, steps=STEPS,
                          resume_at=RESUME_AT)
        info[name] = (jc, tc, jp, {}, vmem)
    return d, info, worker.run(d, cases)


def _single(tc, jp, inp, fused):
    """The port's one-process loss and gradients on the whole batch."""
    cfg = tc.replace(seq_parallel=1, data_parallel=1, model_parallel=1)
    flat = {k: v.requires_grad_(True) for k, v in
            flatten_tree(params_from_numpy(jp, "cpu")).items()}
    t = lambda k: None if k not in inp else torch.from_numpy(inp[k])
    loss, _ = twn.loss_fn(unflatten_tree(flat), cfg, t("tokens"),
                          mel=t("mel"), speaker=t("speaker"),
                          use_fused=fused)
    keys = sorted(flat)
    g = torch.autograd.grad(loss, [flat[k] for k in keys])
    return float(loss.detach()), {k: v.float().numpy()
                                  for k, v in zip(keys, g)}


def _grads(res, prefix="grad/"):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _assert_close(got, want, pipe, what=""):
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        if pipe:
            scale = max(float(np.abs(g).max()), 1e-3)
            np.testing.assert_allclose(got[k] / scale, g / scale, atol=0.02,
                                       err_msg=what + k)
        else:
            np.testing.assert_allclose(got[k], g, atol=5e-5, rtol=1e-4,
                                       err_msg=what + k)


@pytest.mark.parametrize("name", list(LOSS))
def test_model_axis_loss_and_grads_match_single_process(run, name,
                                                        monkeypatch):
    _, info, out = run
    jc, tc, jp, inp, vmem = info[name]
    pipe = vmem is not None
    ranks = out[name]
    assert str(ranks[0]["route"]) == {
        "pp": "pp", "tp": "tp", "tp_dp2": "tp", "tp_sp2": "sp",
        "tp_bf16_leaves": "tp"}.get(name, "pp")
    for r in ranks[1:]:                  # every rank: the whole gradients
        for k, v in _grads(ranks[0]).items():
            np.testing.assert_array_equal(_grads(r)[k], v, err_msg=k)
    if pipe:
        monkeypatch.setattr(tts, "VMEM_BUDGET", vmem)
    loss, grads = _single(tc, jp, inp, pipe)
    np.testing.assert_allclose(float(ranks[0]["loss"]), loss,
                               **(dict(rtol=2e-4, atol=2e-4) if pipe
                                  else dict(rtol=2e-6)))
    # bf16 leaves: each rank's cotangents rounded to bf16 before the sums
    # over `model`, so the bf16 band (2e-2 of each leaf's largest element)
    _assert_close(_grads(ranks[0]), grads, pipe or _bf16(tc))


def _bf16(tc):
    return tc.param_dtype == "bfloat16"


@pytest.mark.parametrize("name", list(LOSS))
def test_model_axis_loss_and_grads_match_jax(run, name, monkeypatch):
    _, info, out = run
    jc, tc, jp, inp, vmem = info[name]
    mesh = jmake_mesh(jc)
    toks = jnp.asarray(inp["tokens"])
    kw = {k: jnp.asarray(inp[k]) for k in ("mel", "speaker") if k in inp}
    if vmem is not None:
        monkeypatch.setattr(jts, "VMEM_BUDGET", _budget(jts, jc))
        fn = lambda p: jpp.loss_fn_pp(p, jc, mesh, toks, interpret=True,
                                      microbatch=jc.pipeline_microbatch,
                                      **kw)[0]
        p = jp
    else:
        p = jax.device_put(jp, jshd.param_shardings(jc, mesh))
        if jc.seq_parallel > 1:
            fn = lambda p: jseqpar.loss_fn_sp(p, jc, mesh, toks[:, :-1],
                                              toks[:, 1:], **kw)[0]
        else:
            fn = lambda p: jwn.loss_fn(p, jc, toks, **kw)[0]
    if _bf16(tc):
        # XLA's CPU compiler aborts on the bf16 all-reduce of a sharded
        # gradient (AllReducePromotion), so the reference runs unsharded
        p = jp
    jl, jg = jax.jit(jax.value_and_grad(fn))(p)
    r0 = out[name][0]
    loose = vmem is not None or _bf16(tc)     # the bf16 stack's bands
    np.testing.assert_allclose(float(r0["loss"]), float(jl),
                               **(dict(rtol=2e-4, atol=2e-4) if loose
                                  else dict(rtol=2e-6)))
    _assert_close(_grads(r0), flatten_tree(jax.tree.map(
        lambda g: np.asarray(g, np.float32), jg)), loose)


def _one_process_trainer(tc, jp):
    cfg = tc.replace(seq_parallel=1, data_parallel=1, model_parallel=1)
    ds = AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.1)
    tr = Trainer(cfg, ds, device="cpu",
                 params=params_from_numpy(jp, "cpu"))
    losses = []
    tr.run(STEPS, log_every=1, log_fn=lambda m: None,
           metrics_fn=lambda step, m: losses.append(m["loss"]))
    return tr, losses


@pytest.mark.parametrize("name", list(TRAIN))
def test_trainer_over_the_model_axis_matches_one_process(run, name,
                                                         monkeypatch):
    """Three steps on (1, 1, 2) against one process.  The pipeline: losses
    rtol 2e-4 and params within 2 * steps * lr, the median element within
    atol 1e-5 (Adam moves a weight by about lr whatever its gradient's
    size; tests/test_torch_dp_train.py); the Megatron scan (grad_accum 2,
    the clip on the whole model's norm): the reference trainer test's
    atol 1e-5 / rtol 1e-4 (tests/test_sharding.py:77-95)."""
    _, info, out = run
    jc, tc, jp, _, vmem = info[name]
    r0 = out[name][0]
    assert str(r0["route"]) == name[len("train_"):]
    if vmem is not None:
        monkeypatch.setattr(tts, "VMEM_BUDGET", vmem)
    tr, losses = _one_process_trainer(tc, jp)
    for k, v in tr.state.params.items():
        v = v.detach().numpy()
        if vmem is None:
            np.testing.assert_allclose(r0[f"param/{k}"], v, atol=1e-5,
                                       rtol=1e-4, err_msg=k)
            continue
        d = np.abs(r0[f"param/{k}"] - v)
        assert d.max() <= 2 * STEPS * LR, (k, d.max())
        assert np.median(d) <= 1e-5, (k, np.median(d))
    np.testing.assert_allclose(r0["losses"], losses,
                               rtol=2e-4 if vmem else 1e-5)


@pytest.mark.parametrize("name", list(TRAIN))
def test_model_checkpoint_resumes_exactly_and_decodes_in_one_process(
        run, name):
    """Each model rank holds its slice and the replicated leaves equal bit
    for bit after the steps; the whole params are the same on both ranks;
    the run resumed from the step-2 checkpoint repeats the uninterrupted
    one bit for bit; the checkpoint holds the whole model, which loads in
    one process and decodes there."""
    d, info, out = run
    _, tc, _, _, _ = info[name]
    r0, r1 = out[name]
    layout = "layer" if name == "train_pp" else "megatron"
    local = _grads(r0, "local/")
    replicated = [k for k in local if sharding.split_dim(k, layout) is None]
    assert {"embed_cur", "embed_prev", "head_w1"} <= set(replicated)
    for k in replicated:
        np.testing.assert_array_equal(local[k], r1[f"local/{k}"], err_msg=k)
    full = _grads(r0, "param/")
    for k, v in full.items():
        np.testing.assert_array_equal(r1[f"param/{k}"], v, err_msg=k)
        np.testing.assert_array_equal(r0[f"resumed/{k}"], v, err_msg=k)
        np.testing.assert_array_equal(r0[f"resumed_ema/{k}"], r0[f"ema/{k}"],
                                      err_msg=k)
    model = WaveNet.from_checkpoint(f"{d}/{name}_ckpt", step=STEPS,
                                    use_ema=False, device="cpu")
    for k, v in flatten_tree(model.params).items():
        np.testing.assert_array_equal(v.numpy(), full[k], err_msg=k)
    toks = model.generate(num_samples=16, batch=2, seed=1)
    want = generate_auto({k: torch.from_numpy(v) for k, v in full.items()},
                         tc, 16, batch=2, seeds=1, device="cpu")
    assert toks.shape == (2, 16) and torch.equal(toks, want)


def test_model_axis_refusals_stay():
    """The pipeline's stages own whole blocks; the Megatron split needs R
    and S divisible by the model axis."""
    _, tc = _cfgs(PIPE, num_blocks=3)
    with pytest.raises(ValueError, match="whole dilation blocks"):
        pipeline.stage_dilations(tc, 2)
    assert not pipeline.supported(tc, 64, 2)
    with pytest.raises(ValueError, match="num_blocks=3"):
        sharding.validate(tc, 2, "layer")
    assert pipeline.supported(tc.replace(num_blocks=4), 64, 2)
    for kw, msg in (({"residual_channels": 18}, "residual_channels=18"),
                    ({"skip_channels": 18}, "skip_channels=18")):
        _, tc = _cfgs(SCAN, **kw)
        with pytest.raises(ValueError, match=msg):
            sharding.validate(tc, 4, "megatron")
