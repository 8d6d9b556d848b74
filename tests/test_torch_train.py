"""The port's training path against the JAX package on the CPU: data,
optimizer, trainer (scan and fused), checkpoints, the train CLI, and the
default device of every entry point.

Inputs come from numpy seeds; JAX's initial params carry over with
params_from_numpy.  Tolerances: batches and resumed runs are compared bit
for bit; the optimizer at rtol 1e-5 / atol 1e-8 (the same f32 formulas,
other libraries' pow/sqrt); training losses at rtol 1e-3 on the scan path
and 2e-3 on the fused path (the reference suite's loss band).
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.audio import dataset as jds
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.training import trainer as jtrainer
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import dataset as tds
from wavenet_tpu_torch.training import trainer as ttrainer
from wavenet_tpu_torch.utils.pytree_io import params_from_numpy

torch.set_num_threads(1)

MICRO = dict(num_blocks=2, max_dilation=8, residual_channels=16,
             skip_channels=16, batch_size=2, train_window=64,
             learning_rate=3e-3)


def _cfgs(**kw):
    kw = dict(MICRO, **kw)
    return jconfig.WaveNetConfig(**kw), tconfig.WaveNetConfig(**kw)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (5, 123)])
def test_dataset_batches_bit_identical(seed, step):
    jc, tc = _cfgs(seed=seed)
    jd = jds.AudioDataset.synthetic(jc, num_clips=3, clip_seconds=0.05)
    td = tds.AudioDataset.synthetic(tc, num_clips=3, clip_seconds=0.05)
    jb, js = jd.sample_batch(jds.IteratorState(seed=seed, step=step))
    tb, ts = td.sample_batch(tds.IteratorState(seed=seed, step=step))
    assert tb["tokens"].dtype == jb["tokens"].dtype
    np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    assert (ts.seed, ts.step) == (js.seed, js.step)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "exponential"])
def test_optimizer_matches_optax(schedule):
    """Adam + schedule with warmup + global-norm clip + MultiSteps(2) + EMA
    on one gradient sequence, step by step."""
    kw = dict(lr_schedule=schedule, lr_decay_steps=6, lr_min_ratio=0.2,
              warmup_steps=2, grad_clip_norm=3.0, grad_accum=2,
              ema_decay=0.9, learning_rate=0.05)
    jc, tc = _cfgs(**kw)
    rs = np.random.RandomState(0)
    p0 = {"a": rs.randn(3, 4).astype(np.float32),
          "b": rs.randn(5).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * (0.5 + 1.5 * (i % 3))).astype(
        np.float32) for k, v in p0.items()} for i in range(12)]

    tx = jtrainer.make_optimizer(jc)
    jp = jax.tree.map(jnp.asarray, p0)
    jst, jema = tx.init(jp), jp
    opt = ttrainer.make_optimizer(tc)
    tp = params_from_numpy(p0, "cpu")
    tst, tema = opt.init(tp), dict(tp)
    for g in grads:
        updates, jst = tx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, updates)
        d = jnp.where(jst.mini_step == 0, 0.9, 1.0)
        jema = jax.tree.map(lambda e, p: d * e + (1.0 - d) * p, jema, jp)
        tp, tst, applied, norms = opt.update(params_from_numpy(g, "cpu"),
                                             tst, tp)
        if applied:
            tema = ttrainer.ema_update(tema, tp, 0.9)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-8, err_msg=k)
            np.testing.assert_allclose(tema[k].numpy(), np.asarray(jema[k]),
                                       rtol=1e-5, atol=1e-8, err_msg=k)
    assert tst["count"] == int(jst.inner_opt_state[1][0].count) == 6


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


def test_trainer_scan_matches_jax_trainer():
    """fused_stack=False: both trainers take the scan path on the CPU."""
    jc, tc = _cfgs(fused_stack=False, grad_clip_norm=1.0)
    jd = jds.AudioDataset.synthetic(jc, num_clips=2, clip_seconds=0.05)
    td = tds.AudioDataset.synthetic(tc, num_clips=2, clip_seconds=0.05)
    jtr = jtrainer.Trainer(jc, jd)
    p0 = params_from_numpy(jax.tree.map(np.asarray, jtr.state.params), "cpu")
    ttr = ttrainer.Trainer(tc, td, device="cpu", params=p0)
    assert not ttr.use_fused
    np.testing.assert_allclose(_port_losses(ttr, 5), _jax_losses(jtr, 5),
                               rtol=1e-3)


def test_trainer_fused_matches_jax_fused_loop():
    """The port's trainer on the fused path (plain versions on the CPU)
    against a JAX loop of loss_fn(use_fused=True, interpret=True) and the
    reference's optimizer."""
    jc, tc = _cfgs(warmup_steps=1)
    td = tds.AudioDataset.synthetic(tc, num_clips=2, clip_seconds=0.05)
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    ttr = ttrainer.Trainer(
        tc, td, device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    assert ttr.use_fused
    tx = jtrainer.make_optimizer(jc)
    st = tx.init(jp)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, t: jwn.loss_fn(p, jc, t, use_fused=True, interpret=True)[0]))
    it, want = tds.IteratorState(jc.seed, 0), []
    for _ in range(3):
        batch, it = td.sample_batch(it)
        loss, g = grad_fn(jp, jnp.asarray(batch["tokens"]))
        updates, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, updates)
        want.append(float(loss))
    np.testing.assert_allclose(_port_losses(ttr, 3), want, rtol=2e-3)


def _micro_trainer(ckpt, **kw):
    _, tc = _cfgs(**kw)
    ds = tds.AudioDataset.synthetic(tc, num_clips=2, clip_seconds=0.05)
    return ttrainer.Trainer(tc, ds, checkpoint_dir=ckpt, device="cpu")


def test_checkpoint_resume_is_exact(tmp_path):
    d = str(tmp_path / "ckpt")
    a = _micro_trainer(d, ema_decay=0.5, grad_accum=2)
    a.run(4, log_every=0, checkpoint_every=2)
    assert a.ckpt.all_steps() == [2, 4]
    b = _micro_trainer(d, ema_decay=0.5, grad_accum=2)
    b.restore(step=2)
    assert b.state.step == 2 and b.iter_state.step == 2
    b.run(2, log_every=0)
    for k in a.state.params:
        assert torch.equal(a.state.params[k], b.state.params[k]), k
        assert torch.equal(a.state.ema[k], b.state.ema[k]), k
    # max_to_keep = 3
    a.run(6, log_every=0, checkpoint_every=2)
    assert a.ckpt.all_steps() == [6, 8, 10]


def test_checkpoint_architecture_guard(tmp_path):
    d = str(tmp_path / "ckpt")
    _micro_trainer(d)
    _micro_trainer(d, learning_rate=1e-4)      # schedule fields may differ
    with pytest.raises(ValueError, match="architecture"):
        _micro_trainer(d, residual_channels=32)


def test_from_checkpoint_uses_ema_by_default(tmp_path):
    from wavenet_tpu_torch.models.api import WaveNet
    d = str(tmp_path / "ckpt")
    tr = _micro_trainer(d, ema_decay=0.5)
    tr.run(2, log_every=0)
    tr.save()
    m = WaveNet.from_checkpoint(d, device="cpu")
    raw = WaveNet.from_checkpoint(d, use_ema=False, device="cpu")
    for k in tr.state.params:
        assert torch.equal(m.params[k], tr.state.ema[k])
        assert torch.equal(raw.params[k], tr.state.params[k].detach())
    assert not torch.equal(m.params["w_cur"], raw.params["w_cur"])
    # the facade's own save round-trips through from_checkpoint
    m.save(str(tmp_path / "saved"), step=3)
    again = WaveNet.from_checkpoint(str(tmp_path / "saved"), device="cpu")
    assert torch.equal(again.params["w_res"], m.params["w_res"])
    assert again.score(tokens=np.zeros((1, 17), np.int32)).shape == (1,)


def test_orbax_directory_is_refused(tmp_path):
    from wavenet_tpu_torch import serve
    _, tc = _cfgs()
    os.makedirs(tmp_path / "10" / "state")
    (tmp_path / "params.json").write_text(tc.to_json())
    with pytest.raises(ValueError, match="export_npz"):
        serve.main(["--ckpt", str(tmp_path), "--device", "cpu"])


def test_train_cli_runs_tiny(tmp_path, capsys):
    from wavenet_tpu_torch import train
    ckpt, mfile = str(tmp_path / "ckpt"), str(tmp_path / "m.jsonl")
    m = train.main(["--preset", "tiny", "--synthetic", "--steps", "3",
                    "--device", "cpu", "--override", "train_window=128",
                    "--batch-size", "2", "--log-every", "1",
                    "--ckpt", ckpt, "--ckpt-every", "2",
                    "--metrics-file", mfile])
    assert np.isfinite(m["loss"]) and m["steps_per_sec"] > 0
    recs = [json.loads(line) for line in open(mfile)]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == m
    # resume continues from the last checkpoint
    m2 = train.main(["--config", os.path.join(ckpt, "params.json"),
                     "--synthetic", "--steps", "1", "--device", "cpu",
                     "--ckpt", ckpt, "--resume", "--log-every", "0"])
    assert np.isfinite(m2["loss"])
    assert sorted(os.listdir(ckpt))[-1] == "params.json"
    assert "ckpt_00000004.pt" in os.listdir(ckpt)


def test_entry_points_default_to_cuda():
    from wavenet_tpu_torch import serve, train
    from wavenet_tpu_torch.generate import sampler
    from wavenet_tpu_torch.models import api
    from wavenet_tpu_torch.models import wavenet as twn
    from wavenet_tpu_torch.ops.cuda import decode_wide
    from wavenet_tpu_torch.training import checkpoint
    from wavenet_tpu_torch.utils import pytree_io
    fns = [api.WaveNet.init, api.WaveNet.from_npz, api.WaveNet.from_checkpoint,
           sampler.generate_auto, sampler.generate_stream,
           decode_wide.setup_decode, decode_wide.generate_wide,
           twn.init_params, twn.generate, pytree_io.params_from_numpy,
           ttrainer.Trainer.__init__, checkpoint.CheckpointManager.restore]
    for fn in fns:
        dflt = inspect.signature(fn).parameters["device"].default
        assert dflt == "cuda", fn.__qualname__
    assert train.parse_args([]).device == "cuda"
    assert serve.parse_args(["--npz", "x.npz"]).device == "cuda"


def test_trainer_route_follows_the_reference():
    """fused_stack and supported(cfg, T) alone pick the fused stack, the
    same on either device: on the card the stack kernels take every width
    supported() takes (R = 18 runs padded to 20), so a width not a
    multiple of 4 trains fused too, as in the reference."""
    from wavenet_tpu_torch.ops.cuda import train_stack as tts
    tiny = tconfig.tiny()
    assert ttrainer.use_fused_stack(tiny, tiny.train_window)
    assert not ttrainer.use_fused_stack(
        tiny.replace(fused_stack=False), tiny.train_window)
    assert not ttrainer.use_fused_stack(tiny, 100)  # untileable
    _, tc = _cfgs(residual_channels=18)
    assert ttrainer.use_fused_stack(tc, tc.train_window)
    assert tts.kernel_supported(tc)
    ds = tds.AudioDataset.synthetic(tc, num_clips=1, clip_seconds=0.05)
    tr = ttrainer.Trainer(tc, ds, device="cpu")
    assert tr.route == "dp" and tr.use_fused


@pytest.mark.parametrize("case", ["data_parallel", "model_parallel",
                                  "seq_parallel", "valid_mask", "halo",
                                  "kernel_size"])
def test_features_left_out_raise(case):
    """What the port leaves out raises.  A kernel_size > 2 model trains on
    the scan, but the fused stack leaves it out.  Every mesh axis is
    ported: a data, seq or model axis that the process group cannot hold
    (here one process, no group) is refused with how to launch the ranks.
    The halo input is taken, beside a valid_mask too: a zero halo is the
    sequence start, so both give the plain forward's logits."""
    from wavenet_tpu_torch.models import wavenet as twn
    if case.endswith("parallel"):
        _, tc = _cfgs(**{case: 2})
        ds = tds.AudioDataset.synthetic(_cfgs()[1], num_clips=1,
                                        clip_seconds=0.05)
        with pytest.raises(ValueError, match="process group has 1.*torchrun"):
            ttrainer.Trainer(tc, ds, device="cpu")
    elif case == "kernel_size":
        _, tc = _cfgs(kernel_size=3)
        p = twn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="trains on the scan"):
            twn.loss_fn(p, tc, torch.zeros(1, 65, dtype=torch.int32),
                        use_fused=True)
    else:
        _, tc = _cfgs()
        p = twn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, 256, (1, 8), generator=torch.Generator(
            ).manual_seed(1), dtype=torch.int32)
        kw = {"halo_fn": lambda x: x.new_zeros(x.shape[0], tc.max_dilation,
                                               x.shape[2])}
        if case == "valid_mask":
            kw["valid_mask"] = torch.ones(1, 8)
        assert torch.equal(twn.forward_logits(p, tc, toks, **kw),
                           twn.forward_logits(p, tc, toks))


def test_step_profile_on_the_cpu():
    """The step profiler runs the trainer under torch.profiler; on the CPU
    there are no device events, so the device numbers are null, and the
    kernel families are told apart by name."""
    from wavenet_tpu_torch.utils import profiling
    tc = tconfig.tiny().replace(batch_size=1, train_window=128)
    ds = tds.AudioDataset.synthetic(tc, num_clips=2, clip_seconds=0.05)
    tr = ttrainer.Trainer(tc, ds, device="cpu")
    assert tr.use_fused
    out = profiling.step_breakdown(tr, steps=1)
    assert out["wall_ms_per_step"] > 0
    assert out["device_busy_ms_per_step"] is None
    assert out["device_idle_share"] is None
    assert out["device_ms_per_step_by_family"] is None
    assert [profiling.family(n) for n in (
        "void (anonymous namespace)::wgrad_kernel<2>(...)",
        "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n", "volta_dgemm_64x64_nn",
        "Memcpy HtoD (Pageable -> Device)", "void at::native::reduce")] == [
        "train_stack", "gemm_f32", "gemm_f64", "copies", "other"]
    assert profiling._busy_ms([(0, 10), (5, 20), (30, 40)]) == 0.03
