"""The port's data parallelism (parallel/distributed.py, mesh.py,
dataparallel.py) on the CPU: the units, then one two-process gloo run.

In the run (tests/_torch_dp_worker.loss_ranks, two spawned ranks, B = 4
global, 2 rows a rank) each rank computes loss_fn_dp on its rows and the
gradients are summed across ranks.  The result must equal
  * the port's single-process loss_fn on the whole batch: loss rtol 2e-5
    (the reference's band, tests/test_dataparallel.py:30,42); the f32
    scan's gradients atol 5e-5 / rtol 1e-4 (:48), the bf16 fused cases'
    atol 5e-4 / rtol 5e-3 (the reference's fused data-parallel band,
    :84-86).  Each row's forward is the same arithmetic; the sums over rows
    differ in order, and a bf16 model rounds some weight cotangents (the
    head's, v_global's: the recipe's bf16 operands, as JAX's transposes
    round them) to bf16 after the sum over rows, so two ranks' rounded
    half-sums differ from one rounded sum by up to about a bf16 ulp (2^-8)
    of the leaf's largest element (0.0034-0.0044 measured at these sizes);
  * JAX's parallel.dataparallel.loss_fn_dp on a 2-device data mesh (the
    conftest's virtual CPU devices), with the fused stack in Pallas
    interpret mode: the f32 scan to rtol 2e-5 (loss) and within 1e-4 of
    each gradient's largest element; the bf16 fused cases to the
    reference suite's bands (loss rtol 2e-3, each gradient within 2e-2 of
    its largest element; tests/test_pallas_train.py:96-103), since the
    port sums bf16 products exactly and JAX in f32; the case with bf16
    leaves (param_dtype bfloat16) to the same bands, its gradients bf16
    on each rank before the sum over ranks, as the reference's are;
  * on every rank the same bits;
and grad_accum = 2 over the two ranks (a reduce on each microstep) must
equal one step of a single-process trainer on the 8 rows (atol 2e-6 /
rtol 2e-4, the reference's band, tests/test_dataparallel.py:110-111).
A data-parallel trainer fed by a StreamingAudioDataset (each rank
assembling only its rows) must equal one fed by the in-memory dataset bit
for bit, and each rank must have decoded only the clips its rows touch.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.parallel import dataparallel as jdp
from wavenet_tpu.parallel.mesh import make_mesh as jmake_mesh
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio.dataset import AudioDataset
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.parallel import distributed, mesh
from wavenet_tpu_torch.training.trainer import Trainer, choose_route
from wavenet_tpu_torch.utils.pytree_io import (flatten_tree,
                                               params_from_numpy,
                                               unflatten_tree)

import _torch_dp_worker as worker

torch.set_num_threads(1)

BASE = dict(num_blocks=2, max_dilation=8, residual_channels=16,
            skip_channels=16, batch_size=4, train_window=64,
            data_parallel=2)
MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=[4, 4])
CASES = {
    "scan_f32": dict(cfg=dict(BASE, compute_dtype="float32",
                              fused_stack=False), use_fused=False),
    "fused": dict(cfg=dict(BASE), use_fused=True),
    "mel": dict(cfg=dict(BASE, mel=MEL), use_fused=True),
    "speaker": dict(cfg=dict(BASE, global_classes=5, global_channels=8),
                    use_fused=True),
    "fused_bf16_leaves": dict(cfg=dict(BASE, param_dtype="bfloat16"),
                              use_fused=True),
}
ACCUM = dict(BASE, compute_dtype="float32", fused_stack=False, grad_accum=2)
STREAM = dict(BASE, compute_dtype="float32", fused_stack=False,
              sample_rate=8000, num_blocks=1)
STREAM_STEPS, STREAM_CLIPS = 2, 6


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def test_local_batch_slice_unit(monkeypatch):
    monkeypatch.setattr(distributed, "world_size", lambda: 4)
    monkeypatch.setattr(distributed, "rank", lambda: 2)
    assert distributed.local_batch_slice(8) == slice(4, 6)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_batch_slice(6)


def test_local_batch_slices_partition(monkeypatch):
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    rows = []
    for i in range(2):
        monkeypatch.setattr(distributed, "rank", lambda i=i: i)
        rows.extend(range(*distributed.local_batch_slice(4).indices(4)))
    assert rows == [0, 1, 2, 3]


def test_mesh_shape_validation():
    cfg = tconfig.tiny()
    assert mesh.AXES == ("data", "seq", "model")
    assert mesh.mesh_shape(cfg, 1) == (1, 1, 1)
    assert mesh.mesh_shape(cfg.replace(data_parallel=4), 4) == (4, 1, 1)
    assert mesh.mesh_shape(cfg.replace(data_parallel=0), 3) == (3, 1, 1)
    with pytest.raises(ValueError, match="process group has 2"):
        mesh.mesh_shape(cfg.replace(data_parallel=4), 2)
    with pytest.raises(ValueError, match="process group has 2"):
        mesh.mesh_shape(cfg, 2)


@pytest.mark.parametrize("axis", ["seq_parallel", "model_parallel"])
def test_seq_and_model_axes_still_raise(axis):
    """The seq and model axes are mesh shapes and the trainer takes both
    (routes chosen as the reference chooses them); what still raises is a
    mesh larger than the process group: in one process the trainer asks
    for the launcher."""
    cfg = tconfig.tiny().replace(**{axis: 2, "data_parallel": 1})
    if axis == "seq_parallel":
        assert mesh.mesh_shape(cfg, 2) == (1, 2, 1)
        assert mesh.mesh_shape(cfg.replace(data_parallel=0), 4) == (2, 2, 1)
        assert choose_route(cfg) == "sp_fused"
        assert choose_route(cfg.replace(fused_stack=False)) == "sp"
    else:
        assert mesh.mesh_shape(cfg, 2) == (1, 1, 2)
        assert choose_route(cfg) == "tp"      # 1 block: no stages
        assert choose_route(cfg.replace(num_blocks=2)) == "pp"
    ds = AudioDataset.synthetic(tconfig.tiny().replace(train_window=128),
                                num_clips=1, clip_seconds=0.05)
    with pytest.raises(ValueError, match="process group has 1.*torchrun"):
        Trainer(cfg.replace(train_window=128), ds, device="cpu")


def test_initialize_and_backend(monkeypatch):
    """No launcher and no world size: a no-op.  The backend follows the
    device unless named, and an unknown one, or nccl for the CPU, is
    refused before any process group starts."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.default_backend("cuda:1") == "nccl"
    assert distributed.default_backend("cpu") == "gloo"
    with pytest.raises(ValueError, match="not one of"):
        distributed.initialize("mpi", world_size=1)
    with pytest.raises(ValueError, match="nccl serves CUDA"):
        distributed.initialize("nccl", device="cpu", world_size=1)
    assert distributed.world_size() == 1 and distributed.is_primary()


def test_single_device_mesh():
    """A one-process mesh stands on a one-rank gloo group; a trainer in
    that group equals one without a group bit for bit (its reductions sum
    one rank)."""
    cfg = tconfig.tiny().replace(train_window=128, batch_size=2)
    ds = AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.05)
    plain = Trainer(cfg, ds, device="cpu")
    plain.run(2, log_every=0)
    try:
        m = mesh.single_device_mesh()
        assert m.mesh_dim_names == mesh.AXES and m.size() == 1
        grouped = Trainer(cfg, ds, device="cpu")
        assert grouped.group is not None and grouped.rows is None
        grouped.run(2, log_every=0)
    finally:
        torch.distributed.destroy_process_group()
    for k, v in plain.state.params.items():
        assert torch.equal(v, grouped.state.params[k]), k


# ---------------------------------------------------------------------------
# the two-process run
# ---------------------------------------------------------------------------

def _configs(kw):
    kw = dict(kw)
    mel = kw.pop("mel", None)
    jm = None if mel is None else jconfig.MelConfig(
        **dict(mel, upsample_factors=tuple(mel["upsample_factors"])))
    tm = None if mel is None else tconfig.MelConfig(
        **dict(mel, upsample_factors=tuple(mel["upsample_factors"])))
    return (jconfig.WaveNetConfig(mel=jm, **kw),
            tconfig.WaveNetConfig(mel=tm, **kw))


def _inputs(name, cfg, batch):
    rs = np.random.RandomState(sum(map(ord, name)))
    toks = rs.randint(0, 256, (batch, cfg.train_window + 1)).astype(np.int32)
    mel = spk = None
    if cfg.mel is not None:
        frames = cfg.train_window // cfg.mel.hop_length
        mel = rs.randn(batch, frames, cfg.mel.num_mels).astype(np.float32)
    if cfg.global_classes is not None:
        spk = np.array([3, 1, 3, 0], np.int32)[:batch]
    return toks, mel, spk


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Write the cases, run the two ranks once, read back their results."""
    d = str(tmp_path_factory.mktemp("dp"))
    cases, inputs = {}, {}
    from wavenet_tpu_torch.audio.io import write_wav
    rs = np.random.RandomState(3)
    for i in range(STREAM_CLIPS):
        write_wav(os.path.join(d, "corpus", f"c{i}.wav"),
                  rs.uniform(-0.5, 0.5, 300 + 40 * i).astype(np.float32),
                  8000)
    for name, case in [*CASES.items(), ("accum", dict(cfg=ACCUM)),
                       ("stream", dict(cfg=STREAM))]:
        jc, tc = _configs(case["cfg"])
        batch = tc.batch_size * tc.grad_accum
        jp = jax.tree.map(np.asarray, jwn.init_params(jc,
                                                      jax.random.PRNGKey(0)))
        np.savez(os.path.join(d, f"{name}.npz"), **flatten_tree(jp))
        toks, mel, spk = _inputs(name, tc, batch)
        inputs[name] = (jc, tc, jp, toks, mel, spk)
        cases[name] = dict(
            kind=name if name in ("accum", "stream") else "loss",
            steps=STREAM_STEPS,
            cfg=case["cfg"], use_fused=case.get("use_fused", False),
            tokens=toks.tolist(),
            mel=None if mel is None else mel.tolist(),
            speaker=None if spk is None else spk.tolist())
    with open(os.path.join(d, "cases.json"), "w") as f:
        json.dump(cases, f)
    worker.run_ranks(worker.loss_ranks, d, store_dir=d)
    inputs["corpus"] = os.path.join(d, "corpus")
    out = {name: [dict(np.load(os.path.join(d, f"{name}.rank{r}.npz")))
                  for r in range(2)] for name in cases}
    return inputs, out


def _single(tc, jp, toks, mel, spk, use_fused):
    """The port's one-process loss and gradients on the whole batch."""
    flat = {k: v.requires_grad_(True) for k, v in
            flatten_tree(params_from_numpy(jp, "cpu")).items()}
    loss, _ = twn.loss_fn(
        unflatten_tree(flat), tc.replace(data_parallel=1),
        torch.from_numpy(toks), use_fused=use_fused,
        mel=None if mel is None else torch.from_numpy(mel),
        speaker=None if spk is None else torch.from_numpy(spk))
    keys = sorted(flat)
    grads = torch.autograd.grad(loss, [flat[k] for k in keys])
    return float(loss.detach()), {k: g.float().numpy()
                                  for k, g in zip(keys, grads)}


def _grads(res):
    return {k[len("grad/"):]: v for k, v in res.items()
            if k.startswith("grad/")}


@pytest.mark.parametrize("name", list(CASES))
def test_dp_loss_and_grads_match_single_process(dp_run, name):
    inputs, out = dp_run
    jc, tc, jp, toks, mel, spk = inputs[name]
    r0, r1 = out[name]
    for k in r0:                                 # every rank: the same bits
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    loss, grads = _single(tc, jp, toks, mel, spk, CASES[name]["use_fused"])

    np.testing.assert_allclose(float(r0["loss"]), loss, rtol=2e-5)
    np.testing.assert_allclose(float(r0["bits_per_sample"]),
                               loss / np.log(2.0), rtol=2e-5)
    got = _grads(r0)
    assert sorted(got) == sorted(grads)
    if name == "mel":
        assert "upsampler/w0" in got
    if name == "speaker":
        assert {"g_embed", "v_global"} <= set(got)
    atol, rtol = (5e-4, 5e-3) if CASES[name]["use_fused"] else (5e-5, 1e-4)
    for k, g in grads.items():
        np.testing.assert_allclose(got[k], g, atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_loss_and_grads_match_jax(dp_run, name):
    inputs, out = dp_run
    jc, tc, jp, toks, mel, spk = inputs[name]
    use_fused = CASES[name]["use_fused"]
    jmesh = jmake_mesh(jc)
    kw = dict(use_fused=use_fused, interpret=use_fused,
              mel=None if mel is None else jax.numpy.asarray(mel),
              speaker=None if spk is None else jax.numpy.asarray(spk))
    loss = lambda p: jdp.loss_fn_dp(p, jc, jmesh, jax.numpy.asarray(toks),
                                    **kw)
    if jc.param_dtype == "bfloat16":
        # XLA's CPU compiler aborts on the bf16 all-reduce of the mesh's
        # gradients (AllReducePromotion: "Invalid binary instruction opcode
        # copy"), so the reference is its one-device loss on the batch
        loss = lambda p: jwn.loss_fn(p, jc, jax.numpy.asarray(toks), **kw)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    r0 = out[name][0]
    rtol, band = (2e-5, 1e-4) if not use_fused else (2e-3, 2e-2)
    np.testing.assert_allclose(float(r0["loss"]), float(jl), rtol=rtol)
    np.testing.assert_allclose(float(r0["accuracy"]),
                               float(jaux["accuracy"]), atol=1 / 256)
    got = _grads(r0)
    jflat = flatten_tree(jax.tree.map(lambda g: np.asarray(g, np.float32),
                                      jg))
    assert sorted(got) == sorted(jflat)
    for k, g in jflat.items():
        scale = max(float(np.abs(g).max()), 1e-12)
        err = float(np.abs(got[k] - g).max())
        assert err <= band * scale, (k, err, scale)


def test_dp_grad_accum_composes(dp_run):
    """Two accumulation microsteps over two ranks (the gradients summed
    across ranks on each) == one step of one process on the 8 rows."""
    inputs, out = dp_run
    _, tc, jp, toks, _, _ = inputs["accum"]
    r0, r1 = out["accum"]
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    single = tc.replace(data_parallel=1, grad_accum=1, batch_size=8)
    ds = AudioDataset.synthetic(single, num_clips=1, clip_seconds=0.05)
    tr = Trainer(single, ds, device="cpu",
                 params=params_from_numpy(jp, "cpu"))
    tr.step(torch.from_numpy(toks))
    start = flatten_tree(jp)
    for k, v in tr.state.params.items():
        np.testing.assert_allclose(r0[f"param/{k}"], v.detach().numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=k)
        assert not np.array_equal(r0[f"param/{k}"], start[k]), k


def test_dp_trainer_on_streaming_data(dp_run):
    """Two ranks' trainers on a StreamingAudioDataset equal those on the
    in-memory dataset bit for bit, on both ranks; each rank decoded just
    the clips its rows of the batches touched."""
    from wavenet_tpu_torch.audio.dataset import IteratorState
    from wavenet_tpu_torch.audio.streaming import StreamingAudioDataset
    inputs, out = dp_run
    tc = inputs["stream"][1]
    r0, r1 = out["stream"]
    keys = [k for k in r0 if k.startswith("mem/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(r0[k], r0["stream/" + k[4:]], err_msg=k)
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    ds = StreamingAudioDataset.from_dir(inputs["corpus"], tc)
    per = tc.batch_size // 2
    for r, res in enumerate((r0, r1)):
        touched = set()
        for step in range(STREAM_STEPS):
            clips, _ = ds._draws(IteratorState(tc.seed, step), tc.batch_size)
            touched |= set(clips[r * per:(r + 1) * per].tolist())
        assert sorted(touched) == res["cached_clips"].tolist(), r
