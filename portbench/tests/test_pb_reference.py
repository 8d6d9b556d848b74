"""The plain reference against the port at the tiny preset on the CPU: the
port computing in float32 must agree with it to float32 rounding, piece by
piece and over whole training steps."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import corpus, sizes, weights
from portbench.reference import data, model, serve, train
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.audio.dataset import AudioDataset, IteratorState
from wavenet_tpu_torch.config import tiny
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops import rng

CFG = tiny().replace(compute_dtype="float32", train_window=512, seed=11)
Z = sizes.Sizes.from_model(json.loads(CFG.to_json()))


@pytest.fixture(scope="module")
def w():
    return weights.make(Z, 123, "cpu")


def test_logits_match_the_port(w):
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 256, (2, 700), generator=g)
    port = wn.forward_logits(w, CFG, tokens)
    ref = model.logits(w, Z.dilations, tokens)
    assert torch.allclose(port, ref, rtol=1e-4, atol=1e-5)


def test_loss_and_gradients_match_the_port(w):
    g = torch.Generator().manual_seed(1)
    window = torch.randint(0, 256, (3, 513), generator=g)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss, _ = wn.loss_fn(p, CFG, window)
    gp = torch.autograd.grad(loss, list(p.values()))
    ref_loss, gr = model.loss_and_grads(w, Z.dilations, window, rows=2)
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-6)
    for k, a in zip(p, gp):
        scale = float(gr[k].abs().max()) + 1e-12
        assert float((a - gr[k]).abs().max()) <= 1e-4 * scale, k


def test_mulaw_windows_and_noise_match_the_port():
    clips = corpus.clips(4, 6, 0.05, 0.2, Z.sample_rate, 0.02)
    ds = AudioDataset(clips, CFG, native=False)
    toks = [data.encode(c, Z.Q) for c in data.kept_clips(clips, Z.window)]
    for a, b in zip(ds.tokens, toks):
        assert np.array_equal(a, b)
    st = IteratorState(CFG.seed, 0)
    for k in range(3):
        batch, st = ds.sample_batch(st)
        assert np.array_equal(batch["tokens"],
                              data.draw(toks, CFG.seed, k, Z.batch,
                                        Z.window)[0])
    q = torch.arange(256)
    assert np.array_equal(serve.tokens_of(mulaw.decode(q).numpy(), 256),
                          q.numpy())
    seeds = torch.tensor([7, 2 ** 31 - 5], dtype=torch.int32)
    for i, s in enumerate(seeds.tolist()):
        ref = serve.noise(s, 40, 256, "cpu")
        for t in (0, 17, 39):
            port = rng.counter_gumbel(seeds, t, 256)[i].double()
            assert torch.allclose(port, ref[t], rtol=1e-5, atol=1e-5)


def test_reference_steps_match_the_port_trainer(w):
    """Three Trainer steps of the port at float32 against the reference's
    three steps on the windows it draws again: the gaps are rounding."""
    from wavenet_tpu_torch.training.trainer import Trainer
    clips = corpus.clips(4, 6, 0.05, 0.2, Z.sample_rate, 0.02)
    tr = Trainer(CFG, AudioDataset(clips, CFG), device="cpu", params=w)
    p0 = {k: v.detach().clone() for k, v in tr.state.params.items()}
    losses, first = [], None
    for _ in range(3):
        losses.append(float(tr.run(1, log_every=0)["loss"]))
        if first is None:
            first = {k: v / float(np.float32(0.1))
                     for k, v in tr.state.opt_state["mu"].items()}
    prog = train.Readings(
        losses=losses, first_grads=first,
        grad_norms={k: train.leaf_norm(v) for k, v in first.items()},
        change_norms={k: train.leaf_norm(tr.state.params[k] - p0[k])
                      for k in p0})
    toks = [data.encode(c, Z.Q) for c in data.kept_clips(clips, Z.window)]
    batches = [torch.from_numpy(data.draw(toks, CFG.seed, k, Z.batch,
                                          Z.window)[0]) for k in range(3)]
    ref = train.steps(w, Z.dilations, batches, Z.learning_rate, Z.adam_b1,
                      Z.adam_b2, rows=2)
    gaps = train.gaps(prog, ref)
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-4
    assert gaps["grad_err"] < 1e-4


def test_reference_refuses_what_it_does_not_train():
    m = json.loads(CFG.replace(grad_clip_norm=1.0).to_json())
    with pytest.raises(NotImplementedError):
        train.check_config(m)
    with pytest.raises(NotImplementedError):
        sizes.Sizes.from_model(json.loads(
            CFG.replace(causal_channels=16).to_json()))
