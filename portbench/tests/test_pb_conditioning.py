"""The plain reference's conditioning against the port's float32 path on
the CPU, at the tiny preset's widths with a small mel front end (16 bins,
hop 32 = 4 x 8) and with 4 speakers: the logits, the loss and every
gradient (v_cond, the upsampler's taps and biases, g_embed, v_global among
them) to float32 rounding, the log-mel frames, the windows' draw, and
whole training steps."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import MEL
from portbench import corpus, harness, sizes, weights
from portbench.reference import data, model, train
from wavenet_tpu_torch.audio import mel as port_mel
from wavenet_tpu_torch.audio.dataset import AudioDataset, IteratorState
from wavenet_tpu_torch.config import MelConfig, full_vocoder, tiny
from wavenet_tpu_torch.models import wavenet as wn

MEL_CFG = MelConfig(**dict(MEL, upsample_factors=tuple(
    MEL["upsample_factors"])))
KINDS = {"mel": {"mel": MEL_CFG}, "speakers": {"global_classes": 4},
         "both": {"mel": MEL_CFG, "global_classes": 4}}


def _cfg(kind: str):
    return tiny().replace(compute_dtype="float32", train_window=512,
                          seed=11, **KINDS[kind])


def _sizes(cfg) -> sizes.Sizes:
    return sizes.Sizes.from_model(json.loads(cfg.to_json()))


def _inputs(z: sizes.Sizes, B: int, T: int, seed: int):
    """Tokens, log-mel-like frames covering T samples and speaker ids."""
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, z.Q, (B, T), generator=g)
    mel = (torch.randn(B, -(-T // z.hop), z.M, generator=g) * 2.0 - 3.0
           if z.M else None)
    spk = torch.randint(0, z.C, (B,), generator=g) if z.C else None
    return tokens, mel, spk


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_weights_have_the_ports_names_shapes_and_dtypes(kind):
    cfg = _cfg(kind).replace(param_dtype="bfloat16")
    z = _sizes(cfg)
    mine = weights.nested(weights.make(z, 3, "cpu", "bfloat16"))
    port = wn.init_params(cfg, torch.Generator().manual_seed(3), "cpu")

    def layout(tree):
        return {k: (layout(v) if isinstance(v, dict)
                    else (tuple(v.shape), v.dtype)) for k, v in tree.items()}
    assert layout(mine) == layout(port)
    if z.M:
        w0 = mine["upsampler"]["w0"].float()      # eye(M) / 9 + noise
        off = w0 - torch.eye(z.M) / 9
        assert float(off.abs().max()) < 0.01 and float(off.std()) > 1e-4


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_conditioned_logits_match_the_port(kind):
    cfg = _cfg(kind)
    z = _sizes(cfg)
    w = weights.make(z, 123, "cpu")
    tokens, mel, spk = _inputs(z, 2, 640, 0)
    port = wn.forward_logits(weights.nested(w), cfg, tokens, mel=mel,
                             speaker=spk)
    ref = model.logits(w, z.dilations, tokens, mel=mel, speaker=spk)
    assert torch.allclose(port, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_conditioned_loss_and_gradients_match_the_port(kind):
    cfg = _cfg(kind)
    z = _sizes(cfg)
    w = weights.make(z, 123, "cpu")
    window, mel, spk = _inputs(z, 3, 513, 1)
    if mel is not None:
        mel = mel[:, :512 // z.hop]
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss, _ = wn.loss_fn(weights.nested(p), cfg, window, mel=mel,
                         speaker=spk)
    gp = torch.autograd.grad(loss, list(p.values()))
    ref_loss, gr = model.loss_and_grads(w, z.dilations, window, rows=2,
                                        mel=mel, speaker=spk)
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-6)
    cond = {k for k in p if k.startswith("upsampler/")} | (
        {"v_cond", "g_embed", "v_global"} & set(p))
    assert len(cond) == {"mel": 5, "speakers": 2, "both": 7}[kind]
    for k, a in zip(p, gp):
        scale = float(gr[k].abs().max()) + 1e-12
        assert float((a - gr[k]).abs().max()) <= 1e-4 * scale, k
        if k in cond:
            assert float(gr[k].abs().max()) > 0, k


@pytest.mark.parametrize("mel_cfg, sr", [(MEL_CFG, 4000),
                                         (MelConfig(), 16000)])
def test_log_mel_matches_the_port(mel_cfg, sr):
    clip = corpus.clips(9, 1, 0.3, 0.3, sr, 0.02)[0]
    port = port_mel.log_mel(clip, sr, mel_cfg)
    ref = data.log_mel(clip, sr, mel_cfg.win_length, mel_cfg.hop_length,
                       mel_cfg.num_mels, mel_cfg.fmin, mel_cfg.fmax)
    assert ref.shape == port.shape == (
        port_mel.frames_for_samples(len(clip), mel_cfg.hop_length),
        mel_cfg.num_mels)
    assert float(np.abs(ref - port).max()) < 1e-4


@pytest.mark.parametrize("kind", ["mel", "speakers"])
def test_conditioned_draw_matches_the_port(kind):
    cfg = _cfg(kind)
    z = _sizes(cfg)
    clips = corpus.clips(4, 6, 0.02, 0.2, z.sample_rate, 0.02)
    ds = AudioDataset(clips, cfg, native=False)
    kept = data.kept_clips(clips, z.window)
    toks = [data.encode(c, z.Q) for c in kept]
    mels = data.clip_mels(kept, z) if z.M else None
    st = IteratorState(cfg.seed, 0)
    for k in range(3):
        batch, st = ds.sample_batch(st)
        win, ids, starts = data.draw(toks, cfg.seed, k, z.batch, z.window,
                                     z.hop)
        assert np.array_equal(batch["tokens"], win)
        if z.M:
            assert (starts % z.hop == 0).all()
            frames = data.window_frames(mels, ids, starts, z.window, z.hop)
            assert frames.shape == batch["mel"].shape
            assert float(np.abs(frames - batch["mel"]).max()) < 1e-4
        if z.C:
            assert np.array_equal(batch["speaker"], ids % z.C)


@pytest.mark.parametrize("kind", ["mel", "speakers"])
def test_conditioned_reference_steps_match_the_port_trainer(kind):
    """Three Trainer steps of the port at float32 against the reference's
    three steps on the windows, frames and ids it draws again: the gaps
    are rounding."""
    from wavenet_tpu_torch.training.trainer import Trainer
    cfg = _cfg(kind)
    z = _sizes(cfg)
    w = weights.make(z, 123, "cpu")
    clips = corpus.clips(4, 6, 0.05, 0.2, z.sample_rate, 0.02)
    tr = Trainer(cfg, AudioDataset(clips, cfg), device="cpu",
                 params=weights.nested(w))
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
    kept = data.kept_clips(clips, z.window)
    toks = [data.encode(c, z.Q) for c in kept]
    mels = data.clip_mels(kept, z) if z.M else None
    batches, frames, speakers = [], [], []
    for k in range(3):
        win, ids, starts = data.draw(toks, cfg.seed, k, z.batch, z.window,
                                     z.hop)
        batches.append(torch.from_numpy(win))
        if z.M:
            frames.append(torch.from_numpy(data.window_frames(
                mels, ids, starts, z.window, z.hop)))
        if z.C:
            speakers.append(torch.from_numpy(ids % z.C))
    ref = train.steps(w, z.dilations, batches, z.learning_rate, z.adam_b1,
                      z.adam_b2, rows=2, mels=frames if z.M else None,
                      speakers=speakers if z.C else None)
    assert set(prog["grad_norms"]) == set(ref["grad_norms"]) == set(w)
    gaps = train.gaps(prog, ref)
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-4
    assert gaps["grad_err"] < 1e-4


@pytest.mark.parametrize("cell, config", [
    ("full.serve", json.loads(full_vocoder().to_json())),
    ("full.train", {"global_classes": 8}),
])
def test_conditioned_configurations_load(cell, config):
    """The full_vocoder preset's JSON and full with speakers get through
    load_cell to their driver."""
    c = harness.load_cell(cell, overrides={"config": config})
    z = c.sizes
    if "mel" in config:
        assert (z.M, z.hop, z.upsample, z.n_fft, z.C) == (
            80, 256, (4, 8, 8), 1024, 0)
    else:
        assert (z.M, z.C, z.G) == (0, 8, 16)
    assert (z.L, z.R, z.S) == (40, 128, 256)
    assert callable(c.driver.run)
