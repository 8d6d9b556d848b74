"""Training traffic: the port's Trainer on batches that its AudioDataset
draws from a synthetic corpus.

Set-up builds one Trainer on weights made from the seed and drives it
through its first `checked_steps` steps by Trainer.run, the window's own
call on the dataset's own feed; the program's readings of those steps (the
losses, the first gradient from Adam's first moment, the change of the
parameters) are taken then.  The window calls Trainer.run(steps_per_call)
until `seconds` have passed; the clock stops after run() returns, which
synchronises the device.  After the window the Trainer is freed and the
reference trains the same steps from the same weights on the windows it
draws again from the same corpus: a mel model's with the frames of its
own log-mel of each clip, a speaker model's with each row's clip index
modulo the classes, as the port's dataset assigns speakers to clips.

Mix parameters: clips, clip_min_s, clip_max_s, noise.  Workload
parameters: steps_per_call, checked_steps, ref_rows, limits.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _norms(tensors) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def program_readings(run, checked_steps: int):
    """Build the Trainer of the run and read its first steps.  Returns
    (trainer, dataset, readings)."""
    from portbench import corpus
    from portbench.reference import train as ref_train
    from wavenet_tpu_torch.audio.dataset import AudioDataset
    from wavenet_tpu_torch.training.trainer import Trainer
    cfg = run.program_config()
    mix, z = run.cell.mix, run.sizes
    clips = corpus.clips(run.seed, mix["clips"], mix["clip_min_s"],
                         mix["clip_max_s"], z.sample_rate, mix["noise"])
    ds = AudioDataset(clips, cfg)
    del clips
    tr = Trainer(cfg, ds, device=run.device, params=run.program_weights())
    p0 = {k: v.detach().clone() for k, v in tr.state.params.items()}
    losses, first = [], None
    b1 = float(np.float32(1.0 - z.adam_b1))  # Adam's (1 - b1), f32 leaves
    for _ in range(checked_steps):
        m = tr.run(1, log_every=0)
        losses.append(float(m["loss"]))
        if first is None:
            first = {k: v.detach().float() / b1
                     for k, v in tr.state.opt_state["mu"].items()}
    change = _norms({k: tr.state.params[k].detach() - p0[k] for k in p0})
    del p0
    return tr, ds, ref_train.Readings(losses=losses, grad_norms=_norms(first),
                                      change_norms=change, first_grads=first)


def reference_readings(run, checked_steps: int, precision: str = "float32",
                       half: bool = False):
    """The reference's readings of the same steps: the corpus and the
    weights made again from the seed, the windows drawn again.  precision
    (model.logits): "fp8" the control, "float64" and "bfloat16" the
    witnesses of the look; half: the fault of half the batch left out (the
    reference put in the program's place), for the calibration."""
    from portbench import corpus
    from portbench.reference import data, model, train as ref_train
    mix, z = run.cell.mix, run.sizes
    ref_train.check_config(run.cell.config["model"])
    model.no_tf32()
    clips = data.kept_clips(corpus.clips(
        run.seed, mix["clips"], mix["clip_min_s"], mix["clip_max_s"],
        z.sample_rate, mix["noise"]), z.window)
    toks = [data.encode(c, z.Q) for c in clips]
    mels = data.clip_mels(clips, z) if z.M else None
    del clips
    s = run.seed % (1 << 62)
    rows = z.batch // 2 if half else z.batch
    batches, frames, speakers = [], [], []
    for k in range(checked_steps):
        win, ids, starts = data.draw(toks, s, k, z.batch, z.window, z.hop)
        batches.append(torch.from_numpy(win[:rows]).to(run.device))
        if z.M:
            frames.append(torch.from_numpy(data.window_frames(
                mels, ids[:rows], starts[:rows], z.window, z.hop)
            ).to(run.device))
        if z.C:
            speakers.append(torch.from_numpy(ids[:rows] % z.C
                                             ).to(run.device))
    w0 = run.weights()
    return ref_train.steps(w0, z.dilations, batches, z.learning_rate,
                           z.adam_b1, z.adam_b2,
                           rows=run.cell.workload["ref_rows"],
                           precision=precision,
                           mels=frames if z.M else None,
                           speakers=speakers if z.C else None)


def run(run) -> None:
    from portbench.reference import train as ref_train
    wl, z = run.cell.workload, run.sizes
    checked = int(wl["checked_steps"])
    tr, ds, prog = program_readings(run, checked)
    per_call = int(wl["steps_per_call"])
    steps = 0
    with run.tracing():
        with run.window() as t0:
            end = t0 + run.seconds
            if run.traced:
                ds.sample_batch = _spanned(ds.sample_batch, run.counters)
            while True:
                tr.run(per_call, log_every=0)
                steps += per_call
                if time.monotonic() >= end:
                    break
    run.after_window()
    run.attempted = steps
    audio_s = steps * z.batch * z.window / z.sample_rate
    run.e2e["train_audio_s_per_s"] = audio_s / run.window_s
    run.counters["steps"] = steps
    del tr, ds
    run.free()
    ref = reference_readings(run, checked)
    gaps = ref_train.gaps(prog, ref)
    for name, limit in wl["limits"].items():
        run.check(name, gaps[name], limit)


def _spanned(sample_batch, counters):
    """sample_batch timing its host seconds into counters["data_host_s"]
    (the traced run only)."""
    counters.setdefault("data_host_s", 0.0)

    def wrapped(*a, **kw):
        t = time.perf_counter()
        try:
            return sample_batch(*a, **kw)
        finally:
            counters["data_host_s"] += time.perf_counter() - t
    return wrapped
