"""The traffic drivers on conditioned models, through the port's plain
routes at tiny sizes on the CPU: the existing cells' files with mel (16
bins, hop 32) or 4 speakers added by load_cell's overrides, and, serving,
the mix's "conditioning": "mel" requests.  A sound run is correct, and a
run with the conditioning broken underneath is not: a mel request decoded
with no conditioning term (the server's unconditioned route), one row's
frames shifted by one frame, and the speaker ids permuted in training.

The mel serving runs hold token_gap to a limit of the tiny model's own,
0.05, not the full cells' (0.15, 1.0), which were set at their own widths
and depth, where rounding reads far more.  At this size sound runs read
0-0.0135 (24 seeds, with and without speakers) and mel requests decoded
unconditioned 0.46-1.65 (15 seeds).  A one-frame shift reads 0.020-0.21
(17 seeds; 0.135 on seed 5): the clips' three sines hold still, so a
frame and the next differ by their noise alone, and on 4 of those seeds
the shift stays under the limit.  The test catches it on its own seed."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import tiny_overrides
from portbench import corpus, harness, spans

MEL_SERVE = {"mel": True, "seconds": 2.5, "limits": {"token_gap": 0.05}}


@pytest.mark.parametrize("mel, speakers", [(True, 0), (False, 4),
                                           (True, 4)])
def test_conditioned_train_loop_sound(tiny_run, mel, speakers):
    run = tiny_run("full.train", mel=mel, speakers=speakers)
    res = harness.result(run)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"grad_gap", "change_gap", "grad_err"}
    assert (run.sizes.M > 0) == mel and run.sizes.C == speakers


@pytest.mark.parametrize("speakers", [0, 4])
def test_mel_closed_loop_serve_sound(tiny_run, monkeypatch, speakers):
    from wavenet_tpu_torch.serving.server import WaveNetServer
    submitted = []
    submit = WaveNetServer.submit

    def spy(self, **kw):
        submitted.append(kw)
        return submit(self, **kw)
    monkeypatch.setattr(WaveNetServer, "submit", spy)
    run = tiny_run("full.serve", speakers=speakers, **MEL_SERVE)
    res = harness.result(run)
    assert res["correct"], (res["checks"], run.faults)
    assert res["attempted"] >= 6 and res["failed"] == 0
    hop = run.sizes.hop
    assert all(kw["mel"].shape == (-(-kw["num_samples"] // hop), 16)
               for kw in submitted)
    assert all((kw["speaker"] is not None) == (speakers > 0)
               for kw in submitted)
    # every group went through the counted stream: the padded rows' base
    assert run.counters["groups"] and run.counters["launches"]


def test_traced_mel_run_reads_the_mel_lane(tiny_run):
    run = tiny_run("full.serve", trace=True, **MEL_SERVE)
    assert run.correct
    assert spans.serving_lane(run) == 1
    run = tiny_run("full.serve", trace=True)
    assert spans.serving_lane(run) == 0


def test_mel_request_decoded_unconditioned_is_not_correct(tiny_run,
                                                          monkeypatch):
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.serving import server
    stream = WaveNet.stream

    def dropped(self, *a, y=None, **kw):
        if y is None:
            return stream(self, *a, **kw)
        return stream(server.unconditioned(self), *a, **kw)
    monkeypatch.setattr(WaveNet, "stream", dropped)
    run = tiny_run("full.serve", **MEL_SERVE)
    assert not run.faults
    assert run.checks["token_gap"]["value"] > \
        run.checks["token_gap"]["limit"]


def test_mel_frames_shifted_by_one_frame_are_not_correct(tiny_run,
                                                         monkeypatch):
    """The longest request's frames start one frame late: the judged
    sample always holds the longest request."""
    from wavenet_tpu_torch.serving.server import WaveNetServer
    mix = tiny_overrides("full.serve", mel=True)["mix"]
    longest = int(np.round(corpus.log_uniform_quantiles(
        mix["clients"], mix["min_s"], mix["max_s"]) * 4000).max())
    submit = WaveNetServer.submit
    shifted = []

    def shift(self, **kw):
        if kw["num_samples"] == longest:
            kw["mel"] = np.concatenate([kw["mel"][1:], kw["mel"][-1:]])
            shifted.append(kw["num_samples"])
        return submit(self, **kw)
    monkeypatch.setattr(WaveNetServer, "submit", shift)
    run = tiny_run("full.serve", **MEL_SERVE)
    assert shifted and not run.faults
    assert run.checks["token_gap"]["value"] > \
        run.checks["token_gap"]["limit"]


def test_speaker_ids_permuted_in_training_are_not_correct(tiny_run,
                                                          monkeypatch):
    from wavenet_tpu_torch.audio.dataset import AudioDataset
    sample = AudioDataset.sample_batch

    def permuted(self, *a, **kw):
        batch, st = sample(self, *a, **kw)
        batch["speaker"] = np.roll(batch["speaker"], 1)
        return batch, st
    monkeypatch.setattr(AudioDataset, "sample_batch", permuted)
    run = tiny_run("full.train", speakers=4)
    assert not run.correct, run.checks
