"""Shared fixtures of the benchmark's tests: tiny cells on the CPU, and the
card for the tests marked `gpu` (decided inside the fixture, never at
import, so that every worker collects the same tests)."""

from __future__ import annotations

import time

import pytest

TINY = {"num_blocks": 1, "max_dilation": 128, "residual_channels": 32,
        "skip_channels": 16, "batch_size": 4, "train_window": 2048,
        "remat": False}
# a small mel front end: 16 bins, hop 32 = 4 x 8, 256-sample frames
MEL = {"num_mels": 16, "hop_length": 32, "win_length": 256, "fmin": 0.0,
       "fmax": 0.0, "upsample_factors": [4, 8]}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips "
                                       "without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


def tiny_overrides(cell: str, mel: bool = False, speakers: int = 0,
                   **workload) -> dict:
    """A cell's files at the tiny preset's widths, sizes a CPU test holds:
    short clips, 4 clients, requests of 20-80 ms at 4 kHz.  mel: the model
    conditioned on MEL and, serving, the mix's requests bringing frames of
    0.1-0.3 s clips; speakers: that many speaker classes."""
    cond = {}
    if mel:
        cond["mel"] = MEL
    if speakers:
        cond["global_classes"] = speakers
    if "train" in cell:
        return {"config": dict(TINY, **cond),
                "mix": {"clips": 8, "clip_min_s": 0.2, "clip_max_s": 0.5},
                "workload": dict({"steps_per_call": 1}, **workload)}
    mix = {"clients": 4, "max_batch": 4, "min_s": 0.02, "max_s": 0.08,
           "chunk_s": 0.02, "length_quantum_s": 0.02, "warm_samples": 8}
    if mel:
        mix.update(conditioning="mel", clips=8, clip_min_s=0.1,
                   clip_max_s=0.3, noise=0.02)
    return {"config": dict(TINY, sample_rate=4000, **cond), "mix": mix,
            "workload": dict({"check_requests": 6, "ref_rows": 4},
                             **workload)}


@pytest.fixture
def tiny_run():
    """harness.execute of a cell at tiny sizes on the CPU (the harness's
    look for a card skipped): tiny_run(cell, seed, seconds, trace, mel,
    speakers, **workload overrides) -> Run."""
    from portbench import harness

    def go(cell: str, seed: int = 5, seconds: float = 1.5,
           trace: bool = False, mel: bool = False, speakers: int = 0,
           **workload):
        c = harness.load_cell(cell, overrides=tiny_overrides(
            cell, mel, speakers, **workload))
        return harness.execute(c, seed, seconds, trace, "cpu",
                               time.monotonic())
    return go
