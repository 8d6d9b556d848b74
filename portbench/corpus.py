"""The synthetic training corpus and the serving requests, from the seed.

Every seed asks the same set of sizes of the program, in an order drawn
from the seed: the corpus's clip lengths are the quantiles of a log-uniform
law over the mix's range (a training step's work does not depend on them);
the requests' lengths are blocks of `block` such quantiles, each block
shuffled.  The seed gives each request its own sampling seed, and a
conditioned request its span of a clip's frames and its speaker.  A clip
is a mixture of three sines plus white noise, in [-1, 1].
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def seed32(seed: int, *salt: int) -> np.random.Generator:
    """A numpy generator keyed by the run's seed and a salt."""
    return np.random.default_rng([int(seed) % (1 << 62), *salt])


def log_uniform_quantiles(n: int, lo: float, hi: float) -> np.ndarray:
    k = (np.arange(n) + 0.5) / n
    return np.exp(math.log(lo) + k * (math.log(hi) - math.log(lo)))


def clips(seed: int, num: int, min_s: float, max_s: float,
          sample_rate: int, noise: float) -> List[np.ndarray]:
    """`num` float32 clips, their lengths the log-uniform quantiles over
    [min_s, max_s] seconds in an order drawn from the seed."""
    rng = seed32(seed, 1)
    lengths = np.round(log_uniform_quantiles(num, min_s, max_s)
                       * sample_rate).astype(np.int64)
    rng.shuffle(lengths)
    freqs = rng.uniform(80.0, 2000.0, size=(num, 3))
    amps = rng.uniform(0.1, 0.25, size=(num, 3))
    phases = rng.uniform(0.0, 2 * np.pi, size=(num, 3))
    out = []
    for i, n in enumerate(lengths):
        t = np.arange(n, dtype=np.float32) / np.float32(sample_rate)
        x = rng.standard_normal(n, dtype=np.float32) * np.float32(noise)
        for f, a, p in zip(freqs[i], amps[i], phases[i]):
            x += np.float32(a) * np.sin(np.float32(2 * np.pi * f) * t
                                        + np.float32(p))
        out.append(np.clip(x, -1.0, 1.0))
    return out


def request_lengths(seed: int, count: int, block: int, min_s: float,
                    max_s: float, sample_rate: int) -> np.ndarray:
    """`count` request lengths in samples: blocks of the `block`
    log-uniform quantiles over [min_s, max_s] s, each block shuffled in an
    order drawn from the seed."""
    rng = seed32(seed, 2)
    base = np.round(log_uniform_quantiles(block, min_s, max_s)
                    * sample_rate).astype(np.int64)
    blocks = [rng.permutation(base) for _ in range(-(-count // block))]
    return np.concatenate(blocks)[:count]


def request_seeds(seed: int, count: int) -> np.ndarray:
    """`count` distinct request seeds in [1, 2**31 - 1)."""
    rng = seed32(seed, 3)
    return rng.choice(2 ** 31 - 2, size=count, replace=False).astype(
        np.int64) + 1


def request_spans(seed: int, frames: np.ndarray, clip_frames
                  ) -> tuple:
    """(clip, first frame) of each request that needs frames[k] frames: a
    clip and a start drawn from the seed, among the clip's clip_frames[c]
    frames; a clip shorter than a request raises ValueError."""
    rng = seed32(seed, 5)
    avail = np.asarray(clip_frames, np.int64)
    clip = rng.integers(0, len(avail), size=len(frames))
    room = avail[clip] - np.asarray(frames, np.int64) + 1
    if (room < 1).any():
        k = int(np.argmin(room))
        raise ValueError(f"request {k} needs {frames[k]} frames; clip "
                         f"{clip[k]} has {avail[clip[k]]}")
    start = np.floor(rng.random(len(frames)) * room).astype(np.int64)
    return clip, start


def request_speakers(seed: int, count: int, classes: int) -> np.ndarray:
    """`count` speaker ids in [0, classes), drawn from the seed."""
    return seed32(seed, 6).integers(0, classes, size=count)
