"""The golden fixtures' parameters and locations (tests/golden_torch/).

The golden files hold what the JAX package computes for `tiny` and `small`
models on the CPU (tests/golden_torch/make_golden.py writes them), but no
parameters: both sides draw them here, from numpy.random.RandomState(seed),
in the reference's shapes and distributions (wavenet_tpu/models/wavenet.py
init_params: N(0, 0.05^2) embedding tables, Glorot-uniform stacked weights
with the fan-in from the input axis, zero biases), so the card, which has
no JAX, redraws the same weights.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from wavenet_tpu_torch import config

# name -> (preset, params seed, batch, loss window T, decode steps N)
MODELS = {"tiny": ("tiny", 0, 2, 512, 256), "small": ("small", 1, 2, 512, 128)}
TF_POSITIONS = (0, 1, 7, 63, 200, 511)       # logits kept teacher-forced
SAMPLE_SEEDS = (11, 29)                      # counter-RNG row seeds
TEMPERATURE = 1.0


def golden_dir() -> Path:
    """tests/golden_torch/ of the checkout this package sits in."""
    return Path(__file__).resolve().parents[2] / "tests" / "golden_torch"


def model_config(name: str) -> config.WaveNetConfig:
    return config.get_config(MODELS[name][0])


def draw_params(cfg: config.WaveNetConfig, seed: int) -> Dict[str, np.ndarray]:
    """f32 numpy params of cfg (unconditional, kernel_size 2) from
    RandomState(seed), leaves drawn in the order of the reference's
    init_params dict."""
    if cfg.mel is not None or cfg.global_classes is not None \
            or cfg.kernel_size != 2 or cfg.causal_channels is not None:
        raise ValueError("golden models are unconditional width-2 models")
    rs = np.random.RandomState(seed)
    L, R = cfg.num_layers, cfg.residual_channels
    S, Q = cfg.skip_channels, cfg.quantization_channels

    def normal(*shape):
        return (rs.standard_normal(shape) * 0.05).astype(np.float32)

    def glorot(*shape):
        fan_in = shape[-3] if len(shape) >= 4 else shape[-2]
        limit = (6.0 / (fan_in + shape[-1])) ** 0.5
        return rs.uniform(-limit, limit, shape).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    return {
        "embed_cur": normal(Q, R), "embed_prev": normal(Q, R),
        "w_cur": glorot(L, R, 2, R), "w_prev": glorot(L, R, 2, R),
        "b": zeros(L, 2, R), "w_res": glorot(L, R, R), "b_res": zeros(L, R),
        "w_skip": glorot(L, R, S), "b_skip": zeros(L, S),
        "head_w1": glorot(S, S), "head_b1": zeros(S),
        "head_w2": glorot(S, Q), "head_b2": zeros(Q),
    }


def tokens(name: str) -> np.ndarray:
    """The [B, T + 1] int32 token window of model `name`'s loss and
    teacher-forced logits."""
    cfg = model_config(name)
    _, seed, B, T, _ = MODELS[name]
    rs = np.random.RandomState(1000 + seed)
    return rs.randint(0, cfg.quantization_channels, (B, T + 1)).astype(
        np.int32)


def near_tie(margin: np.ndarray, scale: float) -> np.ndarray:
    """Where the reference's top-2 margin is at most 2^-7 of `scale` (see
    argmax_agreement)."""
    return margin <= 2.0 ** -7 * scale


def argmax_agreement(logits: np.ndarray, want_argmax: np.ndarray,
                     want_margin: np.ndarray, scale: float):
    """(overall agreement, agreement where the reference's top-2 margin
    exceeds 2^-7 of `scale`, the share of such positions).  Below that
    margin two correct implementations that sum in f32 in different orders
    may round a bf16 residual differently and pick the other of two near-
    tied tokens (random weights give flat logits: at `small`, 20 layers,
    1.6% of positions flip between the port and JAX, all at margins below
    0.01 of a logit scale of 2.1), so the gate holds the rest."""
    agree = logits.argmax(-1) == want_argmax
    keep = ~near_tie(want_margin, scale)
    return (float(agree.mean()), float(agree[keep].mean()),
            float(keep.mean()))
