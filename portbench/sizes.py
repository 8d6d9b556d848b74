"""A configuration file's sizes, read without the port's config class.

A file under configs/ holds the port's WaveNetConfig fields under "model"
(the JSON of `WaveNetConfig.to_json()`), beside its source and what was
assumed.  The yardstick (roofline.py, the reference) reads the sizes from
here, so that a count never follows a change of the program.  A model
without mel has M = 0, hop 1 and no upsampling stages; one without
speakers has C = G = 0.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Sizes:
    Q: int                      # mu-law classes
    R: int                      # residual channels
    S: int                      # skip channels
    K: int                      # causal conv width
    dilations: Tuple[int, ...]
    sample_rate: int
    batch: int                  # training rows a step
    window: int                 # training predictions a row
    learning_rate: float
    adam_b1: float
    adam_b2: float
    M: int = 0                  # mel bins (0: no mel conditioning)
    hop: int = 1                # samples per mel frame
    upsample: Tuple[int, ...] = ()   # the upsampler's factors, product hop
    n_fft: int = 0              # log-mel frame length (Hann window)
    fmin: float = 0.0
    fmax: float = 0.0           # 0: sample_rate / 2
    C: int = 0                  # speaker classes (0: no speakers)
    G: int = 0                  # speaker embedding width

    @property
    def L(self) -> int:
        return len(self.dilations)

    @classmethod
    def from_model(cls, m: dict) -> "Sizes":
        ladder, d = [], 1
        while d <= m["max_dilation"]:
            ladder.append(d)
            d *= 2
        E = m.get("causal_channels") or m["residual_channels"]
        if E != m["residual_channels"]:
            raise NotImplementedError(
                "the yardstick counts models with "
                "causal_channels == residual_channels")
        mel, C = m.get("mel"), m.get("global_classes") or 0
        cond = {}
        if mel is not None:
            ups = tuple(int(f) for f in mel["upsample_factors"])
            if math.prod(ups) != mel["hop_length"]:
                raise ValueError(f"upsample_factors {ups} do not multiply "
                                 f"to hop_length {mel['hop_length']}")
            cond.update(M=mel["num_mels"], hop=mel["hop_length"],
                        upsample=ups, n_fft=mel["win_length"],
                        fmin=float(mel["fmin"]), fmax=float(mel["fmax"]))
        if C:
            cond.update(C=C, G=m["global_channels"])
        return cls(Q=m["quantization_channels"], R=m["residual_channels"],
                   S=m["skip_channels"], K=m["kernel_size"],
                   dilations=tuple(ladder) * m["num_blocks"],
                   sample_rate=m["sample_rate"], batch=m["batch_size"],
                   window=m["train_window"],
                   learning_rate=m["learning_rate"],
                   adam_b1=m["adam_b1"], adam_b2=m["adam_b2"], **cond)


def load_config(path: Path) -> dict:
    """The configuration file as a dict; its "model" holds the port's
    config fields."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc.get("model"), dict):
        raise ValueError(f"{path}: no \"model\" object")
    return doc
