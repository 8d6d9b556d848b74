"""Model weights made on the device from the run's seed.

The port's key names and shapes and its init's distributions (embedding
tables N(0, 0.05^2), Glorot-uniform products with the fan-in from the input
axis and the fan-out from the last, zero biases), drawn by one generator on
the device in two calls, one normal and one uniform, and cut into leaves.
The same call on the same device and seed gives the same tensors, so the
reference is handed what the program was handed, made again after the
program's state is freed.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.sizes import Sizes

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def shapes(z: Sizes) -> Dict[str, tuple]:
    L, R, S, Q = z.L, z.R, z.S, z.Q
    if z.K != 2:
        raise NotImplementedError("the weights are made for kernel_size 2")
    return {"embed_cur": (Q, R), "embed_prev": (Q, R),
            "w_cur": (L, R, 2, R), "w_prev": (L, R, 2, R), "b": (L, 2, R),
            "w_res": (L, R, R), "b_res": (L, R), "w_skip": (L, R, S),
            "b_skip": (L, S), "head_w1": (S, S), "head_b1": (S,),
            "head_w2": (S, Q), "head_b2": (Q,)}


_NORMAL = ("embed_cur", "embed_prev")
_GLOROT = ("w_cur", "w_prev", "w_res", "w_skip", "head_w1", "head_w2")


def _glorot_limit(shape) -> float:
    fan_in = shape[-3] if len(shape) >= 4 else shape[-2]
    return (6.0 / (fan_in + shape[-1])) ** 0.5


def make(z: Sizes, seed: int, device, param_dtype: str = "float32"
         ) -> Dict[str, torch.Tensor]:
    """The flat params {name: tensor} in param_dtype on `device`."""
    shp = shapes(z)
    numel = {k: int(torch.Size(s).numel()) for k, s in shp.items()}
    g = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(sum(numel[k] for k in _NORMAL), generator=g,
                         device=device) * 0.05
    uniform = torch.rand(sum(numel[k] for k in _GLOROT), generator=g,
                         device=device) * 2.0 - 1.0
    out, i, j = {}, 0, 0
    for k in _NORMAL:
        out[k] = normal[i:i + numel[k]].view(shp[k])
        i += numel[k]
    for k in _GLOROT:
        out[k] = uniform[j:j + numel[k]].view(shp[k]) * _glorot_limit(shp[k])
        j += numel[k]
    dt = _DTYPES[param_dtype]
    return {k: (out[k] if k in out else torch.zeros(shp[k], device=device)
                ).to(dt).contiguous() for k in shp}
