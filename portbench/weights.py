"""Model weights made on the device from the run's seed.

The port's key names and shapes and its init's distributions (embedding
tables N(0, 0.05^2), Glorot-uniform products with the fan-in from the input
axis and the fan-out from the last, zero biases), drawn by one generator on
the device in two calls, one normal and one uniform, and cut into leaves.
A conditioned model's leaves follow in two more calls of the same
generator, so an unconditional model's are what they were before these
existed: a normal call for the upsampler's noise (each stage's taps are
eye(M) / k plus N(0, 0.01^2 / (k M)), k = 2f + 1) and g_embed
(N(0, 0.05^2)), then a uniform call for v_cond and v_global (Glorot).
The same call on the same device and seed gives the same tensors, so the
reference is handed what the program was handed, made again after the
program's state is freed.

The leaves are flat, the upsampler's under "upsampler/w{i}" and
"upsampler/b{i}" (the Trainer's names for them); `nested` gives the layout
the port's WaveNet facade takes.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.sizes import Sizes

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
UPSAMPLER = "upsampler/"


def shapes(z: Sizes) -> Dict[str, tuple]:
    L, R, S, Q = z.L, z.R, z.S, z.Q
    if z.K != 2:
        raise NotImplementedError("the weights are made for kernel_size 2")
    out = {"embed_cur": (Q, R), "embed_prev": (Q, R),
           "w_cur": (L, R, 2, R), "w_prev": (L, R, 2, R), "b": (L, 2, R),
           "w_res": (L, R, R), "b_res": (L, R), "w_skip": (L, R, S),
           "b_skip": (L, S), "head_w1": (S, S), "head_b1": (S,),
           "head_w2": (S, Q), "head_b2": (Q,)}
    if z.M:
        out["v_cond"] = (L, z.M, 2, R)
        for i, f in enumerate(z.upsample):
            out[f"{UPSAMPLER}w{i}"] = (2 * f + 1, z.M, z.M)
            out[f"{UPSAMPLER}b{i}"] = (z.M,)
    if z.C:
        out["g_embed"] = (z.C, z.G)
        out["v_global"] = (L, z.G, 2, R)
    return out


_NORMAL = ("embed_cur", "embed_prev")
_GLOROT = ("w_cur", "w_prev", "w_res", "w_skip", "head_w1", "head_w2")
_COND_GLOROT = ("v_cond", "v_global")


def _glorot_limit(shape) -> float:
    fan_in = shape[-3] if len(shape) >= 4 else shape[-2]
    return (6.0 / (fan_in + shape[-1])) ** 0.5


def _cut(flat: torch.Tensor, keys, shp, numel, out) -> None:
    i = 0
    for k in keys:
        out[k] = flat[i:i + numel[k]].view(shp[k])
        i += numel[k]


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
    out: Dict[str, torch.Tensor] = {}
    _cut(normal, _NORMAL, shp, numel, out)
    _cut(uniform, _GLOROT, shp, numel, out)
    taps = [k for k in shp if k.startswith(UPSAMPLER + "w")]
    cond_n = taps + [k for k in ("g_embed",) if k in shp]
    cond_u = [k for k in _COND_GLOROT if k in shp]
    if cond_n:
        _cut(torch.randn(sum(numel[k] for k in cond_n), generator=g,
                         device=device), cond_n, shp, numel, out)
        _cut(torch.rand(sum(numel[k] for k in cond_u), generator=g,
                        device=device) * 2.0 - 1.0, cond_u, shp, numel, out)
    for k in taps:
        k_w, M = shp[k][0], shp[k][1]
        out[k] = (torch.eye(M, device=device) / k_w
                  + out[k] * (0.01 / (k_w * M) ** 0.5))
    if "g_embed" in out:
        out["g_embed"] = out["g_embed"] * 0.05
    for k in list(_GLOROT) + cond_u:
        out[k] = out[k] * _glorot_limit(shp[k])
    dt = _DTYPES[param_dtype]
    return {k: (out[k] if k in out else torch.zeros(shp[k], device=device)
                ).to(dt).contiguous() for k in shp}


def nested(flat: Dict[str, torch.Tensor]) -> dict:
    """The flat leaves in the port's nested layout: the upsampler's under
    "upsampler" as {"w0": .., "b0": ..}; the tensors themselves, not
    copies."""
    out: dict = {}
    for k, v in flat.items():
        if k.startswith(UPSAMPLER):
            out.setdefault("upsampler", {})[k[len(UPSAMPLER):]] = v
        else:
            out[k] = v
    return out
