"""The whole-loop decode as a registered op,
torch.ops.wavenet_tpu_torch.generate.

torch.export traces tensor programs, and the decode loop is not one: it is
one launch of a hand-written kernel (ops/cuda/decode.py or decode_wide.py)
behind generate/sampler.generate_auto.  Registered as a custom op, that
launch is one node of an exported graph, which is how serving/aot.py
freezes a decoder into a deployment artifact.  The op takes only tensors,
ints, floats and strings, so an exported program that calls it saves and
loads with torch.export:

  weights      the model's parameter leaves in sorted '/'-joined key order
               (utils/pytree_io.flatten_tree; `param_keys(cfg)` names them)
  seeds        [batch] int32 per-row counter-RNG seeds (ops/rng.py)
  y            the upsampled mel timeline [batch, >= num_samples, M] of a
               mel model, else None
  speaker      [batch] int ids of a speaker model, else None
  num_samples, temperature, and the WaveNetConfig as its JSON string.

Its body rebuilds the parameter tree and calls generate_auto unchanged, so
it takes the route kernel_module picks: on the card the narrow or the wide
kernel, one launch per call (or the plain route for a model neither takes,
as everywhere in the port); on the CPU the kernel module's plain version.
A CUDA tensor never reaches the plain version of a kernel: a kernel that
fails to build or launch raises.  The kernel layout of the weights
(decode_common.flatten_params) is built once per set of weight tensors
and reused while none of them was moved or modified, as the facade's
WaveNet.decode_weights does.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import List, Optional

import torch

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.generate.sampler import generate_auto
from wavenet_tpu_torch.ops.cuda import decode_common
from wavenet_tpu_torch.utils.pytree_io import unflatten_tree

_CACHE_SIZE = 4                  # weight sets whose kernel layout is kept
_cache_lock = threading.Lock()
_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


def param_keys(cfg: WaveNetConfig) -> List[str]:
    """The sorted '/'-joined keys of cfg's params (models/wavenet.init_params
    makes them): the order the op takes its weights in."""
    keys = ["embed_cur", "embed_prev", "w_cur", "w_prev", "b", "w_res",
            "b_res", "w_skip", "b_skip", "head_w1", "head_b1", "head_w2",
            "head_b2"]
    if cfg.mel is not None:
        keys.append("v_cond")
        for i in range(len(cfg.mel.upsample_factors)):
            keys += [f"upsampler/w{i}", f"upsampler/b{i}"]
    if cfg.global_classes is not None:
        keys += ["g_embed", "v_global"]
    if cfg.kernel_size > 2:
        keys += ["w_prevk", "embed_prevk"]
    if cfg.embed_channels != cfg.residual_channels:
        keys.append("w_embed_proj")
    return sorted(keys)


@functools.lru_cache(maxsize=16)
def _config(cfg_json: str) -> WaveNetConfig:
    return WaveNetConfig.from_json(cfg_json)


def decode_weights(weights: List[torch.Tensor], cfg_json: str
                   ) -> decode_common.DecodeWeights:
    """flatten_params of the weight list, rebuilt only when a tensor was
    moved or modified since the last call with it.  An entry keeps its
    input tensors alive, so their addresses cannot be reused by other
    tensors while it is cached."""
    cfg = _config(cfg_json)
    keys = param_keys(cfg)
    if len(weights) != len(keys):
        raise ValueError(f"{len(weights)} weight tensors for a model with "
                         f"{len(keys)} params ({keys})")
    key = (cfg_json,) + tuple((t.data_ptr(), t._version, t.device)
                              for t in weights)
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            _cache.move_to_end(key)
            return hit[1]
    w = decode_common.flatten_params(
        unflatten_tree(dict(zip(keys, weights))), cfg)
    with _cache_lock:
        _cache[key] = (tuple(weights), w)
        while len(_cache) > _CACHE_SIZE:
            _cache.popitem(last=False)
    return w


@torch.library.custom_op("wavenet_tpu_torch::generate", mutates_args=())
def generate(weights: List[torch.Tensor], seeds: torch.Tensor,
             y: Optional[torch.Tensor], speaker: Optional[torch.Tensor],
             num_samples: int, temperature: float, cfg_json: str
             ) -> torch.Tensor:
    """[batch, num_samples] int32 tokens from one whole-loop decode launch
    (generate_auto) on the seeds' device; batch = len(seeds)."""
    cfg = _config(cfg_json)
    return generate_auto(decode_weights(weights, cfg_json), cfg, num_samples,
                         batch=seeds.shape[0], temperature=temperature,
                         seeds=seeds, device=seeds.device, y=y,
                         speaker=speaker)


@generate.register_fake
def _generate_fake(weights, seeds, y, speaker, num_samples, temperature,
                   cfg_json):
    return seeds.new_empty((seeds.shape[0], num_samples), dtype=torch.int32)
