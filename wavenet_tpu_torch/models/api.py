"""Object-style facade over the functional model core: `WaveNet(nn.Module)`.

The params are registered on the module under the reference's key names
and shapes (embed_cur, w_cur [L, R, 2, R], b [L, 2, R], ...), frozen
(requires_grad=False: this slice only decodes), so
`state_dict()` keys match the JAX package's export_npz keys and
`model.to(device)` moves the whole model.  The kernel-layout weights
(ops/cuda/decode_wide.flatten_params) are built once per device and
reused by every decode launch until a param changes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops.cuda import decode_wide as pwide


class WaveNet(nn.Module):
    """model = WaveNet(cfg).init(); model.to("cuda");
    model.generate(seconds=1.0); for chunk in model.stream(seconds=5): ..."""

    def __init__(self, cfg: WaveNetConfig, params: Optional[dict] = None):
        super().__init__()
        wn.check_supported(cfg)
        self.cfg = cfg
        self._decode_cache = None
        if params is not None:
            self._set_params(params)

    def _set_params(self, params: dict) -> None:
        for k, v in params.items():
            if isinstance(v, dict):
                raise NotImplementedError(
                    f"nested params {k!r} (conditioning) are not ported yet "
                    f"(ROADMAP queue 1 item 6)")
            self.register_parameter(
                k, nn.Parameter(torch.as_tensor(v), requires_grad=False))
        self._decode_cache = None

    # ---- lifecycle ----

    def init(self, generator: Optional[torch.Generator] = None,
             device="cpu") -> "WaveNet":
        """Random weights from `generator` (default: seeded by cfg.seed)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        self._set_params(wn.init_params(self.cfg, generator, device))
        return self

    @property
    def params(self) -> dict:
        """The params dict the functional core takes (live tensors)."""
        return dict(self.named_parameters())

    @property
    def device(self) -> torch.device:
        return self.embed_cur.device

    def export_npz(self, path: str) -> None:
        """One portable .npz: '/'-joined param keys plus the config JSON
        under '__config__' — the JAX package's export format."""
        from wavenet_tpu_torch.utils.pytree_io import (flatten_tree,
                                                       params_to_numpy)
        flat = flatten_tree(params_to_numpy(self.params))
        flat["__config__"] = np.frombuffer(self.cfg.to_json().encode(),
                                           dtype=np.uint8)
        np.savez(path, **flat)

    @classmethod
    def from_npz(cls, path: str, device="cpu") -> "WaveNet":
        """Load an export_npz file written by either package."""
        from wavenet_tpu_torch.utils.pytree_io import (params_from_numpy,
                                                       unflatten_tree)
        with np.load(path) as z:
            cfg = WaveNetConfig.from_json(bytes(z["__config__"]).decode())
            params = unflatten_tree({k: z[k] for k in z.files
                                     if k != "__config__"})
        return cls(cfg, params_from_numpy(params, device))

    # ---- decode ----

    def decode_weights(self) -> "pwide.DecodeWeights":
        """flatten_params of the current params, rebuilt only when a param
        was moved or modified since the last call."""
        key = tuple((p.data_ptr(), p._version, p.device)
                    for p in self.parameters())
        if self._decode_cache is None or self._decode_cache[0] != key:
            self._decode_cache = (key, pwide.flatten_params(self.params,
                                                            self.cfg))
        return self._decode_cache[1]

    def _prime(self, prime_tokens):
        if prime_tokens is None:
            return None
        return torch.as_tensor(prime_tokens, dtype=torch.int32,
                               device=self.device)

    def generate(self, seconds: Optional[float] = None,
                 num_samples: Optional[int] = None, batch: int = 1,
                 prime_tokens=None, temperature: float = 1.0,
                 seed: int = 0, seeds=None) -> torch.Tensor:
        """Sample [batch, num_samples] int32 mu-law tokens on the model's
        device.  seeds: optional [batch] per-row counter-RNG seeds (each
        row's audio then depends only on its seed); else derived from
        `seed`."""
        from wavenet_tpu_torch.generate.sampler import generate_auto
        n = self._num_samples(seconds, num_samples)
        return generate_auto(self.decode_weights(), self.cfg, n, batch=batch,
                             prime_tokens=self._prime(prime_tokens),
                             temperature=temperature,
                             seeds=self._seeds(seed, seeds),
                             device=self.device)

    def stream(self, seconds: Optional[float] = None,
               chunk_seconds: float = 1.0, batch: int = 1,
               prime_tokens=None, temperature: float = 1.0,
               num_samples: Optional[int] = None,
               chunk_samples: Optional[int] = None, seed: int = 0,
               seeds=None):
        """Yield float32 waveform chunks ([batch, <= chunk] numpy arrays in
        [-1, 1]) as they are decoded; the concatenation is bit-identical
        to a one-shot generate at the same seeds."""
        from wavenet_tpu_torch.audio import mulaw
        from wavenet_tpu_torch.generate.sampler import generate_stream
        n = self._num_samples(seconds, num_samples)
        if chunk_samples is None:
            chunk_samples = max(1, int(chunk_seconds * self.cfg.sample_rate))
        gen = generate_stream(self.decode_weights(), self.cfg, n,
                              chunk_samples=chunk_samples, batch=batch,
                              prime_tokens=self._prime(prime_tokens),
                              temperature=temperature,
                              seeds=self._seeds(seed, seeds),
                              device=self.device)
        for toks in gen:
            yield mulaw.decode(toks, self.cfg.quantization_channels
                               ).cpu().numpy()

    def _num_samples(self, seconds, num_samples) -> int:
        if num_samples is None:
            if seconds is None:
                raise ValueError("pass seconds= or num_samples=")
            num_samples = int(seconds * self.cfg.sample_rate)
        return int(num_samples)

    def _seeds(self, seed, seeds):
        if seeds is None:
            return int(seed)
        return torch.as_tensor(seeds, dtype=torch.int32, device=self.device)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
