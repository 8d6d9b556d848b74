"""Object-style facade over the functional model core: `WaveNet(nn.Module)`.

The params are registered on the module under the reference's key names
and shapes (embed_cur, w_cur [L, R, 2, R], b [L, 2, R], ...), frozen
(requires_grad=False: the facade decodes and scores; training runs on the
Trainer's own params, training/trainer.py), so
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
             device="cuda") -> "WaveNet":
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
    def from_npz(cls, path: str, device="cuda") -> "WaveNet":
        """Load an export_npz file written by either package."""
        from wavenet_tpu_torch.utils.pytree_io import (params_from_numpy,
                                                       unflatten_tree)
        with np.load(path) as z:
            cfg = WaveNetConfig.from_json(bytes(z["__config__"]).decode())
            params = unflatten_tree({k: z[k] for k in z.files
                                     if k != "__config__"})
        return cls(cfg, params_from_numpy(params, device))

    @classmethod
    def from_checkpoint(cls, directory: str, step: Optional[int] = None,
                        use_ema: bool = True, device="cuda") -> "WaveNet":
        """Load a model trained by the port's Trainer.  When the run kept
        Polyak-averaged weights (cfg.ema_decay) they are used by default;
        use_ema=False gives the raw training weights.  A directory of the
        JAX package's orbax checkpoints is refused (export_npz carries
        those weights over)."""
        from wavenet_tpu_torch.training.checkpoint import CheckpointManager
        cfg = CheckpointManager.load_config(directory)
        raw, _ = CheckpointManager(directory, cfg).restore(step, device)
        ema = raw.get("ema")
        use = ema if (use_ema and cfg.ema_decay is not None
                      and ema is not None) else raw["params"]
        return cls(cfg, use)

    def save(self, directory: str, step: int = 0) -> None:
        """Write these params as a loadable checkpoint (config JSON beside
        it) without a Trainer, with a freshly initialized optimizer state:
        resuming training from it starts the optimizer cold."""
        from wavenet_tpu_torch.audio.dataset import IteratorState
        from wavenet_tpu_torch.training.checkpoint import CheckpointManager
        from wavenet_tpu_torch.training.trainer import make_optimizer
        params = {k: v.detach() for k, v in self.params.items()}
        if not params:
            raise ValueError("no params; call init() or load a checkpoint")
        state = {"params": params,
                 "opt_state": make_optimizer(self.cfg).init(params),
                 "ema": None}
        CheckpointManager(directory, self.cfg).save(
            step, state, IteratorState(seed=self.cfg.seed, step=0))

    # ---- model surface ----

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).to(torch.int32)

    def logits(self, tokens) -> torch.Tensor:
        """[B, T] tokens -> [B, T, Q] f32 logits (the scan forward)."""
        return wn.forward_logits(self.params, self.cfg, self._tokens(tokens))

    def loss(self, tokens):
        """(loss, aux) of a [B, W+1] token window (the scan forward)."""
        return wn.loss_fn(self.params, self.cfg, self._tokens(tokens))

    def score(self, waveform=None, tokens=None) -> torch.Tensor:
        """Per-utterance teacher-forced bits/sample ([B]; lower is better)
        of float waveforms [B, T] (mu-law encoded here) or tokens [B, T]."""
        from wavenet_tpu_torch.audio import mulaw
        if (waveform is None) == (tokens is None):
            raise ValueError("pass exactly one of waveform= / tokens=")
        if tokens is None:
            tokens = mulaw.encode_np(np.asarray(waveform, np.float32),
                                     self.cfg.quantization_channels)
        return wn.score_fn(self.params, self.cfg, self._tokens(tokens))

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
