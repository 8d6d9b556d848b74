"""Object-style facade over the functional model core: `WaveNet(nn.Module)`.

The params are registered on the module under the reference's key names
and shapes (embed_cur, w_cur [L, R, 2, R], b [L, 2, R], ...), frozen
(requires_grad=False: the facade decodes and scores; training runs on the
Trainer's own params, training/trainer.py), so `model.to(device)` moves
the whole model.  A nested params dict (a mel model's `upsampler`) becomes
a child module holding its leaves; `params` gives the nested dict back, as
the functional core and the JAX package's export_npz keys have it.  The
kernel-layout weights (ops/cuda/decode_common.flatten_params, one layout
for the narrow and the wide decode kernel) are built once per device and
reused by every decode launch until a param changes.  A speaker-conditioned
model takes speaker= ids in logits, loss and score (the training half,
through the same offsets as decode) and in generate and stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import conditioning
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops.cuda import decode_common


def _register(module: nn.Module, tree: dict) -> None:
    """Frozen parameters for the leaves of `tree`, a child module for each
    nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            child = nn.Module()
            _register(child, v)
            module.add_module(k, child)
        else:
            module.register_parameter(
                k, nn.Parameter(torch.as_tensor(v), requires_grad=False))


def _tree(module: nn.Module) -> dict:
    """Inverse of _register: the nested dict of live parameter tensors."""
    out = dict(module.named_parameters(recurse=False))
    for k, child in module.named_children():
        out[k] = _tree(child)
    return out


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
        _register(self, params)
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
        """The params dict the functional core takes (live tensors, nested
        as the reference nests them)."""
        return _tree(self)

    @property
    def device(self) -> torch.device:
        return self.embed_cur.device

    def export_npz(self, path: str) -> None:
        """One portable .npz: '/'-joined param keys plus the config JSON
        under '__config__' — the JAX package's export format."""
        from wavenet_tpu_torch.utils.pytree_io import (flatten_tree,
                                                       params_to_numpy,
                                                       save_npz)
        flat = flatten_tree(params_to_numpy(self.params))
        flat["__config__"] = np.frombuffer(self.cfg.to_json().encode(),
                                           dtype=np.uint8)
        save_npz(path, flat)

    @classmethod
    def from_npz(cls, path: str, device="cuda") -> "WaveNet":
        """Load an export_npz file written by either package (bf16 leaves
        too: utils/pytree_io.load_npz)."""
        from wavenet_tpu_torch.utils.pytree_io import (load_npz,
                                                       params_from_numpy,
                                                       unflatten_tree)
        z = load_npz(path)
        cfg = WaveNetConfig.from_json(bytes(z.pop("__config__")).decode())
        return cls(cfg, params_from_numpy(unflatten_tree(z), device))

    @classmethod
    def from_checkpoint(cls, directory: str, step: Optional[int] = None,
                        use_ema: bool = True, device="cuda") -> "WaveNet":
        """Load a model trained by the port's Trainer.  When the run kept
        Polyak-averaged weights (cfg.ema_decay) they are used by default;
        use_ema=False gives the raw training weights.  A directory of the
        JAX package's orbax checkpoints is refused (export_npz carries
        those weights over)."""
        from wavenet_tpu_torch.training.checkpoint import CheckpointManager
        from wavenet_tpu_torch.utils.pytree_io import unflatten_tree
        cfg = CheckpointManager.load_config(directory)
        raw, _ = CheckpointManager(directory, cfg).restore(step, device)
        ema = raw.get("ema")
        use = ema if (use_ema and cfg.ema_decay is not None
                      and ema is not None) else raw["params"]
        return cls(cfg, unflatten_tree(use))

    def replace_config(self, **kw) -> "WaveNet":
        """A model with non-architectural config fields overridden
        (fused_stack, batch_size, ...), sharing these params (not a copy;
        each model keeps its own decode layout, rebuilt when a param
        changes).  Architecture fields are refused: the params were built
        for their current values (the checkpoint's guard list)."""
        from wavenet_tpu_torch.training.checkpoint import CheckpointManager
        bad = [k for k in kw if k in CheckpointManager._ARCH_FIELDS]
        if bad:
            raise ValueError(
                f"architecture fields {bad} cannot be replaced on a live "
                f"model (params were built for the current values)")
        return WaveNet(self.cfg.replace(**kw), self.params)

    def save(self, directory: str, step: int = 0) -> None:
        """Write these params as a loadable checkpoint (config JSON beside
        it) without a Trainer, with a freshly initialized optimizer state:
        resuming training from it starts the optimizer cold."""
        from wavenet_tpu_torch.audio.dataset import IteratorState
        from wavenet_tpu_torch.training.checkpoint import CheckpointManager
        from wavenet_tpu_torch.training.trainer import make_optimizer
        from wavenet_tpu_torch.utils.pytree_io import flatten_tree
        params = {k: v.detach()
                  for k, v in flatten_tree(self.params).items()}
        if not params:
            raise ValueError("no params; call init() or load a checkpoint")
        state = {"params": params,
                 "opt_state": make_optimizer(self.cfg).init(params),
                 "ema": None}
        CheckpointManager(directory, self.cfg).save(
            step, state, IteratorState(seed=self.cfg.seed, step=0),
            wait=True)

    # ---- model surface ----

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).to(torch.int32)

    def _mel(self, mel) -> Optional[torch.Tensor]:
        """Mel frames [B, F, M] -> f32 on the model's device."""
        if mel is None:
            return None
        if self.cfg.mel is None:
            raise ValueError("model is unconditional; mel= is not an input")
        return torch.as_tensor(mel, dtype=torch.float32, device=self.device)

    def logits(self, tokens, mel=None, speaker=None) -> torch.Tensor:
        """[B, T] tokens -> [B, T, Q] f32 logits (the scan forward); a
        speaker model takes speaker= [B] ids."""
        return wn.forward_logits(self.params, self.cfg, self._tokens(tokens),
                                 mel=self._mel(mel),
                                 speaker=self._speaker(speaker))

    def loss(self, tokens, mel=None, speaker=None):
        """(loss, aux) of a [B, W+1] token window (the scan forward)."""
        return wn.loss_fn(self.params, self.cfg, self._tokens(tokens),
                          mel=self._mel(mel), speaker=self._speaker(speaker))

    def score(self, waveform=None, tokens=None, mel=None,
              speaker=None) -> torch.Tensor:
        """Per-utterance teacher-forced bits/sample ([B]; lower is better)
        of float waveforms [B, T] (mu-law encoded here) or tokens [B, T];
        mel: the frames of a mel model; speaker: the [B] ids of a speaker
        model."""
        from wavenet_tpu_torch.audio import mulaw
        if (waveform is None) == (tokens is None):
            raise ValueError("pass exactly one of waveform= / tokens=")
        if tokens is None:
            tokens = mulaw.encode_np(np.asarray(waveform, np.float32),
                                     self.cfg.quantization_channels)
        return wn.score_fn(self.params, self.cfg, self._tokens(tokens),
                           mel=self._mel(mel), speaker=self._speaker(speaker))

    # ---- decode ----

    def decode_weights(self) -> "decode_common.DecodeWeights":
        """flatten_params of the current params (the layout both decode
        kernels take), rebuilt only when a param was moved or modified
        since the last call."""
        key = tuple((p.data_ptr(), p._version, p.device)
                    for p in self.parameters())
        if self._decode_cache is None or self._decode_cache[0] != key:
            self._decode_cache = (key, decode_common.flatten_params(
                self.params, self.cfg))
        return self._decode_cache[1]

    def _prime(self, prime_tokens):
        if prime_tokens is None:
            return None
        return torch.as_tensor(prime_tokens, dtype=torch.int32,
                               device=self.device)

    def generate(self, seconds: Optional[float] = None,
                 num_samples: Optional[int] = None, batch: int = 1,
                 prime_tokens=None, temperature: float = 1.0,
                 seed: int = 0, seeds=None, mel=None, y=None,
                 speaker=None, mesh=None) -> torch.Tensor:
        """Sample [batch, num_samples] int32 mu-law tokens on the model's
        device.  seeds: optional [batch] per-row counter-RNG seeds (each
        row's audio then depends only on its seed); else derived from
        `seed`.  A mel model takes mel= frames [batch, F, M] (upsampled
        here over the whole timeline, priming included) or y= features
        already upsampled, [batch, >= max(P - 1, 0) + num_samples, M], on
        the model's device.  A speaker model takes speaker= [batch] int
        ids in [0, global_classes).  mesh: a (data, model) mesh of ranks
        (parallel/mesh.make_mesh, or MeshGroups): every rank calls with the
        same arguments and gets the whole batch, equal to one device's
        tokens (sampler.generate_distributed)."""
        from wavenet_tpu_torch.generate.sampler import (generate_auto,
                                                        generate_distributed)
        n = self._num_samples(seconds, num_samples)
        prime = self._prime(prime_tokens)
        kw = dict(prime_tokens=prime, temperature=temperature,
                  device=self.device, y=self._cond(mel, y, prime, n),
                  speaker=self._speaker(speaker))
        if mesh is not None:
            return generate_distributed(self.decode_weights(), self.cfg,
                                        mesh, self._seeds(seed, seeds), n,
                                        batch, **kw)
        return generate_auto(self.decode_weights(), self.cfg, n, batch=batch,
                             seeds=self._seeds(seed, seeds), **kw)

    def stream(self, seconds: Optional[float] = None,
               chunk_seconds: float = 1.0, batch: int = 1,
               prime_tokens=None, temperature: float = 1.0,
               num_samples: Optional[int] = None,
               chunk_samples: Optional[int] = None, seed: int = 0,
               seeds=None, mel=None, y=None, speaker=None, mesh=None,
               local_y=None):
        """Yield float32 waveform chunks ([batch, <= chunk] numpy arrays in
        [-1, 1]) as they are decoded; the concatenation is bit-identical
        to a one-shot generate at the same seeds (mel=/y=/speaker=/mesh=
        as there).  With mesh=, local_y may stand for y: this rank's rows
        of the features (the server's ranks upsample only their own)."""
        from wavenet_tpu_torch.audio import mulaw
        from wavenet_tpu_torch.generate.sampler import (generate_stream,
                                                        stream_distributed)
        n = self._num_samples(seconds, num_samples)
        if chunk_samples is None:
            chunk_samples = max(1, int(chunk_seconds * self.cfg.sample_rate))
        prime = self._prime(prime_tokens)
        kw = dict(chunk_samples=chunk_samples, prime_tokens=prime,
                  temperature=temperature, device=self.device,
                  y=self._cond(mel, y, prime, n),
                  speaker=self._speaker(speaker))
        if mesh is not None:
            gen = stream_distributed(self.decode_weights(), self.cfg, mesh,
                                     self._seeds(seed, seeds), n, batch,
                                     local_y=local_y, **kw)
        elif local_y is not None:
            raise ValueError("local_y= is a mesh decode's input (mesh=)")
        else:
            gen = generate_stream(self.decode_weights(), self.cfg, n,
                                  batch=batch, seeds=self._seeds(seed, seeds),
                                  **kw)
        for toks in gen:
            yield mulaw.decode(toks, self.cfg.quantization_channels
                               ).cpu().numpy()

    def generate_wav(self, path: str, seconds: float, mel=None,
                     prime_tokens=None, **kw) -> np.ndarray:
        """Sample `seconds` of audio and write wav file(s) (path, or
        path_<i>.wav for batch > 1); the arguments of generate() (batch=,
        seed=, seeds=, temperature=, speaker=, mel=, y=).  Returns the
        [batch, T] float32 waveform."""
        from wavenet_tpu_torch.generate.sampler import write_wavs
        toks = self.generate(seconds=seconds, mel=mel,
                             prime_tokens=prime_tokens, **kw)
        return write_wavs(path, toks, self.cfg)

    def vocode(self, waveform, temperature: float = 1.0, seed: int = 0):
        """Re-synthesize audio through the model: log-mel features of
        `waveform` ([T] float, host numpy) -> generate conditioned on them.
        Returns [1, F * hop] int32 tokens, F = 1 + (T - 1) // hop frames."""
        from wavenet_tpu_torch.audio.mel import log_mel
        if self.cfg.mel is None:
            raise ValueError("vocode requires a mel-conditional model")
        mel = log_mel(np.asarray(waveform, np.float32), self.cfg.sample_rate,
                      self.cfg.mel)[None]
        n = mel.shape[1] * self.cfg.mel.hop_length
        return self.generate(num_samples=n, mel=mel, temperature=temperature,
                             seed=seed)

    def _cond(self, mel, y, prime_tokens, num_samples):
        """The decode's conditioning timeline: y as given, or mel upsampled
        (see _upsampled_cond); None for an unconditional model."""
        if y is not None and mel is not None:
            raise ValueError("pass either mel= (frames) or y= (upsampled)")
        if y is not None:
            if self.cfg.mel is None:
                raise ValueError("model is unconditional; y= is not an input")
            return y
        return self._upsampled_cond(mel, prime_tokens, num_samples)

    def _upsampled_cond(self, mel, prime_tokens, num_samples):
        """Upsampled features covering the priming steps too: the decoder
        consumes features for t in [0, max(P - 1, 0) + num_samples).  One
        definition for generate() and stream(), so the coverage rule
        cannot drift between the one-shot and streaming paths."""
        mel = self._mel(mel)
        if mel is None:
            return None
        P = 0 if prime_tokens is None else prime_tokens.shape[1]
        with torch.no_grad():
            return conditioning.upsample_mel(
                self.params["upsampler"], self.cfg.mel, mel,
                max(P - 1, 0) + num_samples)

    def _num_samples(self, seconds, num_samples) -> int:
        if num_samples is None:
            if seconds is None:
                raise ValueError("pass seconds= or num_samples=")
            num_samples = int(seconds * self.cfg.sample_rate)
        return int(num_samples)

    def _speaker(self, speaker) -> Optional[torch.Tensor]:
        """Speaker ids [batch] -> int32 on the model's device, ids outside
        [0, global_classes) refused (they index g_embed); None stays None,
        and the callee checks that ids come with a speaker model only."""
        if speaker is None:
            return None
        ids = torch.as_tensor(speaker).to(torch.int32).reshape(-1)
        C = self.cfg.global_classes
        if C is not None and ids.numel() and (int(ids.min()) < 0
                                              or int(ids.max()) >= C):
            raise ValueError(f"speaker ids must lie in [0, {C}); got "
                             f"[{int(ids.min())}, {int(ids.max())}]")
        return ids.to(self.device)

    def _seeds(self, seed, seeds):
        if seeds is None:
            return int(seed)
        return torch.as_tensor(seeds, dtype=torch.int32, device=self.device)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
