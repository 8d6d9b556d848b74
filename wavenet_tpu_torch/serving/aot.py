"""Ahead-of-time decoder artifacts (torch.export).

Counterpart of wavenet_tpu/serving/aot.py.  A deployment artifact freezes
the decode of one model at fixed shapes, so a serving host needs only this
loader and the file: no WaveNet is constructed at boot, no parameter is
initialised and no checkpoint is read.

Artifact layout (one .zip, conventionally *.wnx), the reference's:
  exported.pt2   torch.export.save bytes of forward(params, seeds[, mel]
                 [, speaker])
  weights.npz    flat '/'-joined parameter arrays (either package's
                 utils/pytree_io.unflatten_tree reads them)
  config.json    WaveNetConfig JSON
  meta.json      {num_samples, batch, temperature, with_speaker, with_mel,
                  mel_frames, platforms, kernel_sources}

What the program computes: for a mel model, the static [batch, mel_frames,
M] features upsampled (models/conditioning.upsample_mel), then one call of
the registered op torch.ops.wavenet_tpu_torch.generate
(ops/cuda/decode_op.py), whose body is generate/sampler.generate_auto.  So
on the card an artifact runs the hand-written whole-loop kernel the model's
widths select (the narrow or the wide one), one launch per generate call,
and on the CPU that kernel's plain version; the kernels build from csrc/ on
the serving host at first use.  Here the port departs from the reference,
whose artifact freezes its XLA scan and leaves the Pallas kernel out,
because a Mosaic payload is bound to a libtpu version
(wavenet_tpu/serving/aot.py:18-21).

Baked in at export: num_samples, batch and temperature, and for a mel
model mel_frames = ceil(num_samples / hop_length).  Runtime inputs: the
[batch] counter-RNG row seeds (the port has no JAX key: generate(seed=s)
uses ops/rng.as_row_seeds(s, batch), as the port's generate CLI treats
--seed), the mel features of a mel model and the speaker ids of a speaker
model.  `platforms` is "cpu" and/or "cuda", the devices load_decoder may
put the program on; TPU lowering is the JAX package's.
"""

from __future__ import annotations

import io
import json
import math
import zipfile
from typing import Optional

import numpy as np
import torch

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models.conditioning import upsample_mel
from wavenet_tpu_torch.ops import rng
# decode_op registers torch.ops.wavenet_tpu_torch.generate
from wavenet_tpu_torch.ops.cuda import build, decode_op  # noqa: F401
from wavenet_tpu_torch.utils.pytree_io import (flatten_tree, load_npz,
                                               params_from_numpy,
                                               params_to_numpy, save_npz,
                                               unflatten_tree)

_EXPORTED = "exported.pt2"
_WEIGHTS = "weights.npz"
_CONFIG = "config.json"
_META = "meta.json"
PLATFORMS = ("cpu", "cuda")


class _Decoder(torch.nn.Module):
    """forward(params, seeds[, mel][, speaker]) -> [batch, num_samples]
    int32 tokens: the computation an artifact freezes."""

    def __init__(self, cfg: WaveNetConfig, num_samples: int,
                 temperature: float):
        super().__init__()
        self.cfg, self.cfg_json = cfg, cfg.to_json()
        self.num_samples, self.temperature = num_samples, temperature

    def forward(self, params, seeds, *opt):
        opt = list(opt)
        y = None
        if self.cfg.mel is not None:
            y = upsample_mel(params["upsampler"], self.cfg.mel, opt.pop(0),
                             self.num_samples)
        speaker = opt.pop(0) if self.cfg.global_classes is not None else None
        flat = flatten_tree(params)
        return torch.ops.wavenet_tpu_torch.generate(
            [flat[k] for k in sorted(flat)], seeds, y, speaker,
            self.num_samples, self.temperature, self.cfg_json)


def _check_platforms(platforms) -> tuple:
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(
            f"platforms {tuple(platforms)}: an artifact of the port runs on "
            f"{PLATFORMS} (the decode kernels on cuda, their plain versions "
            f"on cpu); TPU lowering is the JAX package's "
            f"(wavenet_tpu.serving.export_decoder)")
    return tuple(platforms)


def _sorted_tree(params) -> dict:
    """params with its keys in sorted '/'-joined order at every level: the
    one input structure an export and a load both build."""
    flat = flatten_tree(params)
    return unflatten_tree({k: flat[k] for k in sorted(flat)})


def export_decoder(params, cfg: WaveNetConfig, path: str, *,
                   num_samples: int, batch: int = 1,
                   temperature: float = 1.0,
                   platforms: Optional[tuple] = None) -> None:
    """Serialize a decode artifact of params (the port's nested params dict
    of tensors) to `path`.

    num_samples, batch and temperature are baked into the exported program
    (static shapes); the [batch] row seeds, plus the mel features [batch,
    mel_frames, M] when cfg.mel is set and the speaker ids when
    cfg.global_classes is set, stay runtime inputs.  `platforms` names the
    devices the artifact may be loaded on, from ("cpu", "cuda"); the
    default is the device the params lie on, where the export runs.
    """
    params = _sorted_tree(params)
    dev = params["w_cur"].device
    platforms = _check_platforms((dev.type,) if platforms is None
                                 else tuple(platforms))
    with_speaker = cfg.global_classes is not None
    with_mel = cfg.mel is not None
    # smallest frame count whose upsampling covers num_samples
    mel_frames = math.ceil(num_samples / cfg.mel.hop_length) if with_mel else 0
    example = [params, torch.zeros(batch, dtype=torch.int32, device=dev)]
    if with_mel:
        example.append(torch.zeros(batch, mel_frames, cfg.mel.num_mels,
                                   device=dev))
    if with_speaker:
        example.append(torch.zeros(batch, dtype=torch.int32, device=dev))
    with torch.no_grad():
        exported = torch.export.export(
            _Decoder(cfg, num_samples, float(temperature)), tuple(example))
    # the example params would otherwise be saved inside the program too
    exported.example_inputs = None
    pbuf = io.BytesIO()
    torch.export.save(exported, pbuf)

    wbuf = io.BytesIO()
    save_npz(wbuf, params_to_numpy(flatten_tree(params)))
    meta = {"num_samples": num_samples, "batch": batch,
            "temperature": temperature, "with_speaker": with_speaker,
            "with_mel": with_mel, "mel_frames": mel_frames,
            "platforms": list(platforms),
            "kernel_sources": build.sources_hash()}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_EXPORTED, pbuf.getvalue())
        z.writestr(_WEIGHTS, wbuf.getvalue())
        z.writestr(_CONFIG, cfg.to_json())
        z.writestr(_META, json.dumps(meta))


class AotDecoder:
    """A loaded artifact: weights + the exported decode program, on one
    device.

    generate(seed=..., seeds=..., mel=..., speaker=...) -> [batch,
    num_samples] int32 tokens on the device; waveform(...) -> float32 audio
    in [-1, 1] (mu-law expanded).  The port has no JAX key: seed keys the
    counter RNG through ops/rng.as_row_seeds(seed, batch), and seeds= takes
    [batch] per-row seeds instead (each row's audio then depends only on
    its seed).  Mel-exported artifacts take mel as [batch, mel_frames, M]
    (or [mel_frames, M], broadcast over the batch): the static frame count
    baked at export (meta mel_frames).
    """

    def __init__(self, cfg: WaveNetConfig, params, program, meta: dict,
                 device: torch.device):
        self.cfg = cfg
        self.params = params
        self._program = program
        self.device = device
        self.num_samples = int(meta["num_samples"])
        self.batch = int(meta["batch"])
        self.temperature = float(meta["temperature"])
        self.with_speaker = bool(meta["with_speaker"])
        self.with_mel = bool(meta.get("with_mel", False))
        self.mel_frames = int(meta.get("mel_frames", 0))
        self.platforms = tuple(meta.get("platforms", ()))

    def generate(self, seed: int = 0, seeds=None, speaker=None,
                 mel=None) -> torch.Tensor:
        row = rng.as_row_seeds(
            seed if seeds is None else torch.as_tensor(seeds), self.batch,
            self.device)
        args = [self.params, row]
        if self.with_mel:
            if mel is None:
                raise ValueError("artifact was exported with mel "
                                 "conditioning; pass mel=")
            mel = torch.as_tensor(mel, dtype=torch.float32,
                                  device=self.device)
            if mel.dim() == 2:
                mel = mel.expand((self.batch,) + tuple(mel.shape))
            want = (self.batch, self.mel_frames, self.cfg.mel.num_mels)
            if tuple(mel.shape) != want:
                raise ValueError(f"mel must be {want} (static export "
                                 f"shape); got {tuple(mel.shape)}")
            args.append(mel.contiguous())
        elif mel is not None:
            raise ValueError("artifact was exported without mel "
                             "conditioning; mel= is not an input")
        if self.with_speaker:
            if speaker is None:
                speaker = np.zeros((self.batch,), np.int32)
            args.append(torch.as_tensor(speaker).to(torch.int32)
                        .reshape(self.batch).to(self.device))
        elif speaker is not None:
            raise ValueError("artifact was exported without global "
                             "conditioning; speaker= is not an input")
        with torch.no_grad():
            return self._program(*args)

    def waveform(self, seed: int = 0, seeds=None, speaker=None,
                 mel=None) -> np.ndarray:
        from wavenet_tpu_torch.audio import mulaw
        toks = self.generate(seed=seed, seeds=seeds, speaker=speaker,
                             mel=mel).cpu().numpy()
        return mulaw.decode_np(toks, self.cfg.quantization_channels)


def _traced_on(exported) -> set:
    """The devices of the exported program's inputs."""
    return {n.meta["val"].device for n in exported.graph.nodes
            if n.op == "placeholder" and isinstance(n.meta.get("val"),
                                                    torch.Tensor)}


def load_decoder(path: str, device="cuda") -> AotDecoder:
    """Load an artifact written by export_decoder onto `device`, which must
    be of a type the artifact was exported for (meta platforms)."""
    from torch.export.passes import move_to_device_pass
    dev = torch.device(device)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read(_META).decode())
        if dev.type not in meta["platforms"]:
            raise ValueError(f"artifact was exported for platforms "
                             f"{tuple(meta['platforms'])}; cannot load it "
                             f"on {dev.type}")
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("load_decoder(device='cuda') needs a CUDA "
                                   "device; none is available")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        cfg = WaveNetConfig.from_json(z.read(_CONFIG).decode())
        exported = torch.export.load(io.BytesIO(z.read(_EXPORTED)))
        params = _sorted_tree(params_from_numpy(
            load_npz(io.BytesIO(z.read(_WEIGHTS))), dev))
    if _traced_on(exported) != {dev}:
        exported = move_to_device_pass(exported, dev)
    return AotDecoder(cfg, params, exported.module(), meta, dev)
