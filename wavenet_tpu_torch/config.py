"""Typed configuration of the PyTorch port (pure Python, no framework).

A copy of wavenet_tpu/config.py: the same dataclasses, presets and JSON, so
a config written by either package loads in the other and `to_json()` is
byte-identical for every preset (tests/test_torch_foundations.py).  Fields
that steer JAX-only machinery (remat, fused_stack, decode_unroll, the mesh
axis sizes) are kept so the JSON round-trips; the port ignores them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Local-conditioning (mel spectrogram) config for the vocoder preset.

    WaveNet paper §2.5 eq.3: conditioning enters the gate as V_f*y and V_g*y
    where y is the upsampled conditioning signal.
    """

    num_mels: int = 80
    hop_length: int = 256          # audio samples per mel frame
    win_length: int = 1024
    fmin: float = 0.0
    fmax: float = 8000.0
    # Upsampling from mel frame-rate to sample-rate: product must equal
    # hop_length. Done with repeat + conv smoothing (cheap, MXU-friendly).
    upsample_factors: Tuple[int, ...] = (4, 8, 8)

    def __post_init__(self):
        prod = 1
        for f in self.upsample_factors:
            prod *= f
        if prod != self.hop_length:
            raise ValueError(
                f"prod(upsample_factors)={prod} must equal hop_length="
                f"{self.hop_length}")


@dataclasses.dataclass(frozen=True)
class WaveNetConfig:
    """Full model + training hyperparameters.

    Dilation schedule follows WaveNet paper §2.1 Fig 3: within a block the
    dilation doubles per layer (1, 2, 4, ..., max_dilation), and the block is
    repeated `num_blocks` times.
    """

    # --- quantization (paper §2.2) ---
    quantization_channels: int = 256   # mu-law classes
    sample_rate: int = 16000

    # --- conv stack (paper §2.1-2.4) ---
    num_blocks: int = 1
    max_dilation: int = 128            # dilations 1..max_dilation doubling
    # Causal conv width of the embed conv and every dilated conv (the RF
    # formula below).  The port serves kernel_size == 2 (the paper's and
    # every preset's value) and refuses wider kernels for now.
    kernel_size: int = 2
    residual_channels: int = 32
    skip_channels: int = 16
    # channels of the initial causal embedding conv; defaults to residual
    causal_channels: Optional[int] = None

    # --- conditioning (None => unconditional) ---
    mel: Optional[MelConfig] = None
    # global conditioning (paper §2.5 eq.2): a per-utterance class id (e.g.
    # speaker) embedded to global_channels and projected into every gate.
    # None => no global conditioning.
    global_classes: Optional[int] = None
    global_channels: int = 16

    # --- numerics ---
    compute_dtype: str = "bfloat16"    # activations/matmul inputs
    param_dtype: str = "float32"       # master weights
    # remat, fused_stack and decode_unroll steer the JAX package's training
    # and scan decoder; the port keeps them only so configs round-trip
    remat: bool = False
    fused_stack: bool = True
    decode_unroll: int = 1

    # --- training ---
    batch_size: int = 8
    train_window: int = 4096           # samples per training crop (incl. RF)
    learning_rate: float = 2e-4
    lr_schedule: str = "constant"      # constant | cosine | exponential
    lr_decay_steps: int = 200_000      # horizon for cosine/exponential
    lr_min_ratio: float = 0.1          # floor as fraction of peak lr
    warmup_steps: int = 0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    grad_clip_norm: Optional[float] = None
    # Gradient accumulation: each optimizer update averages the grads of
    # this many consecutive microbatches (optax.MultiSteps), so the
    # effective batch is grad_accum * batch_size while device memory holds
    # one microbatch's activations.  Composes with every parallel path —
    # the jitted step function is unchanged, only the optimizer wraps.
    grad_accum: int = 1
    # Polyak/EMA averaging of params (standard vocoder practice: sample from
    # the average, train on the raw weights).  None disables; typical 0.9999.
    ema_decay: Optional[float] = None
    seed: int = 0

    # --- parallelism (mesh axis sizes; 1 = disabled) ---
    data_parallel: int = 1
    # model sharding of the conv stack: channel (Megatron) sharding on the
    # XLA scan path; LAYER pipeline on the fused-kernel path when
    # num_blocks % model_parallel == 0 (parallel/pipeline.py)
    model_parallel: int = 1
    seq_parallel: int = 1              # time-axis halo sharding
    pipeline_microbatch: int = 1       # batch rows per fused-pipeline stage

    def __post_init__(self):
        if self.max_dilation & (self.max_dilation - 1):
            raise ValueError("max_dilation must be a power of two")
        if self.kernel_size < 2:
            raise ValueError("kernel_size must be >= 2")
        if self.grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")
        if self.decode_unroll < 1:
            raise ValueError("decode_unroll must be >= 1")

    # ---- derived quantities ----

    @property
    def dilations(self) -> Tuple[int, ...]:
        """Per-layer dilation list: num_blocks repetitions of 1..max_dilation."""
        ladder = []
        d = 1
        while d <= self.max_dilation:
            ladder.append(d)
            d *= 2
        return tuple(ladder) * self.num_blocks

    @property
    def num_layers(self) -> int:
        return len(self.dilations)

    @property
    def receptive_field(self) -> int:
        """RF = sum((k-1)*d) + 1 over all layers, + (k-1) for the causal embed
        conv (paper §2.1; SURVEY.md §4 RF formula)."""
        return (self.kernel_size - 1) * (sum(self.dilations) + 1) + 1

    @property
    def embed_channels(self) -> int:
        return self.causal_channels or self.residual_channels

    # ---- serialization (params-JSON parity with the reference) ----

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "WaveNetConfig":
        d = json.loads(s)
        mel = d.pop("mel", None)
        if mel is not None:
            mel["upsample_factors"] = tuple(mel["upsample_factors"])
            mel = MelConfig(**mel)
        return cls(mel=mel, **d)

    def replace(self, **kw) -> "WaveNetConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets — the six presets of the JAX package, unchanged.
# ---------------------------------------------------------------------------

def tiny() -> WaveNetConfig:
    """1 block, dilations 1..128, 32 residual/16 skip, CPU-runnable."""
    return WaveNetConfig(
        num_blocks=1, max_dilation=128,
        residual_channels=32, skip_channels=16,
        batch_size=4, train_window=2048,
    )


def small() -> WaveNetConfig:
    """2 blocks x dilations 1..512, 64 residual ch (LJSpeech-style)."""
    return WaveNetConfig(
        num_blocks=2, max_dilation=512,
        residual_channels=64, skip_channels=64,
        batch_size=8, train_window=8192,
    )


def full() -> WaveNetConfig:
    """4 blocks x dilations 1..512, 128 residual/256 skip (RF ~ 0.26s @16kHz)."""
    return WaveNetConfig(
        num_blocks=4, max_dilation=512,
        residual_channels=128, skip_channels=256,
        batch_size=8, train_window=8192, remat=True,
    )


def fastgen_bench() -> WaveNetConfig:
    """Cached-queue AR sampling benchmark: 24kHz, batch-64 parallel decode."""
    return WaveNetConfig(
        num_blocks=2, max_dilation=512,
        residual_channels=64, skip_channels=128,
        sample_rate=24000, batch_size=64, train_window=8192,
    )


def conditional() -> WaveNetConfig:
    """Mel-conditioned Tacotron-style vocoder, shardable across chips."""
    return WaveNetConfig(
        num_blocks=2, max_dilation=512,
        residual_channels=64, skip_channels=128,
        mel=MelConfig(), batch_size=8, train_window=8192,
    )


def full_vocoder() -> WaveNetConfig:
    """Flagship-quality vocoder: the `full` stack + mel conditioning (the
    realistic TTS product).  Mel conditioning is not served by the port
    yet; the preset is here so configs round-trip."""
    return WaveNetConfig(
        num_blocks=4, max_dilation=512,
        residual_channels=128, skip_channels=256,
        mel=MelConfig(), batch_size=8, train_window=8192, remat=True,
    )


PRESETS = {
    "tiny": tiny,
    "small": small,
    "full": full,
    "fastgen_bench": fastgen_bench,
    "conditional": conditional,
    "full_vocoder": full_vocoder,
}


def get_config(name: str) -> WaveNetConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
