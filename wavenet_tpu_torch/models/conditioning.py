"""Mel-spectrogram local conditioning (WaveNet paper arXiv:1609.03499 §2.5).

Counterpart of wavenet_tpu/models/conditioning.py.  The conditioning signal
(mel frames at sample_rate / hop) is upsampled to the sample rate and
enters every gate as y @ V_cond[l] (paper eq.3).

Upsampler: a chain of stages whose factors multiply to hop_length, each a
nearest repeat by f followed by a SAME-padded time convolution of width
k = 2f + 1 (weights [k, M, M], the reference's WIO layout).  Each
convolution is written as k shifted [.., M] @ [M, M] products summed in
f32, not as a cuDNN convolution: cuDNN's default TF32 and its
weight-gradient atomics would change the bits from run to run and break
exact resume, while the products here are f32 GEMMs (TF32 off) with fixed
summation orders and deterministic backwards.  It stays plain PyTorch on
every device: the upsampler is outside the reference's Pallas kernels.

project_cond is the decode recipe of the gate contribution: bf16 operands,
each dot product summed exactly (f64) and rounded once to f32, as
models/wavenet.py's _dot and the decode kernel compute it.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from wavenet_tpu_torch.config import MelConfig, WaveNetConfig

# f32 products here must stay f32 on a GPU, never TF32 (models/wavenet.py
# sets the same flag)
torch.backends.cuda.matmul.allow_tf32 = False


def init_upsampler_params(mel: MelConfig, generator: torch.Generator,
                          device="cuda") -> Dict[str, torch.Tensor]:
    """Near-identity stages, the reference's shapes and distribution: every
    tap holds eye(M) / k plus N(0, 0.01^2 / (k M)) noise; zero biases.
    Drawn from `generator` (a CPU torch.Generator)."""
    M = mel.num_mels
    params = {}
    for i, f in enumerate(mel.upsample_factors):
        k = 2 * f + 1
        w = torch.zeros(k, M, M) + torch.eye(M)[None] / k
        w = w + 0.01 * torch.randn((k, M, M), generator=generator) \
            / (k * M) ** 0.5
        params[f"w{i}"] = w
        params[f"b{i}"] = torch.zeros(M)
    return {k: v.to(device) for k, v in params.items()}


def _repeat(y: torch.Tensor, f: int) -> torch.Tensor:
    """Nearest repeat along time: [B, T, M] -> [B, T f, M] (an expand, whose
    backward is a sum over the copies, not an index scatter)."""
    B, T, M = y.shape
    return y[:, :, None, :].expand(B, T, f, M).reshape(B, T * f, M)


def _conv_same(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """SAME-padded time convolution (cross-correlation, as lax.conv):
    out[t] = sum_j y[t + j - (k-1)/2] @ w[j] + b, w [k, M, M] (odd k)."""
    k, T = w.shape[0], y.shape[1]
    p = (k - 1) // 2
    yp = F.pad(y, (0, 0, p, k - 1 - p))
    out = yp[:, 0:T] @ w[0]
    for j in range(1, k):
        out = out + yp[:, j:j + T] @ w[j]
    return out + b


def upsample_mel(params: Dict[str, torch.Tensor], mel_cfg: MelConfig,
                 mel: torch.Tensor, target_len: int) -> torch.Tensor:
    """[B, F, M] mel frames -> [B, target_len, M] f32 sample-rate features."""
    y = mel.float()
    for i, f in enumerate(mel_cfg.upsample_factors):
        y = _conv_same(_repeat(y, f), params[f"w{i}"].float(),
                       params[f"b{i}"].float())
    if y.shape[1] < target_len:
        raise ValueError(
            f"upsampled mel length {y.shape[1]} < target {target_len}")
    return y[:, :target_len, :]


def project_cond(params, y: torch.Tensor) -> torch.Tensor:
    """Upsampled features [.., M] -> per-layer gate contributions
    [.., L, 2R] f32: y @ V_cond[l] for every layer, from bf16 operands, each
    dot product the exact f64 sum rounded once to f32.  params["v_cond"]
    may be the model's [L, M, 2, R] or the kernel layout [L, M, 2R]."""
    v = params["v_cond"]
    f64 = torch.float64
    v = v.to(torch.bfloat16).to(f64).reshape(v.shape[0], v.shape[1], -1)
    out = torch.einsum("...m,lmn->...ln", y.to(torch.bfloat16).to(f64), v)
    return out.to(torch.float32)


def prepare_decode_cond(params, cfg: WaveNetConfig, mel: torch.Tensor,
                        total_len: int) -> torch.Tensor:
    """[B, F, M] mel -> [B, total_len, L, 2R] per-step gate contributions
    for the plain decode loop (models/wavenet.generate, cond[:, t])."""
    y = upsample_mel(params["upsampler"], cfg.mel, mel, total_len)
    return project_cond(params, y)
