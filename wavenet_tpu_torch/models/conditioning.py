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

project_cond is the decode recipe of the gate contribution: operands in the
compute dtype (bf16 by default), each dot product summed in f64 (exact for
bf16) and rounded once to f32, as models/wavenet.py's _dot and the decode
kernels compute it.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from wavenet_tpu_torch.config import MelConfig, WaveNetConfig
from wavenet_tpu_torch.utils import profiling

# f32 products here must stay f32 on a GPU, never TF32 (models/wavenet.py
# sets the same flag)
torch.backends.cuda.matmul.allow_tf32 = False


def init_upsampler_params(mel: MelConfig, generator: torch.Generator,
                          device="cuda", dtype=torch.float32
                          ) -> Dict[str, torch.Tensor]:
    """Near-identity stages, the reference's shapes and distribution: every
    tap holds eye(M) / k plus N(0, 0.01^2 / (k M)) noise; zero biases.
    Drawn in f32 from `generator` (a CPU torch.Generator) and cast to
    `dtype` (the config's param_dtype, as the reference's
    init_upsampler_params(cfg.mel, key, pdt))."""
    M = mel.num_mels
    params = {}
    for i, f in enumerate(mel.upsample_factors):
        k = 2 * f + 1
        w = torch.zeros(k, M, M) + torch.eye(M)[None] / k
        w = w + 0.01 * torch.randn((k, M, M), generator=generator) \
            / (k * M) ** 0.5
        params[f"w{i}"] = w
        params[f"b{i}"] = torch.zeros(M)
    return {k: v.to(device=device, dtype=dtype) for k, v in params.items()}


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


def upsample_mel_train(params: Dict[str, torch.Tensor], mel_cfg: MelConfig,
                       mel: torch.Tensor, target_len: int) -> torch.Tensor:
    """upsample_mel in a step that takes gradients.  While a profiler runs
    it is recorded as "train.upsample" (utils/profiling): the forward
    (numbers dir 0) around its launches, and the backward (dir 1) from the
    arrival of the features' gradient (a hook on them) to the last tap's
    (a multi-grad hook on views of the upsampler's params: autograd.grad
    runs no hook of a leaf it returns), each with the device ms between
    its two ends on the stream.  The hooks pass every gradient through
    untouched; with no profiler running none is registered."""
    if not profiling.enabled() or not torch.is_grad_enabled():
        return upsample_mel(params, mel_cfg, mel, target_len)
    dev = mel.device
    taps = {k: v.view_as(v) for k, v in params.items() if v.requires_grad}
    start = profiling.device_mark(dev)
    y = upsample_mel(dict(params, **taps), mel_cfg, mel, target_len)
    profiling.device_interval("train.upsample", start,
                              profiling.device_mark(dev), dir=0)
    if not (y.requires_grad and taps):
        return y
    marks = []

    def arrived(grad):
        marks.append(profiling.device_mark(dev))

    def done(grads):
        if marks:
            profiling.device_interval("train.upsample", marks[0],
                                      profiling.device_mark(dev), dir=1)
    y.register_hook(arrived)
    torch.autograd.graph.register_multi_grad_hook(list(taps.values()), done)
    return y


def project_cond(params, y: torch.Tensor,
                 cdt: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Upsampled features [.., M] -> per-layer gate contributions
    [.., L, 2R] f32: y @ V_cond[l] for every layer, from operands rounded to
    the compute dtype cdt, each dot product summed in f64 and rounded once
    to f32.  params["v_cond"] may be the model's [L, M, 2, R] or the kernel
    layout [L, M, 2R]."""
    v = params["v_cond"]
    f64 = torch.float64
    v = v.to(cdt).to(f64).reshape(v.shape[0], v.shape[1], -1)
    out = torch.einsum("...m,lmn->...ln", y.to(cdt).to(f64), v)
    return out.to(torch.float32)


def prepare_decode_cond(params, cfg: WaveNetConfig, mel: torch.Tensor,
                        total_len: int) -> torch.Tensor:
    """[B, F, M] mel -> [B, total_len, L, 2R] per-step gate contributions
    for the plain decode loop (models/wavenet.generate, cond[:, t])."""
    from wavenet_tpu_torch.models.wavenet import compute_dtype
    y = upsample_mel(params["upsampler"], cfg.mel, mel, total_len)
    return project_cond(params, y, compute_dtype(cfg))
