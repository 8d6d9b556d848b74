"""WaveNet's forward and loss, plain PyTorch.

    e_t = E_cur[x_t] + E_prev[x_{t-1}]            (x_{-1} = class 0)
    z = h_t W_cur + h_{t-d} W_prev + b            (h before the start = 0)
    a = tanh(z_f) * sigmoid(z_g)
    skip += a W_skip + b_skip;  h = h + a W_res + b_res
    logits = relu(relu(skip) W_1 + b_1) W_2 + b_2

in `precision`: "float32", every product a plain matmul (TF32 off);
"float64", the same in double, a witness of the float32 reference's own
rounding; "bfloat16", the configurations' compute dtype as the port states
it, a witness of what that rounding does: each product's operands, the
gate's output and the residual stream rounded to bf16 (and, through
autograd's casts, their cotangents), the products summed in f32; "fp8",
the control, each product's operands in fp8 (`_Fp8Matmul`).  Weights are
the flat leaves of weights.make, under the port's names and shapes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _scaled(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to an fp8 dtype under one per-tensor scale (its largest
    magnitude to the dtype's largest value), held in float32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = amax / top
    return (x / s).to(dtype).to(torch.float32) * s


class _Fp8Matmul(torch.autograd.Function):
    """a @ w with both operands in e4m3 and, in the backward, the incoming
    cotangent in e5m2 (the usual fp8 training recipe), products in f32."""

    @staticmethod
    def forward(ctx, a, w):
        qa = _scaled(a, torch.float8_e4m3fn, 448.0)
        qw = _scaled(w, torch.float8_e4m3fn, 448.0)
        ctx.save_for_backward(qa, qw)
        return qa @ qw

    @staticmethod
    def backward(ctx, g):
        qa, qw = ctx.saved_tensors
        qg = _scaled(g, torch.float8_e5m2, 57344.0)
        ga = qg @ qw.T
        gw = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        return ga, gw


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def matmul(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8Matmul.apply(a, w)
    if precision == "bfloat16":
        return _bf16(a) @ _bf16(w)
    return a @ w


def _dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


def _shift(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[:, t - d] with zeros before the start."""
    return F.pad(x, (0, 0, d, 0))[:, :x.shape[1]]


def logits(w: Weights, dilations, tokens: torch.Tensor,
           precision: str = "float32") -> torch.Tensor:
    """[B, T] int tokens -> [B, T, Q] logits (float64 in that precision,
    else float32); logits[:, t] is the distribution of the token after
    tokens[:, t]."""
    dt, p = _dtype(precision), precision
    f = lambda k: w[k].to(dt)
    r = _bf16 if p == "bfloat16" else (lambda t: t)
    prev = F.pad(tokens, (1, 0))[:, :-1]
    x = r(f("embed_cur")[tokens.long()] + f("embed_prev")[prev.long()])
    R = x.shape[-1]
    skip = None
    for l, d in enumerate(dilations):
        z = (matmul(x, f("w_cur")[l].reshape(R, 2 * R), p)
             + matmul(_shift(x, d), f("w_prev")[l].reshape(R, 2 * R), p)
             + f("b")[l].reshape(2 * R))
        a = r(torch.tanh(z[..., :R]) * torch.sigmoid(z[..., R:]))
        s = matmul(a, f("w_skip")[l], p) + f("b_skip")[l]
        skip = s if skip is None else skip + s
        x = r(x + matmul(a, f("w_res")[l], p) + f("b_res")[l])
    h = torch.relu(matmul(torch.relu(skip), f("head_w1"), p)
                   + f("head_b1"))
    return matmul(h, f("head_w2"), p) + f("head_b2")


def nll_sum(w: Weights, dilations, window: torch.Tensor,
            precision: str = "float32") -> torch.Tensor:
    """Summed next-sample cross-entropy of [B, W+1] token windows (inputs
    window[:, :-1], targets window[:, 1:])."""
    lg = logits(w, dilations, window[:, :-1], precision)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           window[:, 1:].reshape(-1).long(),
                           reduction="sum")


def loss_and_grads(w: Weights, dilations, window: torch.Tensor,
                   rows: Optional[int] = None, precision: str = "float32"):
    """(mean loss, {leaf: gradient}) over [B, W+1] windows, `rows` batch
    rows at a time (the gradient of the whole mean, summed block by
    block)."""
    B = window.shape[0]
    n = window.shape[0] * (window.shape[1] - 1)
    rows = rows or B
    dt = _dtype(precision)
    leaves = {k: v.detach().to(dt).requires_grad_(True)
              for k, v in w.items()}
    total = 0.0
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for i in range(0, B, rows):
        part = nll_sum(leaves, dilations, window[i:i + rows],
                       precision) / n
        gs = torch.autograd.grad(part, list(leaves.values()))
        for k, g in zip(leaves, gs):
            grads[k] += g
        total += float(part.detach())
    return total, grads
