"""WaveNet's forward and loss, plain PyTorch.

    e_t = E_cur[x_t] + E_prev[x_{t-1}]            (x_{-1} = class 0)
    z = h_t W_cur + h_{t-d} W_prev + b            (h before the start = 0)
        [+ y_t V_cond]        with mel, y the upsampled frames
        [+ g_embed[s] V_global]     with speakers, s the row's id
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

The upsampler (arXiv 1609.03499 section 2.5: the mel frames brought to the
sample rate), stage i of factor f: a nearest repeat by f, then a SAME time
convolution of width k = 2f + 1, out[t] = sum_j y[t + j - f] W_i[j] + b_i
(zeros outside the sequence).  Every conditioning product goes through
`matmul` in the run's precision, as the stack's products do.
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


def upsample(w: Weights, mel: torch.Tensor, T: int,
             precision: str = "float32") -> torch.Tensor:
    """[B, F, M] mel frames -> [B, T, M] sample-rate features (the F * hop
    upsampled samples cut to their first T <= F * hop)."""
    dt, p = _dtype(precision), precision
    y = mel.to(dt)
    i = 0
    while f"upsampler/w{i}" in w:
        wi, bi = w[f"upsampler/w{i}"].to(dt), w[f"upsampler/b{i}"].to(dt)
        k = wi.shape[0]
        f = (k - 1) // 2
        y = torch.repeat_interleave(y, f, dim=1)
        n = y.shape[1]
        yp = F.pad(y, (0, 0, f, f))
        out = matmul(yp[:, :n], wi[0], p)
        for j in range(1, k):
            out = out + matmul(yp[:, j:j + n], wi[j], p)
        y = out + bi
        i += 1
    if y.shape[1] < T:
        raise ValueError(f"{mel.shape[1]} frames upsample to {y.shape[1]} "
                         f"< {T} samples")
    return y[:, :T]


def features(w: Weights, frames, lengths, T: int,
             precision: str = "float32") -> torch.Tensor:
    """[len(frames), T, M] features of rows of their own lengths: row i
    from frames[i] ([F_i, M]) upsampled alone to lengths[i] samples, zeros
    after them."""
    rows = []
    for fr, n in zip(frames, lengths):
        y = upsample(w, torch.as_tensor(fr)[None].to(w["v_cond"].device),
                     n, precision)[0]
        rows.append(F.pad(y, (0, 0, 0, T - n)))
    return torch.stack(rows)


def logits(w: Weights, dilations, tokens: torch.Tensor,
           precision: str = "float32", mel: Optional[torch.Tensor] = None,
           y: Optional[torch.Tensor] = None,
           speaker: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T] int tokens -> [B, T, Q] logits (float64 in that precision,
    else float32); logits[:, t] is the distribution of the token after
    tokens[:, t].  A mel model takes mel [B, F, M] frames (F * hop >= T),
    or y [B, T, M] features already upsampled; a speaker model takes
    speaker [B] ids."""
    dt, p = _dtype(precision), precision
    f = lambda k: w[k].to(dt)
    r = _bf16 if p == "bfloat16" else (lambda t: t)
    prev = F.pad(tokens, (1, 0))[:, :-1]
    x = r(f("embed_cur")[tokens.long()] + f("embed_prev")[prev.long()])
    R = x.shape[-1]
    if mel is not None:
        y = upsample(w, mel, tokens.shape[1], precision)
    gvec = None if speaker is None else f("g_embed")[speaker.long()]
    skip = None
    for l, d in enumerate(dilations):
        z = (matmul(x, f("w_cur")[l].reshape(R, 2 * R), p)
             + matmul(_shift(x, d), f("w_prev")[l].reshape(R, 2 * R), p)
             + f("b")[l].reshape(2 * R))
        if y is not None:
            z = z + matmul(y.to(dt), f("v_cond")[l].reshape(-1, 2 * R), p)
        if gvec is not None:
            z = z + matmul(gvec, f("v_global")[l].reshape(-1, 2 * R),
                           p)[:, None, :]
        a = r(torch.tanh(z[..., :R]) * torch.sigmoid(z[..., R:]))
        s = matmul(a, f("w_skip")[l], p) + f("b_skip")[l]
        skip = s if skip is None else skip + s
        x = r(x + matmul(a, f("w_res")[l], p) + f("b_res")[l])
    h = torch.relu(matmul(torch.relu(skip), f("head_w1"), p)
                   + f("head_b1"))
    return matmul(h, f("head_w2"), p) + f("head_b2")


def nll_sum(w: Weights, dilations, window: torch.Tensor,
            precision: str = "float32", mel: Optional[torch.Tensor] = None,
            speaker: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Summed next-sample cross-entropy of [B, W+1] token windows (inputs
    window[:, :-1], targets window[:, 1:]; mel: the frames of the W
    inputs)."""
    lg = logits(w, dilations, window[:, :-1], precision, mel=mel,
                speaker=speaker)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           window[:, 1:].reshape(-1).long(),
                           reduction="sum")


def loss_and_grads(w: Weights, dilations, window: torch.Tensor,
                   rows: Optional[int] = None, precision: str = "float32",
                   mel: Optional[torch.Tensor] = None,
                   speaker: Optional[torch.Tensor] = None):
    """(mean loss, {leaf: gradient}) over [B, W+1] windows (with their
    [B, F, M] mel frames and [B] speaker ids), `rows` batch rows at a time
    (the gradient of the whole mean, summed block by block)."""
    B = window.shape[0]
    n = window.shape[0] * (window.shape[1] - 1)
    rows = rows or B
    dt = _dtype(precision)
    leaves = {k: v.detach().to(dt).requires_grad_(True)
              for k, v in w.items()}
    total = 0.0
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for i in range(0, B, rows):
        part = nll_sum(leaves, dilations, window[i:i + rows], precision,
                       None if mel is None else mel[i:i + rows],
                       None if speaker is None else speaker[i:i + rows]) / n
        gs = torch.autograd.grad(part, list(leaves.values()))
        for k, g in zip(leaves, gs):
            grads[k] += g
        total += float(part.detach())
    return total, grads
