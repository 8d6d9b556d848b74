"""The unconditional yardstick pinned: weights.make and every roofline count
of the `full` and `fastgen_bench` configurations equal a frozen copy of
the functions as they were before conditioning was counted, leaf for leaf
and value for value; and the conditioned counts by hand."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import roofline, sizes, weights

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
BF16, F32, I32 = 2, 4, 4


def _model(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


def _sizes(name: str, **over) -> sizes.Sizes:
    return sizes.Sizes.from_model(dict(_model(name), **over))


# -- the frozen copy ---------------------------------------------------------

def frozen_make(z, seed, device, param_dtype="float32"):
    L, R, S, Q = z.L, z.R, z.S, z.Q
    shp = {"embed_cur": (Q, R), "embed_prev": (Q, R),
           "w_cur": (L, R, 2, R), "w_prev": (L, R, 2, R), "b": (L, 2, R),
           "w_res": (L, R, R), "b_res": (L, R), "w_skip": (L, R, S),
           "b_skip": (L, S), "head_w1": (S, S), "head_b1": (S,),
           "head_w2": (S, Q), "head_b2": (Q,)}
    normal_k = ("embed_cur", "embed_prev")
    glorot_k = ("w_cur", "w_prev", "w_res", "w_skip", "head_w1", "head_w2")
    numel = {k: int(torch.Size(s).numel()) for k, s in shp.items()}
    g = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(sum(numel[k] for k in normal_k), generator=g,
                         device=device) * 0.05
    uniform = torch.rand(sum(numel[k] for k in glorot_k), generator=g,
                         device=device) * 2.0 - 1.0
    out, i, j = {}, 0, 0
    for k in normal_k:
        out[k] = normal[i:i + numel[k]].view(shp[k])
        i += numel[k]
    for k in glorot_k:
        s = shp[k]
        fan_in = s[-3] if len(s) >= 4 else s[-2]
        out[k] = uniform[j:j + numel[k]].view(s) * (
            6.0 / (fan_in + s[-1])) ** 0.5
        j += numel[k]
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    return {k: (out[k] if k in out else torch.zeros(shp[k], device=device)
                ).to(dt).contiguous() for k in shp}


def frozen_counts(z, launches, rows, row_steps) -> dict:
    layer = 2 * (z.K * z.R * 2 * z.R + z.R * z.R + z.R * z.S)
    head = 2 * (z.S * z.S + z.S * z.Q)
    fwd_tok = z.L * layer + head
    stack_fwd = z.L * layer * z.batch * z.window
    sw = z.L * (z.K * z.R * 2 * z.R + z.R * (z.R + z.S))
    sb = z.L * (2 * z.R + z.R + z.S)
    M = z.batch * z.window
    ring = sum(d * (z.K - 1) for d in z.dilations)
    wts = (sw + z.S * z.S + z.S * z.Q) * BF16 \
        + (2 * z.Q * z.R + sb + z.S + z.Q) * F32
    return {
        "layer_flops": layer, "head_flops": head,
        "forward_flops_per_token": fwd_tok,
        "train_flops_per_step": 3 * fwd_tok * z.batch * z.window,
        "stack_fwd_flops": stack_fwd, "stack_bwd_flops": 2 * stack_fwd,
        "stack_weights": sw, "stack_biases": sb,
        "stack_fwd_bytes": (M * z.R * BF16 + sw * BF16 + sb * F32
                            + M * z.S * F32),
        "stack_bwd_bytes": (M * z.S * F32 + M * z.R * BF16 + sw * BF16
                            + M * z.R * F32 + (sw + sb) * F32),
        "ring_rows": ring,
        "decode_flops": fwd_tok * row_steps,
        "decode_bytes": (launches * wts
                         + rows * (2 * ring * z.R * BF16 + 2 * I32)
                         + row_steps * I32),
    }


def counts(z, launches, rows, row_steps) -> dict:
    out = {k: getattr(roofline, k)(z) for k in (
        "layer_flops", "head_flops", "forward_flops_per_token",
        "train_flops_per_step", "stack_fwd_flops", "stack_bwd_flops",
        "stack_weights", "stack_biases", "stack_fwd_bytes",
        "stack_bwd_bytes", "ring_rows")}
    out["decode_flops"] = roofline.decode_flops(z, row_steps)
    out["decode_bytes"] = roofline.decode_bytes(z, launches, rows,
                                                row_steps)
    return out


# -- the pins -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["full", "fastgen_bench"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_unconditional_weights_equal_the_frozen_copy(name, param_dtype):
    z = _sizes(name)
    assert (z.M, z.C, z.G, z.hop, z.upsample) == (0, 0, 0, 1, ())
    new = weights.make(z, 2 ** 31 + 11, "cpu", param_dtype)
    old = frozen_make(z, 2 ** 31 + 11, "cpu", param_dtype)
    assert list(new) == list(old)
    for k in old:
        assert new[k].dtype == old[k].dtype, k
        assert torch.equal(new[k], old[k]), k
    assert weights.nested(new) == new


@pytest.mark.parametrize("name", ["full", "fastgen_bench"])
@pytest.mark.parametrize("launches, rows, row_steps", [
    (1, 4, 4 * 8000), (37.25, 512.5, 4_100_000.75), (0, 0, 0)])
def test_unconditional_counts_equal_the_frozen_copy(name, launches, rows,
                                                    row_steps):
    z = _sizes(name)
    assert counts(z, launches, rows, row_steps) == \
        frozen_counts(z, launches, rows, row_steps)
    assert roofline.upsample_flops_per_token(z) == 0
    assert roofline.speaker_flops_per_row(z) == 0
    assert roofline.offsets(z) == 0


def test_mel_counts_by_hand():
    """full_vocoder: full with 80 mels, hop 256 = 4 x 8 x 8."""
    from wavenet_tpu_torch.config import full_vocoder
    z = sizes.Sizes.from_model(json.loads(full_vocoder().to_json()))
    base = _sizes("full")
    assert roofline.layer_flops(z) == 229_376 + 2 * 80 * 256 == 270_336
    # stages' taps x M^2 x their output samples a frame: 4, 32, 256
    assert roofline.upsample_flops_per_frame(z) == (
        2 * 9 * 6400 * 4 + 2 * 17 * 6400 * 32 + 2 * 17 * 6400 * 256)
    assert roofline.upsample_flops_per_token(z) == pytest.approx(246_600)
    assert roofline.kernel_flops_per_token(z) == 11_075_584
    assert roofline.forward_flops_per_token(z) == pytest.approx(11_322_184)
    assert roofline.train_flops_per_step(z) == pytest.approx(
        3 * 11_322_184 * 8 * 8192)
    assert roofline.stack_bwd_flops(z) == 2 * roofline.stack_fwd_flops(z)
    assert roofline.decode_flops(z, 1000) == 11_075_584_000
    # y [B, W, 80] bf16 in and V_cond [40, 80, 256] bf16; the backward also
    # writes dy f32 and dV_cond f32
    y, vc = 8 * 8192 * 80, 40 * 80 * 256
    assert roofline.stack_fwd_bytes(z) - roofline.stack_fwd_bytes(base) \
        == y * BF16 + vc * BF16
    assert roofline.stack_bwd_bytes(z) - roofline.stack_bwd_bytes(base) \
        == y * BF16 + vc * BF16 + y * F32 + vc * F32
    # decode: V_cond once a launch, the features once a (row, step)
    assert roofline.decode_bytes(z, 1, 4, 32_000) \
        - roofline.decode_bytes(base, 1, 4, 32_000) \
        == vc * BF16 + 32_000 * 80 * BF16


def test_speaker_counts_by_hand():
    """full with 8 speakers, global_channels 16."""
    z = _sizes("full", global_classes=8)
    base = _sizes("full")
    assert roofline.speaker_flops_per_row(z) == 2 * 16 * 256 * 40 == 327_680
    assert roofline.forward_flops_per_token(z) == \
        roofline.forward_flops_per_token(base)
    assert roofline.train_flops_per_step(z) \
        - roofline.train_flops_per_step(base) == 3 * 327_680 * 8
    off = 8 * 40 * 256                      # [B, L, 2R] f32
    assert roofline.stack_fwd_bytes(z) - roofline.stack_fwd_bytes(base) \
        == off * F32
    assert roofline.stack_bwd_bytes(z) - roofline.stack_bwd_bytes(base) \
        == 2 * off * F32
    assert roofline.decode_flops(z, 1000) == roofline.decode_flops(base, 1000)
    assert roofline.decode_bytes(z, 2, 4, 32_000) \
        - roofline.decode_bytes(base, 2, 4, 32_000) == 4 * 40 * 256 * F32
