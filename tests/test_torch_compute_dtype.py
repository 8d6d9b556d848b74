"""compute_dtype in the port, and the decode routes by width.

At compute_dtype "float32" the reference casts nothing to bf16 (its
_dtype(cfg), wavenet_tpu/models/wavenet.py:43); the port's plain path now
follows it, so the port and JAX agree within 1e-5 of the largest logit
(before the repair the port rounded every operand to bf16: 4.8e-3 at a
logit scale of 0.57) and greedy trajectories are equal, unconditionally,
with mel and with a speaker.  Such a model never reaches a bf16 kernel:
it decodes and trains on the plain route.

Routes by width (kernel_module): R < 128 to the narrow kernel, R a
multiple of 128 with S a multiple of 32 to the wide one, every other bf16
width-2 model to the narrow kernel where its block fits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.models import conditioning as jcond
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.generate import sampler
from wavenet_tpu_torch.models import conditioning as tcond
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.ops.cuda import decode as tdec
from wavenet_tpu_torch.ops.cuda import decode_common
from wavenet_tpu_torch.ops.cuda import decode_wide as twide
from wavenet_tpu_torch.utils.pytree_io import params_from_numpy

torch.set_num_threads(1)

F32 = dict(num_blocks=2, max_dilation=8, residual_channels=16,
           skip_channels=8, quantization_channels=64, compute_dtype="float32")
MEL = dict(num_mels=8, hop_length=16, win_length=64, upsample_factors=(4, 4))


@pytest.mark.parametrize("variant", ["plain", "mel", "speaker"])
def test_float32_model_matches_jax(variant):
    """B = 2, T = 64: logits within 1e-5 of the largest; 48 greedy decode
    steps equal JAX's scan decoder token for token."""
    kw = dict(F32)
    if variant == "speaker":
        kw.update(global_classes=3, global_channels=8)
    mel = variant == "mel"
    jc = jconfig.WaveNetConfig(mel=jconfig.MelConfig(**MEL) if mel else None,
                               **kw)
    tc = tconfig.WaveNetConfig(mel=tconfig.MelConfig(**MEL) if mel else None,
                               **kw)
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rs = np.random.RandomState(7)
    toks = rs.randint(0, 64, (2, 64)).astype(np.int32)
    jkw, tkw, jgen, tgen = {}, {}, {}, {}
    N = 48
    if mel:
        frames = rs.randn(2, 5, 8).astype(np.float32)
        jkw["mel"], tkw["mel"] = jnp.asarray(frames), torch.from_numpy(frames)
        jy = jcond.upsample_mel(jp["upsampler"], jc.mel, jnp.asarray(frames),
                                N)
        jgen["cond"] = jcond.project_cond(jp, jy)
        tgen["y"] = tcond.upsample_mel(tp["upsampler"], tc.mel,
                                       torch.from_numpy(frames), N)
    if variant == "speaker":
        sp = np.array([2, 0], np.int32)
        jkw["speaker"] = jgen["speaker"] = jnp.asarray(sp)
        tkw["speaker"] = tgen["speaker"] = torch.from_numpy(sp)
    want = np.asarray(jwn.forward_logits(jp, jc, toks, **jkw))
    got = twn.forward_logits(tp, tc, torch.from_numpy(toks), **tkw).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    jt = np.asarray(jwn.generate(jp, jc, jax.random.PRNGKey(1), N, batch=2,
                                 temperature=0.0, **jgen))
    tt = sampler.generate_auto(tp, tc, N, batch=2, temperature=0.0,
                               device="cpu", **tgen)
    np.testing.assert_array_equal(tt.numpy(), jt)


def test_float32_keeps_every_operand_in_float32():
    """No bf16 anywhere on an f32 model's path: the rings, the decode
    weights and the products are f32, and its route is the plain one on
    any device; a bf16 model keeps its bf16 layout and kernel route."""
    tc = tconfig.WaveNetConfig(**F32)
    p = twn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert twn.compute_dtype(tc) == torch.float32
    assert twn.decode_init(tc, 2, "cpu").queues.dtype == torch.float32
    w = decode_common.flatten_params(p, tc)
    assert {w[k].dtype for k in ("w_cur", "w_res", "head_w2")} == {
        torch.float32}
    assert sampler.kernel_module(tc, "cuda") is sampler.PLAIN
    a = torch.full((1, 4), 1.0 + 2.0 ** -12)
    assert float(twn._dot(a, torch.ones(4, 1), torch.float32)) == \
        4 * (1.0 + 2.0 ** -12)
    assert float(twn._dot(a, torch.ones(4, 1))) == 4.0     # bf16 rounds
    bf = tc.replace(compute_dtype="bfloat16")
    assert decode_common.flatten_params(p, bf)["w_cur"].dtype == \
        torch.bfloat16
    assert sampler.kernel_module(bf, "cuda") is tdec
    # float16 is taken too, on the plain route as float32 is
    f16 = tc.replace(compute_dtype="float16")
    assert twn.compute_dtype(f16) == torch.float16
    assert sampler.kernel_module(f16, "cuda") is sampler.PLAIN


@pytest.mark.parametrize("R,S,route", [(128, 80, "narrow"),
                                       (192, 64, "narrow"),
                                       (128, 256, "wide"), (256, 128, "wide"),
                                       (64, 128, "narrow"), (16, 16, "narrow")])
def test_decode_routes_by_width(R, S, route):
    """R = 128 with S = 80 and R = 192 (widths the reference's narrow kernel
    takes) route to the port's narrow kernel on the card; the wide kernel
    keeps R a multiple of 128 with S a multiple of 32.  On the CPU the
    routed module's plain version decodes them."""
    tc = tconfig.WaveNetConfig(num_blocks=1, max_dilation=2,
                               residual_channels=R, skip_channels=S)
    mod = sampler.kernel_module(tc, "cuda")
    assert mod is {"narrow": tdec, "wide": twide}[route]
    assert tdec.smem_bytes(1, tc.num_layers, R, S, 256, 0) <= 227 * 1024
    p = twn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    out = sampler.generate_auto(p, tc, 3, batch=2, seeds=1, device="cpu")
    assert out.shape == (2, 3)


@pytest.mark.parametrize("preset", ["tiny", "small", "fastgen_bench",
                                    "conditional", "full", "full_vocoder"])
def test_preset_routes_unchanged(preset):
    """Every preset keeps its kernel: R < 128 narrow, R = 128 wide."""
    cfg = tconfig.get_config(preset)
    want = tdec if cfg.residual_channels < 128 else twide
    assert sampler.kernel_module(cfg, "cuda") is want
    assert want.supported(cfg)


def test_narrow_shared_memory_accounting():
    """smem_bytes, the shared memory the narrow kernel is launched with
    (its values at two widths, by hand: fastgen_bench at one row per block
    and R = 192, S = 64, Q = 256 at 16 rows), and a width whose block
    cannot fit is refused."""
    # fastgen_bench: f64 rows x, old (one 64-row block each), h, relu(skip)
    # and s1 (two each); f32 gate sums [64][6], skip sums, scores; ints
    # (3 + 2L); 3 mbarriers; two staged layer blobs (16 gate groups x 2
    # blocks x 2 columns + 48 skip/res groups, 256 weights each, then the
    # f32 biases) and the resident head (32 + 64 groups x 2 blocks)
    blob = 2 * ((16 * 2 * 2 + 48) * 256 + 2 * (3 * 64 + 128))
    head = 2 * ((32 * 2 + 64 * 2) * 256 + 2 * (128 + 256))
    assert tdec.smem_bytes(1, 20, 64, 128, 256, 0) == \
        8 * 64 * 7 + 4 * (64 * 6 + 128 + 256) + 176 + 32 + 2 * blob + head
    # R = 192 at 16 rows: blobs read in place, the head resident
    head = 2 * ((16 + 64) * 256 + 2 * (64 + 256))
    assert tdec.smem_bytes(16, 2, 192, 64, 256, 0) == \
        8 * 16 * 64 * 11 + 4 * 16 * (192 * 6 + 64 + 256) + 208 + 32 + head
    huge = tconfig.WaveNetConfig(num_blocks=1, max_dilation=2,
                                 residual_channels=16, skip_channels=16,
                                 quantization_channels=60000)
    assert not tdec.supported(huge)
