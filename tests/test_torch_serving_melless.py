"""A mel model's server takes a request that brings no mel, as the
reference's server does (wavenet_tpu/serving/server.py:213-247: such a
request takes the batchable lane and decodes with y = None, no
conditioning term; generate/sampler.py:407-420).

  * The kernel route (bf16, R = 128: the wide kernel's plain version on
    the CPU): the served tokens equal the port's decode of the model
    without its conditioning term (serving.server.unconditioned) bit for
    bit, and that decode, forced along the JAX wide kernel's tokens
    (interpret mode, y=None, on the same weights), picks the same token
    on >= 99% of the steps (the vocoder tests' bar: the port sums each dot
    exactly in f64, XLA in f32, so a near-tie may flip).
  * The plain route (a float32 mel model, sampler.PLAIN): the served
    tokens equal the JAX facade's stream with no mel, token for token.
  * Over a mesh (two spawned gloo ranks, tests/_torch_mesh_worker's
    server and follower, on the kernel fan-out (2, 1) and the collective
    loop (1, 2)): each response equals the single-device unconditioned
    decode of its seed bit for bit.
"""

import json
import os


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.models.api import WaveNet as JWaveNet
from wavenet_tpu.ops.pallas import decode_wide as jwide
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.generate import sampler
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.ops.cuda import decode_wide as twide
from wavenet_tpu_torch.serving import WaveNetServer
from wavenet_tpu_torch.serving.server import unconditioned
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.utils.pytree_io import (flatten_tree,
                                               params_from_numpy,
                                               params_to_numpy)

import _torch_dp_worker as dpw
import _torch_mesh_worker as mesh_worker

torch.set_num_threads(1)

MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))
RATE = 16000
ENGINE = dict(max_batch=4, max_wait_ms=1.0, chunk_seconds=64 / RATE,
              length_quantum_seconds=64 / RATE)


def _models(**kw):
    jc = jconfig.WaveNetConfig(mel=jconfig.MelConfig(**MEL), **kw)
    tc = tconfig.WaveNetConfig(mel=tconfig.MelConfig(**MEL), **kw)
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, WaveNet(tc, tp)


def _served(model, n, seed):
    with WaveNetServer(model, **ENGINE) as s:
        wav = s.submit(num_samples=n, seed=seed).waveform()
        assert s.stats["batches"] == 1
    return wav


def test_kernel_route_serves_a_request_without_mel():
    jc, jp, model = _models(num_blocks=1, max_dilation=8,
                            residual_channels=128, skip_channels=128)
    assert sampler.kernel_module(model.cfg, "cpu") is twide
    N, seed = 64, 5
    got = _served(model, N, seed)
    plain = unconditioned(model)
    toks = plain.generate(num_samples=N, seeds=[seed])
    np.testing.assert_array_equal(got, mulaw.decode(toks).numpy()[0])
    # the reference's wide kernel with no y, on the mel model's weights
    B = 1
    seeds = np.array([seed], np.int32)          # the server's row seed
    rings, carry, s, _, _, total = jwide.setup_decode(
        jp, jc, jax.random.PRNGKey(0), B, N, seeds=jnp.asarray(seeds))
    jt, _, _ = jwide.decode_chunk(jp, jc, rings, carry, jnp.int32(0), s,
                                  total, 1.0, interpret=True,
                                  force_tiles=(B, total))
    jt = np.asarray(jt)
    forced = np.concatenate([np.asarray(carry)[:, :1], jt], axis=1)
    w = plain.decode_weights()
    assert "v_cond" not in w
    pt, _, _ = twide.decode_chunk(
        w, plain.cfg, torch.zeros(sum(jc.dilations), B, 128,
                                  dtype=torch.bfloat16),
        torch.from_numpy(np.array(carry)), 0, torch.from_numpy(seeds),
        total, 1.0, forced=torch.from_numpy(forced).contiguous())
    agree = (pt.numpy() == jt).mean()
    assert agree >= 0.99, agree
    assert len(np.unique(jt)) > 8                 # actually sampling


def test_plain_route_serves_a_request_without_mel():
    jc, jp, model = _models(num_blocks=1, max_dilation=4,
                            residual_channels=16, skip_channels=16,
                            compute_dtype="float32")
    assert sampler.kernel_module(model.cfg, "cpu") is sampler.PLAIN
    N, seed = 48, 9
    got = _served(model, N, seed)
    want = np.concatenate(list(JWaveNet(jc, jp).stream(
        num_samples=N, chunk_samples=N, seeds=jnp.asarray([seed]))),
        axis=1)[0]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


MESH_RATE = 8000
MESH_ENGINE = dict(max_batch=4, max_wait_ms=2000.0,
                   chunk_seconds=32 / MESH_RATE,
                   length_quantum_seconds=32 / MESH_RATE)
MESH_REQS = [dict(num_samples=32, seed=4), dict(num_samples=24, seed=9)]
MESH_CASES = {"melless_dp": [2, 1], "melless_mp": [1, 2]}


@pytest.fixture(scope="module")
def mesh_served(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("melless_mesh"))
    cfg = tconfig.WaveNetConfig(
        num_blocks=1, max_dilation=8, residual_channels=16,
        skip_channels=16, sample_rate=MESH_RATE,
        mel=tconfig.MelConfig(**MEL))
    model = WaveNet(cfg, twn.init_params(cfg, torch.Generator().manual_seed(
        1), "cpu"))
    with open(os.path.join(d, "mel.json"), "w") as f:
        json.dump({"cfg": cfg.to_json()}, f)
    np.savez(os.path.join(d, "mel_params.npz"),
             **flatten_tree(params_to_numpy(model.params)))
    np.savez(os.path.join(d, "mel_in.npz"))
    with open(os.path.join(d, "serve.json"), "w") as f:
        json.dump({name: dict(model="mel", layout=layout,
                              server=MESH_ENGINE, requests=MESH_REQS)
                   for name, layout in MESH_CASES.items()}, f)
    dpw.run_ranks(mesh_worker.serve_ranks, d, timeout=120, store_dir=d)
    with np.load(os.path.join(d, "serve_out.npz")) as z:
        return model, dict(z)


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_serves_a_request_without_mel(mesh_served, case):
    model, out = mesh_served
    plain = unconditioned(model)
    for i, req in enumerate(MESH_REQS):
        toks = plain.generate(num_samples=req["num_samples"],
                              seeds=[req["seed"]])
        np.testing.assert_array_equal(out[f"{case}/wave{i}"],
                                      mulaw.decode(toks).numpy()[0],
                                      err_msg=f"req {i}")
