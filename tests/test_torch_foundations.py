"""Port foundations vs the JAX package on the CPU: config JSON, mu-law,
counter RNG, and the .npz weight interchange.

The integer paths are bit-exact contracts (config bytes, mu-law classes and
bin centers, RNG hash bits); the Gumbel transform goes through logf twice
and is compared with a tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.audio import mulaw as jmulaw
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.models.api import WaveNet as JWaveNet
from wavenet_tpu.ops import rng as jrng
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import mulaw as tmulaw
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.ops import rng as trng
from wavenet_tpu_torch.utils.pytree_io import (params_from_numpy,
                                               params_to_numpy)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_config_json_byte_identical(name):
    j, t = jconfig.get_config(name), tconfig.get_config(name)
    assert t.to_json() == j.to_json()
    assert t.dilations == j.dilations
    assert t.receptive_field == j.receptive_field
    assert tconfig.WaveNetConfig.from_json(j.to_json()) == t
    # a config written by the port loads in the reference unchanged
    assert jconfig.WaveNetConfig.from_json(t.to_json()) == j


def test_mulaw_encode_decode_bit_identical():
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.uniform(-1.2, 1.2, 20000),
                        np.linspace(-1, 1, 4097),
                        [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    for q in (256, 64):
        np.testing.assert_array_equal(tmulaw.encode_np(x, q),
                                      jmulaw.encode_np(x, q))
        ids = np.arange(q, dtype=np.int32)
        np.testing.assert_array_equal(tmulaw.decode_np(ids, q),
                                      jmulaw.decode_np(ids, q))


def test_mulaw_torch_decode_matches_jax_decode():
    ids = np.random.RandomState(1).randint(0, 256, (3, 500)).astype(np.int32)
    got = tmulaw.decode(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmulaw.decode(ids)))
    assert got.dtype == np.float32


@pytest.mark.parametrize("seed", [0, 7, -5, 2 ** 31 - 1, -2 ** 31])
def test_derive_row_seeds_bit_identical(seed):
    want = np.asarray(jrng.derive_row_seeds(jnp.int32(seed), 9))
    got = trng.derive_row_seeds(seed, 9).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(trng.as_row_seeds(seed, 9).numpy(), want)


def test_counter_uniform_bits_and_gumbel():
    """uniform values are a function of the hash bits through exact f32 ops
    (a 24-bit integer times 2^-24, plus 1e-12), so equal uniforms pin the
    bits; gumbel = -log(-log u) differs by at most ~1 f32 ulp of log."""
    seeds = np.array([0, 1, -1, 123456789, -2 ** 31, 2 ** 31 - 1, 42, 99],
                     np.int32)
    for t in (0, 1, 4093, 2 ** 31 - 1):
        ju = np.asarray(jrng.counter_uniform(jnp.asarray(seeds)[:, None], t,
                                             0, (8, 256), class_axis=1))
        tu = trng.counter_uniform(torch.from_numpy(seeds), t, 256).numpy()
        np.testing.assert_array_equal(tu, ju)
        jg = np.asarray(jrng.counter_gumbel(jnp.asarray(seeds)[:, None], t,
                                            0, (8, 256), class_axis=1))
        tg = trng.counter_gumbel(torch.from_numpy(seeds), t, 256).numpy()
        # atol covers gumbel values near 0, where rtol alone is meaningless
        np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)
    # the bits themselves, and the top bit is really used (unsigned shifts)
    bits = trng.counter_bits(torch.from_numpy(seeds), 3, 256).numpy()
    assert bits.min() >= 0 and bits.max() >= 2 ** 31
    u = trng.counter_uniform(torch.from_numpy(seeds), 3, 256).numpy()
    np.testing.assert_array_equal(
        u, ((bits >> 8).astype(np.float32) * np.float32(2 ** -24)
            + np.float32(1e-12)))


def _wide_cfg(mod):
    return mod.WaveNetConfig(num_blocks=1, max_dilation=8,
                             residual_channels=128, skip_channels=128)


def test_jax_export_npz_loads_in_port(tmp_path):
    """The weight carry-over: a JAX export_npz file loads in the port with
    every tensor equal (names, shapes, dtypes, values) and the config
    equal; the port's export loads back in the reference unchanged."""
    jm = JWaveNet(_wide_cfg(jconfig)).init(jax.random.PRNGKey(0))
    path = str(tmp_path / "m.npz")
    jm.export_npz(path)
    tm = WaveNet.from_npz(path, device="cpu")
    assert tm.cfg == _wide_cfg(tconfig)
    want = jax.tree.map(np.asarray, jm.params)
    got = params_to_numpy(tm.params)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tm.num_params == sum(v.size for v in want.values())

    back = str(tmp_path / "back.npz")
    tm.export_npz(back)
    jb = JWaveNet.from_npz(back)
    assert jb.cfg == jm.cfg
    for k in want:
        np.testing.assert_array_equal(np.asarray(jb.params[k]), want[k])


def test_init_params_shapes_match_reference():
    """The port's seeded init draws its own values but must give exactly
    the reference's shapes and dtypes, and Glorot limits per tensor."""
    tc, jc = _wide_cfg(tconfig), _wide_cfg(jconfig)
    got = params_to_numpy(
        WaveNet(tc).init(torch.Generator().manual_seed(3), "cpu").params)
    want = jax.tree.map(np.asarray, jwn.init_params(jc, jax.random.PRNGKey(0)))
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}
    for k in ("w_cur", "w_res", "w_skip", "head_w2"):
        assert np.abs(got[k]).max() <= np.abs(want[k]).max() * 1.01
    for k in ("b", "b_res", "b_skip", "head_b1", "head_b2"):
        assert not got[k].any()
    # the same generator seed gives the same weights
    again = params_to_numpy(
        WaveNet(tc).init(torch.Generator().manual_seed(3), "cpu").params)
    for k in got:
        np.testing.assert_array_equal(got[k], again[k])
    assert params_from_numpy(got, "cpu")["w_cur"].dtype == torch.float32


def test_unported_features_raise_not_implemented():
    for kw in ({"global_classes": 4}, {"kernel_size": 3},
               {"causal_channels": 64},
               {"global_classes": 4, "mel": tconfig.MelConfig()}):
        cfg = tconfig.WaveNetConfig(residual_channels=128, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            WaveNet(cfg)
