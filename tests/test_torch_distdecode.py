"""The port's decode over the (data, model) mesh (parallel/distdecode.py,
sharding.py, mesh.py, the sampler's routing) on the CPU: the units, then
one two-process gloo run (tests/_torch_mesh_worker.decode_ranks).

In the run every case decodes on the (data, model) = (2, 1) and (1, 2)
meshes, and each rank's whole-batch results must equal the port's
single-device decode BIT FOR BIT: tokens one-shot and streamed (the chunks
concatenate to the one-shot tokens), with shard_rings_model off and on,
through the routing (the kernel fan-out at (2, 1) for a bf16 model, on
the CPU through the kernels' plain versions; the collective loop at
(1, 2)), and the rings and carry after the whole timeline.  The cases:
greedy, sampled, primed, mel-conditioned and speaker-conditioned bf16
models, and an f32 model (its tokens: an f32 product's f64 sum is not
exact, so its rings may differ in the last bit between two summation
orders).  Against the JAX package on the same weights: JAX's
dd.generate_sharded on the conftest's virtual CPU mesh and its
generate_pallas_dp in interpret mode, each against the port's counterpart
teacher-forced along JAX's tokens: agreement >= 99% and rings allclose at
TOL, the band tests/test_torch_decode.py holds the single-device decode to.
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
from wavenet_tpu.ops import rng as jrng
from wavenet_tpu.ops.pallas import decode as jdec
from wavenet_tpu.parallel import distdecode as jdd
from wavenet_tpu.parallel.mesh import make_mesh as jmake_mesh
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.generate import sampler
from wavenet_tpu_torch.models import conditioning
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.ops.cuda import decode_common
from wavenet_tpu_torch.parallel import distdecode as dd
from wavenet_tpu_torch.parallel import mesh, sharding
from wavenet_tpu_torch.utils.pytree_io import (flatten_tree,
                                               params_from_numpy,
                                               params_to_numpy)

import _torch_dp_worker as dpw
import _torch_mesh_worker as worker

torch.set_num_threads(1)

TOL = 2e-2
BASE = dict(num_blocks=1, max_dilation=8, residual_channels=16,
            skip_channels=16)
MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))
B, N = 4, 32
CASES = {
    "greedy": dict(cfg=BASE, temperature=0.0),
    "sampled": dict(cfg=BASE, temperature=1.0),
    "primed": dict(cfg=BASE, temperature=1.0, prime=9),
    "mel": dict(cfg=dict(BASE, mel=MEL), temperature=1.0, prime=5),
    "speaker": dict(cfg=dict(BASE, global_classes=5, global_channels=8),
                    temperature=1.0),
    "f32": dict(cfg=dict(BASE, compute_dtype="float32"), temperature=1.0),
}
JAX_CASES = ("greedy", "sampled")


def _cfgs(kw):
    kw = dict(kw)
    mel = kw.pop("mel", None)
    jc = jconfig.WaveNetConfig(
        **kw, **({} if mel is None else {"mel": jconfig.MelConfig(**mel)}))
    tc = tconfig.WaveNetConfig(
        **kw, **({} if mel is None else {"mel": tconfig.MelConfig(**mel)}))
    return jc, tc


def _jax_sharded(jc, jp, seed, temp):
    """JAX's collective loop at (data, model) = (1, 2) on two virtual CPU
    devices: (tokens [B, N], rings [sum_d, B, R] f32)."""
    jm = jmake_mesh(jc.replace(model_parallel=2), jax.devices()[:2])
    params = jdd._place_params(jp, jc, jm)
    no = (jnp.zeros((B, 0), jnp.int32), jnp.zeros((B,), jnp.int32),
          jnp.zeros((B, 1, 1)))
    state, first = jdd._sharded_prime_fn(jc, jm, B, 0, False, False, False)(
        params, *no)
    st, _, out = jdd._sharded_chunk_fn(jc, jm, B, N, float(temp), False,
                                       False, False)(
        params, state, first, no[1], no[2], jrng.as_row_seeds(seed, B))
    toks = jdd._unreplicate_tokens(out, jm, B, N)
    return np.asarray(toks), np.asarray(st.queues.astype(jnp.float32))


def _jax_pallas_dp(jc, jp, seed, temp):
    """JAX's kernel fan-out at (2, 1), interpret mode: (tokens, rings
    [sum_d, B, R] f32, each half from its shard's kernel launch)."""
    jm = jmake_mesh(jc.replace(data_parallel=2), jax.devices()[:2])
    toks = np.asarray(jdd.generate_pallas_dp(jp, jc, jm, seed, N, B,
                                             temperature=temp,
                                             interpret=True))
    seeds = jrng.as_row_seeds(seed, B)
    _, sum_d = jdec._ring_offsets(jc)
    rings, shard_toks = [], []
    for h in range(2):
        rows = slice(h * B // 2, (h + 1) * B // 2)
        carry = jnp.stack([jnp.full((B // 2,), 128, jnp.int32),
                           jnp.zeros((B // 2,), jnp.int32)], 1)
        t, r, _ = jdec.decode_chunk(
            jp, jc, jnp.zeros((sum_d, jc.residual_channels, B // 2),
                              jnp.bfloat16), carry, jnp.int32(0),
            seeds[rows], N, temp, interpret=True, force_tiles=(B // 2, N))
        shard_toks.append(np.asarray(t))
        rings.append(np.asarray(jnp.transpose(r, (0, 2, 1)).astype(
            jnp.float32)))
    np.testing.assert_array_equal(np.concatenate(shard_toks), toks)
    return toks, np.concatenate(rings, axis=1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The cases written to disk, one spawned two-rank run over all of
    them, and each case's single-device inputs."""
    d = str(tmp_path_factory.mktemp("mesh"))
    rs = np.random.RandomState(0)
    cases = {}
    for name, c in CASES.items():
        jc, tc = _cfgs(c["cfg"])
        jp = jwn.init_params(jc, jax.random.PRNGKey(len(cases)))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        seed = 11 + len(cases)
        inp = {}
        if c.get("prime"):
            inp["prime"] = rs.randint(0, 256, (B, c["prime"])).astype(
                np.int32)
        total = max(c.get("prime", 0) - 1, 0) + N
        if tc.mel is not None:
            frames = rs.randn(B, -(-total // 16), 8).astype(np.float32)
            inp["y"] = conditioning.upsample_mel(
                tp["upsampler"], tc.mel, torch.from_numpy(frames),
                total).numpy()
        if tc.global_classes is not None:
            inp["speaker"] = np.asarray([3, 0, 4, 3], np.int32)
        jax_out = {}
        if name in JAX_CASES:
            for key, fn in (("1x2", _jax_sharded), ("2x1", _jax_pallas_dp)):
                jt, jr = fn(jc, jp, seed, c["temperature"])
                jax_out[key] = (jt, jr)
                inp[f"jax_forced_{key}"] = np.concatenate(
                    [np.full((B, 1), 128, np.int32), jt], axis=1)
        spec = dict(cfg=tc.to_json(), batch=B, n=N, seed=seed,
                    temperature=c["temperature"])
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump(spec, f)
        np.savez(os.path.join(d, f"{name}_params.npz"),
                 **flatten_tree(params_to_numpy(tp)))
        np.savez(os.path.join(d, f"{name}_in.npz"), **inp)
        cases[name] = (tc, tp, spec,
                       {k: torch.from_numpy(v) for k, v in inp.items()},
                       jax_out)
    with open(os.path.join(d, "cases.json"), "w") as f:
        json.dump(list(CASES), f)
    dpw.run_ranks(worker.decode_ranks, d, store_dir=d)
    got = []
    for r in range(2):
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            got.append(dict(z))
    return cases, got


def _single(tc, tp, spec, inp):
    """The single-device decode of a case: (tokens, rings as int16,
    carry) from one decode_chunk_reference launch over the timeline, and
    generate_auto's tokens."""
    w = decode_common.flatten_params(tp, tc)
    prime = inp.get("prime")
    rings, carry, s, g, P, total = decode_common.setup_decode(
        tc, B, N, prime, spec["seed"], "cpu", w, inp.get("speaker"))
    toks, rings, carry = decode_common.decode_chunk_reference(
        w, tc, rings, carry, 0, s, total, spec["temperature"], forced=prime,
        y=decode_common.cond_timeline(inp.get("y"), total), g=g)
    auto = sampler.generate_auto(w, tc, N, batch=B, prime_tokens=prime,
                                 temperature=spec["temperature"],
                                 seeds=spec["seed"], device="cpu",
                                 y=inp.get("y"), speaker=inp.get("speaker"))
    return toks.numpy(), rings.view(torch.int16).numpy(), carry.numpy(), \
        auto.numpy()


@pytest.mark.parametrize("layout", ["2x1", "1x2"])
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_decode_equals_single_device(run, case, layout):
    """Every route's tokens, one-shot and streamed, with shard_rings_model
    off and on, on both ranks: the single device's bits; the rings and
    carry after the timeline too (bf16 models)."""
    cases, got = run
    tc, tp, spec, inp, _ = cases[case]
    toks, rings, carry, auto = _single(tc, tp, spec, inp)
    np.testing.assert_array_equal(auto, toks[:, toks.shape[1] - N:])
    exact = tc.compute_dtype == "bfloat16"
    for r in range(2):
        g = {k.split("/", 2)[2]: v for k, v in got[r].items()
             if k.startswith(f"{case}/{layout}/")}
        # the route: the kernel fan-out exactly on a bf16 data-only mesh
        assert bool(g["fan_out"]) == (layout == "2x1" and exact)
        for k in ("auto", "stream", "sharded_srm0", "sharded_srm1",
                  "sharded_stream_srm0", "sharded_stream_srm1"):
            np.testing.assert_array_equal(g[k], auto, err_msg=f"rank {r} {k}")
        for srm in ("srm0", "srm1"):
            np.testing.assert_array_equal(g[f"chunk_{srm}"], toks)
            if exact:
                np.testing.assert_array_equal(g[f"rings_{srm}"], rings,
                                              err_msg=f"rank {r} {srm}")
                np.testing.assert_array_equal(g[f"carry_{srm}"], carry)
        if layout == "2x1":                  # the fan-out's own state
            np.testing.assert_array_equal(g["fan_chunk"], toks)
            np.testing.assert_array_equal(g["fan_carry"], carry)
            if exact:
                np.testing.assert_array_equal(g["fan_rings"], rings)


@pytest.mark.parametrize("layout", ["2x1", "1x2"])
@pytest.mark.parametrize("case", JAX_CASES)
def test_mesh_decode_against_jax(run, case, layout):
    """The port's mesh decode consuming JAX's tokens (JAX's
    generate_pallas_dp at (2, 1), its generate_sharded at (1, 2)):
    agreement >= 99%, rings allclose at TOL."""
    cases, got = run
    jt, jr = cases[case][4][layout]
    if case == "sampled":
        assert len(np.unique(jt)) > 8          # actually sampling
    for r in range(2):
        pt = got[r][f"{case}/{layout}/jax_tf"]
        agree = (pt == jt).mean()
        assert agree >= 0.99, (r, agree)
        np.testing.assert_allclose(got[r][f"{case}/{layout}/jax_tf_rings"],
                                   jr, rtol=TOL, atol=TOL)


def test_fan_out_shards_equal_standalone_runs(run):
    """Each rank's rows of the (2, 1) fan-out equal a standalone decode of
    its rows' seed slice (the reference's test_pallas_dp_matches_single_
    chip_kernel)."""
    cases, got = run
    tc, tp, spec, inp, _ = cases["sampled"]
    w = decode_common.flatten_params(tp, tc)
    seeds = torch.as_tensor(np.array(jrng.as_row_seeds(spec["seed"], B)))
    for h in range(2):
        rows = slice(h * B // 2, (h + 1) * B // 2)
        alone = sampler.generate_auto(w, tc, N, batch=B // 2,
                                      seeds=seeds[rows], device="cpu",
                                      temperature=spec["temperature"])
        np.testing.assert_array_equal(got[h]["sampled/2x1/auto"][rows],
                                      alone.numpy())


# ---------------------------------------------------------------------------
# units (no process group)
# ---------------------------------------------------------------------------

def _tiny(**kw):
    return tconfig.WaveNetConfig(**dict(BASE, **kw))


def _params(cfg, seed=0):
    return twn.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("folded", [False, True])
def test_shard_params_concatenate_to_the_whole(mp, folded):
    """Each split leaf's mp slices concatenate back along its split dim;
    every other leaf is whole on every rank; the decode kernels' folded
    layout slices as the model layout does."""
    cfg = _tiny(mel=tconfig.MelConfig(**MEL), global_classes=5,
                global_channels=8)
    p = _params(cfg)
    src = decode_common.flatten_params(p, cfg) if folded else p
    shards = [sharding.shard_params(src, cfg, mp, i) for i in range(mp)]
    split = 0
    for k, v in src.items():
        if k in sharding.PARAM_SPLIT:
            dim, _ = sharding.PARAM_SPLIT[k]
            whole = torch.cat([sh[k] for sh in shards], dim=dim)
            np.testing.assert_array_equal(
                whole.float().numpy(),
                p[k].to(v.dtype).float().numpy(), err_msg=k)
            assert shards[0][k].shape[dim] * mp == p[k].shape[dim]
            split += 1
        else:
            assert all(s[k] is v for s in shards), k
    assert split == 9                  # every split leaf but w_prevk


def test_gate_axis_sliced_before_folding():
    """The local z of every rank is the whole z's columns: rank i holds
    filter columns [i R/mp, (i+1) R/mp) and the SAME gate columns, so its
    gate h is local; folding before the cut would hand one rank every
    filter column."""
    cfg = _tiny(mel=tconfig.MelConfig(**MEL), global_classes=5,
                global_channels=8)
    p = _params(cfg, 3)
    R, mp = cfg.residual_channels, 2
    w = decode_common.flatten_params(p, cfg)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(3, R).astype(np.float32))
    y = torch.from_numpy(rs.randn(3, 8).astype(np.float32))
    spk = torch.tensor([0, 4, 2])
    g_full = twn.global_cond_offsets(w, cfg, spk).reshape(
        cfg.num_layers, 3, 2 * R)
    c_full = conditioning.project_cond(w, y)
    for i in range(mp):
        groups = mesh.MeshGroups(1, mp, 0, i, None, None)
        lw = dd.local_weights(p, cfg, groups)
        g_loc = dd.speaker_offsets_local(lw, cfg, spk)
        c_loc = conditioning.project_cond(lw, y)
        cols = torch.cat([torch.arange(i * R // mp, (i + 1) * R // mp),
                          R + torch.arange(i * R // mp, (i + 1) * R // mp)])
        for l in range(cfg.num_layers):
            z_full = (twn._dot(x, w["w_cur"][l]) + w["b"][l]
                      + c_full[:, l] + g_full[l])
            z_loc = (twn._dot(x, lw["w_cur"][l]) + lw["b"][l]
                     + c_loc[:, l] + g_loc[l])
            np.testing.assert_array_equal(z_loc.numpy(),
                                          z_full[:, cols].numpy())


def test_mesh_shape_takes_the_model_axis():
    cfg = tconfig.tiny()
    assert mesh.mesh_shape(cfg.replace(model_parallel=2), 2) == (1, 1, 2)
    assert mesh.mesh_shape(cfg.replace(data_parallel=2, model_parallel=2),
                           4) == (2, 1, 2)
    assert mesh.mesh_shape(cfg.replace(data_parallel=0, model_parallel=2),
                           6) == (3, 1, 2)
    assert mesh.mesh_shape(cfg.replace(seq_parallel=2), 2) == (1, 2, 1)
    with pytest.raises(ValueError, match="process group has 3"):
        mesh.mesh_shape(cfg.replace(model_parallel=2), 3)


@pytest.mark.parametrize("what", ["kernel_size", "batch", "Q", "R",
                                  "fan_out_model"])
def test_distributed_decode_refusals(what):
    """The reference's refusals (distdecode.py:216-224) and the split
    widths, before any collective."""
    cfg, dp, mp, batch = _tiny(), 1, 1, 4
    match = {"kernel_size": "width-2 only", "batch": "not divisible by data",
             "Q": "Q=256 not divisible", "R": "residual_channels=16",
             "fan_out_model": "data-only mesh"}[what]
    if what == "kernel_size":
        cfg = _tiny(kernel_size=3)
    elif what == "batch":
        dp, batch = 2, 3
    elif what == "Q":
        mp = 3
    elif what == "R":
        cfg, mp = _tiny(quantization_channels=96), 3
    else:
        mp = 2
    groups = mesh.MeshGroups(dp, mp, 0, 0, None, None)
    p = _params(cfg)
    fn = dd.generate_kernel_dp if what == "fan_out_model" else \
        dd.generate_sharded
    with pytest.raises(ValueError, match=match):
        fn(p, cfg, groups, 0, 8, batch, device="cpu")


@pytest.mark.parametrize("case", ["sampled", "primed", "mel", "speaker"])
def test_one_rank_collective_loop_equals_generate_auto(case):
    """On a 1 x 1 mesh (no collective) the collective loop is the
    single-device decode, bit for bit, one-shot and streamed."""
    c = CASES[case]
    _, tc = _cfgs(c["cfg"])
    p = _params(tc, 5)
    rs = np.random.RandomState(2)
    kw = {}
    if c.get("prime"):
        kw["prime_tokens"] = torch.from_numpy(
            rs.randint(0, 256, (2, c["prime"])).astype(np.int32))
    if tc.mel is not None:
        kw["y"] = torch.from_numpy(rs.randn(2, 40, 8).astype(np.float32))
    if tc.global_classes is not None:
        kw["speaker"] = torch.tensor([1, 4])
    groups = mesh.MeshGroups(1, 1, 0, 0, None, None)
    want = sampler.generate_auto(p, tc, 24, batch=2, seeds=3, device="cpu",
                                 **kw)
    got = dd.generate_sharded(p, tc, groups, 3, 24, 2, device="cpu", **kw)
    streamed = torch.cat(list(dd.generate_sharded_stream(
        p, tc, groups, 3, 24, 2, chunk_samples=7, device="cpu", **kw)), 1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(streamed.numpy(), want.numpy())


def test_model_axis_still_refused_by_training():
    """The model axis decodes, serves and now trains: the trainer takes
    the reference's routes (the layer pipeline when the fused stack takes
    the config and the stages own whole blocks, else the Megatron-split
    scan), and the split it cannot make still raises."""
    from wavenet_tpu_torch.training.trainer import choose_route
    cfg = tconfig.tiny().replace(model_parallel=2, train_window=128)
    assert choose_route(cfg) == "tp"
    assert choose_route(cfg.replace(num_blocks=2)) == "pp"
    assert choose_route(cfg.replace(num_blocks=2, fused_stack=False)) == "tp"
    with pytest.raises(ValueError, match="skip_channels=17"):
        choose_route(cfg.replace(skip_channels=17, fused_stack=False))