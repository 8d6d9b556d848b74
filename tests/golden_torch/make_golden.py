"""Write the golden fixtures of the PyTorch port: what the JAX package
computes on the CPU, for the port's verify tool to hold its CUDA kernels
against on a card that has no JAX (python -m wavenet_tpu_torch.verify).

    env JAX_PLATFORMS=cpu python tests/golden_torch/make_golden.py

Run by hand from the repository root; tests/test_torch_golden.py reruns
`build` and requires the stored files to be equal to its output.  No
parameters are stored: wavenet_tpu_torch/utils/golden.py draws them from
numpy seeds on both sides.  Files, each a compressed .npz:

  tiny.npz, small.npz  loss (the scan's, over golden.tokens), tf_argmax
                       and tf_margin [B, T] (teacher-forced argmax and its
                       top-2 logit margin) of the scan and, as
                       tf_argmax_fused and tf_margin_fused, of the fused
                       stack in interpret mode, tf_logits [B, P, Q] (scan)
                       at golden.TF_POSITIONS, greedy [B, N] and sampled
                       [B, N] (temperature 1, counter RNG at
                       golden.SAMPLE_SEEDS) token trajectories of the JAX
                       scan decoder, which the reference's contract makes
                       equal to its kernels, and greedy_margin and
                       sampled_margin [B, N], the top-2 margin of the
                       scores each step's choice was made on (the forward
                       logits on the trajectory, plus the Gumbel noise when
                       sampled);
  probes.npz           gate_t, gate_s, gate_g (tools/tpu_tanh_probe.py's
                       body in interpret mode over its linspace) and
                       shift_A..shift_D (tools/tpu_concat_probe.py's kA-kD
                       in interpret mode on probes.probe_inputs).
"""

import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import jax                                                      # noqa: E402
import jax.numpy as jnp                                         # noqa: E402
from jax.experimental import pallas as pl                       # noqa: E402

from wavenet_tpu import config as jconfig                       # noqa: E402
from wavenet_tpu.models import wavenet as jwn                   # noqa: E402
from wavenet_tpu.ops import rng as jrng                         # noqa: E402
from wavenet_tpu_torch.ops.cuda import probes                   # noqa: E402
from wavenet_tpu_torch.utils import golden                      # noqa: E402

NAMES = ("tiny", "small", "probes")


def build_model(name: str) -> dict:
    preset, seed, B, T, N = golden.MODELS[name]
    cfg = getattr(jconfig, preset)()
    p = {k: jnp.asarray(v) for k, v in golden.draw_params(
        golden.model_config(name), seed).items()}
    toks = golden.tokens(name)
    loss = jwn.loss_fn(p, cfg, jnp.asarray(toks))[0]
    logits = np.asarray(jwn.forward_logits(p, cfg, jnp.asarray(toks[:, :-1])))
    fused = np.asarray(jwn.forward_logits_fused(
        p, cfg, jnp.asarray(toks[:, :-1]), interpret=True))
    key = jax.random.PRNGKey(0)
    greedy = jwn.generate(p, cfg, key, N, batch=B, temperature=0.0)
    sampled = jwn.generate(p, cfg, key, N, batch=B,
                           temperature=golden.TEMPERATURE,
                           seeds=jnp.asarray(golden.SAMPLE_SEEDS, jnp.int32))
    margins = {}
    for kind, traj in (("greedy", greedy), ("sampled", sampled)):
        feed = jnp.concatenate([jnp.full((B, 1), cfg.quantization_channels
                                         // 2, jnp.int32),
                                traj[:, :-1].astype(jnp.int32)], axis=1)
        sc = jwn.forward_logits(p, cfg, feed)             # [B, N, Q]
        if kind == "sampled":
            seeds = jnp.asarray(golden.SAMPLE_SEEDS, jnp.int32)[:, None]
            noise = jnp.stack([jrng.counter_gumbel(
                seeds, t, 0, (B, cfg.quantization_channels), class_axis=1)
                for t in range(N)], axis=1)
            sc = sc * (1.0 / golden.TEMPERATURE) + noise
        sc = np.sort(np.asarray(sc), -1)[..., -2:]
        margins[f"{kind}_margin"] = sc[..., 1] - sc[..., 0]
    top2 = np.sort(logits, -1)[..., -2:]
    ftop2 = np.sort(fused, -1)[..., -2:]
    return {"loss": np.asarray(loss, np.float32),
            "tf_argmax": logits.argmax(-1).astype(np.int16),
            "tf_margin": top2[..., 1] - top2[..., 0],
            "tf_argmax_fused": fused.argmax(-1).astype(np.int16),
            "tf_margin_fused": ftop2[..., 1] - ftop2[..., 0],
            "tf_logits": logits[:, list(golden.TF_POSITIONS)],
            "greedy": np.asarray(greedy, np.int16),
            "sampled": np.asarray(sampled, np.int16), **margins}


def _tanh_kern(x_ref, t_ref, s_ref, g_ref):      # tools/tpu_tanh_probe.py:18
    z = x_ref[:]
    t_ref[:] = jnp.tanh(z)
    s_ref[:] = jax.nn.sigmoid(z)
    g_ref[:] = jnp.tanh(z) * jax.nn.sigmoid(z)


def build_probes() -> dict:
    spec = importlib.util.spec_from_file_location(
        "tpu_concat_probe", os.path.join(ROOT, "tools", "tpu_concat_probe.py"))
    cat = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cat)
    inp = {k: jnp.asarray(v.float().numpy())
           for k, v in probes.probe_inputs("cpu").items()}
    t, s, g = pl.pallas_call(
        _tanh_kern, out_shape=(jax.ShapeDtypeStruct((64, 128),
                                                    jnp.float32),) * 3,
        interpret=True)(inp["gate_x"])
    out = {"gate_t": np.asarray(t), "gate_s": np.asarray(s),
           "gate_g": np.asarray(g)}
    x = inp["shift_x"]
    for case, kern in zip(probes.SHIFT_CASES, (cat.kA, cat.kB, cat.kC,
                                               cat.kD)):
        ring = inp["snaps"] if case == "B" else inp["ring"]
        out[f"shift_{case}"] = np.asarray(pl.pallas_call(
            kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
            interpret=True)(ring, x))
    return out


def build(name: str) -> dict:
    return build_probes() if name == "probes" else build_model(name)


def main() -> None:
    out_dir = golden.golden_dir()
    for name in NAMES:
        path = out_dir / f"{name}.npz"
        np.savez_compressed(path, **build(name))
        print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
