"""The golden fixtures (tests/golden_torch/): fresh, small, and met by the
port's plain versions on the CPU.

  * make_golden.build reruns the JAX package at the stored seeds and must
    give the stored arrays exactly, so the files cannot go stale;
  * the directory stays under 1 MB;
  * the port's plain versions on the drawn params (utils/golden.py): the
    scan loss within 2e-3 relative of JAX's; teacher-forced argmax
    agreement >= 99% where JAX's top-2 margin exceeds 2^-7 of the logit
    scale (golden.argmax_agreement: below it two correct f32 summation
    orders may pick the other of two near-tied tokens), for the scan and
    for the fused stack against JAX's fused stack; the decode teacher-forced
    on JAX's greedy and sampled trajectories flips <= 1% of steps.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from wavenet_tpu_torch.generate import sampler
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.utils import golden
from wavenet_tpu_torch.utils.pytree_io import params_from_numpy

torch.set_num_threads(1)

DIR = golden.golden_dir()


def _stored(name):
    with np.load(DIR / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def make_golden():
    spec = importlib.util.spec_from_file_location(
        "make_golden", os.path.join(DIR, "make_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["tiny", "small", "probes"])
def test_golden_files_are_reproduced_by_make_golden(make_golden, name):
    fresh = make_golden.build(name)
    stored = _stored(name)
    assert sorted(fresh) == sorted(stored)
    for k, v in fresh.items():
        assert v.dtype == stored[k].dtype and v.shape == stored[k].shape, k
        np.testing.assert_array_equal(v, stored[k], err_msg=k)


def test_golden_directory_is_small():
    size = sum(p.stat().st_size for p in DIR.iterdir() if p.is_file())
    assert size < 1 << 20, size


@pytest.mark.parametrize("name", list(golden.MODELS))
def test_port_plain_versions_meet_the_goldens(name):
    _, seed, B, T, N = golden.MODELS[name]
    stored = _stored(name)
    cfg = golden.model_config(name)
    p = params_from_numpy(golden.draw_params(cfg, seed), "cpu")
    toks = torch.from_numpy(golden.tokens(name))
    scale = float(np.abs(stored["tf_logits"]).max())
    with torch.no_grad():
        loss, _ = twn.loss_fn(p, cfg, toks)
        scan = twn.forward_logits(p, cfg, toks[:, :-1]).numpy()
        fused = twn.forward_logits_fused(p, cfg, toks[:, :-1]).numpy()
    assert abs(loss.item() - float(stored["loss"])) <= 2e-3 * abs(
        float(stored["loss"]))
    np.testing.assert_allclose(
        scan[:, list(golden.TF_POSITIONS)], stored["tf_logits"],
        atol=2.0 ** -7 * scale)
    for got, kind in ((scan, ""), (fused, "_fused")):
        overall, kept, share = golden.argmax_agreement(
            got, stored["tf_argmax" + kind], stored["tf_margin" + kind],
            scale)
        assert kept >= 0.99 and share > 0.5, (kind, overall, kept, share)
        assert overall >= 0.97, (kind, overall)
    mod = sampler.kernel_module(cfg, "cpu")
    w = mod.flatten_params(p, cfg)
    for kind, temp in (("greedy", 0.0), ("sampled", golden.TEMPERATURE)):
        want = torch.from_numpy(stored[kind].astype(np.int32))
        rings, carry, seeds, _, _, _ = mod.setup_decode(
            cfg, B, N, seeds=list(golden.SAMPLE_SEEDS), device="cpu", w=w)
        forced = torch.cat([carry[:, :1], want], 1)
        got, _, _ = mod.decode_chunk(w, cfg, rings, carry, 0, seeds, N,
                                     temp, forced)
        assert int((got != want).sum()) <= 0.01 * want.numel(), kind
