"""The port stands alone: no JAX, no reference package, no silent fallback.

  * every module of wavenet_tpu_torch imports in a fresh interpreter
    without pulling jax or wavenet_tpu into sys.modules (the GPU machine
    has no JAX);
  * the kernel module imports without nvcc (kernels build at first use);
  * a tensor on a CUDA device never reaches the plain PyTorch version: on
    a machine without CUDA (or nvcc), decode_chunk for a CUDA tensor raises.
"""

import os
import subprocess
import sys

import pytest
import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.ops.cuda import build
from wavenet_tpu_torch.ops.cuda import decode_wide as twide

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _run(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_reference():
    code = """
import importlib, pkgutil, sys
import wavenet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "wavenet_tpu" or m.startswith("wavenet_tpu."))
assert not bad, bad
assert "wavenet_tpu_torch.serve" in names and len(names) >= 15, names
for n in ("train", "training.trainer", "training.checkpoint",
          "ops.cuda.train_stack", "audio.dataset"):
    assert "wavenet_tpu_torch." + n in names, n
print(len(names))
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15


def test_kernel_module_imports_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    code = """
from wavenet_tpu_torch.ops.cuda import build, decode_wide
try:
    build.nvcc_path()
except RuntimeError as e:
    print("no nvcc:", e)
else:
    raise SystemExit("nvcc found on an empty PATH")
"""
    r = _run(code, env)
    assert r.returncode == 0, r.stderr
    assert "no nvcc" in r.stdout


class _OnCuda:
    """Stands in for a CUDA tensor on a machine without CUDA: reports a
    cuda device and otherwise behaves like the CPU tensor it wraps."""

    def __init__(self, t: torch.Tensor):
        self._t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return True

    def __getattr__(self, name):
        return getattr(self._t, name)


def _cuda_args(cfg, batch=2):
    from wavenet_tpu_torch.models import wavenet as wn
    params = wn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w = twide.DecodeWeights({k: _OnCuda(v) for k, v in
                             twide.flatten_params(params, cfg).items()})
    _, sum_d = wn.ring_offsets(cfg)
    rings = _OnCuda(torch.zeros(sum_d, batch, cfg.residual_channels,
                                dtype=torch.bfloat16))
    carry = _OnCuda(torch.zeros(batch, 2, dtype=torch.int32))
    seeds = _OnCuda(torch.zeros(batch, dtype=torch.int32))
    return w, rings, carry, seeds


@pytest.mark.parametrize("case", ["wide", "narrow"])
def test_cuda_tensor_never_takes_the_plain_path(monkeypatch, case):
    """A supported config on a CUDA tensor goes to the kernel (which cannot
    build here: no nvcc); an unsupported one (R < 128) raises.  Neither
    touches decode_chunk_reference."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the kernel path really runs")
    calls = []
    monkeypatch.setattr(twide, "decode_chunk_reference",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(build, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    kw = dict(num_blocks=1, max_dilation=4, skip_channels=128,
              residual_channels=128 if case == "wide" else 32)
    cfg = tconfig.WaveNetConfig(**kw)
    w, rings, carry, seeds = _cuda_args(cfg)
    build._libs.pop("decode_wide", None)
    err = RuntimeError if case == "wide" else ValueError
    with pytest.raises(err):
        twide.decode_chunk(w, cfg, rings, carry, 0, seeds, 8, 1.0)
    assert not calls


def test_bad_operands_are_refused_before_launch():
    cfg = tconfig.WaveNetConfig(num_blocks=1, max_dilation=4,
                                residual_channels=128, skip_channels=128)
    w, rings, carry, seeds = _cuda_args(cfg)
    with pytest.raises(ValueError, match="tokens_init"):
        twide.decode_chunk(w, cfg, rings, _OnCuda(torch.zeros(
            2, 3, dtype=torch.int32)), 0, seeds, 8, 1.0)
    with pytest.raises(ValueError, match="seeds"):
        twide.decode_chunk(w, cfg, rings, carry, 0, _OnCuda(torch.zeros(
            2, dtype=torch.int64)), 8, 1.0)
    with pytest.raises(ValueError, match="num_steps"):
        twide.decode_chunk(w, cfg, rings, carry, 0, seeds, 0, 1.0)
    with pytest.raises(ValueError, match="device"):
        twide.decode_chunk(w, cfg, rings.to("meta"), carry, 0, seeds, 8, 1.0)
    with pytest.raises(ValueError, match="prime token ids"):
        twide.setup_decode(cfg, 2, 8, torch.tensor([[3, 256], [0, 1]]),
                           device="cpu")
