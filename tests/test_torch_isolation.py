"""The port stands alone: no JAX, no reference package, no silent fallback.

  * every module of wavenet_tpu_torch imports in a fresh interpreter
    without pulling jax, ml_dtypes or wavenet_tpu into sys.modules (the
    GPU machine has no JAX and no ml_dtypes);
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
from wavenet_tpu_torch.ops.cuda import decode as tnarrow
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
             or m == "ml_dtypes" or m.startswith("ml_dtypes.")
             or m == "wavenet_tpu" or m.startswith("wavenet_tpu."))
assert not bad, bad
assert "wavenet_tpu_torch.serve" in names and len(names) >= 15, names
for n in ("train", "training.trainer", "training.checkpoint",
          "ops.cuda.train_stack", "audio.dataset", "ops.cuda.decode",
          "ops.cuda.decode_common", "verify", "ops.cuda.probes",
          "utils.golden", "cpp.loader", "audio.streaming",
          "parallel.distributed", "parallel.mesh", "parallel.dataparallel",
          "parallel.sharding", "parallel.distdecode", "parallel.seqpar",
          "parallel.pipeline", "parallel.megatron",
          "parallel.collectives", "serving.aot", "ops.cuda.decode_op",
          "utils.compcache"):
    assert "wavenet_tpu_torch." + n in names, n
print(len(names))
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15


def test_kernel_module_imports_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    code = """
from wavenet_tpu_torch.ops.cuda import build, decode, decode_wide
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


@pytest.mark.parametrize("kernel", ["wide", "narrow"])
@pytest.mark.parametrize("case", ["wide", "narrow", "narrow_speaker",
                                  "speaker"])
def test_cuda_tensor_never_takes_the_plain_path(monkeypatch, kernel, case):
    """A config a kernel takes, on a CUDA tensor, goes to that kernel
    (which cannot build here: no nvcc); a config it does not take (R < 128
    for the wide kernel; the narrow one takes R = 128 too, as every width
    whose block fits) raises.  Neither touches decode_chunk_reference.
    `speaker` is R = 128 with speaker offsets g; on the wide case's route
    the train stack's speaker variant (g [B, Lg, 2R]) takes its kernel
    too, never group_fwd_reference or group_bwd_reference."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the kernel path really runs")
    mod = twide if kernel == "wide" else tnarrow
    calls = []
    monkeypatch.setattr(mod, "decode_chunk_reference",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(build, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    wide = case in ("wide", "speaker")
    kw = dict(num_blocks=1, max_dilation=4, skip_channels=128,
              residual_channels=128 if wide else 32)
    if case.endswith("speaker"):
        kw.update(global_classes=3)
    cfg = tconfig.WaveNetConfig(**kw)
    w, rings, carry, seeds = _cuda_args(cfg)
    g = None
    if cfg.global_classes:
        g = _OnCuda(torch.zeros(cfg.num_layers, 2,
                                2 * cfg.residual_channels))
    build._libs.pop("decode_wide", None)
    build._libs.pop("decode", None)
    err = RuntimeError if kernel == "narrow" or wide else ValueError
    with pytest.raises(err):
        mod.decode_chunk(w, cfg, rings, carry, 0, seeds, 8, 1.0, g=g)
    if case == "speaker" and kernel == "wide":
        from wavenet_tpu_torch.models import wavenet as wn
        from wavenet_tpu_torch.ops.cuda import train_stack as ts
        for name in ("group_fwd_reference", "group_bwd_reference"):
            monkeypatch.setattr(ts, name, lambda *a, **k: calls.append(1))
        build._libs.pop("train_stack", None)
        R, L = cfg.residual_channels, cfg.num_layers
        params = wn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        ops = ts.prep_weights(*(params[k] for k in ts.GROUP_KEYS))
        gs = _OnCuda(torch.zeros(2, L, 2 * R))
        x = _OnCuda(torch.zeros(2, 16, R))
        with pytest.raises(RuntimeError, match="nvcc"):
            ts.group_fwd(x, _OnCuda(torch.zeros(2, 16, 128)), ops,
                         cfg.dilations, g=gs)
        with pytest.raises(RuntimeError, match="nvcc"):
            ts.group_bwd(_OnCuda(torch.zeros(L + 1, 2, 16, R)),
                         _OnCuda(torch.zeros(2, 16, 128)), x, ops,
                         cfg.dilations, g=gs)
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


def test_no_source_of_the_port_names_jax_the_reference_or_tools():
    """Every module of wavenet_tpu_torch (verify.py and ops/cuda/probes.py
    included) and chip_smoke.py import neither jax, nor wavenet_tpu, nor
    anything under tools/ (checked on the source, so that an import inside
    a function counts too)."""
    import ast
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "wavenet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert any(f.endswith("verify.py") for f in files)
    assert any(f.endswith(os.path.join("cuda", "probes.py")) for f in files)
    for f in files:
        for node in ast.walk(ast.parse(open(f).read())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "wavenet_tpu", "tools"), \
                    (f, m)


def test_probe_wrappers_take_the_kernel_on_cuda(monkeypatch):
    """A CUDA tensor sent to a probe wrapper goes to its kernel (which
    cannot build here) and never to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the kernel path really runs")
    from wavenet_tpu_torch.ops.cuda import probes
    calls = []
    for name in ("probe_scratch_reference", "probe_gate_reference",
                 "probe_lane_ops_reference", "probe_shift_concat_reference"):
        monkeypatch.setattr(probes, name, lambda *a, **k: calls.append(1))
    monkeypatch.setattr(build, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    build._libs.pop("probes", None)
    inp = {k: _OnCuda(v) for k, v in probes.probe_inputs("cpu").items()}
    for call in (lambda: probes.probe_gate(inp["gate_x"]),
                 lambda: probes.probe_lane_ops("a", inp["a"], inp["b"],
                                               inp["w"]),
                 lambda: probes.probe_lane_ops("c", inp["xf"], inp["yf"],
                                               inp["wf"]),
                 lambda: probes.probe_shift_concat("B", inp["snaps"],
                                                   inp["shift_x"])):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert not calls
