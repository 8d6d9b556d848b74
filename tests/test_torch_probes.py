"""The verify tool's probes (ops/cuda/probes.py): each plain version
against the JAX probe it replaces, run in Pallas interpret mode on the CPU.

Rows 10-16 of PERF.md's kernel table: the kernel bodies are imported from
tools/tpu_lane_ops_check.py and tools/tpu_concat_probe.py (importing them
runs nothing).  Rows 5-9: tools/tpu_scratch_test.py, tpu_scratch2d.py and
tpu_tanh_probe.py run a hardware pallas_call when imported, so their
bodies are restated here, as written there.

Tolerances: P1 and P4 exactly (data movement and exact f32 multiplies).
P3's bf16 cases: the port sums each dot product exactly and rounds once,
JAX sums the same bf16 products in f32, so they may differ by the f32
rounding of a 64- or 128-term sum (K 2^-24 sum|a_k w_k| per element), and
the port's plain version is held exactly against its own exact sum.
kernel_c: within 1e-6 of the largest element (two f32 sums).  P2: torch's
and XLA's f32 tanh and sigmoid agree within 4 ulps over [-30, 30] (the
largest difference of the two CPU libraries there).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu_torch.ops.cuda import probes

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _j(t: torch.Tensor):
    """A port tensor as the JAX array of the same values and dtype."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.fixture(scope="module")
def inputs():
    return probes.probe_inputs("cpu")


# ---- P1: rows 5-8, bodies as in tools/tpu_scratch_test.py and
# tools/tpu_scratch2d.py ----

def _kern_1d(out_ref, acc):                      # tpu_scratch_test.py:6
    j = pl.program_id(0)

    @pl.when(j == 0)
    def _():
        acc[:] = jnp.zeros_like(acc)
    acc[:] = acc[:] + 1.0
    out_ref[0] = acc[:]


def _kern_2d(out_ref, acc):                      # tpu_scratch2d.py:6
    j = pl.program_id(1)

    @pl.when(j == 0)
    def _():
        acc[:] = jnp.zeros_like(acc)
    acc[:] = acc[:] + 1.0
    out_ref[0, 0] = acc[:]


def _kern2(out_ref, ring):                       # tpu_scratch2d.py:26
    j = pl.program_id(1)

    @pl.when(j == 0)
    def _():
        ring[:] = jnp.zeros_like(ring)
    out_ref[0, 0] = ring[:]
    ring[:] = ring[:] + (j + 1).astype(jnp.float32)


def _kern3(out_ref, ring, buf):                  # tpu_scratch2d.py:45
    j = pl.program_id(1)

    @pl.when(j == 0)
    def _():
        ring[:] = jnp.zeros_like(ring)
    buf[:] = jnp.full((16, 128), (j + 1).astype(jnp.float32), jnp.float32)
    out_ref[0, 0] = ring[0:8]
    ring[0:8] = buf[8:16]


def _jax_scratch(mode):
    if mode == "accumulate":
        return pl.pallas_call(
            _kern_1d, grid=(4,),
            out_specs=pl.BlockSpec((1, 8, 128), lambda j: (j, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((4, 8, 128), jnp.float32),
            scratch_shapes=[pltpu.VMEM((8, 128), jnp.float32)],
            interpret=True)()[None]
    kern, rows, scratch = {
        "reset": (_kern_2d, 2, [(8, 128)]),
        "ring": (_kern2, 1, [(8, 128)]),
        "ring_launches": (_kern2, 1, [(8, 128)]),
        "partial": (_kern3, 1, [(16, 128), (16, 128)])}[mode]
    return pl.pallas_call(
        kern, grid=(rows, 4),
        out_specs=pl.BlockSpec((1, 1, 8, 128),
                               lambda bi, j: (bi, j, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, 4, 8, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM(s, jnp.float32) for s in scratch],
        interpret=True)()


@pytest.mark.parametrize("mode", list(probes.SCRATCH_MODES))
def test_probe_scratch_matches_the_probe(mode):
    """Every element equals the probe's printed expectation (tile j's value
    fills its [8, 128] tile) and JAX's interpret-mode output."""
    got = probes.probe_scratch(mode, "cpu")
    want = np.asarray(_jax_scratch(mode))
    np.testing.assert_array_equal(got.numpy(), want)
    expect = np.asarray(probes.SCRATCH_MODES[mode][3], np.float32)
    np.testing.assert_array_equal(
        got.numpy(), np.broadcast_to(expect[:, :, None, None], got.shape))


# ---- P2: row 9, the body of tools/tpu_tanh_probe.py:18 ----

def _tanh_kern(x_ref, t_ref, s_ref, g_ref):
    z = x_ref[:]
    t_ref[:] = jnp.tanh(z)
    s_ref[:] = jax.nn.sigmoid(z)
    g_ref[:] = jnp.tanh(z) * jax.nn.sigmoid(z)


def _ulps(a, b) -> int:
    """Largest distance in f32 units in the last place (same-sign values)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def test_probe_gate_matches_jax(inputs):
    x = inputs["gate_x"]
    np.testing.assert_array_equal(
        x.reshape(-1).numpy(), np.linspace(-30, 30, 8192, dtype=np.float32))
    want = pl.pallas_call(
        _tanh_kern, out_shape=(jax.ShapeDtypeStruct((64, 128),
                                                    jnp.float32),) * 3,
        interpret=True)(_j(x))
    got = probes.probe_gate(x)
    for name, w, g in zip(("tanh", "sigmoid", "gate"), want, got):
        assert g.dtype == torch.float32 and g.shape == (64, 128)
        assert _ulps(g.numpy(), w) <= 4, name
    np.testing.assert_array_equal(got[2].numpy(),
                                  (got[0] * got[1]).numpy())


@pytest.mark.parametrize("n", [1, 5, 8190, 8191])
@pytest.mark.parametrize("offset", [0, 1])
def test_probe_gate_matches_jax_ragged(offset, n):
    """n not a multiple of 4, from the buffer's start or from a view one
    element into it (on the card: pairs and an odd last element, or one
    element at a time): within 4 ulps of JAX's interpret-mode values, as
    at the probe's n."""
    buf = torch.from_numpy(np.linspace(-30.0, 30.0, n + offset,
                                       dtype=np.float32))
    x = buf[offset:]
    assert x.storage_offset() == offset and x.is_contiguous()
    want = pl.pallas_call(
        _tanh_kern, out_shape=(jax.ShapeDtypeStruct((n,), jnp.float32),) * 3,
        interpret=True)(_j(x.clone()))
    got = probes.probe_gate(x)
    for name, w, g in zip(("tanh", "sigmoid", "gate"), want, got):
        assert g.dtype == torch.float32 and g.shape == (n,)
        assert _ulps(g.numpy(), w) <= 4, name


# ---- P3: rows 10-12, tools/tpu_lane_ops_check.py ----

def _lane_jax(kernel, ins, n_out):
    shape = jax.ShapeDtypeStruct((ins[0].shape[0], 64), jnp.float32)
    out = pl.pallas_call(kernel, out_shape=(shape,) * n_out if n_out > 1
                         else shape, interpret=True)(*ins)
    return out if isinstance(out, tuple) else (out,)


def _check_lane(case, inputs):
    lane = _tool("tpu_lane_ops_check")
    args = [inputs[k] for k in probes.LANE_OPS[case]]
    kernel = {"a": lane.kernel_a, "b": lane.kernel_b,
              "c": lane.kernel_c}[case]
    want = _lane_jax(kernel, [_j(t) for t in args], 2 if case == "b" else 1)
    got = probes.probe_lane_ops(case, *args)
    assert len(got) == len(want)
    for g in got:
        assert g.shape == (args[0].shape[0], 64)
    if case == "c":
        w = np.asarray(want[0])
        assert np.abs(got[0].numpy() - w).max() <= 1e-6 * np.abs(w).max()
        return
    # the exact product, and JAX's f32 sums within their rounding
    if case == "a":
        cat = torch.cat(args[:2], 1).double()
        exact, mag = cat @ args[2].double(), cat.abs() @ args[2].double().abs()
        outs = [(exact, mag, 1.0, 0.0)]
    else:
        exact = args[0].double() @ args[1].double()
        mag = args[0].double().abs() @ args[1].double().abs()
        outs = [(exact[:, :64], mag[:, :64], 2.0, 1.0),
                (exact[:, 64:], mag[:, 64:], 3.0, -1.0)]
    K = 128 if case == "a" else 64
    for g, w, (e, m, scale, shift) in zip(got, want, outs):
        np.testing.assert_array_equal(
            g.numpy(), (e.float() * scale + shift).numpy())
        bound = (K * 2.0 ** -24 * m * abs(scale)).numpy() + 2 * np.spacing(
            np.abs(np.asarray(w)))
        assert (np.abs(g.numpy().astype(np.float64) - np.asarray(w))
                <= bound).all()


@pytest.mark.parametrize("case", probes.LANE_CASES)
def test_probe_lane_ops_matches_jax(case, inputs):
    _check_lane(case, inputs)


@pytest.mark.parametrize("case", probes.LANE_CASES)
@pytest.mark.parametrize("T", [17, 300])
def test_probe_lane_ops_matches_jax_ragged(T, case):
    """T not a multiple of the kernel's 16-row tile (lane_inputs, drawn
    from a numpy seed): the same checks as at the probe's T = 256."""
    _check_lane(case, probes.lane_inputs(T, "cpu"))


# ---- P4: rows 13-16, tools/tpu_concat_probe.py ----

@pytest.mark.parametrize("case", probes.SHIFT_CASES)
def test_probe_shift_concat_matches_jax(case, inputs):
    cat = _tool("tpu_concat_probe")
    kernel = {"A": cat.kA, "B": cat.kB, "C": cat.kC, "D": cat.kD}[case]
    ring = inputs["snaps"] if case == "B" else inputs["ring"]
    x = inputs["shift_x"]
    want = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(tuple(x.shape), jnp.float32),
        interpret=True)(_j(ring), _j(x))
    got = probes.probe_shift_concat(case, ring, x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", probes.SHIFT_CASES)
@pytest.mark.parametrize("T,R", [(300, 63), (96, 4)])
@pytest.mark.parametrize("offset", [0, 1])
def test_probe_shift_concat_matches_jax_ragged(offset, T, R, case):
    """Other TT and R than the probe's (R = 63: no whole 16-byte units on
    the card; TT = 96 = 3 d), on x from its buffer's start or one element
    into it (off 16-byte alignment: one f32 a unit on the card), drawn
    from a numpy seed: equal to kA-kD in interpret mode at that TT (the
    tool's kernels read TT from their module)."""
    cat = _tool("tpu_concat_probe")
    cat.TT = T
    kernel = {"A": cat.kA, "B": cat.kB, "C": cat.kC, "D": cat.kD}[case]
    inp = probes.shift_inputs(T, R, "cpu", offset=offset)
    ring, x = inp["snaps" if case == "B" else "ring"], inp["shift_x"]
    assert x.shape == (T, R) and x.storage_offset() == offset
    want = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((T, R), jnp.float32),
        interpret=True)(_j(ring), _j(x))
    got = probes.probe_shift_concat(case, ring, x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_probe_wrappers_refuse_other_devices(inputs):
    """Only a CPU tensor takes a plain version; other devices raise (a CUDA
    tensor takes the kernel, tests/test_torch_kernels.py)."""
    meta = inputs["shift_x"].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        probes.probe_shift_concat("A", meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        probes.probe_scratch("ring", "meta")
