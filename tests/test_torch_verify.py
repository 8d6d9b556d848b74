"""The port's verify tool (python -m wavenet_tpu_torch.verify) on the CPU.

  * `--device cpu --quick` (the plain version on both sides of every
    comparison, each family in its own process) exits 0 and ends with the
    launch counts;
  * without --device on a machine with no card it refuses to run, as
    tools/tpu_verify.py refuses the CPU;
  * its drift classification gives BIT-EXACT / DRIFT / FAIL as the
    reference's report_cmp and report_grad do (tools/tpu_verify.py:87-126),
    on synthetic arrays.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wavenet_tpu_torch import verify

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, env=None):
    return subprocess.run([sys.executable, "-m", "wavenet_tpu_torch.verify",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)


def test_quick_run_on_the_cpu_exits_0():
    r = _run("--device", "cpu", "--quick")
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert "decode batch-tiled: BIT-EXACT" in lines
    assert any(ln.startswith("train fwd small-dims multigrp") and
               ln.endswith("BIT-EXACT") for ln in lines)
    assert lines[-1].startswith("VERIFY_COUNTS ")
    got = json.loads(lines[-1][len("VERIFY_COUNTS "):])
    assert "probes.gate_launches" in got and not any(got.values())


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = _run()
    assert r.returncode == 1 and "needs a CUDA device" in r.stderr


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location(
        "tpu_verify", os.path.join(ROOT, "tools", "tpu_verify.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_verdict(ref, fn, *args):
    ref.FAILURES.clear()
    ref.DRIFTS.clear()
    fn("x", *args)
    return ("FAIL" if ref.FAILURES else "DRIFT" if ref.DRIFTS
            else "BIT-EXACT")


def _cases():
    rs = np.random.RandomState(0)
    b = rs.randn(4096).astype(np.float32)
    one_ulp = np.where(rs.rand(4096) < 0.3, b * np.float32(1 + 2.0 ** -9), b)
    return {
        "equal": (b.copy(), b),
        "bf16 noise": (one_ulp.astype(np.float32), b),
        "tiny noise": ((b * np.float32(1 + 1e-7)).astype(np.float32), b),
        "wrong data": (np.roll(b, 1), b),
        "one big error": (np.where(np.arange(4096) == 7, b + 0.3, b)
                          .astype(np.float32), b),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_classification_matches_the_reference(reference, case):
    a, b = _cases()[case]
    assert verify.classify_cmp(a, b) == _ref_verdict(
        reference, reference.report_cmp, a, b)
    for band in (1e-4, 2e-2):
        assert verify.classify_grad(a, b, band) == _ref_verdict(
            reference, reference.report_grad, a, b, band)


def test_classification_verdicts():
    c = _cases()
    assert verify.classify_cmp(*c["equal"]) == "BIT-EXACT"
    assert verify.classify_cmp(*c["bf16 noise"]) == "DRIFT"
    assert verify.classify_cmp(*c["wrong data"]) == "FAIL"
    assert verify.classify_grad(*c["tiny noise"], 1e-4) == "BIT-EXACT"
    assert verify.classify_grad(*c["bf16 noise"], 1e-4) == "DRIFT"
    assert verify.classify_grad(*c["wrong data"], 1e-4) == "FAIL"
    verify.FAILURES.clear()
    verify.report_exact("t", [(torch.zeros(3), torch.zeros(3))])
    assert not verify.FAILURES
    verify.report_exact("t", [(torch.zeros(3), torch.ones(3))])
    assert verify.FAILURES == ["t"]
    verify.FAILURES.clear()


def _bumped(t, n):
    """f32 tensor t moved n ulps up (its bit pattern plus n)."""
    return (t.view(torch.int32) + n).view(torch.float32)


@pytest.mark.parametrize("fault", ["none", "gate swapped", "gate 5 ulps",
                                   "gate 4 ulps", "lane c 1e-5",
                                   "lane c 1e-7"])
def test_probes_family_holds_p2_and_p3_c(monkeypatch, fault):
    """The probes family FAILs a gate whose outputs are wrong (tanh and
    sigmoid swapped) or more than probes.GATE_ULPS ulps from torch's CPU
    values, and a P3 c whose product is off by more than 1e-6 of its
    largest element; it never calls either a DRIFT.  Inside those limits
    it passes."""
    from wavenet_tpu_torch.ops.cuda import probes
    from wavenet_tpu_torch.utils import golden
    gate, lane = probes.probe_gate, probes.probe_lane_ops
    if fault.startswith("gate"):
        def bad_gate(x):
            t, s, g = gate(x)
            if fault == "gate swapped":
                return s, t, g
            n = int(fault.split()[1])
            return t, _bumped(s, n), g
        monkeypatch.setattr(probes, "probe_gate", bad_gate)
    if fault.startswith("lane"):
        rel = float(fault.split()[-1])

        def bad_lane(case, *ops):
            out = lane(case, *ops)
            if case != "c":
                return out
            return (out[0] + rel * out[0].abs().max(),) + tuple(out[1:])
        monkeypatch.setattr(probes, "probe_lane_ops", bad_lane)
    verify.FAILURES.clear()
    verify.DRIFTS.clear()
    verify.family_probes(torch.device("cpu"), False, golden.golden_dir())
    failed = list(verify.FAILURES)
    assert not verify.DRIFTS
    verify.FAILURES.clear()
    want = {"none": [], "gate 4 ulps": [], "lane c 1e-7": [],
            "gate swapped": ["P2 tanh vs torch cpu (<= 4 ulps)",
                             "P2 sigmoid vs torch cpu (<= 4 ulps)"],
            "gate 5 ulps": ["P2 sigmoid vs torch cpu (<= 4 ulps)"],
            "lane c 1e-5": ["P3 lane c (f32)"]}[fault]
    assert failed == want
