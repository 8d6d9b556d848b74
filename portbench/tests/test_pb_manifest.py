"""BENCHMARK.json's names, units, `moves` and files, and the import
check."""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench import harness, manifest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def doc():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_meets_the_contract(doc):
    assert manifest.validate(doc, ROOT) == []


def test_names_and_cells(doc):
    assert [c["name"] for c in doc["configs"]] == ["full", "fastgen_bench"]
    assert [w["name"] for w in doc["workloads"]] == [
        "full.train", "fastgen_bench.serve", "full.serve",
        "fastgen_bench.train"]
    assert all(w["chips"] == 1 for w in doc["workloads"])


@pytest.mark.parametrize("edit, fault", [
    (lambda d: d["per_layer"][0].update(name="data ms"), "name"),
    (lambda d: d["per_layer"][0].update(name="mfu/train"), "name"),
    (lambda d: d["end_to_end"][0].update(unit="audio s/s"), "unit"),
    (lambda d: d["end_to_end"][0].update(unit="µs"), "unit"),
    (lambda d: d["per_layer"][0].update(moves="setup"), "moves"),
    (lambda d: d["per_layer"][0].update(moves="served_audio_s_per_s"),
     "do not report"),
    (lambda d: d["configs"][0].update(name="full model"), "name"),
    (lambda d: d["configs"][0]["reduced"].append("num,blocks"), "name"),
    (lambda d: d["workloads"][1].update(traffic="closed 64"), "name"),
    (lambda d: d["end_to_end"][1].update(unit=""), "unit"),
    (lambda d: d["configs"][1].update(file="portbench/configs/nowhere.json"),
     "does not exist"),
    (lambda d: d["workloads"][1].update(traffic="nowhere"),
     "no portbench/traffic/nowhere.json"),
    (lambda d: d["per_layer"].append(dict(d["per_layer"][0],
                                          name="nowhere")), "no reader"),
])
def test_manifest_faults_are_found(doc, edit, fault):
    bad = copy.deepcopy(doc)
    edit(bad)
    errs = manifest.validate(bad, ROOT)
    assert any(fault in e for e in errs), errs


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".", 1)[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in ("wavenet_tpu_torch", "wavenet_tpu_torch.config",
                 "jax_like", "flaxen", "my_jaxlib"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "wavenet_tpu.models",
                        types.ModuleType("wavenet_tpu.models"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "wavenet_tpu"]


def test_the_harness_imports_no_jax():
    """The import closure of a run's modules, in a fresh process: the
    harness, every driver and reader, the reference and the port's modules
    that the drivers use."""
    code = """
import sys, importlib, pathlib
from portbench import harness, calibrate, manifest
from portbench.reference import data, model, serve, train
for name in ("full.train", "fastgen_bench.serve"):
    cell = harness.load_cell(name)
    for m in cell.per_layer:
        harness._reader(m["name"])
import wavenet_tpu_torch.training.trainer, wavenet_tpu_torch.serving.server
import wavenet_tpu_torch.models.api, wavenet_tpu_torch.audio.dataset
import wavenet_tpu_torch.generate.sampler, wavenet_tpu_torch.utils.compcache
print(",".join(harness.forbidden_modules()))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""
