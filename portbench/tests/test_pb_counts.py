"""The yardstick's arithmetic: operation counts, percentiles, rates and the
union of device intervals."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import roofline, sizes, stats, trace

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _sizes(name):
    return sizes.Sizes.from_model(
        json.loads((CONFIGS / f"{name}.json").read_text())["model"])


@pytest.mark.parametrize("name, layer, head, per_token", [
    ("full", 229_376, 262_144, 9_437_184),
    ("fastgen_bench", 57_344, 98_304, 1_245_184),
])
def test_forward_flops_per_token(name, layer, head, per_token):
    z = _sizes(name)
    assert roofline.layer_flops(z) == layer
    assert roofline.head_flops(z) == head
    assert roofline.forward_flops_per_token(z) == per_token
    assert roofline.train_flops_per_step(z) == \
        3 * per_token * z.batch * z.window
    assert roofline.stack_bwd_flops(z) == 2 * roofline.stack_fwd_flops(z)


def test_full_step_and_least_times():
    z = _sizes("full")
    assert roofline.train_flops_per_step(z) == 1_855_425_871_872
    fwd = roofline.least_seconds(roofline.stack_fwd_flops(z),
                                 roofline.stack_fwd_bytes(z), "bfloat16")
    assert fwd == pytest.approx(601_295_421_440 / 989e12)
    # a decode step at B = 4 is bound by its operations, not its bytes
    d = roofline.least_seconds(roofline.decode_flops(z, 4 * 8000),
                               roofline.decode_bytes(z, 1, 4, 4 * 8000),
                               "bfloat16")
    assert d == pytest.approx(4 * 8000 * 9_437_184 / 989e12)


def test_nearest_rank():
    v = list(range(1, 101))
    assert stats.nearest_rank(v, 95) == 95
    assert stats.nearest_rank(v, 100) == 100
    assert stats.nearest_rank([3.0], 95) == 3.0
    assert stats.nearest_rank([5, 1, 4, 2, 3], 50) == 3


def test_missing_requests_count_at_the_give_up_time():
    lat = stats.request_latencies([0.0, 1.0, 2.0], [0.5, None, 2.1], 10.0)
    assert lat == pytest.approx([0.5, 9.0, 0.1])


class _R:
    def __init__(self, seed, n, submit, first, chunks, done=True):
        self.seed, self.n, self.submit, self.first = seed, n, submit, first
        self.chunks, self.done, self.error = chunks, done, None


def test_window_metrics_over_requests_not_chunks():
    """One request with many chunks and three with one: the tail is over
    the four requests; the rate counts the samples that the launches
    delivered to real rows, a launch straddling the close by its share,
    over the whole window."""
    from portbench.traffic import closed_loop_serve as cls
    reqs = [_R(1, 5000, 0.0, 0.1, [(0.1 + i / 100, 100) for i in range(50)]),
            _R(2, 100, 0.0, 2.0, [(2.0, 100)]),
            _R(3, 60, 1.0, 4.0, [(4.0, 60)]),
            _R(4, 100, 9.5, None, [], done=None)]
    launches = ([(0.0 + i / 100, 0.1 + i / 100, 1, 100, (1,))
                 for i in range(50)]
                + [(1.5, 2.0, 2, 100, (2, 0)),      # a pad row: no samples
                   (3.0, 4.0, 1, 100, (3,))])      # 60 of its 100 steps
    assert [n for _, _, n in cls.launch_samples(reqs, launches)] == \
        [100] * 50 + [100, 60]
    m = cls.window_metrics(reqs, launches, t0=0.0, t1=10.0, window_s=10.0,
                           gave_up=20.0, sample_rate=1000)
    assert m["samples_in_window"] == pytest.approx(5160)
    assert m["served_audio_s_per_s"] == pytest.approx(0.516)
    # latencies 0.1, 2.0, 3.0 and 10.5 (missing, until gave_up)
    assert m["first_audio_ms_p95"] == pytest.approx(10_500.0)
    m = cls.window_metrics(reqs[:3], launches, 0.0, 10.0, 10.0, 20.0, 1000)
    assert m["first_audio_ms_p95"] == pytest.approx(3_000.0)
    # a launch straddling the close counts by its share inside the window,
    # those after the close not at all
    m = cls.window_metrics(reqs[:3], launches, 0.0, 3.25, 3.25, 20.0, 1000)
    assert m["samples_in_window"] == pytest.approx(5100 + 60 * 0.25)


def test_union_of_spans():
    assert trace.union_seconds([]) == 0
    assert trace.union_seconds([(0, 1), (0.5, 2), (3, 4)]) == 3
    assert trace.union_seconds([(0, 10), (1, 2), (3, 4)]) == 10
    assert trace.union_seconds([(5, 6), (0, 1)]) == 2


def test_trace_clips_to_the_window_and_finds_gaps():
    tr = trace.Trace((10.0, 20.0),
                     [("void (anonymous namespace)::fwd_layer_kernel<64>"
                       "(float*)", 9.0, 12.0),
                      ("void (anonymous namespace)::wgrad_kernel<1>(int)",
                       13.0, 14.0),
                      ("Memcpy HtoD (Pageable -> Device)", 15.0, 15.5),
                      ("late", 19.0, 25.0), ("outside", 30.0, 31.0)],
                     [("aten::copy_", 14.1, 14.9), ("trainer", 12.0, 15.0)])
    assert tr.window_s == 10.0
    assert tr.busy_s == pytest.approx(2.0 + 1.0 + 0.5 + 1.0)
    assert tr.seconds(lambda n: n == "fwd_layer_kernel") == 2.0
    assert tr.copy_seconds("HtoD") == 0.5
    b = tr.breakdown()
    assert b["device_ops"][0] == ["fwd_layer_kernel<64>", 2.0]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["trainer"] == pytest.approx(1.0)          # 12-13
    assert gaps["aten::copy_"] == pytest.approx(1.0)      # 14-15
    assert gaps["no host op"] == pytest.approx(3.5)       # 15.5-19
    assert trace.kernel_name("void (anonymous namespace)::wgrad_kernel<1>"
                             "(int)") == "wgrad_kernel<1>"
    assert trace.base_name("decode_wide_kernel<4, true, false>") == \
        "decode_wide_kernel"
