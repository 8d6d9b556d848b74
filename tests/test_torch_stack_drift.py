"""utils/stack_drift.py on the CPU at the `tiny` preset's widths: the
stack forward summed in f32 in two orders against its exact sums (the
plain version's), one JSON line; on the CPU no kernel runs."""

import json

import pytest

from wavenet_tpu_torch.utils import stack_drift


def test_stack_drift_reports_each_order(capsys):
    assert stack_drift.main(["--preset", "tiny", "--batch", "1",
                             "--window", "256", "--layers", "4",
                             "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["preset"], out["layers"], out["device"]) == ("tiny", 4, "cpu")
    assert sorted(out["vs_exact"]) == ["f32", "f32 reversed"]
    for v in out["vs_exact"].values():
        assert 0.0 <= v["skip_rel"] < 1e-2 and v["xs_differ"] >= 0


@pytest.mark.parametrize("args", [["--preset", "full_vocoder"],
                                  ["--preset", "tiny", "--layers", "11"]])
def test_stack_drift_refuses(args):
    with pytest.raises(SystemExit):
        stack_drift.main(args + ["--device", "cpu"])
