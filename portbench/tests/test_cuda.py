"""One short run of every cell on the card, through the command the driver
runs, its result line read as the driver reads it. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # a traced run needs the whole window: its profiler starts halfway through
    seconds = harness.benchmark()["run_seconds"] if trace else 2
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                          "--seed", str(2**31 + 5), "--seconds", str(seconds),
                          "--trace", str(trace)],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    c = harness.cell(name)
    want = c["per_layer"] if trace else c["end_to_end"]
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if trace:
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
    else:
        assert set(line["metrics"]) == {m["name"] for m in want}
