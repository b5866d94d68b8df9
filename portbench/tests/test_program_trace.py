"""The readers of the program's own spans (``portbench/program_trace.py``)
in a small traced run of every cell on the CPU: each host-side reader
returns a number, each reader that needs the device's events returns None,
and against a program without a recorder every reader returns None."""

import pytest
import torch

from portbench import harness, program_trace
from portbench.tests.test_compare import SEED, small

CPU = torch.device("cpu")
HOST = {"base_offline_pose": ["stage_ms.offline", "fetch_wait_ms.offline"],
        "hires_offline_pose": ["stage_ms.offline", "fetch_wait_ms.offline"],
        "base_stream_pose": ["pull_ms.stream"],
        "base_train_step": ["backward_enqueue_ms.train", "update_enqueue_ms.train"],
        "base_train_devsynth": ["backward_enqueue_ms.train", "update_enqueue_ms.train"]}
DEVICE = {"base_offline_pose": ["pose_ms.offline"],
          "hires_offline_pose": ["pose_ms.offline"],
          "base_stream_pose": ["held_ms.stream", "step_idle_pct.stream",
                               "idle_in_pull_pct.stream"],
          "base_train_step": [], "base_train_devsynth": []}


def traced(name):
    torch.manual_seed(0)
    # the profiler starts after a few steps, so that the window before it
    # holds whole steps to read
    over = dict(small(name), trace_skip=3)
    return harness.run_once(name, SEED, 0.5, True, device=CPU, overrides=over)


@pytest.mark.parametrize("name", sorted(HOST))
def test_program_span_readers_in_a_traced_cpu_run(name, monkeypatch):
    result, run, _ = traced(name)
    assert result["correct"], result["checks"]
    spec = {m["name"]: m for m in harness.cell(name)["per_layer"]}
    for metric in HOST[name] + DEVICE[name]:
        assert spec[metric]["source"] == "program_span"
    for metric in HOST[name]:
        value = harness.reader(metric)(run)
        assert isinstance(value, float) and value >= 0, metric
        assert result["metrics"][metric]["value"] == value
    for metric in DEVICE[name]:
        assert harness.reader(metric)(run) is None and metric not in result["metrics"]
    monkeypatch.setattr(program_trace, "recorder", lambda: None)
    for metric in HOST[name] + DEVICE[name]:
        assert harness.reader(metric)(run) is None, metric


def test_served_steps_hold_their_children():
    _, run, _ = traced("base_stream_pose")
    got = program_trace.steps(run)
    assert got
    for d in got:
        step = d["serving.step"]
        assert {"serving.pull", "serving.stage", "serving.launch", "serving.fetch"} <= set(d)
        assert all(s.step == step.step and s.parent is step for s in d.values() if s is not step)
        assert step.t0 <= d["serving.pull"].t0 and d["serving.fetch"].t1 <= step.t1
