"""The comparison that decides ``correct``, driven through whole runs of
every cell on the CPU at a small size (the port's plain path,
``device="cpu"``): sound runs pass the cells' own limits; each fault the
cell can have, planted in the timed path, and the control (the reference in
the program's place, one precision below) fail them. The small sizes are
each driver's ``SMALL``, the faults each cell's own list."""

import pytest
import torch

from portbench import harness

CPU = torch.device("cpu")
SEED = 2**31 + 977
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def small(name):
    return harness.driver(harness.cell(name)).SMALL


def run(name, trace=False, fault=None):
    torch.manual_seed(0)
    return harness.run_cell(name, SEED, 0.3, trace, device=CPU, fault=fault,
                            overrides=dict(small(name)))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    c = harness.cell(name)
    assert set(r["metrics"]) == {m["name"] for m in c["end_to_end"]}
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(c["limits"])


@pytest.mark.parametrize("name,fault",
                         [(n, f) for n in CELLS for f in harness.cell(n)["faults"]])
def test_planted_fault_is_not_correct(name, fault):
    assert not run(name, fault=fault)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    c = harness.cell(name)
    c["params"].update(small(name))
    readings = c["program"].control(c, SEED, CPU)
    assert any(readings[k] > limit for k, limit in c["limits"].items()), readings


@pytest.mark.parametrize("name", [n for n in CELLS if harness.driver(harness.cell(n)).TASK
                                  == "train"])
def test_traced_run_reads_its_host_metrics(name):
    """Every host-clock reader of a training cell reads a traced CPU run; a
    device metric is never read on the CPU."""
    r = run(name, trace=True)
    assert r["correct"]
    for m in harness.cell(name)["per_layer"]:
        if m["source"] in ("host_clock", "device_trace"):
            assert (m["name"] in r["metrics"]) == (m["source"] == "host_clock"), m["name"]


def test_pose_is_judged_on_every_frame_its_corners_determine():
    """Frames of 5 or more corners that the reference's optimum fits are
    judged, one wrong pose among them is enough; 4 corners, or corners that
    fit no pose, are counted and left."""
    import numpy as np

    from portbench.reference import pose
    from portbench.reference.pipeline import Reference

    c = harness.cell("base_offline_pose")
    ref = Reference(c["config"], harness.ROOT, CPU)
    obj = torch.from_numpy(pose.object_points(c["config"]["board"]))
    K, d = torch.from_numpy(ref.K), torch.from_numpy(ref.dist)
    p = torch.tensor([0.2, -0.1, 0.05, -0.02, -0.02, 0.12], dtype=torch.float64)
    corners = np.repeat(pose.project(obj, p, K, d).numpy()[None], 4, 0)
    corners[3, 5] += 7.0                                     # a corner that fits no pose
    valid = np.ones((4, 16), bool)
    valid[2] = np.isin(np.arange(16), [0, 3, 12, 15])        # four corners
    ok, rvec, tvec, rms = pose.solve(c["config"]["board"], ref.K, ref.dist,
                                     torch.from_numpy(corners), torch.from_numpy(valid))
    out = {"refined": corners, "valid": valid, "ok": ok, "rvec": rvec, "tvec": tvec,
           "reproj_rms": rms}
    gaps, left = ref._pose_gaps(out)
    assert len(gaps) == 2 and left == 2 and gaps.max() < 1e-6
    out["tvec"] = tvec.copy()
    out["tvec"][1, 0] += 1e-3
    gaps, _ = ref._pose_gaps(out)
    assert gaps.max() > c["limits"]["pose_gap_max"]
    out["tvec"], out["ok"] = tvec, ok.copy()
    out["ok"][0] = False
    assert np.isinf(ref._pose_gaps(out)[0]).any()
