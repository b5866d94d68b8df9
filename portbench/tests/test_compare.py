"""The comparison that decides ``correct``, driven through whole runs of
every cell on the CPU at a small size (the port's plain path,
``device="cpu"``): sound runs pass the cells' own limits; each fault the
cell can have, planted in the timed path, and the control (the reference in
the program's place, one precision below) fail them."""

import pytest
import torch

from portbench import calibrate, harness

CPU = torch.device("cpu")
SMALL = {
    "offline": dict(batch=2, pool_batches=2, warm_batches=1, check_frames=4,
                    trace_skip=1, trace_steps=1, trace_drop=0),
    "stream": dict(streams=2, pool_frames=8, warm_steps=1, tail_steps=1, fps=10.0,
                   trace_skip=1, trace_steps=1, trace_drop=0, check_frames=4),
    "train_step": dict(batch=2, pool_batches=3, warm_steps=1, trace_skip=1,
                       trace_steps=1, trace_drop=0),
}
SEED = 2**31 + 977
FAULTS = {
    "base_offline_pose": ["wrong_rows", "altered_answer", "half_batch", "pose_wrong_corners",
                          "pose_one_row"],
    "hires_offline_pose": ["wrong_rows", "half_batch", "pose_wrong_corners"],
    "base_stream_pose": ["wrong_rows", "pose_wrong_corners", "pose_one_row"],
    "base_train_step": ["unchanged", "half_batch_train"],
}
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def small(name):
    return SMALL[harness.cell(name)["driver"]]


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


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items() for f in fs])
def test_planted_fault_is_not_correct(name, fault):
    assert not run(name, fault=fault)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    c = harness.cell(name)
    c["params"].update(small(name))
    fn = calibrate.control_train if c["driver"] == "train_step" else calibrate.control_inference
    readings = fn(c, SEED, CPU)
    assert any(readings[k] > limit for k, limit in c["limits"].items()), readings


def test_traced_run_reads_its_host_metrics():
    r = run("base_train_step", trace=True)
    assert r["correct"] and "enqueue_ms.train" in r["metrics"]
    assert "mfu.train" not in r["metrics"]         # a device metric is never read on the CPU


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
