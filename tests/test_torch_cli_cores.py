"""The cores of ``cli.infer``, ``cli.eval`` and ``cli.pose_video`` and
their ``main([..., "--device", "cpu"])`` on the CPU against the JAX
package's: the pose filter and the pixel-error helpers (numpy copies, the
same floats), the infer rows against ``detect`` and the stored JAX outputs,
the eval core on the stored JAX synthesis against the JAX eval's forward,
the pose-video core against ``detect_with_pose``, RANSAC against JAX's,
and the cv2-only flags."""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu_torch.cli import benchmark as bench_cli
from deepcharuco_tpu_torch.cli import eval as eval_cli
from deepcharuco_tpu_torch.cli import infer as infer_cli
from deepcharuco_tpu_torch.cli import pose_video as pose_cli
from deepcharuco_tpu_torch.configs import default_config, load_configuration
from deepcharuco_tpu_torch.pipeline import Camera, load_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(ROOT, "artifacts", "detector_devsynth.npz")
RN = os.path.join(ROOT, "artifacts", "refinenet_devsynth.npz")
RN32 = os.path.join(ROOT, "artifacts", "refinenet32_devsynth.npz")
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_frames.npz")
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def fix():
    return dict(np.load(FIXTURE))


@pytest.fixture
def small(tmp_path):
    """The 64×96 config of ``tests/test_torch_train_cli.py`` (eval batches
    of 4 frames and 8 patches) and 4 frames."""
    cfg = tmp_path / "small.yaml"
    cfg.write_text("board_name: DICT_4X4_50\nrow_count: 5\ncol_count: 5\nsquare_len: 0.01\n"
                   "marker_len: 0.0075\ninput_size: [96, 64]\nbs_val: 4\nbs_val_rn: 8\n")
    frames = np.random.default_rng(0).integers(0, 255, (4, 64, 96), dtype=np.uint8)
    np.save(tmp_path / "frames.npy", frames)
    return tmp_path, ["--config", str(cfg)] + CPU, frames


# --- numpy copies --------------------------------------------------------

def pose_sequence(n=60):
    """A slowly moving board with noise, short and long dropouts, and a
    planar-ambiguity flip."""
    rng = np.random.default_rng(5)
    ok = np.ones(n, bool)
    ok[[7, 20, 21]] = False
    ok[30:38] = False                       # longer than max_coast: the track is lost
    rvec = np.stack([[0.1 + 0.01 * i, -0.2 + 0.005 * i, 0.05] for i in range(n)])
    tvec = np.stack([[0.01 * np.sin(i / 9), 0.002 * i, 0.3 + 0.001 * i] for i in range(n)])
    rvec = rvec + rng.normal(0, 2e-3, rvec.shape)
    tvec = tvec + rng.normal(0, 5e-4, tvec.shape)
    rvec[45] = rvec[45] * np.array([-1.0, 1.0, 1.0]) + np.array([0.8, 0.0, 0.0])   # flip
    return ok, rvec, tvec


def test_pose_filter_bit_equal_to_jax():
    from deepcharuco_tpu.pose_filter import PoseFilter as JFilter
    from deepcharuco_tpu_torch.pose_filter import PoseFilter

    ok, rvec, tvec = pose_sequence()
    ours, theirs = PoseFilter(gate_t=0.1), JFilter(gate_t=0.1)
    states = set()
    for i in range(len(ok)):
        a = ours.update(bool(ok[i]), rvec[i], tvec[i])
        b = theirs.update(bool(ok[i]), rvec[i], tvec[i])
        assert a[0] == b[0] and a[3] == b[3], i
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
        states.add(a[3])
    assert states == {"tracking", "coasting", "lost"}


def test_pixel_error_and_l2_distance_equal_jax():
    from deepcharuco_tpu import utils as ju
    from deepcharuco_tpu_torch import utils as pu

    rng = np.random.default_rng(2)
    target = np.concatenate([rng.uniform(0, 320, (12, 2)), np.arange(12)[:, None]], 1)
    raw = target[[1, 3, 4, 8, 8]] + np.concatenate([rng.normal(0, 2, (5, 2)),
                                                    np.zeros((5, 1))], 1)
    ref = raw + np.concatenate([rng.normal(0, 0.5, (5, 2)), np.zeros((5, 1))], 1)
    for args in ((raw[:, :2], raw[:, 2], target[:, :2], target[:, 2]),
                 (raw[:, :2], raw[:, 2], target[:0, :2], target[:0, 2])):
        a, b = pu.compute_l2_distance(*args), ju.compute_l2_distance(*args)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert pu.pixel_error(raw, ref, target, verbose=False) == \
        ju.pixel_error(raw, ref, target, verbose=False)
    bad = raw.copy()
    bad[0, 2] = 40
    assert pu.pixel_error(bad, ref, target, verbose=False) == (None, None)


# --- infer, eval, pose_video ---------------------------------------------

def test_infer_rows_equal_detect(small, capsys, fix):
    tmp, base, frames = small
    got = infer_cli.main([str(tmp / "frames.npy"), "--deepc", DET, "--refinenet", RN] + base)
    out = capsys.readouterr().out.splitlines()
    pipe = load_pipeline(load_configuration(base[1]), DET, RN, device="cpu")
    kp, valid, refined = pipe.detect(frames)
    for i, (rows, k, v, r) in enumerate(got):
        np.testing.assert_array_equal(rows, pipe.keypoint_array(refined[i], valid[i]))
        np.testing.assert_array_equal(v, valid[i])
    assert re.match(r"^\S+frames\.npy\[0\]: \d+ corners$", out[0])
    # the fixture frames: the rows hold to the stored JAX bf16 outputs
    pipe = load_pipeline(default_config(), DET, RN, device="cpu")
    got = infer_cli.infer_frames(pipe, fix["frames"], batch=4)
    valid = np.stack([v for _, _, v, _ in got])
    assert (valid != fix["valid_bf16"]).mean() <= 0.02
    both = valid & fix["valid_bf16"]
    refined = np.stack([r for _, _, _, r in got])
    near = (np.abs(refined - fix["refined_bf16"]).max(-1) <= 0.125)[both].mean()
    assert near >= 0.98


def test_infer_hires_and_cv2_outputs(small, capsys):
    tmp, base, _ = small
    hi = np.random.default_rng(1).integers(0, 255, (2, 128, 192), dtype=np.uint8)
    np.save(tmp / "hi.npy", hi)
    infer_cli.main([str(tmp / "hi.npy"), "--hires", "--refinenet", RN32, "--rn-patch-size",
                    "32", "--rn-decode", "soft", "--geom-decode", "--geom-fill",
                    "--out-dir", str(tmp / "vis"), "--cv2-baseline"] + base)
    assert sorted(os.listdir(tmp / "vis")) == ["hi.npy_0.png", "hi.npy_1.png"]


def test_cv2_flags_fail_clearly_without_cv2(small, monkeypatch):
    tmp, base, _ = small
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="needs OpenCV"):
        infer_cli.main([str(tmp / "frames.npy"), "--out-dir", str(tmp / "o")] + base)
    with pytest.raises(SystemExit, match="needs OpenCV"):
        infer_cli.main([str(tmp / "a.png")] + base)
    with pytest.raises(SystemExit, match="needs OpenCV"):
        pose_cli.main([str(tmp / "frames.npy")] + base)
    with pytest.raises(SystemExit, match="needs OpenCV"):
        bench_cli.main(base + ["--image", "x.png", "--batch", "1"])
    poses = pose_cli.main([str(tmp / "frames.npy"), "--no-video"] + base)   # no cv2 needed
    assert len(poses) == 4


@pytest.mark.parametrize("flags", [[], ["--truth", "subpixel", "--soft-argmax"],
                                   ["--truth", "subpixel", "--hires", "--rn-patch-size", "32",
                                    "--refinenet", RN32, "--geom-decode", "--geom-fill"],
                                   ["--frontal", "--scale", "1.0", "--min-margin", "0.5"]])
def test_eval_cli_on_the_cpu(small, capsys, flags):
    _, base, _ = small
    refinenet = [] if "--refinenet" in flags else ["--refinenet", RN]
    res = eval_cli.main(base + ["--samples", "16", "--deepc", DET] + refinenet + flags)
    out = capsys.readouterr().out.splitlines()
    assert re.match(r"^samples: 16  target corners: \d+  predicted: \d+  "
                    r"matched\(<3.0px\): \d+$", out[0])
    assert res["samples"] == 16 and res["n_target"] > 0


def test_eval_refuses_the_host_stream(small):
    _, base, _ = small
    with pytest.raises(NotImplementedError, match="A4"):
        eval_cli.main(base + ["--source", "host"])


def jax_eval_forward(images):
    """``deepcharuco_tpu/cli/eval.py``'s forward (float32, hard decode)."""
    from deepcharuco_tpu.models import Detector, RefineNet
    from deepcharuco_tpu.ops import extract_patches, pred_to_keypoints, refine_keypoints
    from deepcharuco_tpu.pipeline import variables_from_npz

    det, rn = Detector(n_ids=16, dtype=jnp.float32), RefineNet(dtype=jnp.float32)
    dv, rv = variables_from_npz(DET), variables_from_npz(RN)
    out = det.apply(dv, images)
    kp, valid = pred_to_keypoints(out["loc"], out["ids"], 16)
    patches = extract_patches(images, kp, patch_size=24)
    n, k, p, _ = patches.shape
    heat = rn.apply(rv, patches.reshape(n * k, p, p, 1)).reshape(n, k, 64, 64)
    return kp, valid, refine_keypoints(heat, kp)


def test_eval_core_on_the_stored_jax_draws(fix):
    images = fix["synth/det_base/out/images"].astype(np.float32)
    truth = (torch.from_numpy(fix["synth/det_base/out/kpts"]),
             torch.from_numpy(fix["synth/det_base/out/visible"]))
    args = eval_cli.build_argparser().parse_args(["--deepc", DET, "--refinenet", RN] + CPU)
    port = eval_cli.evaluate(eval_cli.make_forward(args, default_config(), torch.device("cpu")),
                             [(torch.from_numpy(images), truth)], 16, truth="subpixel")
    jax_fwd = lambda x: tuple(torch.from_numpy(np.array(t)) for t in jax_eval_forward(
        jnp.asarray(x.numpy())))
    theirs = eval_cli.evaluate(jax_fwd, [(torch.from_numpy(images), truth)], 16,
                               truth="subpixel")
    for key in ("n_target", "n_pred", "n_matched"):
        assert abs(port[key] - theirs[key]) <= 1, key
        assert abs(port[key] - int(fix[f"eval/{key}"])) <= 1, key
    for key in ("raw_mean", "refined_mean"):
        assert abs(port[key] - theirs[key]) <= 1e-3, key
        assert abs(port[key] - float(fix[f"eval/{key}"])) <= 1e-3, key


def test_pose_video_core_equals_the_pipeline(fix):
    from deepcharuco_tpu_torch.pose_filter import PoseFilter

    cam = Camera(K=fix["K"], dist=fix["dist"])
    pipe = load_pipeline(default_config(), DET, RN, camera=cam, device="cpu")
    frames = fix["frames"]
    want = pipe.detect_with_pose(frames)
    got = list(pose_cli.estimate(pipe, [frames[:5], frames[5:]]))
    for i, (kp, v, r, ok, rvec, tvec) in enumerate(got):
        for a, b in ((kp, want[0][i]), (v, want[1][i]), (r, want[2][i]), (ok, want[3][i]),
                     (rvec, want[4][i]), (tvec, want[5][i])):
            np.testing.assert_array_equal(a, b)
    stats = {}
    smooth = list(pose_cli.estimate(pipe, [frames], pose_filter=PoseFilter(gate_t=0.1),
                                    stats=stats))
    ref = PoseFilter(gate_t=0.1)
    for i, (_, _, _, ok, rvec, tvec) in enumerate(smooth):
        o, r, t, _ = ref.update(bool(want[3][i]), want[4][i].astype(np.float64),
                                want[5][i].astype(np.float64))
        assert ok == o
        np.testing.assert_array_equal(rvec, r)
        np.testing.assert_array_equal(tvec, t)
    assert sum(stats.values()) == len(frames)
    # --ransac: detect's corners through pnp.ransac with a generator seeded 0
    from deepcharuco_tpu_torch.pnp.ransac import solve_pnp_ransac_batch

    robust = list(pose_cli.estimate(pipe, [frames], cam, ransac=True))
    to = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    direct = solve_pnp_ransac_batch(pipe.object_points, to(want[2]),
                                    torch.as_tensor(want[1]), to(cam.K), to(cam.dist),
                                    torch.Generator().manual_seed(0))
    for i, (_, _, _, ok, rvec, tvec) in enumerate(robust):
        assert ok == bool(direct[0][i])
        np.testing.assert_array_equal(rvec, direct[1][i].numpy())
        np.testing.assert_array_equal(tvec, direct[2][i].numpy())


def test_ransac_misses_no_more_often_than_jax(fix):
    """16 four-point hypotheses often land on the planar twin or fail on
    these frames, in the JAX package as in the port; over 10 seeds each the
    port's frames that are not ok or off the least-squares pose by more than
    0.02 rad must not outnumber JAX's by more than 8 of 80."""
    from deepcharuco_tpu.board import inner_corner_object_points
    from deepcharuco_tpu.pnp.ransac import solve_pnp_ransac_batch as jransac
    from deepcharuco_tpu_torch.pnp.ransac import solve_pnp_ransac_batch

    obj = inner_corner_object_points(5, 5, 0.01)
    ref, valid, K, dist = (fix[k] for k in ("refined_bf16", "valid_bf16", "K", "dist"))
    misses = lambda ok, rvec: int((~ok | (np.abs(rvec - fix["rvec_bf16"]).max(-1) > 0.02)).sum())
    ours = theirs = 0
    jitted = jax.jit(jransac)
    for seed in range(10):
        out = jitted(*(jnp.asarray(a) for a in (obj, ref, valid, K, dist)),
                     jax.random.PRNGKey(seed))
        theirs += misses(np.asarray(out[0]), np.asarray(out[1]))
        out = solve_pnp_ransac_batch(*(torch.from_numpy(a) for a in (obj, ref, valid, K, dist)),
                                     torch.Generator().manual_seed(seed))
        ours += misses(out[0].numpy(), out[1].numpy())
    print(f"RANSAC misses over 80 frame solves: port {ours}, JAX {theirs}")
    assert ours <= theirs + 8


@pytest.mark.parametrize("flags", [[], ["--smooth", "--ransac"],
                                   ["--hires", "--refinenet", RN32, "--rn-patch-size", "32",
                                    "--rn-decode", "soft", "--geom-decode"]])
def test_pose_video_cli_on_the_cpu(small, capsys, flags):
    tmp, base, frames = small
    src = tmp / "frames.npy"
    if "--hires" in flags:
        np.save(tmp / "hi.npy", np.repeat(np.repeat(frames, 2, 1), 2, 2))
        src = tmp / "hi.npy"
    refinenet = [] if "--refinenet" in flags else ["--refinenet", RN]
    poses = pose_cli.main([str(src), "--batch", "3", "--deepc", DET] + refinenet + flags
                          + base)
    out = capsys.readouterr().out
    assert len(poses) == 4 and "4/4 frames" in out
    assert os.path.getsize(tmp / "res.mp4") > 0
    if "--smooth" in flags:
        assert re.search(r"pose filter: tracking \d+, coasting \d+, lost \d+", out)


