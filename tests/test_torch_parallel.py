"""The port's mesh (``deepcharuco_tpu_torch.parallel``) on the CPU: gloo
ranks in processes of their own, held against the port's one-process
programs and the JAX package's mesh programs on the conftest's 8 CPU
devices.

The ranks run ``tests/_torch_parallel_worker.py`` (torch and the port only:
no rank imports JAX), started once per layout in a module fixture: two
ranks for the 2×1 and 1×2 meshes, four for the 2×2 and 1×4 meshes, joined through a
file store. Rank 0 writes each job's results.

Tolerances, float64 steps (3 Adam steps of the shipped detector at lr
5e-3, 2 of the shipped RefineNet at 1e-4) against the one-process step:
losses and every parameter and running statistic within 1e-9 of the
tensor's largest value, but for the biases of convolutions that feed a
BatchNorm: their gradient is zero up to rounding, and Adam turns that
rounding into steps of its own, held to 1e-6·lr. Against JAX's
``sharded_train_step`` on the same mesh: ``tests/test_torch_train_steps.py``'s
float64 rules. Sharded inference against the one-process call: equal;
against JAX's ``sharded_inference`` on the same mesh: keypoints and
``valid`` equal, refined corners within 1e-4 px, |Δrvec| ≤ 1e-3 rad and
|Δtvec| ≤ 1e-3·|tvec| where both solves succeed.
"""

import functools
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parallel_worker as WK
from deepcharuco_tpu.board import inner_corner_object_points as jobject_points
from deepcharuco_tpu.models import Detector as JDetector
from deepcharuco_tpu.models import RefineNet as JRefineNet
from deepcharuco_tpu.parallel import make_mesh as jmake_mesh
from deepcharuco_tpu.parallel import replicate as jreplicate
from deepcharuco_tpu.parallel import shard_batch as jshard_batch
from deepcharuco_tpu.parallel import sharded_inference as jsharded_inference
from deepcharuco_tpu.parallel import sharded_train_step as jsharded_train_step
from deepcharuco_tpu.pipeline import full_forward as jfull_forward
from deepcharuco_tpu.pipeline import two_stage_forward as jtwo_stage_forward
from deepcharuco_tpu.train import steps as JS
from deepcharuco_tpu_torch import weights as W
from deepcharuco_tpu_torch.cli import train as det_cli
from deepcharuco_tpu_torch.data import (BatchLoader, DeviceRefineSynthesizer,
                                        DeviceSynthesizer, FramePatchSynthesizer)
from deepcharuco_tpu_torch.models.detector import splits_rows
from deepcharuco_tpu_torch.parallel import (Mesh, make_mesh, shard_batch, shard_frames,
                                            sharded_synth_train_program)
from deepcharuco_tpu_torch.train import make_detector_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")
RUN_TIMEOUT = 400


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def _start_ranks(world, out_dir):
    init = os.path.join(out_dir, "init")
    return [subprocess.Popen([sys.executable, WORKER, init, out_dir], cwd=ROOT,
                             env=_env(RANK=str(r), WORLD_SIZE=str(world),
                                      LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both layouts' results: {job: arrays}. The 2-rank and 4-rank groups
    run at the same time."""
    dirs = {w: str(tmp_path_factory.mktemp(f"ranks{w}")) for w in (2, 4)}
    procs = {w: _start_ranks(w, d) for w, d in dirs.items()}
    logs = {}
    for w, group in procs.items():
        for r, p in enumerate(group):
            try:
                logs[w, r] = p.communicate(timeout=RUN_TIMEOUT)[0]
            except subprocess.TimeoutExpired:
                for q in group:
                    q.kill()
                raise
            assert p.returncode == 0, f"rank {r} of {w}:\n{logs[w, r]}"
    out = {}
    for d in dirs.values():
        for name in os.listdir(d):
            if name.endswith(".npz"):
                with np.load(os.path.join(d, name)) as z:
                    out[name[:-4]] = {k: z[k] for k in z.files}
    out["logs"] = logs
    return out


def test_every_rank_joined_with_gloo(ranks):
    """(That the worker imports no JAX is ``tests/test_torch_weights.py``'s
    static check.)"""
    for (w, r), log in ranks["logs"].items():
        assert f"rank {r} of {w}, backend gloo, device cpu" in log, log
    assert {"det_2x1", "det_2x2", "rn_2x2", "synth_2x1", "synth_2x2", "infer_2x1",
            "infer_2x2", "infer_1x4", "host_1x2"} <= set(ranks)


# ---------------------------------------------------------------------------
# Steps against the one-process step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process():
    return {"det": WK.det_steps(), "rn": WK.rn_steps(), "synth": WK.synth_program()}


def _feeds_a_batchnorm(key):
    return key.endswith("conv.bias") and not key.startswith(("convPb", "convDb"))


def assert_state_close(got, want, lr):
    for k, t in want.items():
        b = t.numpy()
        if b.dtype.kind != "f":
            continue
        diff = np.abs(got[k] - b).max()
        limit = 1e-6 * lr if _feeds_a_batchnorm(k) else 1e-9 * np.abs(b).max()
        assert diff <= limit, (k, diff, limit)


@pytest.mark.parametrize("job,lr", [("det_2x1", WK.DET_LR), ("det_2x2", WK.DET_LR),
                                    ("rn_2x2", 1e-4)])
def test_sharded_steps_match_the_one_process_step(ranks, one_process, job, lr):
    want_sd, want_losses = one_process[job.split("_")[0]]
    got = ranks[job]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-9)
    assert_state_close(got, want_sd, lr)


@pytest.mark.parametrize("job", ["synth_2x1", "synth_2x2"])
def test_sharded_synth_program_matches_synth_scan_program(ranks, one_process, job):
    """Two fused rounds of synthesis + step; each rank renders its own
    samples of the global batch, which is the one-process batch bit for bit
    (test below), so the step agrees as the host-fed one does."""
    want_sd, want_loss = one_process["synth"]
    got = ranks[job]
    np.testing.assert_allclose(got["losses"], [want_loss], rtol=1e-9)
    assert_state_close(got, want_sd, 1e-4)


def test_spatial_peers_train_on_the_same_host_batch(ranks):
    """The trainer's host feed on a 1×2 mesh. ``CharucoDataset``'s draws
    are not seeded alike on the ranks: the first rank of the spatial group
    builds the batch and the other receives it, so the two halves of the
    height belong to the same images and labels."""
    got = ranks["host_1x2"]
    for k in ("image", "loc", "ids"):
        np.testing.assert_array_equal(got[f"peer1/{k}"], got[f"peer0/{k}"], err_msg=k)
        np.testing.assert_array_equal(got[f"peer0/{k}"], got[k], err_msg=k)
    assert (got["ids"] != 16).any()               # the batch holds corners


def test_host_fed_spatial_step_matches_the_one_process_step(ranks):
    """Two float64 steps on that host batch, height split over 1×2, against
    the one-process steps on the same batch."""
    got = ranks["host_1x2"]
    want_sd, want_losses = WK.det_steps(steps=2, batch=(got["image"], got["loc"], got["ids"]))
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-9)
    assert_state_close(got, want_sd, WK.DET_LR)


# ---------------------------------------------------------------------------
# Steps against JAX's sharded_train_step on the same mesh (float64)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps():
    """3 Adam steps of JAX's float64 detector through ``sharded_train_step``
    on ``make_mesh(2, 1)`` and ``make_mesh(2, 2)``: (losses, state dict)."""
    from deepcharuco_tpu.pipeline import variables_from_npz

    v = variables_from_npz(WK.DET)
    images, loc, ids = WK.det_batch()
    out = {}
    with jax.enable_x64(True):
        jdet = JDetector(n_ids=16, dtype=jnp.float64, param_dtype=jnp.float64)
        tx = optax.adam(WK.DET_LR)
        step_fn = JS.make_detector_train_step(jdet, tx, **WK.CONF)
        for n_d, n_s in ((2, 1), (2, 2)):
            # fresh arrays each time: the sharded step donates its state
            v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
            state = JS.TrainState(step=jnp.zeros((), jnp.int32), params=v64["params"],
                                  batch_stats=v64["batch_stats"],
                                  opt_state=tx.init(v64["params"]))
            mesh = jmake_mesh(n_d, n_s)
            with mesh:
                state = jreplicate(mesh, state)
                batch = jshard_batch(mesh, (jnp.asarray(images, jnp.float64),
                                            jnp.asarray(loc), jnp.asarray(ids)))
                step = jsharded_train_step(step_fn, mesh)
                losses = []
                for _ in range(3):
                    state, aux = step(state, *batch)
                    losses.append(float(aux["loss"]))
            tree = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                {"params": state.params, "batch_stats": state.batch_stats})
            out[f"{n_d}x{n_s}"] = (losses, W.detector_state_dict(tree))
    return out


@pytest.mark.parametrize("layout", ["2x1", "2x2"])
def test_sharded_steps_match_jax_sharded_train_step(ranks, jax_steps, layout):
    jlosses, want = jax_steps[layout]
    got = ranks[f"det_{layout}"]
    for i in range(3):
        assert abs(got["losses"][i] - jlosses[i]) <= 1e-5 * abs(jlosses[i]), i
    lr = WK.DET_LR
    for k, b in want.items():
        if "num_batches" in k:
            continue
        diff = np.abs(got[k] - b)
        if k.endswith("running_var"):
            assert diff.max() <= 1e-4 * np.abs(b).max(), (k, diff.max())
            continue
        assert diff.max() <= 3 * lr, (k, diff.max())
        if not k.endswith(("conv.bias", "running_mean")):
            close = diff <= 5e-5 + 1e-5 * np.abs(b)
            assert close.mean() >= 0.999, (k, close.mean(), diff.max())


# ---------------------------------------------------------------------------
# Shares of a synthesized batch and of the host loader
# ---------------------------------------------------------------------------

def _synthesizers():
    cfg = WK.small_config()
    bank = np.random.default_rng(0).uniform(0, 255, (3, 96, 128)).astype(np.float32)
    return {"device": (DeviceSynthesizer(cfg, low_gain_p=0.5, perspective_p=0.5,
                                         axis_snap_p=0.5, device="cpu"), 8),
            "device_bank": (DeviceSynthesizer(cfg, bg_bank=bank, device="cpu"), 8),
            "frame_patches": (FramePatchSynthesizer(cfg, per_frame=4, device="cpu"), 16),
            "refine": (DeviceRefineSynthesizer(cfg, device="cpu"), 8)}


@pytest.mark.parametrize("name", ["device", "device_bank", "frame_patches", "refine"])
@pytest.mark.parametrize("k", [2, 4])
def test_a_share_renders_those_rows_of_the_whole_batch(name, k):
    synth, n = _synthesizers()[name]
    whole = synth.batch(torch.Generator().manual_seed(5), n)
    for i in range(k):
        part = synth.batch(torch.Generator().manual_seed(5), n, share=(i, k))
        for a, b in zip(part, whole):
            assert torch.equal(a, b[i * n // k:(i + 1) * n // k]), (name, i)


def test_frame_patch_share_of_part_of_a_frame_renders_every_frame():
    synth = FramePatchSynthesizer(WK.small_config(), per_frame=4, device="cpu")
    whole = synth.batch(torch.Generator().manual_seed(1), 8)
    with pytest.warns(UserWarning, match="not a multiple of per_frame"):
        part = synth.batch(torch.Generator().manual_seed(1), 8, share=(1, 4))
    for a, b in zip(part, whole):
        assert torch.equal(a, b[2:4])


class _Indexed:
    """A dataset whose item ``i`` is a function of ``i`` alone, which
    records the indices it was asked for."""

    def __init__(self, n):
        self.n, self.asked = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.asked.append(i)
        return {"x": np.full((2,), i, np.int64)}


def test_batch_loader_shares_reassemble_the_one_loader_batches():
    whole_ds = _Indexed(50)
    whole = [b["x"] for b in BatchLoader(whole_ds, 6, num_workers=1, seed=0, max_batches=5)]
    parts, asked = [], []
    for i in range(3):
        ds = _Indexed(50)
        parts.append([b["x"] for b in BatchLoader(ds, 6, num_workers=1, seed=0,
                                                  max_batches=5, share=(i, 3))])
        asked.append(sorted(ds.asked))
    for j in range(5):
        np.testing.assert_array_equal(np.concatenate([p[j] for p in parts]), whole[j])
    assert sorted(sum(asked, [])) == sorted(whole_ds.asked)   # nothing built twice
    uneven = BatchLoader(_Indexed(50), 5, num_workers=1, seed=0, max_batches=1,
                         share=(1, 3))
    np.testing.assert_array_equal(next(iter(uneven))["x"], whole[0][:5])


# ---------------------------------------------------------------------------
# Sharded inference
# ---------------------------------------------------------------------------

INFER = {"infer_2x1": ["two_stage"],
         "infer_2x2": ["two_stage", "fused", "geom_fill", "full", "full_fused"],
         "infer_1x4": ["two_stage_224", "two_stage"]}


@pytest.fixture(scope="module")
def one_process_inference():
    det, rn = WK.pipeline_models()
    return {name: tuple(t.numpy() for t in fn(det, rn, frames))
            for name, (fn, frames) in WK.inference_fns().items()}


@pytest.mark.parametrize("job,name", [(j, n) for j, names in INFER.items() for n in names])
def test_sharded_inference_equals_the_one_process_call(ranks, one_process_inference, job,
                                                       name):
    want = one_process_inference[name]
    for i, b in enumerate(want):
        np.testing.assert_array_equal(ranks[job][f"{name}/{i}"], b, err_msg=f"{name}/{i}")


@pytest.fixture(scope="module")
def jax_inference():
    """JAX's ``sharded_inference`` of ``two_stage_forward`` on 2×2 and on 1×4
    (224-row frames) and of ``full_forward`` on 2×2, float32, shipped
    weights."""
    from deepcharuco_tpu.pipeline import variables_from_npz

    det, rn = JDetector(n_ids=16, dtype=jnp.float32), JRefineNet(dtype=jnp.float32)
    dv, rv = variables_from_npz(WK.DET), variables_from_npz(WK.RN)
    obj = jnp.asarray(jobject_points(5, 5, 0.01))
    K = jnp.asarray([[420.0, 0, 160], [0, 420.0, 120], [0, 0, 1]], jnp.float32)
    dist = jnp.zeros(5, jnp.float32)
    two = lambda dv, rv, x: jtwo_stage_forward(det, rn, dv, rv, x, 16)
    full = lambda dv, rv, x: jfull_forward(det, rn, dv, rv, x, 16, obj, K, dist)
    out = {}
    for key, fn, layout, frames in (
            ("infer_2x2/two_stage", two, (2, 2), WK.inference_frames()),
            ("infer_2x2/full", full, (2, 2), WK.inference_frames()),
            ("infer_1x4/two_stage_224", two, (1, 4), WK.inference_frames(224, 2))):
        mesh = jmake_mesh(*layout)
        with mesh:
            res = jsharded_inference(fn, mesh)(jreplicate(mesh, dv), jreplicate(mesh, rv),
                                               jnp.asarray(frames))
        out[key] = tuple(np.asarray(o) for o in res)
    return out


@pytest.mark.parametrize("key", ["infer_2x2/two_stage", "infer_2x2/full",
                                 "infer_1x4/two_stage_224"])
def test_sharded_inference_matches_jax_on_the_same_mesh(ranks, jax_inference, key):
    job, name = key.split("/")
    got = [ranks[job][f"{name}/{i}"] for i in range(len(jax_inference[key]))]
    want = jax_inference[key]
    valid = want[1]
    np.testing.assert_array_equal(got[1], valid)
    np.testing.assert_array_equal(got[0][valid], want[0][valid])
    np.testing.assert_allclose(got[2][valid], want[2][valid], atol=1e-4)
    if name == "full":
        ok = got[3] & want[3]
        assert ok.sum() >= 2 and (got[3] == want[3]).all()
        assert np.abs(got[4][ok] - want[4][ok]).max() <= 1e-3
        tdiff = np.linalg.norm(got[5][ok] - want[5][ok], axis=-1)
        assert (tdiff <= 1e-3 * np.linalg.norm(want[5][ok], axis=-1)).all()


# ---------------------------------------------------------------------------
# make_mesh's errors and the warnings of an indivisible dimension
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,error", [(dict(n_spatial=2), ValueError),
                                          (dict(n_data=0), ValueError),
                                          (dict(n_data=2, n_spatial=2), AssertionError),
                                          (dict(n_data=4), AssertionError)])
def test_make_mesh_errors_are_jax_s(kwargs, error):
    """The same errors with the same messages, on three devices (ranks)."""
    with pytest.raises(error) as got:
        make_mesh(devices=[0, 1, 2][:1 if "n_spatial" in kwargs and "n_data" not in kwargs
                                    else 3], **kwargs)
    with pytest.raises(error) as want:
        jmake_mesh(devices=jax.devices()[:1 if "n_spatial" in kwargs and "n_data" not in
                                          kwargs else 3], **kwargs)
    assert str(got.value) == str(want.value)


def _fake_mesh(n_d, n_s, d=0, s=0):
    """A mesh's shape and coordinates, without groups (for the checks that
    run before any collective)."""
    return Mesh({"data": n_d, "spatial": n_s}, (d, s), tuple(range(n_d * n_s)), None, None,
                None, torch.device("cpu"))


def test_indivisible_dimensions_are_left_whole_with_a_warning():
    mesh = _fake_mesh(2, 2, d=1)
    images = torch.zeros(3, 40, 64, 1)
    with pytest.warns(UserWarning) as rec:
        (got,) = shard_batch(mesh, (images,))
    msgs = " ".join(str(w.message) for w in rec)
    assert "mesh axis 'data' (2)" in msgs and "8 × mesh axis 'spatial' (2)" in msgs
    assert got.shape == images.shape
    with pytest.warns(UserWarning, match="shard_frames: size 40 not divisible by 8"):
        assert shard_frames(mesh, torch.zeros(4, 40, 64)).shape == (2, 40, 64)
    with pytest.warns(UserWarning, match="synth_train_program batch: size 3"):
        sharded_synth_train_program(make_detector_train_step(), DeviceSynthesizer(
            WK.small_config(), device="cpu"), mesh, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        shard_batch(mesh, torch.zeros(4, 48, 64, 1))      # 48 % 16 == 0: split
        shard_batch(mesh, torch.zeros(4, 40, 24, 24), spatial_dim=None)   # patches
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # patch-shaped: the height is not checked
        sharded_synth_train_program(make_detector_train_step(), DeviceSynthesizer(
            WK.small_config(), device="cpu"), _fake_mesh(2, 4), 4, spatial_dim=None)
    with pytest.warns(UserWarning, match="image height: size 48 not divisible by 8 × mesh "
                                         "axis 'spatial' \\(4\\)"):
        sharded_synth_train_program(make_detector_train_step(), DeviceSynthesizer(
            WK.small_config(), device="cpu"), _fake_mesh(2, 4), 4)
    assert splits_rows(mesh, 48) and not splits_rows(mesh, 40)
    assert not splits_rows(_fake_mesh(4, 1), 48) and not splits_rows(None, 48)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

TINY = ("board_name: DICT_4X4_50\nrow_count: 5\ncol_count: 5\nsquare_len: 0.01\n"
        "marker_len: 0.0075\ninput_size: [64, 48]\n")


def test_cli_train_device_synth_data_parallel_composes_on_four_ranks(tmp_path):
    """The flagship mode of ``tests/test_sharded_training.py``, as a user runs
    it: four gloo ranks under torchrun, a 2×2 mesh, fused steps and the mixed
    diet. Rank 0 alone logs and checkpoints; the checkpoint serves."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "deepcharuco_tpu_torch.cli.train",
           "--device", "cpu", "--config", str(cfg), "--device-synth", "--fused-steps", "2",
           "--data-parallel", "--mesh-spatial", "2", "--mixed-host-every", "3",
           "--steps", "4", "--eval-every", "4", "--eval-batches", "1", "--batch-size", "8",
           "--num-workers", "1", "--logdir", str(tmp_path / "tb"),
           "--ckpt-dir", str(tmp_path / "ck")]
    run = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=RUN_TIMEOUT)
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.count("data-parallel over 4 ranks (mesh 2x2 data×spatial)") == 4
    assert run.stdout.count("best checkpoint:") == 1
    rows = [json.loads(line) for line in (tmp_path / "tb" / "scalars.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == [4] and np.isfinite(rows[0]["train_loss"])
    # dispatches 1, 2 and 4 take 2 fused steps, dispatch 3 one host step
    assert sorted(json.loads((tmp_path / "ck" / "index.json").read_text())) == ["step_0000007"]

    from deepcharuco_tpu_torch.configs import load_configuration
    from deepcharuco_tpu_torch.pipeline import load_pipeline

    pipe = load_pipeline(load_configuration(str(cfg)), str(tmp_path / "ck" / "step_0000007"),
                         device="cpu")
    kp, valid, _ = pipe.detect(np.zeros((2, 48, 64), np.uint8))
    assert kp.shape == (2, 16, 2)


def test_cli_mesh_spatial_must_divide_the_rank_count(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    args = det_cli.build_argparser().parse_args(["--data-parallel", "--mesh-spatial", "3"])
    with pytest.raises(SystemExit, match="--mesh-spatial 3 does not divide the device "
                                         "count 4; 1 device"):
        det_cli.start_mesh(args)


def test_cli_mesh_flags_on_one_rank_do_nothing(tmp_path, monkeypatch):
    """As in the JAX trainer: one rank (no torchrun), no mesh; the run is the
    plain one, step for step."""
    from deepcharuco_tpu_torch.train import logging as train_logging

    monkeypatch.setattr(train_logging, "ScalarLogger",
                        functools.partial(train_logging.ScalarLogger, use_tensorboard=False))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY)
    losses = {}
    for tag, extra in (("plain", []), ("flags", ["--data-parallel", "--mesh-spatial", "2"])):
        args = det_cli.build_argparser().parse_args(
            ["--device", "cpu", "--config", str(cfg), "--device-synth", "--steps", "2",
             "--eval-every", "2", "--eval-batches", "1", "--batch-size", "2",
             "--logdir", str(tmp_path / tag), "--ckpt-dir", str(tmp_path / f"ck{tag}")]
            + extra)
        assert det_cli.start_mesh(args) is None
        det_cli.train(args)
        losses[tag] = json.loads((tmp_path / tag / "scalars.jsonl").read_text())["train_loss"]
    assert losses["flags"] == losses["plain"]
