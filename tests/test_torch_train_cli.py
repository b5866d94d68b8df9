"""The port's two training CLIs on the CPU (``--device cpu``), on 64×96
frames of the default board (a YAML config), for a couple of steps: the
jsonl log and the top-k checkpoints are written, a checkpoint serves in
``InferencePipeline``, ``--resume`` continues the global step, and the
options that need another one are refused. Several ranks:
``tests/test_torch_parallel.py``."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from deepcharuco_tpu_torch.cli import train as det_cli
from deepcharuco_tpu_torch.cli import train_refinenet as rn_cli
from deepcharuco_tpu_torch.train import logging as train_logging

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RN = os.path.join(ROOT, "artifacts", "refinenet_devsynth.npz")


@pytest.fixture
def small(tmp_path, monkeypatch):
    """A 64×96 config and, for speed, the jsonl log without TensorBoard."""
    monkeypatch.setattr(train_logging, "ScalarLogger",
                        functools.partial(train_logging.ScalarLogger, use_tensorboard=False))
    cfg = tmp_path / "small.yaml"
    cfg.write_text("board_name: DICT_4X4_50\nrow_count: 5\ncol_count: 5\nsquare_len: 0.01\n"
                   "marker_len: 0.0075\ninput_size: [96, 64]\n")
    return tmp_path, ["--config", str(cfg), "--device", "cpu"]


def rows(logdir):
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_detector_cli_trains_logs_checkpoints_and_resumes(small):
    tmp, base = small
    logdir, ckdir = str(tmp / "tb"), str(tmp / "ck")
    args = base + ["--device-synth", "--batch-size", "2", "--eval-every", "1",
                   "--eval-batches", "1", "--logdir", logdir, "--ckpt-dir", ckdir,
                   "--conf-weight", "0.3", "--conf-topk", "2", "--perspective-p", "0.5",
                   "--low-gain-p", "0.5", "--axis-snap-p", "0.5", "--scale-max", "1.05",
                   "--data-parallel"]
    det_cli.main(args + ["--steps", "2"])
    log = rows(logdir)
    assert [r["step"] for r in log] == [1, 2]
    for key in ("train_loss", "val_loss", "val_l2_pixels", "val_match_ratio", "val_n_pred",
                "val_n_target", "steps_per_sec"):
        assert all(np.isfinite(r[key]) for r in log), key
    with open(os.path.join(ckdir, "index.json")) as f:
        assert sorted(json.load(f)) == ["step_0000001", "step_0000002"]

    from deepcharuco_tpu_torch.configs import load_configuration
    from deepcharuco_tpu_torch.pipeline import load_pipeline

    cfg = load_configuration(base[1])
    pipe = load_pipeline(cfg, os.path.join(ckdir, "step_0000002", "variables.npz"), RN,
                         device="cpu")
    frames = np.random.default_rng(0).integers(0, 255, (2, 64, 96), dtype=np.uint8)
    kp, valid, refined = pipe.detect(frames)
    assert kp.shape == (2, 16, 2) and np.isfinite(refined).all()

    det_cli.main(args + ["--steps", "1", "--fused-steps", "2", "--resume", "step_0000002"])
    with open(os.path.join(ckdir, "index.json")) as f:
        assert "step_0000004" in json.load(f)       # 2 restored + 2 fused steps
    assert rows(logdir)[-1]["step"] == 1


@pytest.mark.parametrize("variant", ["frame_patches", "direct_32_offset"])
def test_refinenet_cli_trains_and_checkpoints(small, variant):
    tmp, base = small
    logdir, ckdir = str(tmp / "tb"), str(tmp / "ck")
    args = base + ["--device-synth", "--batch-size", "8", "--eval-every", "2",
                   "--eval-batches", "1", "--steps", "2", "--logdir", logdir,
                   "--ckpt-dir", ckdir, "--init-npz", RN]
    if variant == "frame_patches":
        args += ["--frame-patches", "--fused-steps", "2", "--coord-weight", "0.1",
                 "--rounded-targets"]
    else:
        args += ["--patch-size", "32", "--offset-weight", "0.2", "--upsample", "bilinear"]
    rn_cli.main(args)
    (row,) = rows(logdir)
    assert row["step"] == 2
    for key in ("train_refinenet_loss", "val_refinenet_loss", "val_dist_refinenet_pixels"):
        assert np.isfinite(row[key]), key
    name = "step_0000004" if variant == "frame_patches" else "step_0000002"
    files = sorted(os.listdir(os.path.join(ckdir, name)))
    assert files == ["optimizer.npz", "variables.npz"]
    keys = np.load(os.path.join(ckdir, name, "variables.npz")).files
    assert ("params/conv2c/conv/kernel" in keys) == (variant != "frame_patches")


def test_refinenet_cli_refusals(small):
    _, base = small
    with pytest.raises(SystemExit, match="--patch-size 32 requires --device-synth"):
        rn_cli.main(base + ["--patch-size", "32", "--steps", "1"])
    with pytest.raises(SystemExit):
        rn_cli.main(base + ["--device-synth", "--frame-scale", "2", "--steps", "1"])


def test_clis_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (det_cli.main, rn_cli.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--device-synth", "--steps", "1"])
