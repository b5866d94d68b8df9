"""The port's benchmark entry points on the CPU against the JAX package's:
the benchmark's frame, ``cli.benchmark``'s ``main([..., "--device",
"cpu"])`` on 64×96 frames with the options ``chip_smoke.py`` runs on the
card, ``python -m deepcharuco_tpu_torch.bench``, the card as every entry
point's default, the trainers' steps per second (fault C3) and the ROADMAP
items the unported flags name."""

import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from deepcharuco_tpu_torch.cli import benchmark as bench_cli
from deepcharuco_tpu_torch.cli import eval as eval_cli
from deepcharuco_tpu_torch.cli import infer as infer_cli
from deepcharuco_tpu_torch.cli import pose_video as pose_cli
from deepcharuco_tpu_torch.configs import default_config, scaled_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(ROOT, "artifacts", "detector_devsynth.npz")
RN = os.path.join(ROOT, "artifacts", "refinenet_devsynth.npz")
RN32 = os.path.join(ROOT, "artifacts", "refinenet32_devsynth.npz")
CPU = ["--device", "cpu"]


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


# --- the benchmark -------------------------------------------------------

@pytest.mark.parametrize("size,hires", [(None, 0), ("640x480", 0), (None, 2),
                                        ("512x384", 0)])
@pytest.mark.parametrize("fmt", ["gray", "bgr"])
def test_benchmark_frame_equals_jax(size, hires, fmt):
    import cv2

    from deepcharuco_tpu.cli import benchmark as jbench
    from deepcharuco_tpu.configs import default_config as jdefault
    from deepcharuco_tpu.configs import scaled_config as jscaled

    ns = types.SimpleNamespace(image=None)
    jcfg, pcfg = jdefault(), default_config()
    if size:
        wh = tuple(int(v) for v in size.split("x"))
        jcfg = dataclasses.replace(jcfg, input_size=wh)
        pcfg = dataclasses.replace(pcfg, input_size=wh)
    if hires:
        jcfg, pcfg = jscaled(jcfg, hires), scaled_config(pcfg, hires)
    want = jbench._frame(jcfg, ns)
    if fmt == "gray":
        want = cv2.cvtColor(want, cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(bench_cli._frame(pcfg, ns, fmt), want)


BENCH_CASES = {
    "two-stage": [],
    "with-pose": ["--with-pose", "--fetch", "refined", "--depth", "1"],
    "fused-head": ["--fused-head"],
    "breakdown": ["--breakdown", "--input", "bgr"],
    "multi-stream": ["--multi-stream", "3", "--frames-per-stream", "2", "--with-pose"],
    "stream-chunk": ["--multi-stream", "2", "--stream-chunk", "2", "--frames-per-stream", "3"],
    "hires": ["--hires", "2", "--with-pose", "--rn-patch-size", "32", "--rn-decode", "soft",
              "--refinenet", RN32],
    "geom": ["--geom-decode", "--geom-fill", "--geom-ransac", "4"],
}
JAX_FORMATS = [r"^(two-stage|full\+pose)( \(hires tap\))?( \(geom decode\))?: [\d.]+ fps  "
               r"\([\d.]+ ms / batch of \d+\)$",
               r"^detector-only: [\d.]+ fps$", r"^two-stage: [\d.]+ fps$",
               r"^detector→keypoints (unfused|fused): +[\d.]+ fps \([\d.]+ ms/batch\)$",
               r"^agreement: valid [\d.]+, coords\(valid∩\) [\d.]+$",
               r"^multi-stream: \d+ streams @ \d+x\d+( \(hires tap\))?( \(device-queue "
               r"chunk=\d+\))?: [\d.]+ fps aggregate \([\d.]+ fps/stream\), "
               r"(median step latency|chunk-boundary latency) [\d.]+ ms"]


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_benchmark_cli_on_the_cpu(small, capsys, case):
    _, base, _ = small
    res = bench_cli.main(base + ["--deepc", DET, "--batch", "2", "--iters", "2",
                                 "--warmup", "1"] + BENCH_CASES[case])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == res["lines"] and lines
    for line in lines:
        assert any(re.match(p, line) for p in JAX_FORMATS), line
    assert res["fps"] > 0
    if case == "fused-head":
        assert res["agree_valid"] >= 0.98 and res["fused_fps"] > 0
    if case == "breakdown":
        assert res["detector_only_fps"] > 0 and res["two_stage_fps"] > 0


def test_benchmark_refusals(small):
    _, base, _ = small
    with pytest.raises(SystemExit, match="--hires composes"):
        bench_cli.main(base + ["--hires", "--fused-head"])
    with pytest.raises(SystemExit, match="float"):
        bench_cli.main(base + ["--fused-head", "--deepc",
                               os.path.join(ROOT, "artifacts", "detector_devsynth_int8.npz")])


def test_bench_prints_one_json_line_and_leaves_benchmarks_alone():
    last_good = os.path.join(ROOT, "benchmarks", "last_good.json")
    before = open(last_good, "rb").read() if os.path.exists(last_good) else None
    env = dict(os.environ, BENCH_BATCH="2", BENCH_ITERS="2", BENCH_DEVICE="cpu",
               BENCH_COMPUTE="1", BENCH_SCAN_ITERS="1")
    r = subprocess.run([sys.executable, "-m", "deepcharuco_tpu_torch.bench"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    (line,) = r.stdout.strip().splitlines()
    rec = json.loads(line)
    assert sorted(rec) == ["metric", "unit", "value", "vs_baseline"] and rec["value"] > 0
    flops = re.search(r"([\d.]+) GFLOP/frame ⇒ ([\d.]+) TFLOP/s", r.stderr)
    assert flops and 1.0 < float(flops.group(1)) < 100.0
    assert "2 distinct result sums over 2 unique batches" in r.stderr
    assert re.search(r"compute-only \(1 batches per fetch\): [\d.]+ fps", r.stderr)
    after = open(last_good, "rb").read() if os.path.exists(last_good) else None
    assert before == after


# --- the card by default, C3, the roadmap labels --------------------------

@pytest.mark.parametrize("name", ["benchmark", "infer", "eval", "pose_video", "bench"])
def test_entry_points_refuse_the_cpu_unless_asked(small, monkeypatch, name):
    tmp, base, _ = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = base[:2]
    run = {"benchmark": lambda: bench_cli.main(cfg + ["--batch", "1"]),
           "infer": lambda: infer_cli.main([str(tmp / "frames.npy")] + cfg),
           "eval": lambda: eval_cli.main(cfg),
           "pose_video": lambda: pose_cli.main([str(tmp / "frames.npy"), "--no-video"] + cfg),
           "bench": lambda: __import__("deepcharuco_tpu_torch.bench",
                                       fromlist=["main"]).main()}[name]
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()


@pytest.mark.parametrize("trainer", ["train", "train_refinenet"])
def test_c3_steps_per_sec_counts_the_checkpoint_write(small, monkeypatch, trainer):
    """The JAX trainers restart the window before the log and the save, so
    a window counts the previous checkpoint write; the port restarted it
    after the save."""
    from deepcharuco_tpu_torch.cli import train as det_cli
    from deepcharuco_tpu_torch.cli import train_refinenet as rn_cli
    from deepcharuco_tpu_torch.train import checkpoints
    from deepcharuco_tpu_torch.train import logging as train_logging

    tmp, base, _ = small
    monkeypatch.setattr(train_logging, "ScalarLogger",
                        functools.partial(train_logging.ScalarLogger, use_tensorboard=False))
    pause = 1.0
    save = checkpoints.CheckpointManager.save

    def slow_save(self, *a, **kw):
        time.sleep(pause)
        return save(self, *a, **kw)

    monkeypatch.setattr(checkpoints.CheckpointManager, "save", slow_save)
    logdir = str(tmp / "tb")
    common = base + ["--device-synth", "--steps", "2", "--eval-every", "1", "--eval-batches",
                     "1", "--logdir", logdir, "--ckpt-dir", str(tmp / "ck")]
    if trainer == "train":
        det_cli.main(common + ["--batch-size", "2"])
    else:
        rn_cli.main(common + ["--batch-size", "4"])
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert 1.0 / rows[1]["steps_per_sec"] >= pause     # the second window holds a save


def roadmap_items():
    text = open(os.path.join(ROOT, "ROADMAP.md")).read()
    section = text[text.index("### A."):text.index("### B.")]
    return {int(n): title for n, title in re.findall(r"^(\d+)\. \*\*(.+?)\*\*", section,
                                                     re.M)}


REFUSALS = [
    ("train", [], "host data pipeline"),
    ("train", ["--device-synth", "--eval-host-batches", "1"], "host data pipeline"),
    ("train", ["--device-synth", "--bg-bank", "4"], "background bank"),
    ("train", ["--device-synth", "--mixed-host-every", "2"], "mixed diet"),
    ("train", ["--device-synth", "--mesh-spatial", "2"], "data parallelism"),
    ("train_refinenet", [], "host data pipeline"),
    ("eval", ["--source", "host"], "host data pipeline"),
]


@pytest.mark.parametrize("cli,flags,title", REFUSALS)
def test_unported_flags_name_their_roadmap_item(small, cli, flags, title):
    import importlib

    _, base, _ = small
    main = importlib.import_module(f"deepcharuco_tpu_torch.cli.{cli}").main
    with pytest.raises(NotImplementedError) as e:
        main(base + flags + ["--steps", "1"] if cli != "eval" else base + flags)
    (item,) = re.findall(r"ROADMAP\.md §A, A(\d+)\)", str(e.value))
    assert title in roadmap_items()[int(item)].lower(), (str(e.value), roadmap_items())
