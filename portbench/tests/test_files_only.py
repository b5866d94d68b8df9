"""A model of another family enters the benchmark as new files only: a copy
of ``portbench/`` gains a toy program module (two convolutions with weights
drawn from the seed), its plain reference, its configuration and a cell on
the ``offline`` mix, plus their entries in ``BENCHMARK.json``. In the copy,
the specification's tests pass, a sound run of the cell on the CPU is
``correct`` with today's result line, its planted fault is not, and no file
but ``BENCHMARK.json`` was edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench import harness

PROGRAM = '''"""A toy model family: two 3x3 convolutions (1 -> width -> 1 channels,
stride 2, ReLU between) on the frame scaled to [0, 1], weights drawn from
the seed, served by the offline driver."""

import torch

from portbench.counts import conv_flops
from portbench.reference import toyconv as ref

OUTPUTS = ("features",)


class Toy:
    def __init__(self, weights):
        self.weights = weights

    def forward_device(self, frames, with_pose=False):
        return (ref.forward(self.weights, frames),)


def build(cfg, root, seed, device):
    return Toy(ref.weights(cfg["width"], seed, device))


def instrument(spans, system, layers):
    spans.wrap(system, "forward_device", "forward_device")


def judge(cfg, root, seed, device, frames_u8, out):
    return ref.gaps(cfg, seed, device, frames_u8, out["features"])


def control(c, seed, device):
    """The reference in bfloat16 in the program's place."""
    from portbench import harness

    cfg = c["config"]
    frames = harness.driver(c).control_inputs(c, seed, device)["frames"]
    w = [t.bfloat16() for t in ref.weights(cfg["width"], seed, device)]
    x = torch.from_numpy(frames).to(device)
    return ref.gaps(cfg, seed, device, frames, ref.forward(w, x).float().cpu().numpy())


def shifted_rows(run):
    """Each frame's features handed out from the next frame's row."""
    fn = run.pipe.forward_device
    run.pipe.forward_device = lambda x, with_pose=False: tuple(
        t.roll(1, 0) for t in fn(x, with_pose))


FAULTS = {"shifted_rows": shifted_rows}


def plant(run):
    if run.fault is not None:
        FAULTS[run.fault](run)


def flops_per_item(cfg, task):
    h, w = (x // 2 for x in cfg["input_hw"])
    return conv_flops(1, cfg["width"], 3, h, w) + conv_flops(cfg["width"], 1, 3, h // 2, w // 2)
'''

REFERENCE = '''"""The toy model family's reference in plain PyTorch."""

import torch
import torch.nn.functional as F


def weights(width, seed, device):
    gen = torch.Generator().manual_seed(seed)
    w1 = torch.randn(width, 1, 3, 3, generator=gen) / 3.0
    w2 = torch.randn(1, width, 3, 3, generator=gen) / (3.0 * width ** 0.5)
    return [w1.to(device), w2.to(device)]


def forward(w, frames):
    x = frames.to(w[0].dtype)[:, None] / 255.0
    y = F.relu(F.conv2d(x, w[0], stride=2, padding=1))
    return F.conv2d(y, w[1], stride=2, padding=1)[:, 0]


def gaps(cfg, seed, device, frames_u8, features):
    want = forward(weights(cfg["width"], seed, device), torch.from_numpy(frames_u8).to(device))
    got = torch.from_numpy(features).to(device)
    return {"feature_gap_max": float((got - want).abs().max())}
'''

CONFIG = {"program": "toyconv", "source": "https://pytorch.org/docs/stable/generated/"
          "torch.nn.Conv2d.html", "input_hw": [240, 320], "width": 4, "reduced": [],
          "assumed": ["weights: drawn from --seed (normal, over the square root of fan-in)"]}
CELL = {"params": {}, "limits": {"feature_gap_max": 1e-4}, "faults": ["shifted_rows"]}

RUN = '''
import json, torch
from portbench import harness
over = dict(harness.driver(harness.cell("toy_offline")).SMALL)
cpu = torch.device("cpu")
sound = harness.run_cell("toy_offline", 2**31 + 977, 0.3, False, device=cpu, overrides=over)
fault = harness.run_cell("toy_offline", 2**31 + 977, 0.3, False, device=cpu,
                         fault="shifted_rows", overrides=over)
print(json.dumps({"sound": sound, "fault": fault, "forbidden": harness.forbidden_modules()}))
'''


def digests(root):
    """SHA-256 of ``BENCHMARK.json`` and every file under ``portbench/``."""
    files = [root / "BENCHMARK.json", *(root / "portbench").rglob("*")]
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(files) if p.is_file() and "__pycache__" not in p.parts}


def add_entries(spec):
    spec["configs"].append({"name": "toy_conv", "source": CONFIG["source"],
                            "file": "portbench/configs/toy_conv.json", "reduced": [],
                            "why": "two convolutions with weights drawn from the seed"})
    spec["workloads"].append({"name": "toy_offline", "config": "toy_conv", "traffic": "offline",
                              "chips": 1, "why": "the offline mix through another model"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("fps", "enqueue_ms.offline"):
            m["workloads"].append("toy_offline")


def test_a_new_model_needs_only_new_files(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "artifacts").symlink_to(harness.ROOT / "artifacts")   # the other configs' weights
    before = digests(tmp_path)
    new = {"portbench/programs/toyconv.py": PROGRAM, "portbench/reference/toyconv.py": REFERENCE,
           "portbench/configs/toy_conv.json": json.dumps(CONFIG),
           "portbench/workloads/toy_offline.json": json.dumps(CELL)}
    for rel, text in new.items():
        assert not (tmp_path / rel).exists()
        (tmp_path / rel).write_text(text)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    add_entries(spec)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))

    env = dict(os.environ, PYTHONPATH=str(harness.ROOT), PYTHONDONTWRITEBYTECODE="1")
    tests = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                            "portbench/tests/test_spec.py"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
    assert tests.returncode == 0, tests.stdout[-4000:]
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    sound, fault = got["sound"], got["fault"]
    assert sound["correct"] and sound["attempted"] > 0 and sound["failed"] == 0, sound
    assert list(sound) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(sound["metrics"]) == {"fps", "setup_s"}
    assert set(sound["checks"]) == {"feature_gap_max"}
    assert not fault["correct"], fault["checks"]
    assert got["forbidden"] == []

    after = digests(tmp_path)
    edited = {k for k in before if after.get(k) != before[k]}
    assert edited == {"BENCHMARK.json"}
    assert set(after) - set(before) == set(new)
