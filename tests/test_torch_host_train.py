"""The host-fed entry points on the CPU: both trainers without
``--device-synth``, ``--eval-host-batches``, ``--bg-bank``,
``--mixed-host-every`` (which dispatches train on host batches), ``eval
--source host`` against the JAX package's eval on the same flags, and
``cli.quantize``. Small config (64×96 frames) where a size is free."""

import json
import os
import re

import numpy as np
import pytest
import torch

from deepcharuco_tpu_torch.cli import eval as eval_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(ROOT, "artifacts", "detector_devsynth.npz")
RN = os.path.join(ROOT, "artifacts", "refinenet_devsynth.npz")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs six workers on the machine's cores: each trainer run
    here takes one torch thread (its host pipeline has its own threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(tmp_path):
    cfg = tmp_path / "small.yaml"
    cfg.write_text("board_name: DICT_4X4_50\nrow_count: 5\ncol_count: 5\nsquare_len: 0.01\n"
                   "marker_len: 0.0075\ninput_size: [96, 64]\nbs_val: 4\nbs_val_rn: 8\n")
    return tmp_path, ["--config", str(cfg)] + CPU


def rows_of(logdir):
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


# the flags that raised NotImplementedError before the host pipeline was ported
FORMERLY_REFUSED = [
    ("train", []),
    ("train", ["--device-synth", "--eval-host-batches", "1"]),
    ("train", ["--device-synth", "--bg-bank", "4"]),
    ("train", ["--device-synth", "--mixed-host-every", "2"]),
    ("train_refinenet", []),
    ("eval", ["--source", "host"]),
]


@pytest.mark.parametrize("cli,flags", FORMERLY_REFUSED)
def test_formerly_refused_flags_run(small, cli, flags):
    import importlib

    tmp, base = small
    main = importlib.import_module(f"deepcharuco_tpu_torch.cli.{cli}").main
    if cli == "eval":
        res = main(base + flags + ["--samples", "4"])
        assert res["samples"] == 16 and res["n_target"] > 0
        return
    logdir = str(tmp / "tb")
    batch = ["--batch-size", "2"] if cli == "train" else ["--batch-size", "16"]
    main(base + flags + batch + ["--steps", "1", "--eval-every", "1", "--eval-batches", "1",
                                 "--num-workers", "1", "--logdir", logdir,
                                 "--ckpt-dir", str(tmp / "ck")])
    (row,) = rows_of(logdir)
    assert row["step"] == 1 and all(np.isfinite(v) for v in row.values())
    if "--eval-host-batches" in flags:
        assert {"val_host_loss", "val_host_l2_pixels", "val_host_match_ratio"} <= set(row)
    assert os.path.isdir(tmp / "ck" / "step_0000001")


def test_mixed_diet_trains_every_nth_dispatch_on_a_host_batch(small, monkeypatch):
    """--mixed-host-every 2 over 5 dispatches: dispatches 2 and 4 take a host
    batch (one step each), the others a synthesised one; the bank's
    backgrounds reach the synthesiser."""
    import deepcharuco_tpu_torch.data as data
    import deepcharuco_tpu_torch.train as train
    from deepcharuco_tpu_torch.cli import train as det_cli

    tmp, base = small
    events = []
    real_prefetch, real_step = data.device_prefetch, train.make_detector_train_step
    real_batch, real_init = data.DeviceSynthesizer.batch, data.DeviceSynthesizer.__init__

    def prefetch(it, size=2, device=None):
        for b in real_prefetch(it, size=size, device=device):
            events.append(("host", tuple(b["image"].shape)))
            yield b

    def make_step(**kw):
        step = real_step(**kw)

        def counted(state, *batch):
            events.append(("step", tuple(batch[0].shape)))
            return step(state, *batch)
        return counted

    banks = []

    def init(self, *a, **kw):
        banks.append(kw.get("bg_bank"))
        real_init(self, *a, **kw)

    monkeypatch.setattr(data, "device_prefetch", prefetch)
    monkeypatch.setattr(train, "make_detector_train_step", make_step)
    monkeypatch.setattr(data.DeviceSynthesizer, "__init__", init)
    monkeypatch.setattr(data.DeviceSynthesizer, "batch",
                        lambda self, g, n: events.append(("synth", n)) or real_batch(self, g, n))
    det_cli.main(base + ["--device-synth", "--mixed-host-every", "2", "--bg-bank", "2",
                         "--batch-size", "2", "--steps", "5", "--eval-every", "100",
                         "--num-workers", "1", "--logdir", str(tmp / "tb"),
                         "--ckpt-dir", str(tmp / "ck")])
    dispatches, i = [], 0
    while i < len(events):
        kind = events[i][0]
        assert kind in ("host", "synth"), events
        assert events[i + 1] == ("step", (2, 64, 96, 1)), events
        dispatches.append(kind)
        i += 2
    assert dispatches == ["synth", "host", "synth", "host", "synth"]
    assert banks[0].shape == (2, 480, 640)


def test_eval_host_source_equals_jax_eval(capsys):
    """16 host samples through float32 models: target, predicted and matched
    counts equal to the JAX package's eval, mean errors within 1e-4 px."""
    from deepcharuco_tpu.cli import eval as jax_eval

    flags = ["--source", "host", "--samples", "16", "--deepc", DET, "--refinenet", RN]
    port = eval_cli.main(flags + CPU)
    capsys.readouterr()
    theirs = jax_eval.main(flags)
    text = capsys.readouterr().out
    counts = re.search(r"target corners: (\d+)\s+predicted: (\d+)\s+matched\(<3.0px\): (\d+)",
                       text).groups()
    assert (port["n_target"], port["n_pred"], port["n_matched"]) == tuple(map(int, counts))
    for key in ("raw_mean", "refined_mean"):
        assert abs(port[key] - theirs[key]) <= 1e-4, key
    assert port["recall"] == pytest.approx(theirs["recall"], abs=1e-12)


def test_quantize_cli_writes_a_servable_int8_artifact(small, tmp_path):
    from deepcharuco_tpu_torch.cli import quantize
    from deepcharuco_tpu_torch.models.quant import QuantDetector, qvars_from_npz
    from deepcharuco_tpu_torch.pipeline import is_quantized_npz

    _, base = small
    out = str(tmp_path / "int8.npz")
    res = quantize.main([DET, "--out", out, "--calib-samples", "4", "--eval-samples", "4"]
                        + base)
    assert is_quantized_npz(out)
    assert res["detections_int8"] > 0 and res["both"] > 0
    det = QuantDetector(qvars_from_npz(out)).eval()
    with torch.inference_mode():
        o = det(torch.zeros(1, 64, 96, 1))
    assert o["loc"].shape == (1, 8, 12, 65) and torch.isfinite(o["ids"]).all()
