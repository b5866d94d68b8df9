"""The DeepCharuco program module's analytic counts against
``torch.utils.flop_counter`` over the plain reference's networks, on the
CPU."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.programs import deepcharuco as dc
from portbench.reference import nets

CONFIGS = ["deepc_240x320", "deepc_hires_480x640"]


def config(name):
    return json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@pytest.mark.parametrize("name", CONFIGS)
def test_detector_and_refinenet_flops(name):
    cfg = config(name)
    W = nets.read_weights(str(harness.ROOT / cfg["detector"]["weights"]), "cpu")
    R = nets.read_weights(str(harness.ROOT / cfg["refinenet"]["weights"]), "cpu")
    h, w = (x // cfg["hires_scale"] for x in cfg["input_hw"])
    p = cfg["refinenet"]["patch_size"]
    with torch.no_grad():
        det = counted(lambda: nets.detector(W, torch.zeros(1, 1, h, w)))
        rn = counted(lambda: nets.refinenet(R, torch.zeros(2, 1, p, p), p)) / 2
    assert det == dc.detector_flops(cfg)
    assert rn == dc.refinenet_flops(cfg)
    assert det + cfg["n_ids"] * rn == dc.frame_flops(cfg) == dc.flops_per_item(cfg, "serve")


def test_train_step_flops():
    cfg = config("deepc_240x320")
    start = dc.initial_state(cfg, 0, torch.device("cpu"))
    P = {k: v.requires_grad_(True) for k, v in start.items()
         if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}

    def step():
        loc, ids = nets.detector_train(P, torch.zeros(1, 1, *cfg["input_hw"]))
        (loc.sum() + ids.sum()).backward()

    assert counted(step) == dc.train_sample_flops(cfg) == dc.flops_per_item(cfg, "train")


def test_decode_bound():
    cfg = config("deepc_240x320")
    b = dc.decode_bytes(cfg, 256)
    assert b["read"] == 256 * 30 * 40 * (65 + 17) * 4
    assert b["written"] == 256 * 16 * 9
    assert dc.decode_min_seconds(cfg, 256) == pytest.approx(b["total"] / 3.35e12)
