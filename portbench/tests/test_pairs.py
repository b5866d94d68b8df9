"""The pair-matching cell's own pieces on the CPU: the program module's
analytic FLOPs against ``torch.utils.flop_counter`` over the plain
reference, the pairs the driver makes, and its readers: in a traced CPU run
the host readers read and the device readers (no CUDA events there) do
not; none raises where the program records no ``match.*`` span, as a
checkout from before the matcher records none."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, program_trace
from portbench.drivers import offline_pairs as D
from portbench.programs import superpoint_lightglue as prog
from portbench.reference import superpoint_lightglue as ref
from portbench.tests.test_compare import SEED

CELL = "splg_offline_pairs"
CPU = torch.device("cpu")
NEW = ["superpoint_ms.pairs", "keypoints_ms.pairs", "lightglue_ms.pairs", "assign_ms.pairs",
       "attention_roofline.pairs"]
HOST = ["enqueue_ms.offline", "stage_ms.offline", "fetch_wait_ms.offline"]


def small_config():
    return D.config({"config": json.loads((harness.BENCH / "configs/splg_480x640.json")
                                          .read_text()),
                     "params": {"model": D.SMALL["model"]}}, CPU)


@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark()["workloads"]
                                  if harness.cell(w["name"])["driver"] == "offline_pairs"])
def test_no_cells_mix_resizes_its_configuration(name):
    """``model`` is the CPU tests' small model: a cell's mix leaves it
    empty, and a run on the card refuses one that is not."""
    c = harness.cell(name)
    assert not c["params"].get("model")
    assert D.config(c, torch.device("cuda", 0)) == c["config"]
    c["params"]["model"] = dict(n_layers=2)
    with pytest.raises(ValueError, match="CPU tests only"):
        D.config(c, torch.device("cuda", 0))
    assert D.config(c, CPU)["n_layers"] == 2


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def test_flops_equal_the_references_own_count():
    """With every keypoint slot holding a keypoint, the reference's counted
    FLOPs are the module's: SuperPoint a frame, LightGlue a pair (the cross
    block's similarity counted once, as the reference forms it)."""
    cfg = small_config()
    sp, lg = ref.draw_weights(cfg, 5)
    h, w = cfg["input_hw"]
    frames = D.pair_pool(5, (h, w), 2, 1, dict(background=90, roll_max=32, noise=25,
                                                  warp=0.15))[0]
    img = torch.from_numpy(frames).float()[:, None] / 255.0
    with torch.no_grad():
        sp_flops = counted(lambda: ref.superpoint_dense(sp, img[:1]))
        ex = ref.extract(sp, img, cfg)
        k = [len(x) for x in ex["keypoints"]]
        assert k == [cfg["max_num_keypoints"]] * 2
        lg_flops = counted(lambda: ref.match(lg, ex["keypoints"][0], ex["keypoints"][1],
                                             ex["descriptors"][0], ex["descriptors"][1],
                                             (w, h), cfg))
    assert sp_flops == prog.superpoint_flops(cfg)
    assert lg_flops == prog.lightglue_flops(cfg)
    assert prog.flops_per_item(cfg, "serve") == sp_flops + lg_flops / 2


def test_attention_flops_at_the_published_widths():
    cfg = json.loads((harness.BENCH / "configs/splg_480x640.json").read_text())
    n, d = 2048, 256
    assert prog.attention_flops(cfg) == 9 * (2 * 2 * 2 * n * n * d + 3 * 2 * n * n * d)
    assert prog.attention_flops(cfg) == pytest.approx(135.3e9, rel=1e-3)
    assert prog.lightglue_flops(cfg) - prog.attention_flops(cfg) == pytest.approx(94.0e9,
                                                                                 rel=2e-2)
    assert 2 * prog.superpoint_flops(cfg) == pytest.approx(104e9, rel=2e-2)


def test_pairs_are_a_frame_and_its_warp_from_the_seed():
    params = dict(background=90, roll_max=32, noise=25, warp=0.15)
    a = D.pair_pool(11, (96, 128), 4, 2, params)
    b = D.pair_pool(11, (96, 128), 4, 2, params)
    assert len(a) == 2 and a[0].shape == (4, 96, 128) and a[0].dtype == np.uint8
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], D.pair_pool(12, (96, 128), 4, 2, params)[0])
    first, warped = a[0][0].astype(int), a[0][1].astype(int)
    assert 0 < np.abs(first - warped).mean() < 80
    ident = D.homography(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float),
                         np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float))
    img = np.arange(48, dtype=np.float32).reshape(6, 8)
    np.testing.assert_allclose(D.warp(img, ident, -1.0), img, atol=1e-4)


def test_traced_cpu_run_reads_the_host_readers_and_no_device_reader():
    torch.manual_seed(0)
    over = dict(D.SMALL, trace_skip=3)
    result, run, _ = harness.run_once(CELL, SEED, 0.5, True, device=CPU, overrides=over)
    assert result["correct"], result["checks"]
    for metric in HOST:
        value = harness.reader(metric)(run)
        assert isinstance(value, float) and value >= 0, metric
    for metric in NEW + ["mfu.offline", "idle_pct.offline"]:
        assert harness.reader(metric)(run) is None and metric not in result["metrics"], metric


class _Empty:
    ranges, ops = {}, []

    def device_ms_of(self, name):
        return None


def test_new_readers_return_none_without_the_programs_spans(monkeypatch):
    """The parent's program records no ``match.*`` span: every new reader
    returns None there and raises nothing."""
    c = harness.cell(CELL)
    run = type("Run", (), {"stretch": _Empty(), "cfg": c["config"], "p": c["params"],
                           "prog": c["program"], "device": CPU})()
    monkeypatch.setattr(program_trace, "recorder", lambda: None)
    for metric in NEW:
        assert harness.reader(metric)(run) is None, metric
