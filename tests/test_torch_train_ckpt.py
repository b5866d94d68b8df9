"""The port's training metrics, checkpoints, logging and weight bridge
against the JAX package's, on the CPU.

``detector_metrics`` runs the decode kernel's plain version here (CPU
tensors); its cases are those of ``tests/test_metrics_ckpt.py``, plus random
logits held against the JAX function within 1e-6. A resumed run must equal
an uninterrupted one bit for bit; the JAX package must read a port
checkpoint and compute the same forward pass (float32, within 1e-5 of the
logits' scale).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu.configs import scaled_config as jax_scaled_config
from deepcharuco_tpu.models import Detector as JDetector
from deepcharuco_tpu.pipeline import merge_variables as jax_merge_variables
from deepcharuco_tpu.pipeline import variables_from_npz as jax_variables_from_npz
from deepcharuco_tpu.train import metrics as JM
from deepcharuco_tpu_torch import profiling
from deepcharuco_tpu_torch import weights as W
from deepcharuco_tpu_torch.configs import default_config, scaled_config
from deepcharuco_tpu_torch.models import Detector, RefineNet
from deepcharuco_tpu_torch.pipeline import merge_variables
from deepcharuco_tpu_torch.train import (create_detector_state, create_refinenet_state,
                                         make_detector_train_step, make_refinenet_train_step,
                                         state_variables)
from deepcharuco_tpu_torch.train.checkpoints import (CheckpointManager, optimizer_arrays,
                                                     resume)
from deepcharuco_tpu_torch.train.logging import ScalarLogger
from deepcharuco_tpu_torch.train.metrics import (MeanAccumulator, detector_metrics,
                                                 refinenet_metric)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(ROOT, "artifacts", "detector_devsynth.npz")
RN = os.path.join(ROOT, "artifacts", "refinenet_devsynth.npz")
N_IDS = 16


def _maps_from_kpts(kpts_by_id, hc=6, wc=8):
    loc = np.full((hc, wc), 64, np.int32)
    ids = np.full((hc, wc), N_IDS, np.int32)
    for k, (x, y) in kpts_by_id.items():
        loc[y // 8, x // 8] = (x % 8) + 8 * (y % 8)
        ids[y // 8, x // 8] = k
    return loc, ids


def _logits_from_maps(loc, ids):
    hc, wc = loc.shape
    loc_hat = np.zeros((hc, wc, 65), np.float32)
    ids_hat = np.zeros((hc, wc, N_IDS + 1), np.float32)
    for r in range(hc):
        for c in range(wc):
            loc_hat[r, c, loc[r, c]] = 9.0
            ids_hat[r, c, ids[r, c]] = 9.0
    return loc_hat, ids_hat


def both_metrics(loc_hat, ids_hat, loc_t, ids_t):
    want = JM.detector_metrics(*(jnp.asarray(a) for a in (loc_hat, ids_hat, loc_t, ids_t)),
                               N_IDS)
    got = detector_metrics(*(torch.from_numpy(a) for a in (loc_hat, ids_hat, loc_t, ids_t)),
                           N_IDS)
    assert sorted(got) == sorted(want)
    return {k: float(v) for k, v in got.items()}, {k: float(v) for k, v in want.items()}


METRIC_CASES = {
    # ids 0@(10,10), 1@(30,20); predicted 0@(12,11) (2.24 px, a match),
    # 1@(37,24) (8.06 px, no match) and a spurious 5@(50,40)
    "hand_computed": ({0: (10, 10), 1: (30, 20)}, {0: (12, 11), 1: (37, 24), 5: (50, 40)}),
    "empty_target": ({}, {3: (20, 20)}),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_detector_metrics_on_the_jax_package_cases(case):
    tgt, prd = METRIC_CASES[case]
    tgt_loc, tgt_ids = _maps_from_kpts(tgt)
    loc_hat, ids_hat = _logits_from_maps(*_maps_from_kpts(prd))
    before = profiling.counters().get("kernels.b1_launches", 0)
    got, want = both_metrics(loc_hat[None], ids_hat[None], tgt_loc[None], tgt_ids[None])
    # the plain version on the CPU
    assert profiling.counters().get("kernels.b1_launches", 0) == before
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
    if case == "hand_computed":
        assert got["l2_pixels"] == pytest.approx((np.hypot(2, 1) + np.hypot(7, 4)) / 2, rel=1e-6)
        assert got["match_ratio"] == pytest.approx(0.5) and got["n_pred"] == 3
    else:
        assert got["l2_pixels"] == 0.0 and got["n_target"] == 0


def test_detector_metrics_on_random_logits_with_duplicate_claims():
    rng = np.random.default_rng(0)
    loc_hat = rng.normal(size=(6, 6, 8, 65)).astype(np.float32)
    ids_hat = (np.round(rng.normal(size=(6, 6, 8, N_IDS + 1)) * 2) / 2).astype(np.float32)
    loc_t = rng.integers(0, 65, size=(6, 6, 8)).astype(np.int32)
    ids_t = rng.integers(0, N_IDS + 1, size=(6, 6, 8)).astype(np.int32)
    ids_t[0] = N_IDS                                # a frame without targets
    got, want = both_metrics(loc_hat, ids_hat, loc_t, ids_t)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k


def test_refinenet_metric_and_mean_accumulator():
    a = np.zeros((2, 64, 64, 1), np.float32)
    b = np.zeros((2, 64, 64, 1), np.float32)
    a[0, 10, 20, 0], b[0, 13, 24, 0] = 1, 1          # 5 apart
    a[1, 0, 0, 0], b[1, 0, 0, 0] = 1, 1
    got = refinenet_metric(torch.from_numpy(a), torch.from_numpy(b))
    assert float(got) == pytest.approx(float(JM.refinenet_metric(jnp.asarray(a),
                                                                 jnp.asarray(b)))) == 2.5
    acc = MeanAccumulator()
    acc.update(loss=torch.tensor(1.0))
    acc.update(loss=3.0, extra=torch.tensor(10.0))
    assert acc.compute() == {"loss": 2.0, "extra": 10.0}
    acc.reset()
    assert acc.compute() == {}


# --- checkpoints ------------------------------------------------------------

def tiny_detector_state(seed=0):
    torch.manual_seed(seed)
    return create_detector_state(Detector(N_IDS, torch.float32), 5e-3)


def det_batch(seed=0, hw=(32, 48)):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=(2, *hw, 1)).astype(np.float32))
    loc = torch.from_numpy(rng.integers(0, 65, size=(2, hw[0] // 8, hw[1] // 8)))
    ids = torch.from_numpy(rng.integers(0, 17, size=(2, hw[0] // 8, hw[1] // 8)))
    return images, loc, ids


def test_checkpoint_top_k_retention(tmp_path):
    state = tiny_detector_state()
    mgr = CheckpointManager(str(tmp_path / "ck"), top_k=2)
    v = state_variables(state)
    mgr.save("step_0000001", v, metric=5.0)
    mgr.save("step_0000002", v, metric=3.0)
    mgr.save("step_0000003", v, metric=4.0)              # evicts step 1, the worst
    assert set(mgr.index) == {"step_0000002", "step_0000003"}
    assert not os.path.exists(mgr.path("step_0000001"))
    assert mgr.best_checkpoint() == "step_0000002" and mgr.latest_checkpoint() == "step_0000003"
    with open(tmp_path / "ck" / "index.json") as f:
        assert json.load(f) == {"step_0000002": 3.0, "step_0000003": 4.0}
    again = CheckpointManager(str(tmp_path / "ck"), top_k=2)   # the index persists
    assert again.index == mgr.index
    assert again.restore("step_0000002")["optimizer"] is None
    hi = CheckpointManager(str(tmp_path / "hi"), top_k=1, higher_is_better=True)
    hi.save("a", v, metric=0.1)
    hi.save("b", v, metric=0.9)
    assert hi.index == {"b": 0.9} and hi.best_checkpoint() == "b"


@pytest.mark.parametrize("kind", ["detector", "refinenet"])
def test_resume_continues_bit_for_bit(tmp_path, kind):
    """Three steps, a checkpoint, two more: a fresh state resumed from the
    checkpoint (another seed's weights, a new optimizer) takes the same two
    steps to the same bits (``tests/test_resume_conf.py:44``)."""
    if kind == "detector":
        make = lambda seed: tiny_detector_state(seed)
        step = make_detector_train_step(conf_weight=0.5, conf_topk=2)
        batch = det_batch()
    else:
        def make(seed):
            torch.manual_seed(seed)
            return create_refinenet_state(RefineNet(torch.float32, offset_head=True), 1e-4)
        step = make_refinenet_train_step(offset_weight=0.5, coord_weight=0.1)
        rng = np.random.default_rng(0)
        batch = (torch.from_numpy(rng.normal(size=(3, 24, 24, 1)).astype(np.float32)),
                 torch.from_numpy(rng.uniform(size=(3, 64, 64, 1)).astype(np.float32)))
    state = make(0)
    for _ in range(3):
        state, _ = step(state, *batch)
    mgr = CheckpointManager(str(tmp_path / "ck"), top_k=2)
    mgr.save(f"step_{state.step:07d}", state_variables(state), 1.0, optimizer_arrays(state))
    gold = []
    for _ in range(2):
        state, aux = step(state, *batch)
        gold.append(aux["loss"])
    fresh = make(99)
    assert "with optimizer state" in resume(fresh, mgr, "step_0000003")
    assert fresh.step == 3
    for i in range(2):
        fresh, aux = step(fresh, *batch)
        assert torch.equal(aux["loss"], gold[i])
    assert fresh.step == 5
    a, b = state.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a if "num_batches" not in k)


def test_the_jax_package_reads_a_port_checkpoint(tmp_path):
    """A port checkpoint's ``variables.npz`` through the JAX package's
    ``variables_from_npz``: the same keys and bits, and Flax's forward pass
    equals the port's."""
    state = tiny_detector_state(3)
    step = make_detector_train_step()
    images, loc, ids = det_batch()
    state, _ = step(state, images, loc, ids)          # moved weights and statistics
    mgr = CheckpointManager(str(tmp_path / "ck"))
    path = mgr.save("step_0000001", state_variables(state), 0.5, optimizer_arrays(state))
    jv = jax_variables_from_npz(os.path.join(path, "variables.npz"))
    port_flat = W.flatten_variables(state_variables(state))
    assert sorted(W.flatten_variables(jv)) == sorted(port_flat)
    x = np.random.default_rng(1).normal(size=(2, 32, 48, 1)).astype(np.float32)
    want = JDetector(n_ids=N_IDS, dtype=jnp.float32).apply(jv, jnp.asarray(x))
    with torch.inference_mode():
        got = state.model(torch.from_numpy(x))
    for k in ("loc", "ids"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    opt = np.load(os.path.join(path, "optimizer.npz"))
    assert int(opt["step"]) == 1 and "exp_avg/conv1a.conv.weight" in opt.files


def test_variables_to_npz_and_merge_variables_match_the_jax_package(tmp_path):
    v = W.variables_from_npz(RN)
    path = str(tmp_path / "rn.npz")
    W.variables_to_npz(path, v)
    back = W.read_npz(path)
    ship = W.read_npz(RN)
    assert sorted(back) == sorted(ship)
    assert all(np.array_equal(back[k], ship[k]) and back[k].dtype == ship[k].dtype for k in ship)
    big = W.refinenet_variables(RefineNet(torch.float32, patch_size=32,
                                          offset_head=True).state_dict())
    merged, loaded, skipped = merge_variables(big, v)
    j_merged, j_loaded, j_skipped = jax_merge_variables(big, v)
    assert loaded == j_loaded and skipped == j_skipped and len(loaded) == 68
    flat, j_flat = W.flatten_variables(merged), W.flatten_variables(j_merged)
    assert sorted(flat) == sorted(j_flat)
    assert all(np.array_equal(flat[k], j_flat[k]) for k in flat)


def test_scalar_logger_writes_jsonl(tmp_path):
    log = ScalarLogger(str(tmp_path / "tb"), use_tensorboard=False)
    log.log(5, {"train_loss": torch.tensor(0.25), "val_loss": 1.5})
    log.log(10, {"train_loss": 0.125})
    log.close()
    rows = [json.loads(line) for line in open(tmp_path / "tb" / "scalars.jsonl")]
    assert [r["step"] for r in rows] == [5, 10]
    assert rows[0]["train_loss"] == 0.25 and rows[0]["val_loss"] == 1.5


def test_scaled_config_matches_the_jax_package():
    from deepcharuco_tpu.configs import default_config as jax_default_config

    for f in (2, 4):
        got, want = scaled_config(default_config(), f), jax_scaled_config(jax_default_config(), f)
        assert got.input_size == want.input_size == (320 * f, 240 * f)
        assert got.input_hw == want.input_hw and got.n_ids == want.n_ids

