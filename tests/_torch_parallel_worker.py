"""One rank of the port's mesh on the CPU (gloo), for
``tests/test_torch_parallel.py``. Imports torch, numpy and the port only.

Run by hand as ``RANK=r WORLD_SIZE=n python tests/_torch_parallel_worker.py
INIT_FILE OUT_DIR`` in ``n`` processes; the test starts them. With 2 ranks
it runs the 2×1 and 1×2 meshes' jobs, with 4 ranks the 2×2 and 1×4 meshes'
jobs, and rank 0 writes each job's result to ``OUT_DIR/<job>.npz``. The
inputs come from the functions below, which the test calls too.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(ROOT, "artifacts", "detector_devsynth.npz")
RN = os.path.join(ROOT, "artifacts", "refinenet_devsynth.npz")
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_frames.npz")
STEP_HW = (48, 64)
STEP_BATCH = 4
DET_LR = 5e-3
CONF = dict(conf_weight=0.5, conf_topk=2)
SYNTH_SEED = 3


def det_batch(n=STEP_BATCH, hw=STEP_HW, seed=0):
    """(images, loc, ids) numpy arrays: noise images and a few corner cells."""
    rng = np.random.default_rng(seed)
    images = rng.normal(scale=0.3, size=(n, *hw, 1)).astype(np.float32)
    hc, wc = hw[0] // 8, hw[1] // 8
    loc = rng.integers(0, 64, size=(n, hc, wc)).astype(np.int32)
    ids = np.full((n, hc, wc), 16, np.int32)
    for b in range(n):
        cells = rng.choice(hc * wc, size=5, replace=False)
        ids[b].reshape(-1)[cells] = rng.choice(16, size=5, replace=False)
    loc[ids == 16] = 64
    return images, loc, ids


def rn_batch(n=8, seed=0):
    """(patches, heatmaps) numpy arrays for the 24-px RefineNet."""
    from deepcharuco_tpu_torch.data.device_synth import _heatmaps

    rng = np.random.default_rng(seed)
    patches = rng.normal(scale=0.3, size=(n, 24, 24, 1)).astype(np.float32)
    hp = torch.from_numpy(rng.uniform(8, 56, size=(n, 2)).astype(np.float32))
    return patches, _heatmaps(hp, True)[..., None].numpy()


def detector64():
    """The shipped detector in float64 (BatchNorm too)."""
    from deepcharuco_tpu_torch import weights as W
    from deepcharuco_tpu_torch.models import Detector

    det = Detector(16, torch.float64)
    return W.load_state(det, W.detector_state_dict(W.variables_from_npz(DET))).double()


def refinenet64():
    from deepcharuco_tpu_torch import weights as W
    from deepcharuco_tpu_torch.models import RefineNet

    rn = RefineNet(torch.float64)
    return W.load_state(rn, W.refinenet_state_dict(W.variables_from_npz(RN))).double()


def small_config():
    from deepcharuco_tpu_torch.configs import default_config

    return default_config(input_size=(STEP_HW[1], STEP_HW[0]))


def det_steps(mesh=None, steps=3, batch=None):
    """``steps`` Adam steps of the float64 detector on ``batch`` (numpy
    arrays, default :func:`det_batch`; this rank's share under ``mesh``) →
    (state dict, losses)."""
    from deepcharuco_tpu_torch.parallel import shard_batch, sharded_train_step
    from deepcharuco_tpu_torch.train import create_detector_state, make_detector_train_step

    state = create_detector_state(detector64(), DET_LR)
    step = make_detector_train_step(**CONF)
    batch = tuple(torch.from_numpy(a) for a in (det_batch() if batch is None else batch))
    if mesh is not None:
        step, batch = sharded_train_step(step, mesh), shard_batch(mesh, batch)
    losses = []
    for _ in range(steps):
        state, aux = step(state, *batch)
        losses.append(float(aux["loss"]))
    return state.model.state_dict(), losses


def rn_steps(mesh=None, steps=2):
    """Adam steps of the float64 RefineNet on :func:`rn_batch` (patches are
    shared over ``data`` only) → (state dict, losses)."""
    from deepcharuco_tpu_torch.parallel import shard_batch, sharded_train_step
    from deepcharuco_tpu_torch.train import create_refinenet_state, make_refinenet_train_step

    state = create_refinenet_state(refinenet64(), 1e-4)
    step = make_refinenet_train_step(coord_weight=0.2)
    batch = tuple(torch.from_numpy(a) for a in rn_batch())
    if mesh is not None:
        step, batch = sharded_train_step(step, mesh), shard_batch(mesh, batch, None)
    losses = []
    for _ in range(steps):
        state, aux = step(state, *batch)
        losses.append(float(aux["loss"]))
    return state.model.state_dict(), losses


def synth_program(mesh=None, fused_steps=2, batch=STEP_BATCH):
    """One call of the synthesis + train program (``fused_steps`` rounds) on
    the small config, float64 detector → (state dict, last loss)."""
    from deepcharuco_tpu_torch.data import DeviceSynthesizer
    from deepcharuco_tpu_torch.parallel import sharded_synth_train_program, synth_scan_program
    from deepcharuco_tpu_torch.train import create_detector_state, make_detector_train_step

    synth = DeviceSynthesizer(small_config(), device="cpu")
    state = create_detector_state(detector64(), 1e-4)
    step = make_detector_train_step()
    if mesh is None:
        program = synth_scan_program(step, lambda g: synth.batch(g, batch), fused_steps)
    else:
        program = sharded_synth_train_program(step, synth, mesh, batch, fused_steps)
    state, aux = program(state, torch.Generator().manual_seed(SYNTH_SEED))
    return state.model.state_dict(), float(aux["loss"])


def host_fed_steps(mesh, steps=2):
    """The trainer's host feed (``cli.train.host_batches``) on ``mesh``: one
    batch of the small config's ``CharucoDataset`` → this rank's batch, the
    spatial group's batches (gathered), and ``steps`` float64 detector steps
    on it (state dict, losses)."""
    import torch.distributed as dist

    from deepcharuco_tpu_torch.cli.train import host_batches
    from deepcharuco_tpu_torch.data import CharucoDataset

    feed, loader = host_batches(lambda: CharucoDataset(small_config()), STEP_BATCH, 1, mesh,
                                "cpu")
    b = next(feed)
    if loader is not None:
        loader.stop()
    batch = tuple(b[k].numpy() for k in ("image", "loc", "ids"))
    peers = {}
    for k, t in b.items():
        parts = [torch.empty_like(t) for _ in range(mesh.shape["spatial"])]
        dist.all_gather(parts, t, group=mesh.spatial)
        peers.update({f"peer{i}/{k}": p.numpy() for i, p in enumerate(parts)})
    sd, losses = det_steps(mesh, steps, batch)
    return batch, peers, sd, losses


def inference_frames(rows=240, n=4):
    """``n`` fixture frames (uint8 gray 240×320), cut to their middle ``rows``."""
    frames = np.load(FIXTURE)["frames"][:n]
    top = (240 - rows) // 2
    return frames[:, top:top + rows]


def pipeline_models():
    """The shipped float32 detector and RefineNet, eval mode, on the CPU."""
    from deepcharuco_tpu_torch.weights import load_detector, load_refinenet

    return (load_detector(DET, dtype=torch.float32, device="cpu"),
            load_refinenet(RN, dtype=torch.float32, device="cpu"))


def inference_fns():
    """name → (fn(det, rn, frames), frames) for the sharded-inference jobs."""
    from deepcharuco_tpu_torch.board import inner_corner_object_points
    from deepcharuco_tpu_torch.pipeline import full_forward, two_stage_forward

    obj = inner_corner_object_points(5, 5, 0.01)
    K = np.array([[420.0, 0, 160], [0, 420.0, 120], [0, 0, 1]], np.float32)
    dist = np.zeros(5, np.float32)
    bxy = obj[:, :2]
    cpu = dict(device="cpu")
    return {
        "two_stage": (lambda d, r, x: two_stage_forward(d, r, x, 16, **cpu),
                      inference_frames()),
        "fused": (lambda d, r, x: two_stage_forward(d, r, x, 16, fused_head=True, **cpu),
                  inference_frames()),
        "geom_fill": (lambda d, r, x: two_stage_forward(d, r, x, 16, geom_board_xy=bxy,
                                                        geom_fill=True, **cpu),
                      inference_frames()),
        "full": (lambda d, r, x: full_forward(d, r, x, 16, obj, K, dist, **cpu),
                 inference_frames()),
        "full_fused": (lambda d, r, x: full_forward(d, r, x, 16, obj, K, dist,
                                                    fused_head=True, **cpu),
                       inference_frames()),
        "two_stage_224": (lambda d, r, x: two_stage_forward(d, r, x, 16, **cpu),
                          inference_frames(224, 2)),
    }


def run_inference(mesh, names):
    from deepcharuco_tpu_torch.parallel import sharded_inference

    det, rn = pipeline_models()
    fns = inference_fns()
    out = {}
    for name in names:
        fn, frames = fns[name]
        res = sharded_inference(fn, mesh)(det, rn, frames)
        out.update({f"{name}/{i}": t.numpy() for i, t in enumerate(res)})
    return out


def state_arrays(sd, prefix=""):
    return {prefix + k: v.numpy() for k, v in sd.items()}


def main():
    import torch.distributed as dist

    from deepcharuco_tpu_torch.parallel import init_distributed, make_mesh

    init_file, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(2)
    init_distributed("cpu", init_method=f"file://{init_file}")
    world = dist.get_world_size()
    results = {}
    if world == 2:
        mesh = make_mesh(2, 1, device="cpu")
        sd, losses = det_steps(mesh)
        results["det_2x1"] = {**state_arrays(sd), "losses": np.array(losses)}
        sd, loss = synth_program(mesh)
        results["synth_2x1"] = {**state_arrays(sd), "losses": np.array([loss])}
        results["infer_2x1"] = run_inference(mesh, ["two_stage"])
        batch, peers, sd, losses = host_fed_steps(make_mesh(1, 2, device="cpu"))
        results["host_1x2"] = {**state_arrays(sd), **peers, "losses": np.array(losses),
                               **dict(zip(("image", "loc", "ids"), batch))}
    else:
        mesh = make_mesh(2, 2, device="cpu")
        sd, losses = det_steps(mesh)
        results["det_2x2"] = {**state_arrays(sd), "losses": np.array(losses)}
        sd, losses = rn_steps(mesh)
        results["rn_2x2"] = {**state_arrays(sd), "losses": np.array(losses)}
        sd, loss = synth_program(mesh)
        results["synth_2x2"] = {**state_arrays(sd), "losses": np.array([loss])}
        results["infer_2x2"] = run_inference(
            mesh, ["two_stage", "fused", "geom_fill", "full", "full_fused"])
        results["infer_1x4"] = run_inference(make_mesh(1, 4, device="cpu"),
                                             ["two_stage_224", "two_stage"])
    if dist.get_rank() == 0:
        for name, arrays in results.items():
            np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
