"""The system under test, built from a configuration file: the port's
``InferencePipeline`` and its training state. The only module of the
benchmark that imports the port (``deepcharuco_tpu_torch``)."""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def check_weights(cfg: dict, root) -> None:
    """Refuse weight files that are not the ones the configuration names:
    the benchmark's inputs do not move with the repository's artifacts."""
    for part in ("detector", "refinenet"):
        path = root / cfg[part]["weights"]
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        if digest != cfg[part]["sha256"]:
            raise RuntimeError(f"{path} is not the configuration's weight file "
                               f"(sha256 {digest}, want {cfg[part]['sha256']})")


def board_config(cfg: dict):
    from deepcharuco_tpu_torch.configs import Config

    h, w = cfg["input_hw"]
    s = cfg.get("hires_scale", 1)
    return Config(input_size=(w // s, h // s), **cfg["board"])


def pipeline(cfg: dict, root, device):
    """``InferencePipeline`` with the configuration's weights, precision,
    decode and RefineNet options and camera (at the input resolution)."""
    from deepcharuco_tpu_torch.pipeline import Camera, InferencePipeline, load_model_variables

    check_weights(cfg, root)
    r = cfg["refinenet"]
    cam = Camera(K=np.array(cfg["camera"]["K"], np.float32),
                 dist=np.array(cfg["camera"]["dist"], np.float32))
    scale = cfg.get("hires_scale", 1)
    return InferencePipeline(
        board_config(cfg),
        load_model_variables(str(root / cfg["detector"]["weights"]), "detector", cfg["n_ids"]),
        load_model_variables(str(root / r["weights"]), "refinenet"),
        camera=cam, compute_dtype=getattr(torch, cfg["compute_dtype"]),
        pnp_iters=cfg["pnp_iters"], rn_upsample=r["upsample"], rn_patch_size=r["patch_size"],
        rn_decode=r["decode"], hires=scale if scale > 1 else False,
        fused_head=cfg["detector"]["fused_head"], device=device)


def initial_detector(cfg: dict, seed: int, device) -> dict:
    """Initial detector parameters and statistics from the seed, made on the
    device in one draw: kernels LeCun-normal (a unit normal clipped at ±2,
    scaled by 1/sqrt(fan_in)), biases 0, BatchNorm scale 1 and bias 0,
    running mean 0 and variance 1. Keyed as the port's ``state_dict``."""
    from deepcharuco_tpu_torch.models import Detector

    shapes = {k: tuple(v.shape) for k, v in Detector(cfg["n_ids"], torch.float32)
              .state_dict().items()}
    kernels = [k for k, s in shapes.items() if k.endswith("weight") and len(s) == 4]
    sizes = [int(np.prod(shapes[k])) for k in kernels]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    out = {}
    for k, part in zip(kernels, draw.split(sizes)):
        fan_in = int(np.prod(shapes[k][1:]))
        out[k] = (part / np.sqrt(fan_in)).reshape(shapes[k])
    for k, s in shapes.items():
        if k in out:
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif k.endswith(("bn.weight", "running_var")):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def train_state(cfg: dict, start: dict, device):
    """The port's detector training state (float32, Adam) from ``start``,
    and its step function (``train.make_detector_train_step``)."""
    from deepcharuco_tpu_torch.models import Detector
    from deepcharuco_tpu_torch.train import create_detector_state, make_detector_train_step

    det = Detector(n_ids=cfg["n_ids"], dtype=torch.float32).to(device)
    det.load_state_dict({k: v.clone() for k, v in start.items()})
    t = cfg["train"]
    state = create_detector_state(det, t["lr"])
    return state, make_detector_train_step()
