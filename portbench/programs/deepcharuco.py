"""DeepCharuco as the benchmark runs it: the port's ``InferencePipeline``
(detector, corner decode, RefineNet, planar PnP) and its detector training
state, built from a configuration file; their plain reference, control,
planted faults and analytic FLOPs. The interface is
``programs/__init__.py``'s.

The control of a serving cell runs the reference's networks with their
convolutions' inputs and kernels rounded to float8 e4m3 (per-tensor scale)
and solves the pose in bfloat16, in batches of the cell's size; that of a
training cell runs the reference's steps with convolutions rounded to
bfloat16 (the configuration trains in float32 with TF32 convolutions).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import harness
from portbench.counts import HBM_BYTES_PER_S, conv_flops

OUTPUTS = ("keypoints", "valid", "refined", "ok", "rvec", "tvec", "reproj_rms")
STATISTICS = ("running_mean", "running_var", "num_batches_tracked")


# ----- the system under test --------------------------------------------------
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


def build(cfg: dict, root, seed: int, device):
    """``InferencePipeline`` with the configuration's weights (the shipped
    files; ``seed`` is not used), precision, decode and RefineNet options
    and camera (at the input resolution)."""
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


def instrument(spans, pipe, layers: bool) -> None:
    """A traced run's spans: around ``forward_device`` and ``solve_pose``,
    and with ``layers`` around the detector's and RefineNet's calls."""
    if layers:
        spans.hook(pipe.detector, "detector")
        spans.hook(pipe.refinenet, "refinenet")
    spans.wrap(pipe, "forward_device", "forward_device")
    spans.wrap(pipe, "solve_pose", "solve_pose")


def initial_state(cfg: dict, seed: int, device) -> dict:
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


def synthesizer(cfg: dict, device):
    """``data.DeviceSynthesizer`` on the configuration's board and input
    size, with its defaults (``cli.train --device-synth``'s: negatives 0.05,
    procedural backgrounds, no bank): ``batch(gen, n) → (images (n, H, W,
    1), loc, ids)``."""
    from deepcharuco_tpu_torch.data import DeviceSynthesizer

    return DeviceSynthesizer(board_config(cfg), device=device)


# ----- the reference ------------------------------------------------------------
def judge(cfg: dict, root, seed: int, device, frames_u8: np.ndarray,
          out: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The readings of the answers ``out`` on ``frames_u8`` against the
    reference pipeline (``reference.pipeline.Reference``)."""
    from portbench.reference.pipeline import Reference

    return Reference(cfg, root, device).judge(frames_u8, out)


def train_reference(cfg: dict, start: dict, batches, q=None) -> dict:
    """The reference's Adam steps from ``start`` on ``batches``
    (``reference.train.steps``), ``q`` rounding its convolutions; without
    ``q`` also the first step's gradient with bfloat16 convolutions, the
    yardstick of ``grad_gap_bf16_share``."""
    from portbench.reference import nets
    from portbench.reference import train as ref_train

    t = cfg["train"]
    kw = {} if q is None else {"q": q}
    losses, grad, end = ref_train.steps(start, batches, t["lr"], t["betas"], t["eps"], **kw)
    out = {"losses": losses, "grad": grad, "end": end}
    if q is None:
        out["grad_bf16"] = ref_train.steps(start, batches[:1], t["lr"], t["betas"], t["eps"],
                                           q=nets.bf16)[1]
    return out


def judge_train(record: dict, reference: dict) -> Dict[str, float]:
    from portbench.reference import train as ref_train

    return ref_train.judge(record, reference)


def synth_readings(cfg: dict, batches) -> Dict[str, int]:
    """What the synthesizer's own batches must hold whatever they draw:
    ``bad_label_samples`` counts samples whose label maps break it (a cell
    without a corner is 64 in ``loc`` and ``n_ids`` in ``ids``, a corner's
    cell neither; no id in two cells) or whose image is not finite."""
    n_ids = cfg["n_ids"]
    bad = 0
    for images, loc, ids in batches:
        empty_loc, empty_ids = loc == 64, ids == n_ids
        ok = (empty_loc == empty_ids).flatten(1).all(1)
        ok &= torch.isfinite(images).flatten(1).all(1)
        for i in range(n_ids):
            ok &= (ids == i).flatten(1).sum(1) <= 1
        bad += int((~ok).sum())
    return {"bad_label_samples": bad}


# ----- the control ----------------------------------------------------------------
def control(c: dict, seed: int, device) -> Dict[str, float]:
    """The control's readings on the inputs a run of ``seed`` judges (the
    cell's driver's ``control_inputs``)."""
    driver = harness.driver(c)
    inputs = driver.control_inputs(c, seed, device)
    fn = _control_train if driver.TASK == "train" else _control_serve
    return {**inputs.get("readings", {}), **fn(c, seed, device, inputs)}


def _control_serve(c: dict, seed: int, device, inputs: dict) -> Dict[str, float]:
    from portbench.common import full_float32
    from portbench.reference import nets
    from portbench.reference.pipeline import Reference

    sample = inputs["frames"]
    ref = Reference(c["config"], harness.ROOT, device)
    with full_float32():
        out = ref.run(sample, q=nets.fp8, pose_dtype=torch.bfloat16, block=inputs["block"])
        return ref.judge(sample, out)


def _control_train(c: dict, seed: int, device, inputs: dict) -> Dict[str, float]:
    from portbench.common import full_float32
    from portbench.reference import nets

    cfg = c["config"]
    start = initial_state(cfg, seed, device)
    start = {k: v for k, v in start.items() if not k.endswith(STATISTICS)}
    with full_float32():
        ref = train_reference(cfg, start, inputs["batches"])
        ctl = train_reference(cfg, start, inputs["batches"], q=nets.bf16)
    return judge_train({"start": start, **ctl}, ref)


# ----- faults planted in the timed path ---------------------------------------
def _forward(run, change):
    fn = run.pipe.forward_device

    def faulty(frames, with_pose=False):
        return change(list(fn(frames, with_pose)), frames, fn, with_pose)

    run.pipe.forward_device = faulty


def wrong_rows(run):
    """Refined corners handed out from the next frame's row."""
    def change(out, *_):
        out[2] = out[2].roll(1, 0)
        return tuple(out)
    _forward(run, change)


def altered_answer(run):
    """One detected corner of every frame moved by half a pixel where the
    pipeline makes it (after the pose)."""
    def change(out, *_):
        r = out[2].clone()
        first = out[1].to(torch.int8).argmax(1)
        r[torch.arange(r.shape[0], device=r.device), first, 0] += 0.5
        out[2] = r
        return tuple(out)
    _forward(run, change)


def half_batch(run):
    """Only the first half of each batch computed; its answers are handed out
    for the second half too."""
    def change(out, frames, fn, with_pose):
        n = frames.shape[0]
        h = (n + 1) // 2
        return tuple(t[torch.arange(n, device=t.device) % h] for t in out)
    _forward(run, change)


def pose_wrong_corners(run):
    """The pose of each frame solved from the next frame's corners."""
    fn = run.pipe.solve_pose
    run.pipe.solve_pose = lambda refined, valid: fn(refined.roll(1, 0), valid.roll(1, 0))


def pose_one_row(run):
    """The pose of the first frame of every batch (of every step: the
    first stream's) solved from the next frame's corners."""
    fn = run.pipe.solve_pose

    def solve(refined, valid):
        r, v = refined.clone(), valid.clone()
        r[0], v[0] = refined[1 % len(refined)], valid[1 % len(valid)]
        return fn(r, v)
    run.pipe.solve_pose = solve


def unchanged(run):
    """A training step that computes its loss and leaves the state as it
    was."""
    from deepcharuco_tpu_torch.train import detector_loss_fn

    def step(state, images, loc, ids, mesh=None):
        _, aux, _ = detector_loss_fn(state.model, images, loc, ids)
        return state, {k: v.detach() for k, v in aux.items()}
    run.step = step


def half_batch_train(run):
    """A training step on the first half of its batch only, the mean taken
    over that half."""
    fn = run.step

    def step(state, images, loc, ids, mesh=None):
        h = images.shape[0] // 2
        return fn(state, images[:h], loc[:h], ids[:h])
    run.step = step


def same_batch(run):
    """The first synthesised batch handed to every step."""
    fn = run.synth.batch
    first = []

    def batch(gen, n, share=None):
        if not first:
            first.append(fn(gen, n, share))
        return first[0]
    run.synth.batch = batch


def label_mismatch(run):
    """One corner cell of every sample keeps its position in ``loc`` and
    loses its id in ``ids`` where the synthesizer makes the labels."""
    fn = run.synth.batch

    def batch(gen, n, share=None):
        images, loc, ids = fn(gen, n, share)
        flat = ids.flatten(1).clone()
        first = (flat < run.cfg["n_ids"]).to(torch.int8).argmax(1)
        flat[torch.arange(flat.shape[0], device=flat.device), first] = run.cfg["n_ids"]
        return images, loc, flat.view_as(ids)
    run.synth.batch = batch


FAULTS = {"wrong_rows": wrong_rows, "altered_answer": altered_answer,
          "half_batch": half_batch, "pose_wrong_corners": pose_wrong_corners,
          "pose_one_row": pose_one_row,
          "unchanged": unchanged, "half_batch_train": half_batch_train,
          "same_batch": same_batch, "label_mismatch": label_mismatch}


def plant(run) -> None:
    if run.fault is not None:
        FAULTS[run.fault](run)


# ----- analytic counts ---------------------------------------------------------
# Two FLOPs per multiply-accumulate of every convolution, counted from the
# layer shapes the configuration states, whatever the program launches to
# compute them. Bytes of a kernel are its inputs read once and its outputs
# written once.
def detector_layers(h: int, w: int, widths, head: int, loc: int, ids: int
                    ) -> List[Tuple[str, float]]:
    """(name, FLOPs) of the detector on one (h, w) frame: conv pairs at
    ``widths`` (SAME 3x3) with a 2x2 pool after each of the first three,
    then two heads (3x3 to ``head``, 1x1 to ``loc`` / ``ids``) at h/8."""
    c1, c2, c3, c4 = widths
    out, cin = [], 1
    for i, c in enumerate((c1, c2, c3, c4)):
        s = 2 ** i
        out += [(f"conv{i + 1}a", conv_flops(cin, c, 3, h // s, w // s)),
                (f"conv{i + 1}b", conv_flops(c, c, 3, h // s, w // s))]
        cin = c
    hc, wc = h // 8, w // 8
    out += [("convPa", conv_flops(c4, head, 3, hc, wc)),
            ("convPb", conv_flops(head, loc, 1, hc, wc)),
            ("convDa", conv_flops(c4, head, 3, hc, wc)),
            ("convDb", conv_flops(head, ids, 1, hc, wc))]
    return out


def refinenet_layers(patch: int, widths, heatmap: int = 64) -> List[Tuple[str, float]]:
    """(name, FLOPs) of RefineNet on one patch: four VALID 3x3 convs, a 2x2
    pool, two more VALID convs for the 32-px net, SAME conv pairs at 8, 16
    and 32 px around x2 upsamples, a SAME conv and a 1x1 conv at 64 px."""
    c1, c2, c3, c4, c5 = widths
    s = patch
    out = []
    for name, cin, cout in (("conv1a", 1, c1), ("conv1b", c1, c1),
                            ("conv2a", c1, c2), ("conv2b", c2, c2)):
        s -= 2
        out.append((name, conv_flops(cin, cout, 3, s, s)))
    s //= 2
    if patch == 32:
        for name in ("conv2c", "conv2d"):
            s -= 2
            out.append((name, conv_flops(c2, c2, 3, s, s)))
    if s != heatmap // 8:
        raise ValueError(f"patch {patch} does not reach the {heatmap // 8}-px bottleneck")
    for name, cin, cout in (("conv3a", c2, c3), ("conv3b", c3, c3)):
        out.append((name, conv_flops(cin, cout, 3, s, s)))
    for (a, b), cin, cout in ((("conv4a", "conv4b"), c3, c4), (("conv5a", "conv5b"), c4, c5)):
        s *= 2
        out += [(a, conv_flops(cin, cout, 3, s, s)), (b, conv_flops(cout, cout, 3, s, s))]
    s *= 2
    out += [("convPa", conv_flops(c5, c5, 3, s, s)), ("convPb", conv_flops(c5, 1, 1, s, s))]
    return out


def detector_flops(cfg: dict) -> float:
    """FLOPs of the detector on one frame of the view it sees (the pooled
    view under the hi-res tap)."""
    d = cfg["detector"]
    h, w = (x // cfg.get("hires_scale", 1) for x in cfg["input_hw"])
    return sum(f for _, f in detector_layers(h, w, d["widths"], d["head_width"],
                                             d["loc_classes"], d["id_classes"]))


def refinenet_flops(cfg: dict) -> float:
    """FLOPs of RefineNet on one patch."""
    r = cfg["refinenet"]
    return sum(f for _, f in refinenet_layers(r["patch_size"], r["widths"], r["heatmap"]))


def frame_flops(cfg: dict) -> float:
    """FLOPs of one frame through the pipeline's networks: the detector and
    RefineNet on every one of the ``n_ids`` slots."""
    return detector_flops(cfg) + cfg["n_ids"] * refinenet_flops(cfg)


def train_sample_flops(cfg: dict) -> float:
    """FLOPs of one detector training sample: the forward pass, and a
    backward pass that computes every kernel's gradient and every layer's
    input gradient but the first's (nothing needs the image's)."""
    d = cfg["detector"]
    h, w = cfg["input_hw"]
    layers = detector_layers(h, w, d["widths"], d["head_width"], d["loc_classes"],
                             d["id_classes"])
    return 3.0 * sum(f for _, f in layers) - layers[0][1]


def flops_per_item(cfg: dict, task: str) -> float:
    """FLOPs of one frame served (``task`` "serve") or one detector sample
    trained ("train")."""
    return frame_flops(cfg) if task == "serve" else train_sample_flops(cfg)


def decode_bytes(cfg: dict, n: int) -> Dict[str, float]:
    """Bytes of the corner decode (B1) on ``n`` frames: the float32 loc and
    ids logits read once, keypoints (float32 pairs) and validity (bool)
    written once."""
    d = cfg["detector"]
    h, w = (x // cfg.get("hires_scale", 1) for x in cfg["input_hw"])
    cells = n * (h // 8) * (w // 8)
    read = cells * (d["loc_classes"] + d["id_classes"]) * 4
    written = n * cfg["n_ids"] * (2 * 4 + 1)
    return {"read": float(read), "written": float(written), "total": float(read + written)}


def decode_min_seconds(cfg: dict, n: int) -> float:
    """The least time of B1 on ``n`` frames: it does no matrix work, so its
    bytes over the card's bandwidth bound it."""
    return decode_bytes(cfg, n)["total"] / HBM_BYTES_PER_S
